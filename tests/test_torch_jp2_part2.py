"""JPEG 2000 Part 2 codestreams (ITU-T T.801) and samples of 17 to 31 bits
in the port (`utils/jp2.py` and the compiled `csrc/jp2_decode.cc`) against
PIL 12 (OpenJPEG 2.5), on files of the test-side encoder
`tests/torch_j2k_writer.py` and edits of their markers.

OpenJPEG's Part 2 support is partial, and the rule is what it makes of a
file for PIL, not the standard: Rsiz bit 15 changes nothing; of the Part 2
markers it reads MCT, MCC, MCO and CBD (an MCO zeroes every component's DC
level shift, and an MCT offset array named through an MCC becomes it; a
CBD sets each component's precision and sign), and skips the others as
unknown markers in the main header (failing in a tile-part header). Above
16 bits PIL reads grey as "I;16" and the rest in its 8-bit modes, rounding
the samples down; more than 4 components fail.

The writer is checked first: PIL decodes each lossless write to the
picture as PIL reduces it, and its low 16 bits read back exactly through a
CBD of 16 bits and an MCT offset. Then the port is held to PIL's reading
of the same bytes: the findings of a probe of PIL, each a named case;
marker edits in both headers; every precision, mode, sign, wavelet and
block coder; seeded damage; the committed fixtures
(`tests/fixtures/torch_jp2_part2`); and both dataset paths to the JAX
package, which opens its images with PIL.

Tolerances: every comparison is bit-equal. For each file the port's
`image_io.open_image` must give PIL's mode and `np.asarray(Image.open(f))`
(a channel axis kept) and `to_rgba` PIL's `convert("RGBA")`, or raise a
`ValueError` naming the file where PIL raises. Pictures are at most 48x40,
made from `np.random.default_rng(seed)`.
"""

import functools
import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import image_io, jp2
from test_torch_image_forms import (  # noqa: F401  (cxx: a fixture)
    assert_follows_pil, cxx, smooth, write_colmap_dataset_of,
)
from test_torch_scene import assert_same_cameras
from torch_image_writers import j2k_join, j2k_markers, jp2_box, jp2_bytes
from torch_j2k_writer import CBD, HT, MCC, MCO, MCT, cbd, deep_samples, edited, encode, mcc, mco, mct

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_jp2_part2")
SIZ, COD, COC = 0xFF51, 0xFF52, 0xFF53
# Part 2 markers OpenJPEG does not read: DCO, VMS, DFS, ADS, NLT, ATK, and the rest of 0xFF70-0xFF7F
SKIPPED = {"DCO": 0xFF70, "VMS": 0xFF71, "DFS": 0xFF72, "ADS": 0xFF73, "NLT": 0xFF76, "ATK": 0xFF79,
           "0xFF7A": 0xFF7A, "0xFF7B": 0xFF7B, "0xFF7C": 0xFF7C, "0xFF7D": 0xFF7D, "0xFF7E": 0xFF7E,
           "0xFF7F": 0xFF7F, "0xFF5A": 0xFF5A, "0xFF5B": 0xFF5B}


def picture(c=3, seed=1, h=40, w=48):
    return smooth(h, w, c, seed)


def pil_reduced(v, bits, signed, out_bits):
    """PIL's unpackers on samples `v` of `bits` bits read into a mode of
    `out_bits` (8, or 16 for I;16): the sign offset and the rounding offset
    added in 32 bits, shifted down, the result's low `out_bits` kept."""
    shift = out_bits - bits
    offset = (1 << (bits - 1) if signed else 0) + (1 << (-shift - 1) if shift < 0 else 0)
    u = (v.astype(np.int64) + offset) & 0xFFFFFFFF
    return (u >> -shift if shift < 0 else u << shift) & ((1 << out_bits) - 1)


def _with_coding(main, marker, offset, value):
    return [(m, b[:offset] + bytes([value]) + b[offset + 1:] if m == marker else b) for m, b in main]


# ---- the writer ----

# (name, bits, signed, channels, options): lossless writes (5/3), MQ and HT
REVERSIBLE = [
    ("17-bit grey", 17, False, 1, {}),
    ("20-bit RGB, RCT", 20, False, 3, {"mct": True}),
    ("24-bit grey, signed", 24, True, 1, {}),
    ("24-bit RGBA, tiles", 24, False, 4, {"tile": (24, 24)}),
    ("31-bit grey", 31, False, 1, {}),
    ("31-bit LA, signed", 31, True, 2, {}),
    ("20-bit grey, HT", 20, False, 1, {"style": HT}),
    ("24-bit RGB, HT, RCT", 24, False, 3, {"style": HT, "mct": True}),
    ("31-bit grey, HT, band exponents 28", 31, False, 1, {"style": HT, "max_expn": 28}),
]


def _reversible(name):
    _, bits, signed, c, options = next(r for r in REVERSIBLE if r[0] == name)
    v = deep_samples(picture(c, bits), bits, signed, bits, headroom=3 if bits == 31 else 0)
    return v, bits, signed, encode(v, precision=bits, signed=signed, levels=3, **options)


@pytest.mark.parametrize("j2k", [True, False], ids=["j2k", "jp2"])
@pytest.mark.parametrize("case", [r[0] for r in REVERSIBLE])
def test_writer_decodes_in_pil_to_the_picture(case, j2k):
    """Every lossless high-precision write decodes in PIL to the picture as
    PIL's unpackers reduce it (grey to 16 bits, the rest to 8)."""
    v, bits, signed, cs = _reversible(case)
    data = cs if j2k else jp2_bytes(cs, bpc=(bits - 1) | (0x80 if signed else 0),
                                    colr=(1, 17 if v.shape[2] <= 2 else 16))
    im = Image.open(io.BytesIO(data))
    out_bits = 16 if im.mode == "I;16" else 8
    np.testing.assert_array_equal(np.asarray(im).reshape(v.shape), pil_reduced(v, bits, signed, out_bits), err_msg=case)


@pytest.mark.parametrize("ht", [False, True], ids=["MQ", "HT"])
@pytest.mark.parametrize("bits", [17, 20, 24, 31])
def test_writer_low_bits_read_back_through_cbd_and_mco(tmp_path, cxx, bits, ht):
    """The writer's low bits, which PIL's 8- and 16-bit modes drop: a grey
    picture of 16 bits of content above a base of `bits` bits, written
    lossless, then read with a CBD of 16 unsigned bits (the clamp and PIL's
    unpacker take 16 bits) and an MCT offset array, named by an MCC and an
    MCO, moving the DC level shift by the base: PIL gives the content
    exactly, and so does the port."""
    rng = np.random.default_rng(bits)
    content = rng.integers(0, 1 << 16, (20, 24, 1))
    base = (1 << (bits - 1)) - 40_000
    cs = encode((base + content).astype(np.uint32), precision=bits, levels=3, style=HT if ht else 0,
                max_expn=24 if ht else 31)  # HT: bands of at most 30 bit-planes, which OpenJPEG's decoder needs
    shift = (1 << (bits - 1)) - base  # the sample less 2^(bits - 1) plus this is the content
    data = edited(cs, [cbd([15]), mct(1, 1, [shift]), mcc(1, 1, offset=1), mco(1)], rsiz=0x8000 | (0x4000 if ht else 0))
    got = assert_follows_pil(tmp_path, data, f"{bits} bits", ".j2k")
    assert got.mode == "I;16"
    np.testing.assert_array_equal(got.pixels, content)


# ---- the probe's findings ----

@functools.cache
def findings():
    """The findings of a probe of PIL 12.1.0 / OpenJPEG 2.5.4, each a view
    and what it must read as beside the plain file's pixels (a function of
    them), or None where PIL fails."""
    a = picture(3, 1)
    plain = encode(a, mct=True)
    ht = encode(a, style=HT, mct=True)

    def shifted(delta):
        return lambda p: np.clip(p.astype(np.int64) + np.asarray(delta), 0, 255).astype(np.uint8)

    def same(p):
        return p

    out = {
        "Rsiz bit 15 is read": (edited(plain, rsiz=0x8000), same),
        "Rsiz 0xC000 is read (HTJ2K)": (edited(ht, rsiz=0xC000), same),
        "MCO with Nmco = 0 zeroes the DC shift": (edited(plain, [mco()], rsiz=0x8000), shifted(-128)),
        "an MCT offset array becomes the DC shift through MCC + MCO": (
            edited(plain, [mct(1, 1, [10, 20, 30]), mcc(1, 3, offset=1), mco(1)], rsiz=0x8000),
            shifted([10 - 128, 20 - 128, 30 - 128])),
        "MCT + MCC without MCO leave the pixels unchanged": (
            edited(plain, [mct(1, 1, [10, 20, 30]), mcc(1, 3, offset=1)], rsiz=0x8000), same),
        "a CBD of the SIZ depths leaves the pixels unchanged": (edited(plain, [cbd([7] * 3)], rsiz=0x8000), same),
        "a CBD of a wrong length fails": (edited(plain, [(CBD, b"\x00\x03\x07\x07")]), None),
        "an MCO whose length disagrees with Nmco fails": (edited(plain, [(MCO, b"\x01\x01\x01")]), None),
        "SGcod MCT = 2 fails": (edited(plain, main_edit=lambda m: _with_coding(m, COD, 4, 2)), None),
        "SGcod MCT = 3 fails": (edited(plain, main_edit=lambda m: _with_coding(m, COD, 4, 3)), None),
    }
    for name in ("NLT", "ATK", "0xFF7A", "0xFF7B", "0xFF7C", "0xFF7D"):
        out[f"{name} with an empty body is skipped"] = (edited(plain, [(SKIPPED[name], b"")], rsiz=0x8000), same)
    row = np.where(np.arange(16) % 2 == 0, -(1 << 30), (1 << 30) - 1)  # differences of 31 bits
    out["a code-block of 31 bit-planes fails (MQ)"] = (
        encode((np.tile(row, (4, 1))[..., None] + (1 << 30)).astype(np.uint32), precision=31, levels=1), None)
    out["a band of 31 bit-planes fails (HT)"] = (
        encode(deep_samples(picture(1, 2, 8, 8), 31, headroom=3), precision=31, style=HT, levels=1), None)
    for bits in (17, 20, 24, 31):
        for c, mode in ((1, "I;16"), (3, "RGB")):
            v = deep_samples(picture(c, bits), bits, headroom=3 if bits == 31 else 0)
            out[f"precision {bits} reads as {mode}"] = (encode(v, precision=bits, levels=3, mct=c == 3), mode)
    return out


@pytest.mark.parametrize("name", list(findings()))
def test_probe_findings(tmp_path, cxx, name):
    """Each finding: PIL's reading and the port's agree, and are what the
    finding says (the plain file's pixels, moved by the DC shift an MCO
    sets; a mode; or a failure)."""
    data, want = findings()[name]
    got = assert_follows_pil(tmp_path, data, name, ".j2k")
    if want is None:
        assert got is None, name
    elif isinstance(want, str):
        assert got is not None and got.mode == want, name
    else:
        plain = np.asarray(Image.open(io.BytesIO(edited(data, main_edit=lambda m: [
            x for x in m if x[0] not in (MCT, MCC, MCO, CBD) and x[0] not in SKIPPED.values()]))))
        np.testing.assert_array_equal(got.pixels, want(plain), err_msg=name)


# ---- marker edits in both headers ----

@functools.cache
def edited_views():
    """Edits of Part 2 markers: MCT element types and values (negative,
    fractional, out of int32, NaN, wrapping the DC shift's int32 sum),
    records OpenJPEG passes over (Zmct, Ymct, Zmcc, Ymcc, several
    collections, another Xmcc, shuffled components, several MCO stages)
    and ones it fails on, the first-record rule of its MCC search, CBDs of
    other depths and signs, each marker in a tile-part header, the skipped
    markers with bodies (even and odd lengths, and bodies holding a known
    marker's code), Rsiz values, and transform bytes above 1."""
    a = picture(3, 2, 24, 28)
    plain = encode(a, mct=True, levels=3)
    tiled = encode(a, mct=True, levels=2, tile=(16, 16))
    i32 = lambda *v: mct(1, 1, list(v))  # noqa: E731
    offsets = lambda record: [record, mcc(1, 3, offset=1), mco(1)]  # noqa: E731
    views = {
        "int16 offsets (read unsigned)": offsets(mct(1, 0, [0xFFFF, 100, -5])),
        "int32 offsets, negative and extreme": offsets(i32(-50, 0x7FFFFFFF, -2**31)),
        "int32 offsets wrapping the DC shift's sum": offsets(i32(0x7FFFFFF0, 0x7FFFFFFF - 100, -2**31 + 50)),
        "float32 offsets, fractional and negative": offsets(mct(1, 2, [130.7, -2.5, 2.9])),
        "float32 offsets outside int32 and NaN": offsets(mct(1, 2, [3e9, -1e10, float("nan")])),
        "float32 offsets at int32's ends": offsets(mct(1, 2, [-130.7, 2147483520.0, -2147483648.0])),
        "float64 offsets": offsets(mct(1, 3, [130.7, 5e9, -3.99])),
        "float64 offsets at int32's ends": offsets(mct(1, 3, [2147483647.9, -2147483648.9, float("inf")])),
        "an offset array of 2 elements": offsets(mct(1, 1, [10, 20])),
        "an MCT of no data": [(MCT, struct.pack(">HHH", 0, 0x601, 0))],
        "an MCT of 1 byte": [(MCT, b"\x00")],
        "an MCT with Zmct 1": [(MCT, b"\x00\x01" + bytes(10)), mcc(1, 3, offset=1), mco(1)],
        "an MCT with Ymct 1": offsets(mct(1, 1, [10, 20, 30], ymct=1)),
        "an MCT with Ymct 1 over a record": [i32(10, 20, 30), mcc(1, 3, offset=1), mct(1, 1, [1, 2, 3], ymct=1),
                                              mco(1)],
        "an MCT redefined after its MCC": [i32(10, 20, 30), mcc(1, 3, offset=1), i32(40, 50, 60), mco(1)],
        "an MCT of array type 0": offsets(mct(1, 1, [10, 20, 30], array=0)),
        "two MCCs, the MCO naming the second": [i32(10, 20, 30), mcc(1, 3, offset=1), mcc(2, 3, offset=1), mco(2)],
        "two MCCs, the MCO naming the first": [i32(10, 20, 30), mcc(1, 3, offset=1), mcc(2, 3, offset=1), mco(1)],
        "an MCC redefined": [i32(10, 20, 30), mct(2, 1, [5, 5, 5]), mcc(1, 3, offset=1), mcc(1, 3, offset=2), mco(1)],
        "an MCC naming no MCT": [mcc(1, 3, offset=5)],
        "an MCC of 2 components": [i32(10, 20, 30), mcc(1, 2, offset=1), mco(1)],
        "an MCC with Xmcc 2": [i32(10, 20, 30), mcc(1, 3, offset=1, kind=2), mco(1)],
        "an MCC of no collection": [mcc(1, 3, collections=0), mco(1)],
        "an MCC of two collections": [i32(10, 20, 30), mcc(1, 3, offset=1, collections=2), mco(1)],
        "an MCC with Zmcc 1": [(MCC, b"\x00\x01" + bytes(20)), mco(1)],
        "an MCC of 6 bytes": [(MCC, bytes(6))],
        "an MCC with shuffled components": [i32(10, 20, 30), mcc(1, 3, offset=1, order=[1, 0, 2]), mco(1)],
        "an MCC with a byte left over": [i32(10, 20, 30), (MCC, mcc(1, 3, offset=1)[1] + b"\x00"), mco(1)],
        "a shuffled MCC, then a good one of its index": [i32(10, 20, 30), mcc(1, 3, offset=1, order=[2, 1, 0]),
                                                         mcc(1, 3, offset=1), mco(1)],
        "a decorrelation array of 9 elements": [mct(2, 1, list(range(9)), array=1), mcc(1, 3, deco=2), mco(1)],
        "a decorrelation array of 3 elements": [mct(2, 1, [1, 2, 3], array=1), mcc(1, 3, deco=2), mco(1)],
        "a decorrelation and an offset array": [mct(2, 2, [1.0] * 9, array=1), i32(-10, 0, 10),
                                                mcc(1, 3, offset=1, deco=2), mco(1)],
        "an MCO of two stages": [i32(10, 20, 30), mcc(1, 3, offset=1), (MCO, b"\x02\x01\x01")],
        "an MCO of no body": [(MCO, b"")],
        "an MCO naming no MCC": [mco(7)],
        "an MCO before its MCC": [i32(10, 20, 30), mco(1), mcc(1, 3, offset=1)],
        "two MCOs": [i32(10, 20, 30), mcc(1, 3, offset=1), mco(1), mco()],
        "a CBD of 12 bits": [cbd([11] * 3)],
        "a CBD of 4 bits": [cbd([3] * 3)],
        "a CBD of 20 bits": [cbd([19] * 3)],
        "a CBD of 31 bits": [cbd([30] * 3)],
        "a CBD of 32 bits": [cbd([31] * 3)],
        "a CBD of signed 8 bits": [cbd([0x87] * 3)],
        "a CBD of mixed depths": [cbd([0x83, 15, 9])],
        "a CBD counting 2 components": [(CBD, b"\x00\x02\x07\x07\x07")],
        "a CBD then MCO offsets": [cbd([9] * 3)] + offsets(i32(300, 600, 900)),
    }
    out = {name: edited(plain, add, rsiz=0x8000) for name, add in views.items()}
    for name, add in (("MCO", [mco()]), ("MCT, MCC and MCO", offsets(i32(10, 20, 30))), ("CBD", [cbd([7] * 3)]),
                      ("MCC and MCO", [mcc(1, 3, offset=1), mco(1)])):
        out[f"{name} in every tile-part header"] = edited(tiled, (), add, rsiz=0x8000)
    out["MCT and MCC in the main header, MCO in the tile-part headers"] = edited(
        tiled, [i32(10, 20, 30), mcc(1, 3, offset=1)], [mco(1)])
    out["MCO in the main header, MCT, MCC and MCO in the tile-part headers"] = edited(
        tiled, [mco()], offsets(i32(10, 20, 30)))
    out["MCT in the main header, redefined in the tile-part headers"] = edited(
        tiled, offsets(i32(10, 20, 30)), [i32(50, 60, 70), mco(1)])
    for name, m in SKIPPED.items():
        out[f"{name}, empty"] = edited(plain, [(m, b"")])
        out[f"{name}, a body of 40 bytes"] = edited(plain, [(m, bytes(range(1, 41)))])
        out[f"{name}, a body of 39 bytes"] = edited(plain, [(m, bytes(range(1, 40)))])
        out[f"{name} in a tile-part header"] = edited(tiled, (), [(m, b"\x01\x02")])
    for m, label in ((0xFF76, "NLT"), (0xFF79, "ATK")):
        out[f"{label}, a body holding a COD code"] = edited(plain, [(m, b"\x01\x02\xff\x52\x00\x03\x04\x05")])
        out[f"{label}, a body holding a COM"] = edited(plain, [(m, b"\x01\x02\xff\x64\x00\x04\x04\x05")])
        out[f"{label}, a body holding a QCD code"] = edited(plain, [(m, b"\xff\x5c\x00\x02")])
    for rsiz in (0x8001, 0x8123, 0xC000, 0xFFFF):
        out[f"Rsiz {rsiz:#06x}"] = edited(plain, rsiz=rsiz)
    for value in (2, 3, 255):
        out[f"a COD transform byte {value} (an ATK reference)"] = edited(
            plain, main_edit=lambda m, v=value: _with_coding(m, COD, 9, v))
        out[f"a COC transform byte {value}"] = edited(plain, [(COC, b"\x01\x00\x03\x04\x04\x00" + bytes([value]))])
    cod = next(b for m, b in j2k_markers(tiled)[0] if m == COD)
    out["a COD MCT of 2 in a tile-part header"] = edited(tiled, (), [(COD, cod[:4] + b"\x02" + cod[5:])])
    return out


EDITED_VIEWS = sorted(edited_views())


@pytest.mark.parametrize("view", EDITED_VIEWS)
def test_port_follows_pil_on_marker_edits(tmp_path, cxx, view):
    """Each edit reads as PIL reads it, or raises where PIL raises."""
    assert_follows_pil(tmp_path, edited_views()[view], view, ".j2k")


# ---- precision 17 to 31 ----

HIGH = [(bits, c, signed, irreversible, ht) for bits in (17, 20, 24, 31) for c in (1, 2, 3, 4)
        for signed in (False, True) for irreversible in (False, True) for ht in (False, True)]


@pytest.mark.parametrize("bits, c, signed, irreversible, ht", HIGH, ids=[
    f"{b}-bit {('grey', 'LA', 'RGB', 'RGBA')[c - 1]} {'signed' if s else 'unsigned'} {'9-7' if i else '5-3'} "
    f"{'HT' if h else 'MQ'}" for b, c, s, i, h in HIGH])
def test_high_precision_follows_pil(tmp_path, cxx, bits, c, signed, irreversible, ht):
    """Samples of 17, 20, 24 and 31 bits in each mode, sign, wavelet and
    block coder (31-bit pictures a quarter of the range wide: the 5/3's
    coefficients fit OpenJPEG's 30 bit-planes; its HT decoder fails any
    band of more than 30, which the 31-bit HT files have): PIL's mode and
    pixels, or a raise where PIL raises."""
    v = deep_samples(picture(c, bits, 12, 14), bits, signed, bits, headroom=2 if bits == 31 else 0)
    cs = encode(v, precision=bits, signed=signed, irreversible=irreversible, style=HT if ht else 0, levels=2,
                mct=c >= 3)
    got = assert_follows_pil(tmp_path, cs, f"{bits} {c} {signed} {irreversible} {ht}", ".j2k")
    assert (got is None) == (ht and bits == 31)
    if got is not None:
        assert got.mode == ("I;16", "LA", "RGB", "RGBA")[c - 1]


# (rows, columns, pattern, image offset, levels): 31-bit pictures whose 5/3
# coefficients reach 2^30 - 1, where OpenJPEG's lifting sums wrap
WRAPS = [(1, 16, "columns", (0, 0), 1), (4, 16, "columns", (1, 0), 1), (9, 3, "rows", (0, 0), 1),
         (10, 19, "rows", (0, 1), 2), (7, 13, "checks", (1, 1), 1), (12, 27, "checks", (0, 0), 2),
         (17, 9, "random", (1, 0), 1), (6, 25, "random", (0, 1), 3), (2, 2, "checks", (1, 1), 1),
         (19, 24, "columns", (0, 0), 3)]


@pytest.mark.parametrize("h, w, pattern, offset, levels", WRAPS, ids=[f"{h}x{w} {p} offset {o} {n} levels"
                                                                     for h, w, p, o, n in WRAPS])
def test_5_3_wraps_as_openjpeg(tmp_path, cxx, h, w, pattern, offset, levels):
    """The inverse 5/3 at 31 bits: OpenJPEG's int32 sums wrap, and its
    row and column forms (scalar, and SSE2 on each whole group of 8
    columns) differ at the ends only where they wrap: PIL's pixels, which
    differ from the picture written where a sum wrapped."""
    rng = np.random.default_rng(h * 100 + w)
    yy, xx = np.mgrid[0:h, 0:w]
    low, high = -(1 << 29), (1 << 29) - 1  # highpass coefficients of 2^30 - 1
    a = {"columns": np.where(xx % 2 == 0, low, high), "rows": np.where(yy % 2 == 0, low, high),
         "checks": np.where((xx + yy) % 2 == 0, low, high),
         "random": np.where(rng.random((h, w)) < 0.5, low - rng.integers(0, 3, (h, w)),
                            high + rng.integers(-2, 1, (h, w)))}[pattern]
    v = (a[..., None] + (1 << 30)).astype(np.uint32)
    got = assert_follows_pil(tmp_path, encode(v, precision=31, levels=levels, offset=offset), pattern, ".j2k")
    if (h, w) == (1, 16):  # the first: a wrap at the row's start
        assert got is not None and not np.array_equal(got.pixels, pil_reduced(v, 31, False, 16)), "no sum wrapped"


@functools.cache
def jp2_views():
    """High-precision JP2s: ihdr's bpc of the SIZ depth, of 8 and 9 bits
    (PIL's mode follows bpc, not SIZ), 255 with a bpcc box (of the right
    and a wrong length), a signed one, sYCC (4:2:0 too, and with alpha),
    CMYK and a palette."""
    views = {}
    for bits in (17, 24, 31):
        v = deep_samples(picture(3, bits, 16, 20), bits, headroom=2 if bits == 31 else 0)
        rgb, grey = encode(v, precision=bits, mct=True, levels=2), encode(v[..., :1], precision=bits, levels=2)
        for bpc in (bits - 1, 7, 8, 255):
            views[f"{bits}-bit grey, bpc {bpc}"] = jp2_bytes(grey, bpc=bpc, colr=(1, 17))
            views[f"{bits}-bit RGB, bpc {bpc}"] = jp2_bytes(rgb, bpc=bpc)
        views[f"{bits}-bit RGB, bpcc"] = jp2_bytes(rgb, bpc=255, extra_header=jp2_box(b"bpcc", bytes([bits - 1] * 3)))
        views[f"{bits}-bit RGB, a short bpcc"] = jp2_bytes(rgb, bpc=255, extra_header=jp2_box(b"bpcc", b"\x07\x07"))
    s = deep_samples(picture(4, 5, 16, 20), 20, True, 5)
    views["20-bit RGBA, signed"] = jp2_bytes(encode(s, precision=20, signed=True, levels=2), bpc=0x80 | 19)
    for bits in (17, 24):  # PIL's sYCC and CMYK unpackers, and a palette, above 16 bits
        v = deep_samples(picture(4, bits, 16, 20), bits)
        views[f"{bits}-bit sYCC"] = jp2_bytes(encode(v[..., :3], precision=bits, levels=2), colr=(1, 18))
        views[f"{bits}-bit sYCC 4:2:0"] = jp2_bytes(encode(v[..., :3], precision=bits, levels=2, subsampling=[
            (1, 1), (2, 2), (2, 2)]), colr=(1, 18))
        views[f"{bits}-bit sYCC + alpha"] = jp2_bytes(encode(v, precision=bits, levels=2), colr=(1, 18))
        views[f"{bits}-bit CMYK"] = jp2_bytes(encode(v, precision=bits, levels=2), colr=(1, 12))
        views[f"{bits}-bit grey, a palette"] = jp2_bytes(encode(v[..., :1], precision=bits, levels=2), bpc=7,
                                                         pclr=np.random.default_rng(bits).integers(0, 256, (30, 3)))
    return views


@pytest.mark.parametrize("view", sorted(jp2_views()))
def test_high_precision_jp2_follows_pil(tmp_path, cxx, view):
    assert_follows_pil(tmp_path, jp2_views()[view], view, ".jp2")


@functools.cache
def component_views():
    """More than 4 components, in a codestream and in JP2s whose ihdr count
    differs from SIZ's, and palettes of 5 columns."""
    a = picture(3, 7, 16, 20)
    cs = encode(a, levels=2)
    main, parts = j2k_markers(cs)
    siz = main[0][1]

    def with_components(n):
        return j2k_join([(SIZ, siz[:34] + struct.pack(">H", n) + siz[36:] + siz[36:39] * (n - 3))] + main[1:], parts)

    five, six = with_components(5), with_components(6)
    grey = encode(a[..., :1], levels=2)
    entries = np.random.default_rng(7).integers(0, 256, (20, 5))
    views = {"5 components": five, "6 components": six, "5 components, ihdr 5": jp2_bytes(five, 5)}
    views.update({f"5 components, ihdr {n}": jp2_bytes(five, n) for n in (1, 3, 4)})
    views["a pclr of 5 columns"] = jp2_bytes(grey, pclr=entries)
    views["a pclr of 5 columns, ihdr 5"] = jp2_bytes(grey, 5, pclr=entries)
    views["a pclr of 5 columns over 5 components"] = jp2_bytes(five, 1, pclr=entries)
    return views


@pytest.mark.parametrize("view", sorted(component_views()))
def test_more_than_four_components_follow_pil(tmp_path, cxx, view):
    """PIL fails on every file of more than 4 components (its plugin finds
    no mode, or its decoder refuses the count); the port fails on each,
    naming the file, and reads a 5-column palette over one component as
    PIL does."""
    data = component_views()[view]
    got = assert_follows_pil(tmp_path, data, view, ".jp2" if data.startswith(jp2.JP2_SIGNATURE) else ".j2k")
    assert (got is not None) == (view == "a pclr of 5 columns"), view


# ---- damaged files ----

# (picture channels, writer options, main-header segments, tile-part segments)
DAMAGED = {
    "20-bit RGB 5/3, MCT / MCC / MCO / CBD in the main header": (
        3, dict(precision=20, mct=True, levels=3), [cbd([19] * 3), mct(1, 1, [1 << 19, 5 << 16, 3 << 17]),
                                                    mcc(1, 3, offset=1), mco(1)], []),
    "24-bit RGBA 9/7, MCT / MCC / MCO in tile-part headers": (
        4, dict(precision=24, irreversible=True, mct=True, tile=(24, 24), levels=2, planes=10), [],
        [mct(2, 3, [8e6, 8.5e6, 7.5e6, 8.3e6]), mcc(4, 4, offset=2), mco(4)]),
    "17-bit signed LA, HT, skipped markers": (
        2, dict(precision=17, signed=True, style=HT, levels=3), [(0xFF76, bytes(range(1, 9))), (0xFF79, b"\x00\x00"),
                                                                 mco()], []),
}


@pytest.mark.parametrize("form", list(DAMAGED))
def test_damaged_files_follow_pil(tmp_path, cxx, form):
    """Seeded damage to a Part 2 high-precision file: a flipped byte in a
    code-block's coded data (40), in the body of a Part 2 marker segment
    (40: an ignored record can become an applied one, or a failure), one
    anywhere in the headers' first 300 bytes (30), overwrites of 2 to 8
    bytes anywhere (20) and cuts (20): PIL's pixels, or a raise where PIL
    raises."""
    c, options, main_add, part_add = DAMAGED[form]
    signed = options.get("signed", False)
    v = deep_samples(picture(c, 40, 30, 36), options["precision"], signed, 40)
    data = edited(encode(v, **options), main_add, part_add, rsiz=0x8000)
    bodies = jp2.segments(data)
    part2 = []  # (offset, length) of each Part 2 segment's body, in both headers
    at, next_sot = 2, None
    while at + 4 <= len(data):
        marker, n = struct.unpack_from(">HH", data, at)
        if marker == 0xFF90:
            next_sot = at + struct.unpack_from(">I", data, at + 6)[0]
        elif marker == 0xFF93:  # SOD: on to the tile-part's end
            at = next_sot
            continue
        elif marker in (MCT, MCC, MCO, CBD, 0xFF76, 0xFF79) and n > 2:
            part2.append((at + 4, n - 2))
        at += 2 + n
    assert bodies and part2
    outcomes = {"read": 0, "raised": 0}
    for seed in range(150):
        rng = np.random.default_rng(seed)
        bad = bytearray(data)
        if seed < 80:
            at, n = (bodies if seed < 40 else part2)[int(rng.integers(len(bodies if seed < 40 else part2)))]
            bad[at + int(rng.integers(n))] ^= int(rng.integers(1, 256))
        elif seed < 110:
            bad[int(rng.integers(2, 300))] ^= int(rng.integers(1, 256))
        elif seed < 130:
            at, n = int(rng.integers(2, len(bad) - 8)), int(rng.integers(2, 9))
            bad[at:at + n] = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        else:
            bad = bad[:int(rng.integers(1, len(bad)))]
        got = assert_follows_pil(tmp_path, bytes(bad), f"{form} seed {seed}", ".j2k")
        outcomes["read" if got is not None else "raised"] += 1
    assert outcomes["read"] >= 30 and outcomes["raised"] >= 30, outcomes


# ---- fixtures ----

def _readings():
    with open(os.path.join(FIXTURES, "sha256.json")) as f:
        return json.load(f)


def _digest(pixels) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(_readings()))
def test_part2_fixtures_give_pils_hash(cxx, name):
    """Every committed file: PIL's reading and the port's have the mode,
    shape, pixel SHA-256 and RGBA SHA-256 in sha256.json (or both raise,
    the port naming the file), which chip_smoke.py holds the port to on
    the card's machine."""
    want = _readings()[name]
    path = os.path.join(FIXTURES, name)
    if want.get("raises"):
        with pytest.raises(Exception):
            np.asarray(Image.open(path))
        with pytest.raises(ValueError, match=name):
            image_io.open_image(path)
        return
    pil = Image.open(path)
    got = image_io.open_image(path)
    for mode, px, rgba in ((pil.mode, np.asarray(pil), np.asarray(pil.convert("RGBA"))),
                           (got.mode, got.pixels, image_io.to_rgba(got))):
        px = px[..., None] if px.ndim == 2 else px
        assert (mode, list(px.shape), _digest(px), _digest(rgba)) == (want["mode"], want["shape"], want["sha256"],
                                                                       want["rgba_sha256"])


def test_part2_fixtures_are_small():
    """The committed files stay under 600 kB together; the 1920x1080 one
    (chip_smoke.py's timed decode and COLMAP view) under 500 kB."""
    names = _readings()
    assert len(names) >= 20
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in names) < 600_000
    assert os.path.getsize(os.path.join(FIXTURES, "ortho_part2_1920x1080.j2k")) < 500_000


# ---- both dataset paths against the JAX package ----

def colmap_views(w, h):
    """Part 2 high-precision views: 20-bit RGB with MCO offsets and a CBD,
    24-bit RGB 9/7 as a JP2, 31-bit signed RGB, a Part 1 8-bit file with an
    MCO of no stage."""
    a = smooth(h, w, 3, 50)
    return {"v_20.j2k": edited(encode(deep_samples(a, 20), precision=20, mct=True), [
                cbd([19] * 3), mct(1, 1, [(1 << 19) + 999, 1 << 19, (1 << 19) - 4321]), mcc(1, 3, offset=1), mco(1)],
                rsiz=0x8000),
            "v_24_97.jp2": jp2_bytes(encode(deep_samples(a, 24, seed=1), precision=24, irreversible=True, mct=True,
                                            planes=12), bpc=23),
            "v_31.j2k": encode(deep_samples(a, 31, True, 2, headroom=2), precision=31, signed=True, mct=True),
            "v_mco.j2k": edited(encode(a, mct=True), [mco()], rsiz=0x8000)}


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_reads_part2_views_as_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of Part 2 and high-precision views: the Scene's
    cameras equal the JAX package's, images bit for bit."""
    from test_torch_scene import both_scenes

    w, h = 45, 37
    src = str(tmp_path / "part2")
    write_colmap_dataset_of(src, colmap_views(w, h), w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == 4
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


@pytest.mark.parametrize("bits", [17, 24, 31])
def test_colmap_refuses_high_precision_grey(tmp_path, cxx, bits):
    """Grey above 16 bits is PIL's I;16, which the JAX package's COLMAP
    path would train on as 0..65535: the port refuses it through
    load_camera, naming the file and the mode (such files reach only the
    Blender path)."""
    data = encode(deep_samples(smooth(11, 13, 1, 61), bits, headroom=2 if bits == 31 else 0), precision=bits)
    src = str(tmp_path / "data")
    write_colmap_dataset_of(src, {"view.j2k": data}, 13, 11)
    assert Image.open(os.path.join(src, "images", "view.j2k")).mode == "I;16"
    info = dataset_readers.read_colmap_scene(src, None, eval_split=False)
    with pytest.raises(ValueError, match=r"'view\.j2k' in .*images\.bin: .*view\.j2k: .*\(mode I;16\)"):
        dataset_readers.load_camera(info.train_cameras[0], 1)


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_reads_part2_frames_as_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on Part 2 high-precision frames: a 17-bit RGBA
    JP2 with MCO offsets in its tile-part header, a 24-bit signed RGBA
    codestream, 20-bit grey + alpha (HT), 20-bit grey (I;16, which only
    this path reads): PIL's convert("RGBA") composited on the background,
    bit for bit, then load_camera at -r 2."""
    from test_torch_tga import blender_scenes

    w, h = 29, 23
    rgba = smooth(h, w, 4, 64)
    frames = [jp2_bytes(edited(encode(deep_samples(rgba, 17), precision=17, mct=True), (),
                               [mct(1, 1, [1 << 16, (1 << 16) + 700, 1 << 16, (1 << 16) - 300]), mcc(1, 4, offset=1),
                                mco(1)], rsiz=0x8000), bpc=16),
              encode(deep_samples(rgba, 24, True, 1), precision=24, signed=True, mct=True),
              edited(encode(deep_samples(rgba[..., [0, 3]], 20, seed=2), precision=20, style=HT), rsiz=0xC000),
              encode(deep_samples(rgba[..., :1], 20, seed=3), precision=20)]
    blender_scenes(tmp_path, monkeypatch, frames, white_background, jreaders, dataset_readers)
