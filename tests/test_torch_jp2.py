"""JPEG 2000 in the port (`utils/jp2.py` and the compiled
`csrc/jp2_decode.cc`) against PIL, which the JAX package opens its
datasets with (PIL 12 through OpenJPEG 2.5).

Tolerances: every comparison is bit-equal. For each file the port's
`image_io.open_image` must give PIL's mode and `np.asarray(Image.open(f))`
(a channel axis kept) and `to_rgba` PIL's `convert("RGBA")`, or raise a
`ValueError` naming the file where PIL raises; the port refuses no file
PIL reads (Part 2 codestreams, precision above 16 bits and more than 4
components included: `tests/test_torch_jp2_part2.py` holds the port to
PIL on each). Files are PIL's own (every option of its writer), JP2 boxes written around PIL's
codestreams, PIL codestreams whose markers are edited
(`tests/torch_image_writers`), and files of the test-side encoder
`tests/torch_j2k_writer.py` (the Part 1 features PIL's writer never sets;
`tests/test_torch_jp2_part1.py` holds the port to PIL on each, and
`tests/test_torch_htj2k.py` on its HTJ2K files). Pictures are at most 67x45 here, made from
`np.random.default_rng(seed)`; the committed fixtures
(`tests/fixtures/torch_jp2`, 1080p ones included) are held to PIL's
hashes.

The compiled decoder is built here with the host's `c++`; tests that need
it skip, with the reason, only where no C++ compiler exists.
"""

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
from gaussian_splatting_torch.utils import cuda_build, image_io, jp2
from test_torch_image_forms import (  # noqa: F401  (cxx: a fixture)
    assert_follows_pil, cxx, smooth, write_colmap_dataset_of,
)
from test_torch_jpeg import fake_cxx  # noqa: F401  (a fixture)
from test_torch_scene import assert_same_cameras
from torch_image_writers import j2k_join, j2k_markers, j2k_split_parts, jp2_box, jp2_bytes
from torch_j2k_writer import ALL_STYLES, BYPASS, TERMALL, encode

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_jp2")
COD, QCD, COM, TLM, SIZ = 0xFF52, 0xFF5C, 0xFF64, 0xFF55, 0xFF51


def pil_j2k(pixels, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG2000", **options)
    return buf.getvalue()


# ---- PIL's writer, every option ----

# (name, picture (height, width, channels), options); the 9/7 files keep
# every tile and level at least 2 samples wide (OpenJPEG's 9/7 encoder
# asserts otherwise)
WRITER_CASES = [
    ("grey 5/3", (45, 67, 1), {}),
    ("grey 9/7", (45, 67, 1), {"irreversible": True}),
    ("grey 1x1", (1, 1, 1), {"num_resolutions": 1}),
    ("grey 7x5", (5, 7, 1), {"num_resolutions": 3}),
    ("grey + alpha", (45, 67, 2), {}),
    ("RGB 5/3", (45, 67, 3), {}),
    ("RGB RCT", (45, 67, 3), {"mct": 1}),
    ("RGB 9/7", (45, 67, 3), {"irreversible": True}),
    ("RGB ICT", (45, 67, 3), {"irreversible": True, "mct": 1}),
    ("RGBA 5/3", (45, 67, 4), {"mct": 1}),
    ("RGBA ICT", (45, 67, 4), {"irreversible": True, "mct": 1}),
    ("tiles", (45, 67, 3), {"tile_size": (16, 16)}),
    ("tiles and offsets", (45, 67, 3), {"tile_size": (16, 16), "tile_offset": (3, 5), "offset": (3, 5)}),
    ("9/7 tiles and offsets", (45, 67, 3), {"tile_size": (37, 26), "tile_offset": (1, 2), "offset": (4, 3),
                                            "irreversible": True, "mct": 1}),
    ("image offset", (45, 67, 3), {"offset": (7, 2), "tile_size": (128, 128)}),
    ("1 resolution", (45, 67, 3), {"num_resolutions": 1}),
    ("2 resolutions 9/7", (45, 67, 3), {"num_resolutions": 2, "irreversible": True}),
    ("code-blocks 4x64", (45, 67, 3), {"codeblock_size": (4, 64)}),
    ("code-blocks 16x16 9/7", (45, 67, 3), {"codeblock_size": (16, 16), "irreversible": True}),
    ("precincts 32", (45, 67, 3), {"precinct_size": (32, 32)}),
    ("layers 5/3", (45, 67, 3), {"quality_layers": [40, 10, 0]}),
    ("layers 9/7", (45, 67, 3), {"quality_layers": [60, 20, 5], "irreversible": True}),
    ("layers dB", (45, 67, 3), {"quality_mode": "dB", "quality_layers": [25, 35, 45], "irreversible": True}),
    ("signed", (45, 67, 3), {"signed": True}),
    ("signed 9/7 grey", (45, 67, 1), {"signed": True, "irreversible": True}),
    ("plt", (45, 67, 3), {"plt": True}),
    ("comment", (45, 67, 3), {"comment": "captured 2024"}),
] + [(f"{order} precincts layers tiles", (45, 67, 3),
      {"progression": order, "precinct_size": (16, 16), "codeblock_size": (4, 4), "quality_layers": [20, 5, 1],
       "tile_size": (32, 16), "tile_offset": (1, 2), "offset": (3, 3), "num_resolutions": 4})
     for order in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")] + [
    (f"{order} 9/7 precincts", (45, 67, 3), {"progression": order, "precinct_size": (32, 32),
                                             "quality_layers": [20, 5, 1], "irreversible": True, "mct": 1})
    for order in ("RPCL", "PCRL", "CPRL")]


@pytest.mark.parametrize("j2k", [True, False], ids=["j2k", "jp2"])
@pytest.mark.parametrize("case", WRITER_CASES, ids=[c[0] for c in WRITER_CASES])
def test_pil_written_files_give_pils_pixels(tmp_path, cxx, case, j2k):
    """Every option of PIL's JPEG 2000 writer, as a raw codestream and as
    a JP2: PIL's mode, pixels and RGBA."""
    name, (h, w, c), options = case
    a = smooth(h, w, c, len(name))
    got = assert_follows_pil(tmp_path, pil_j2k(a[..., 0] if c == 1 else a, no_jp2=j2k, **options), name,
                             ".j2k" if j2k else ".jp2")
    assert got is not None and got.mode == {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[c]
    lossy = {"irreversible", "signed", "quality_layers", "offset"} & set(options)  # PIL's offset files read shifted
    if not lossy:
        np.testing.assert_array_equal(got.pixels, a)  # lossless: the picture itself


@pytest.mark.parametrize("j2k", [True, False], ids=["j2k", "jp2"])
def test_16_bit_grey(tmp_path, cxx, j2k):
    """A 16-bit grey picture: PIL's "I;16", the 5/3 file the samples
    themselves, the 9/7 one PIL's rounding."""
    a = (np.random.default_rng(3).integers(0, 65536, (21, 34))).astype(np.uint16)
    got = assert_follows_pil(tmp_path, pil_j2k(a, no_jp2=j2k), "16", ".jp2")
    assert got.mode == "I;16" and got.pixels.dtype == np.dtype("<u2")
    np.testing.assert_array_equal(got.pixels[..., 0], a)
    assert_follows_pil(tmp_path, pil_j2k(a, no_jp2=j2k, irreversible=True), "16 9/7", ".jp2")


def test_precision_below_8_and_between_8_and_16(tmp_path, cxx):
    """SIZ precisions PIL does not write (4, 5, 12 bits, signed and not),
    set by editing a PIL codestream's Ssiz: PIL shifts each to 8 bits for
    its modes (or 16 for I;16), through its own rounding and wrap."""
    a = smooth(21, 34, 3, 9)
    for prec, signed in ((5, 0), (4, 1), (12, 0), (12, 1), (10, 0)):
        for grey in (True, False):
            main, parts = j2k_markers(pil_j2k(a[..., 0] if grey else a, no_jp2=True))
            siz = bytearray(main[0][1])
            for k in range(1 if grey else 3):
                siz[36 + 3 * k] = (signed << 7) | (prec - 1)
            main[0] = (SIZ, bytes(siz))
            assert assert_follows_pil(tmp_path, j2k_join(main, parts), f"{prec} {signed}", ".j2k") is not None


# ---- JP2 boxes ----

def box_views():
    """JP2 files PIL's writer does not make: a codestream of 1 to 4
    components under each colr box and each ihdr component count, P / PA
    palettes, channel definitions, resolution boxes, the jpx brand."""
    grey, la, rgb, rgba = (smooth(23, 29, c, 10 + c) for c in (1, 2, 3, 4))
    streams = {1: pil_j2k(grey[..., 0], no_jp2=True), 2: pil_j2k(la, no_jp2=True),
               3: pil_j2k(rgb, no_jp2=True, mct=1), 4: pil_j2k(rgba, no_jp2=True, irreversible=True, mct=1)}
    rng = np.random.default_rng(12)
    palette = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    palette[150:] = palette[:50]  # repeats, which PIL's getcolor drops
    views = {}
    for nc in (1, 2, 3, 4):
        for k, cs in streams.items():
            for colr in ((1, 16), (1, 17), (1, 18), (1, 12), (1, 24), (1, 99), (2, bytes(40)), None):
                views[f"ihdr {nc}, {k} components, colr {colr and colr[:1] + colr[1:][:1]}"] = jp2_bytes(
                    cs, nc, colr=colr if colr is None or colr[0] == 1 else (2, colr[1]))
    views.update({
        "P": jp2_bytes(streams[1], colr=(1, 16), pclr=palette),
        "P, an RGBA palette": jp2_bytes(streams[1], colr=(1, 16), pclr=rng.integers(0, 256, (60, 4))),
        "P, 2 columns": jp2_bytes(streams[1], colr=(1, 16), pclr=rng.integers(0, 256, (30, 2))),
        "P, grey colr": jp2_bytes(streams[1], colr=(1, 17), pclr=palette),
        "PA": jp2_bytes(streams[2], colr=(1, 16), pclr=palette),
        "cdef BGRA": jp2_bytes(streams[4], cdef=[(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 1, 0)]),
        "cdef premultiplied": jp2_bytes(streams[4], cdef=[(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 2, 0)]),
        "cdef RGB reversed": jp2_bytes(streams[3], cdef=[(0, 0, 3), (1, 0, 2), (2, 0, 1)]),
        "res": jp2_bytes(streams[3], res=3780),
        "jpx brand": jp2_bytes(streams[3], brand=b"jpx "),
        "an xml box before the codestream": jp2_bytes(streams[3], after_header=jp2_box(b"xml ", b"<a/>")),
        "a wider ihdr": jp2_bytes(streams[3], size=(30, 23)),
        "two colr boxes": jp2_bytes(streams[4], colr=(1, 16), extra_header=jp2_box(b"colr", b"\x01\0\0\0\0\0\x0c")),
    })
    return views


@pytest.mark.parametrize("view", list(box_views()))
def test_jp2_boxes_follow_pil(tmp_path, cxx, view):
    """PIL's mode from its plugin's box rules, OpenJPEG's colour space from
    the first colr box, PIL's unpacker for the pair (sYCC through PIL's
    YCbCr tables), no palette or channel definition applied to the
    pixels; PIL raises where it finds no unpacker or OpenJPEG a bad box."""
    assert_follows_pil(tmp_path, box_views()[view], view, ".jp2")


def test_palette_modes_as_pil_holds_them(tmp_path, cxx):
    """A pclr box: mode P (PA with alpha) whose pixels are the
    codestream's values and whose palette is each colour once, in the
    order of its first entry; to_rgba takes the palette's colours (black
    past its end), and PA its own alpha."""
    a = (np.arange(23 * 29).reshape(23, 29) % 256).astype(np.uint8)
    palette = np.array([(i, 255 - i, 7) for i in range(40)] * 2, np.uint8)
    got = assert_follows_pil(tmp_path, jp2_bytes(pil_j2k(a, no_jp2=True), pclr=palette), "P", ".jp2")
    assert got.mode == "P" and got.palette.shape == (40, 3)
    np.testing.assert_array_equal(got.pixels[..., 0], a)
    np.testing.assert_array_equal(image_io.to_rgba(got)[a >= 40][:, :3], 0)


# ---- the codestream's structure ----

def structure_views():
    a = smooth(45, 67, 3, 20)
    tiled = pil_j2k(a, no_jp2=True, tile_size=(16, 16), tile_offset=(3, 5), offset=(3, 5))
    layered = pil_j2k(a, no_jp2=True, irreversible=True, quality_layers=[30, 10, 2], progression="CPRL",
                      precinct_size=(32, 32))
    main, parts = j2k_markers(tiled)
    cod, qcd = [b for m, b in main if m == COD][0], [b for m, b in main if m == QCD][0]
    in_tiles = [(i, tp, tn, [(COD, cod), (QCD, qcd), (COM, b"\x00\x01tile")] + s, d) for i, tp, tn, s, d in parts]
    reordered = sorted(parts, key=lambda p: -p[0])
    tlm = struct.pack(">BB", 0, 0x60) + b"".join(struct.pack(">HI", p[0], 14 + len(p[4])) for p in parts)
    return {
        "two tile-parts a tile": j2k_split_parts(tiled, 2),
        "three tile-parts, layers": j2k_split_parts(layered, 3),
        "COD, QCD and COM in every tile-part header": j2k_join(main, in_tiles),
        "tiles in reverse order": j2k_join(main, reordered),
        "TLM and COM in the main header": j2k_join(main + [(TLM, tlm), (COM, b"\x00\x01made here")], parts),
        "a tile missing": j2k_join(main, parts[1:]),
        "no EOC, Psot 0": j2k_join(main, parts[:-1]) [:-2] + _psot_zero(parts[-1]),
        "no EOC": j2k_join(main, parts)[:-2],
        "bytes after EOC": j2k_join(main, parts) + b"\x00\x01\x02",
        "tile-part index skipped": j2k_join(main, [parts[0][:1] + (1,) + parts[0][2:]] + parts[1:]),
        "Psot past the end": j2k_join(main, parts)[:-40],
    }


def _psot_zero(part) -> bytes:
    isot, tpsot, tnsot, _, data = part
    return struct.pack(">HHHIBB", 0xFF90, 10, isot, 0, tpsot, tnsot) + b"\xff\x93" + data + b"\xff\xd9"


@pytest.mark.parametrize("view", list(structure_views()))
def test_codestream_structure_follows_pil(tmp_path, cxx, view):
    """Tile-parts, coding parameters in tile-part headers, tiles out of
    order, TLM / COM, a missing tile (left black), a stream ending without
    EOC, a bad tile-part index, a tile-part running past the file: PIL's
    pixels, or a raise where PIL raises (OpenJPEG's strict mode)."""
    got = assert_follows_pil(tmp_path, structure_views()[view], view, ".j2k")
    assert (got is None) == (view in ("no EOC", "tile-part index skipped", "Psot past the end"))


# ---- the views once refused ----

def _edit_cod(cs, offset, value, mask=None):
    main, parts = j2k_markers(cs)
    i = [k for k, (m, _) in enumerate(main) if m == COD][0]
    body = bytearray(main[i][1])
    body[offset] = value if mask is None else body[offset] | mask
    main[i] = (COD, bytes(body))
    return j2k_join(main, parts)


def refused_views():
    a = smooth(23, 29, 3, 30)
    cs = pil_j2k(a, no_jp2=True)
    main, parts = j2k_markers(cs)
    siz = main[0][1]

    def with_siz(edit):
        body = bytearray(siz)
        edit(body)
        return j2k_join([(SIZ, bytes(body))] + main[1:], parts)

    extra = bytearray(siz[:34]) + struct.pack(">H", 5) + siz[36:] + siz[36:39] * 2
    views = {
        "HTJ2K": with_siz(lambda b: b.__setitem__(0, 0x40)),
        "Part 2": with_siz(lambda b: b.__setitem__(0, 0x80)),
        "subsampling": with_siz(lambda b: b.__setitem__(36 + 3 + 1, 2)),
        "precision 17": with_siz(lambda b: b.__setitem__(36, 16)),
        "five components": j2k_join([(SIZ, bytes(extra))] + main[1:], parts),
        "five components, JP2": jp2_bytes(j2k_join([(SIZ, bytes(extra))] + main[1:], parts), 5),
        "SOP": _edit_cod(cs, 0, 0, mask=2),
        "EPH": _edit_cod(cs, 0, 0, mask=4),
        "RGN": j2k_join(main + [(0xFF5E, b"\x00\x00\x02")], parts),
        "POC": j2k_join(main + [(0xFF5F, b"\x00\x00\x00\x01\x02\x01\x00")], parts),
        "PPM": j2k_join(main + [(0xFF60, b"\x00\x00\x00\x00\x00")], parts),
        "PPT": j2k_join(main, [p[:3] + ([(0xFF61, b"\x00")] + p[3], p[4]) for p in parts]),
        "CAP": j2k_join(main + [(0xFF50, b"\x00\x02\x00\x00\x00\x00")], parts),
        "a Part 2 marker": j2k_join(main + [(0xFF74, b"\x00\x00")], parts),
        "an unknown marker": j2k_join(main + [(0xFF6A, b"\x00\x00")], parts),
        "JPX with two codestreams": jp2_bytes(cs, 3, brand=b"jpx ") + jp2_box(b"jp2c", cs),
    }
    for bit, style in enumerate(("BYPASS", "RESET", "TERMALL", "VSC", "PTERM", "SEGSYM", "HT")):
        views[f"code-block style {style}"] = _edit_cod(cs, 8, 1 << bit)
    return views


@pytest.mark.parametrize("view", list(refused_views()))
def test_refused_features_are_named(tmp_path, cxx, view):
    """Every view the port once refused by name (a style bit, HT's Rsiz
    bit, CAP marker and code-block style, SOP / EPH, RGN, POC, PPM / PPT,
    an unknown marker, subsampling, a second codestream, Part 2's Rsiz bit
    15 and an MCT marker, a SIZ precision of 17 bits, five components in
    a codestream and in a JP2: edits of a PIL file that its data does not
    follow) gives PIL's pixels, or raises where PIL raises."""
    data = refused_views()[view]
    suffix = ".jp2" if data.startswith(jp2.JP2_SIGNATURE) else ".j2k"
    assert_follows_pil(tmp_path, data, view, suffix)


# ---- damaged files ----

# (writer, options): PIL's writer, or the test-side encoder's Part 1 forms
DAMAGED = {
    "5/3 RGB": (pil_j2k, dict(mct=1, no_jp2=True)),
    "9/7 tiles layers": (pil_j2k, dict(irreversible=True, quality_layers=[30, 10, 3], tile_size=(32, 32),
                                       no_jp2=True)),
    "9/7 RPCL precincts": (pil_j2k, dict(progression="RPCL", precinct_size=(32, 32), codeblock_size=(8, 8),
                                         irreversible=True, quality_layers=[20, 5], mct=1, no_jp2=True)),
    "SOP EPH": (encode, dict(sop=True, eph=True, layers=[4, None], mct=True)),
    "BYPASS TERMALL": (encode, dict(style=BYPASS | TERMALL, cblk=(4, 4), layers=[6, None])),
    "PPT": (encode, dict(headers="ppt", tile=(32, 32), tile_parts=2, layers=[3, None])),
    "POC": (encode, dict(poc=[(0, 0, 1, 6, 3, "RLCP"), (0, 0, 3, 6, 3, "CPRL")], layers=[3, 8, None],
                         style=ALL_STYLES)),
}


@pytest.mark.parametrize("form", list(DAMAGED))
def test_damaged_files_follow_pil(tmp_path, cxx, form):
    """Seeded damage to a PIL file: one flipped byte in a code-block's
    coded data (every one PIL and the port read, to the same pixels: the
    MQ decoder's 0xFF rules and end-of-segment sentinel), one anywhere in
    the codestream (headers, packet headers, bodies; half of them in its
    first 200 bytes), and seeded
    truncations (which PIL's strict reader refuses). Each outcome is
    counted; the port refuses no file PIL reads. The forms are PIL's, and the test-side encoder's with
    SOP and EPH, BYPASS and TERMALL, PPT headers, and a POC."""
    writer, options = DAMAGED[form]
    data = writer(smooth(40, 50, 3, 40), **options)
    bodies = jp2.segments(data)
    assert sum(n for _, n in bodies) > 0.4 * len(data)
    outcomes = {"body read": 0, "read": 0, "raised": 0, "truncated": 0}
    for seed in range(160):
        rng = np.random.default_rng(seed)
        bad = bytearray(data)
        if seed < 60:
            at, n = bodies[int(rng.integers(len(bodies)))]
            bad[at + int(rng.integers(n))] ^= int(rng.integers(1, 256))
        elif seed < 130:  # half of them in the first 200 bytes: the headers and the first packets
            bad[int(rng.integers(2, len(bad) if seed % 2 else 200))] ^= int(rng.integers(1, 256))
        else:
            bad = bad[:int(rng.integers(1, len(bad)))]
        label = f"{form} seed {seed}"
        got = assert_follows_pil(tmp_path, bytes(bad), label, ".j2k")  # raises where the port refuses a file PIL reads
        if seed < 60:
            assert got is not None, label
            outcomes["body read"] += 1
        elif seed < 130:
            outcomes["read" if got is not None else "raised"] += 1
        else:
            assert got is None, label
            outcomes["truncated"] += 1
    assert outcomes["body read"] == 60 and outcomes["truncated"] == 30, outcomes
    assert outcomes["read"] >= 20 and outcomes["raised"] >= 3, outcomes


# ---- the compiled decoder, fixtures ----

def test_failed_jp2_build_raises_naming_the_file(tmp_path, fake_cxx):
    """No fallback: a JPEG 2000 file cannot be read without the compiled
    decoder, and the error names the file."""
    path = tmp_path / "a.jp2"
    path.write_bytes(pil_j2k(smooth(9, 11, 3, 70)))
    fake_cxx(fail=True)
    with pytest.raises(RuntimeError, match=r"(?s)a\.jp2: .*JPEG 2000 decoder .*jp2_decode\.cc.* could not be built"):
        image_io.open_image(path)
    assert not cuda_build.host_library_path("jp2_decode").exists()


def _readings():
    with open(os.path.join(FIXTURES, "sha256.json")) as f:
        return json.load(f)


def _digest(pixels) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(_readings()))
def test_fixtures_give_pils_hash(cxx, name):
    """Every committed file: PIL's reading and the port's have the mode,
    shape, pixel SHA-256 and RGBA SHA-256 in sha256.json, which
    chip_smoke.py holds the port to on the card's machine."""
    want = _readings()[name]
    path = os.path.join(FIXTURES, name)
    pil = Image.open(path)
    got = image_io.open_image(path)
    for mode, px, rgba in ((pil.mode, np.asarray(pil), np.asarray(pil.convert("RGBA"))),
                           (got.mode, got.pixels, image_io.to_rgba(got))):
        px = px[..., None] if px.ndim == 2 else px
        assert (mode, list(px.shape), _digest(px), _digest(rgba)) == (want["mode"], want["shape"], want["sha256"],
                                                                       want["rgba_sha256"])


def test_fixtures_are_small():
    """The committed JPEG 2000 files stay under 1.5 MB together."""
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in _readings()) < 1_500_000


# ---- both dataset paths against the JAX package ----

def colmap_views(w, h):
    """JP2 and J2K views whose pixels are the picture (RGB and L, 5/3),
    a lossy 9/7 one, a 4:2:0 sYCC JP2 and a codestream with all six
    code-block styles, SOP, EPH and a POC (the test-side encoder)."""
    a = smooth(h, w, 3, 50)
    return {"v_rgb.jp2": pil_j2k(a, mct=1), "v_grey.j2k": pil_j2k(a[..., 1], no_jp2=True),
            "v_tiles.jp2": pil_j2k(a, tile_size=(16, 16), tile_offset=(2, 1), offset=(2, 1)),
            "v_97.jp2": pil_j2k(a, irreversible=True, mct=1, quality_layers=[20, 5]),
            "v_420.jp2": jp2_bytes(encode(a, subsampling=[(1, 1), (2, 2), (2, 2)]), colr=(1, 18)),
            "v_styles.j2k": encode(a, style=ALL_STYLES, sop=True, eph=True, mct=True, layers=[4, None],
                                   poc=[(0, 0, 1, 6, 3, "RLCP"), (0, 0, 2, 6, 3, "CPRL")])}


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_reads_jp2_views_as_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of JPEG 2000 views: the Scene's cameras equal the
    JAX package's, images bit for bit."""
    from test_torch_scene import both_scenes

    w, h = 45, 37
    src = str(tmp_path / "jp2")
    write_colmap_dataset_of(src, colmap_views(w, h), w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == 6
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


def refused_colmap_views():
    grey, la, rgba = smooth(11, 13, 1, 60)[..., 0], smooth(11, 13, 2, 61), smooth(11, 13, 4, 62)
    palette = np.random.default_rng(63).integers(0, 256, (64, 3), dtype=np.uint8)
    return {
        "P": jp2_bytes(pil_j2k(grey, no_jp2=True), pclr=palette),
        "PA": jp2_bytes(pil_j2k(la, no_jp2=True), pclr=palette),
        "LA": pil_j2k(la),
        "CMYK": jp2_bytes(pil_j2k(rgba, no_jp2=True), colr=(1, 12)),
        "I;16": pil_j2k((grey.astype(np.uint16) * 257)),
    }


@pytest.mark.parametrize("mode", list(refused_colmap_views()))
def test_colmap_refuses_jp2_modes_that_are_not_the_picture(tmp_path, cxx, mode):
    """The JAX package's COLMAP path would train on np.asarray of these
    (indices, index and alpha, grey and alpha, C M Y K, 16-bit values):
    the port refuses each through load_camera, naming the file as
    images.bin lists it and the mode."""
    src = str(tmp_path / "data")
    write_colmap_dataset_of(src, {"view.jp2": refused_colmap_views()[mode]}, 13, 11)
    assert Image.open(os.path.join(src, "images", "view.jp2")).mode == mode
    info = dataset_readers.read_colmap_scene(src, None, eval_split=False)
    with pytest.raises(ValueError, match=rf"'view\.jp2' in .*images\.bin: .*view\.jp2: .*\(mode {mode}\)"):
        dataset_readers.load_camera(info.train_cameras[0], 1)


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_reads_jp2_frames_as_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on JPEG 2000 frames: RGBA 9/7 and 5/3, grey +
    alpha, P and PA with palettes, CMYK, an RGB raw codestream, an RGBA
    JP2 whose alpha is subsampled 2x2 (the test-side encoder): PIL's
    convert("RGBA") composited on the background, bit for bit, then
    load_camera at -r 2."""
    from test_torch_tga import blender_scenes

    w, h = 29, 23
    rgba = smooth(h, w, 4, 64)
    frames = [pil_j2k(rgba, irreversible=True, mct=1), pil_j2k(rgba, mct=1), pil_j2k(rgba[..., :2]),
              pil_j2k(rgba[..., :3], no_jp2=True)]
    frames += [jp2_bytes(pil_j2k(rgba[..., k], no_jp2=True) if mode == "P" else pil_j2k(rgba[..., [k, 3]],
                                                                                         no_jp2=True),
                         pclr=np.random.default_rng(65).integers(0, 256, (200, 3), dtype=np.uint8))
               for k, mode in enumerate(("P", "PA"))]
    frames.append(jp2_bytes(pil_j2k(rgba, no_jp2=True), colr=(1, 12)))
    frames.append(jp2_bytes(encode(rgba, subsampling=[(1, 1)] * 3 + [(2, 2)], mct=True)))
    blender_scenes(tmp_path, monkeypatch, frames, white_background, jreaders, dataset_readers)
