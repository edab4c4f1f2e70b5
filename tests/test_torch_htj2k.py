"""HTJ2K (JPEG 2000 Part 15, ITU-T T.814) in the port (`utils/jp2.py` and
the compiled `csrc/jp2_decode.cc`) against PIL 12 (OpenJPEG 2.5), on files
of the test-side encoder `tests/torch_j2k_writer.py`: HT code-blocks (the
cleanup pass's MEL, CxtVLC, UVLC and MagSgn streams, the SigProp and
MagRef passes), their packet-header signalling, CAP and CPF, with every
Part 1 feature beside them (tiles, precincts, progression orders, POC,
PPM / PPT, SOP / EPH, layers, subsampling, 5/3 and 9/7).

The writer is checked first: PIL decodes each reversible write to the
picture itself. Then the port is held to PIL's reading of the same bytes,
on the writer's files, on marker edits, on seeded damage to the HT bodies
and on the committed fixtures (`tests/fixtures/torch_htj2k`), and both
dataset paths to the JAX package, which opens its images with PIL.

Tolerances: every comparison is bit-equal. For each file the port's
`image_io.open_image` must give PIL's mode and `np.asarray(Image.open(f))`
(a channel axis kept) and `to_rgba` PIL's `convert("RGBA")`, or raise a
`ValueError` naming the file where PIL raises. Pictures are at most 67x45,
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
from torch_image_writers import j2k_join, j2k_markers, jp2_bytes
from torch_j2k_writer import (
    BYPASS, HT, HT_MIXED, PTERM, RESET, SEGSYM, TERMALL, VSC, encode, ht_vlc_decoding_tables, ht_vlc_encoding_tables,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_htj2k")
SIZ, CAP, COD, COC, CPF, RGN = 0xFF51, 0xFF50, 0xFF52, 0xFF53, 0xFF59, 0xFF5E
PRECINCTS = [(4, 4), (4, 4), (4, 4), (5, 5), (5, 5), (5, 5)]


def picture(c=3, seed=1, h=45, w=67):
    return smooth(h, w, c, seed)


def refinable(c=3, seed=1, h=45, w=67):
    """A picture whose samples less 128 are 0, at least 2 in magnitude, or
    +-1 beside a sample of at least 2 in its row: with no decomposition and
    the cleanup pass at bit-plane 1, SigProp and MagRef code it whole (a
    lone 1 has no significant neighbour to be found by)."""
    q = picture(c, seed, h, w).astype(np.int64) - 128
    big = np.abs(q) >= 2
    near = np.zeros_like(big)
    near[:, 1:] |= big[:, :-1]
    near[:, :-1] |= big[:, 1:]
    return (np.where((np.abs(q) == 1) & ~near, 0, q) + 128).astype(np.uint8)


def grey16(seed=3, h=45, w=67):
    rng = np.random.default_rng(seed)
    return (picture(1, seed, h, w).astype(np.uint16) * 257 + rng.integers(0, 256, (h, w, 1))).astype(np.uint16)


# ---- the writer ----

def test_vlc_tables_invert():
    """The encoder's CxtVLC codewords are the decoding tables' inverse by
    enumeration (each decodes to its own context, rho and EMB bits), one
    for every quad a context can hold."""
    tables = ht_vlc_decoding_tables()
    assert [len(t) for t in tables] == [1024, 1024]
    for enc in ht_vlc_encoding_tables():
        assert len(enc) == sum(1 << bin(rho).count("1") for rho in range(16)) * 8 - 1


# (name, picture, options): reversible writes (cleanup passes at bit-plane 0,
# or with SigProp and MagRef over a `refinable` picture at bit-plane 1)
REVERSIBLE = [
    ("RGB", lambda: picture(), {}),
    ("RCT", lambda: picture(), {"mct": True}),
    ("grey", lambda: picture(1), {}),
    ("grey + alpha", lambda: picture(2), {}),
    ("RGBA", lambda: picture(4), {"mct": True}),
    ("16-bit grey", lambda: grey16(), {"precision": 16}),
    ("no decomposition", lambda: picture(), {"levels": 0}),
    ("code-blocks 4x4", lambda: picture(), {"cblk": (2, 2), "levels": 3}),
    ("code-blocks 1024x4", lambda: picture(1, 5, 9, 67), {"cblk": (10, 2), "levels": 2}),
    ("code-blocks 8x16, 2 levels", lambda: picture(), {"cblk": (3, 4), "levels": 2}),
    ("precincts", lambda: picture(), {"precincts": PRECINCTS, "cblk": (3, 3)}),
    ("tiles and offsets", lambda: picture(), {"tile": (32, 16), "tile_offset": (1, 2), "offset": (3, 3)}),
    ("tile-parts", lambda: picture(), {"tile": (32, 32), "tile_parts": 3}),
    ("SOP and EPH", lambda: picture(), {"sop": True, "eph": True, "tile": (32, 32)}),
    ("PPM", lambda: picture(), {"headers": "ppm", "split": 23, "tile": (32, 32), "tile_parts": 2}),
    ("PPT", lambda: picture(), {"headers": "ppt", "split": 11, "tile": (32, 32), "tile_parts": 2}),
    ("RPCL, precincts, a POC", lambda: picture(), {"progression_order": "RPCL", "precincts": PRECINCTS,
                                                   "cblk": (3, 3),
                                                   "poc": [(0, 0, 1, 3, 2, "PCRL"), (0, 0, 1, 6, 3, "RPCL")]}),
    ("CPRL, tiles", lambda: picture(), {"progression_order": "CPRL", "tile": (24, 24)}),
    ("1x1", lambda: picture(3, 7, 1, 1), {"levels": 0}),
    ("7x1 and 1 level", lambda: picture(3, 8, 1, 7), {"levels": 1}),
    ("1x7", lambda: picture(3, 9, 7, 1), {"levels": 1}),
    ("SigProp and MagRef", lambda: refinable(), {"levels": 0, "planes": 1, "ht_passes": 3}),
    ("SigProp and MagRef, VSC", lambda: refinable(3, 2), {"levels": 0, "planes": 1, "ht_passes": 3,
                                                         "style": HT | VSC}),
    ("SigProp and MagRef, code-blocks 16x4 and odd sizes", lambda: refinable(3, 4, 37, 43),
     {"levels": 0, "planes": 1, "ht_passes": 3, "cblk": (4, 2)}),
    ("two layers (TERMALL)", lambda: refinable(3, 5), {"levels": 0, "planes": 1, "ht_passes": 3,
                                                      "style": HT | TERMALL, "layers": [1, 3]}),
] + [(f"HT with {name}", lambda: picture(), {"style": HT | bit, "mct": True})
     for name, bit in (("BYPASS", BYPASS), ("RESET", RESET), ("PTERM", PTERM), ("SEGSYM", SEGSYM))]


@pytest.mark.parametrize("j2k", [True, False], ids=["j2k", "jp2"])
@pytest.mark.parametrize("case", REVERSIBLE, ids=[c[0] for c in REVERSIBLE])
def test_writer_decodes_in_pil_to_the_picture(case, j2k):
    """Every reversible HT write decodes in PIL to the picture."""
    name, make, options = case
    a = make()
    a = a[..., None] if a.ndim == 2 else a
    data = encode(a, **{"style": HT, **options})
    bpc = 15 if a.dtype == np.uint16 else 7
    data = data if j2k else jp2_bytes(data, bpc=bpc, colr=(1, 17 if a.shape[2] <= 2 else 16))
    got = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(got.reshape(a.shape), a, err_msg=name)


# ---- the port against PIL ----

@functools.cache
def writer_views():
    """The writer's reversible files, and lossy ones (bit-planes left
    out below the cleanup pass, SigProp alone, 9/7, 16 bits), the 4:2:0 and
    RGBA forms, and what OpenJPEG refuses: passes split over layers without
    TERMALL, placeholder passes, MIXED code-blocks, ROI on HT blocks."""
    views = {name: encode(make(), **{"style": HT, **options}) for name, make, options in REVERSIBLE}
    a = picture()
    views.update({
        "bit-planes from 2": encode(a, style=HT, planes=2, mct=True),
        "bit-planes from 2, SigProp": encode(a, style=HT, planes=2, ht_passes=2),
        "bit-planes from 3, SigProp and MagRef": encode(a, style=HT, planes=3, ht_passes=3, mct=True),
        "bit-planes from 1, SigProp and MagRef, VSC, tiles": encode(a, style=HT | VSC, planes=1, ht_passes=3,
                                                                   tile=(24, 40), cblk=(3, 2), levels=2),
        "9/7": encode(a, style=HT, irreversible=True),
        "9/7 ICT": encode(a, style=HT, irreversible=True, mct=True),
        "9/7 ICT, SigProp and MagRef, RPCL precincts": encode(
            a, style=HT, irreversible=True, mct=True, planes=2, ht_passes=3, progression_order="RPCL",
            precincts=PRECINCTS, cblk=(3, 3)),
        "9/7 grey, tiles": encode(a[..., :1], style=HT, irreversible=True, tile=(21, 17), offset=(2, 1)),
        "16-bit grey, bit-planes from 5, SigProp and MagRef": encode(grey16(), style=HT, precision=16, planes=5,
                                                                     ht_passes=3),
        "4:2:0": encode(a, style=HT, subsampling=[(1, 1), (2, 2), (2, 2)]),
        "4:2:0, tiles not multiples of 2": encode(a, style=HT, subsampling=[(1, 1), (2, 2), (2, 2)],
                                                  tile=(15, 13), tile_offset=(1, 2), offset=(3, 5)),
        "RGBA, alpha subsampled": encode(picture(4, 6), style=HT, subsampling=[(1, 1)] * 3 + [(2, 2)]),
        "no CAP or CPF": encode(a, style=HT, cap=False),
        "passes split over layers (no TERMALL)": encode(a, style=HT, planes=2, ht_passes=3, layers=[1, 3]),
        "passes split over layers (BYPASS)": encode(a, style=HT | BYPASS, planes=2, ht_passes=3, layers=[1, 3]),
        "three layers, TERMALL": encode(a, style=HT | TERMALL, planes=2, ht_passes=3, layers=[1, 1, 3]),
        "placeholder passes": encode(a, style=HT, placeholders=1),
        "placeholder passes, SigProp and MagRef": encode(a, style=HT, placeholders=1, planes=2, ht_passes=3),
        "MIXED": encode(a, style=HT | HT_MIXED),
        "RGN on HT code-blocks": encode(a, style=HT, roi={1: 4}, guard=6),
    })
    return views


WRITER_VIEWS = sorted(writer_views())


@pytest.mark.parametrize("j2k", [True, False], ids=["j2k", "jp2"])
@pytest.mark.parametrize("view", WRITER_VIEWS)
def test_port_follows_pil_on_the_writers_files(tmp_path, cxx, view, j2k):
    """Each HT form, reversible and lossy, and each form OpenJPEG refuses,
    as a raw codestream and as a JP2: PIL's mode, pixels and RGBA, or a
    raise where PIL raises."""
    cs = writer_views()[view]
    nc, ssiz = struct.unpack_from(">HB", cs, 40)
    colr = 17 if nc <= 2 else 18 if "4:2:0" in view else 16
    data = cs if j2k else jp2_bytes(cs, bpc=ssiz & 0x7F, colr=(1, colr))
    got = assert_follows_pil(tmp_path, data, view, ".j2k" if j2k else ".jp2")
    refused = ("split over layers", "placeholder", "MIXED", "RGN")
    assert (got is None) == any(word in view for word in refused), view


def _edit(cs, main_edit=None, part_edit=None):
    main, parts = j2k_markers(cs)
    main = main_edit(main) if main_edit else main
    parts = [part_edit(p) for p in parts] if part_edit else parts
    return j2k_join(main, parts)


def _with_style(main, value, marker=COD):
    return [(m, b[:8] + bytes([value]) + b[9:] if m == marker else b) for m, b in main]


@functools.cache
def edited_views():
    """Marker edits of an HT file: CAP and CPF of other content, sizes and
    places, Rsiz and the code-block style, a COC making one component HT
    or not, the style in a tile-part header."""
    a = picture(3, 11, 30, 37)
    cs = encode(a, style=HT, mct=True, tile=(20, 30), planes=1, ht_passes=3)
    part1 = encode(a, mct=True, tile=(20, 30))
    cap = [b for m, b in j2k_markers(cs)[0] if m == CAP][0]

    def coc(c, style):  # a COC of component c: COD's SPcod with another style
        spcod = [b for m, b in j2k_markers(cs)[0] if m == COD][0][5:]
        return (COC, bytes([c, 0]) + spcod[:3] + bytes([style]) + spcod[4:])

    return {
        "CAP of other content": _edit(cs, lambda m: [(k, b"\x00\x02\x40\x00\xa5\x5a" if k == CAP else b)
                                                     for k, b in m]),
        "CAP of Pcap alone": _edit(cs, lambda m: [(k, cap[:4] if k == CAP else b) for k, b in m]),
        "CAP with no body": _edit(cs, lambda m: [(k, b"" if k == CAP else b) for k, b in m]),
        "CAP twice": _edit(cs, lambda m: m[:2] + [(CAP, cap)] + m[2:]),
        "CAP after COD and QCD": _edit(cs, lambda m: [x for x in m if x[0] != CAP] + [(CAP, cap)]),
        "CPF with no body": _edit(cs, lambda m: [(k, b"" if k == CPF else b) for k, b in m]),
        "CPF of other content": _edit(cs, lambda m: [(k, b"\x12\x34\x56" if k == CPF else b) for k, b in m]),
        "no CPF": _edit(cs, lambda m: [x for x in m if x[0] != CPF]),
        "CAP in a tile-part header": _edit(cs, part_edit=lambda p: p[:3] + ([(CAP, cap)] + p[3], p[4])),
        "CPF in a tile-part header": _edit(cs, part_edit=lambda p: p[:3] + ([(CPF, b"\x00\x00")] + p[3], p[4])),
        "Rsiz bit 14 cleared": _edit(cs, lambda m: [(k, b"\x00\x00" + b[2:] if k == SIZ else b) for k, b in m]),
        "HT style cleared (read as Part 1)": _edit(cs, lambda m: _with_style(m, 0)),
        "HT style with VSC": _edit(cs, lambda m: _with_style(m, HT | VSC)),
        "HT style with TERMALL": _edit(cs, lambda m: _with_style(m, HT | TERMALL)),
        "HT style with MIXED": _edit(cs, lambda m: _with_style(m, HT | HT_MIXED)),
        "a COC making component 1 Part 1": _edit(cs, lambda m: m + [coc(1, 0)]),
        "a Part 1 file with a COC making component 2 HT": _edit(part1, lambda m: m + [coc(2, HT)]),
        "HT style in tile-part CODs of a Part 1 file": _edit(
            part1, part_edit=lambda p: p[:3] + ([x for x in j2k_markers(cs)[0] if x[0] == COD] + p[3], p[4])),
        "RGN of 0 on HT code-blocks": _edit(cs, lambda m: m + [(RGN, b"\x00\x00\x00")]),
    }


EDITED_VIEWS = sorted(edited_views())


@pytest.mark.parametrize("view", EDITED_VIEWS)
def test_port_follows_pil_on_marker_edits(tmp_path, cxx, view):
    """CAP and CPF are read and ignored in the main header (of any content
    and size) and refused in a tile-part header, as OpenJPEG does; HT is
    decided by the code-block style alone (not Rsiz), per component and per
    tile, so a COC or a tile-part COD naming the other coder reads data it
    does not hold; MIXED fails: PIL's pixels, or a raise where PIL raises."""
    got = assert_follows_pil(tmp_path, edited_views()[view], view, ".j2k")
    reads = ("CAP of", "CAP with", "CAP twice", "CAP after", "CPF of", "CPF with", "no CPF", "Rsiz", "HT style with V",
             "HT style with T", "HT style cleared", "RGN of 0")
    assert (got is not None) == view.startswith(reads), view


# ---- damaged files ----

# (writer options): the HT forms whose code-block bodies are damaged
DAMAGED = {
    "cleanup passes, RCT": dict(style=HT, mct=True),
    "SigProp and MagRef": dict(style=HT, planes=2, ht_passes=3, mct=True),
    "SigProp and MagRef, VSC, code-blocks 8x16": dict(style=HT | VSC, planes=1, ht_passes=3, cblk=(3, 4),
                                                      levels=3),
    "9/7 ICT, tiles, RPCL precincts": dict(style=HT, irreversible=True, mct=True, tile=(16, 16), planes=1,
                                           ht_passes=3, precincts=[(3, 3)] * 6, progression_order="RPCL",
                                           cblk=(3, 3)),
}


def _port_error(path) -> str | None:
    try:
        image_io.open_image(path)
    except ValueError as err:
        return str(err)
    return None


@pytest.mark.parametrize("form", list(DAMAGED))
def test_damaged_files_follow_pil(tmp_path, cxx, form):
    """Seeded damage to an HT file: a flipped byte in a code-block's HT
    segments (60), one of its last 4 bytes (Scup and the VLC stream's
    start, 40), one anywhere in the codestream (30), and cuts (20): PIL's
    pixels, or a raise where PIL raises. A sweep of some 7,000 such files
    (SigProp and MagRef, VSC, 9/7, tiles, TERMALL layers) found no
    difference from OpenJPEG 2.5.4; OpenJPEG's HT decoder fails the file
    where a segment's Scup, VLC codes or exponent bounds are out of range,
    and the flips here reach each of those paths."""
    data = encode(smooth(40, 50, 3, 40), **DAMAGED[form])
    bodies = jp2.segments(data)
    assert sum(n for _, n in bodies) > 0.4 * len(data)
    outcomes, paths = {"read": 0, "raised": 0}, set()
    for seed in range(150):
        rng = np.random.default_rng(seed)
        bad = bytearray(data)
        if seed < 100:
            at, n = bodies[int(rng.integers(len(bodies)))]
            at += int(rng.integers(n)) if seed < 60 else n - 1 - int(rng.integers(min(n, 4)))
            bad[at] ^= int(rng.integers(1, 256))
        elif seed < 130:
            bad[int(rng.integers(2, len(bad)))] ^= int(rng.integers(1, 256))
        else:
            bad = bad[:int(rng.integers(1, len(bad)))]
        got = assert_follows_pil(tmp_path, bytes(bad), f"{form} seed {seed}", ".j2k")
        outcomes["read" if got is not None else "raised"] += 1
        if got is None and seed < 100:
            err = _port_error(tmp_path / "view.j2k")
            paths |= {p for p in ("Scup", "VLC code", "U_q") if p in err}
    assert outcomes["read"] >= 30 and outcomes["raised"] >= 30, outcomes
    assert paths == {"Scup", "VLC code", "U_q"}, paths


def test_mel_stuffing_check_follows_the_address(tmp_path, cxx):
    """OpenJPEG's MEL reader checks for a 0xFF followed by a byte above
    0x8F only in its first 1 to 4 bytes, as many as the segment's address
    modulo 4 leaves: such a pair at each of the first 4 places of each
    code-block's MEL stream fails or reads as in PIL (the port follows
    where OpenJPEG's tile buffer puts the segment)."""
    data = encode(smooth(40, 50, 3, 40), style=HT, mct=True, tile=(24, 24))
    outcomes = {"read": 0, "raised": 0}
    for at, n in jp2.segments(data)[:40]:
        scup = (data[at + n - 1] << 4) + (data[at + n - 2] & 0xF)
        mel = at + n - scup
        for k in range(min(4, scup - 3)):
            bad = bytearray(data)
            bad[mel + k], bad[mel + k + 1] = 0xFF, 0xA0 + k
            got = assert_follows_pil(tmp_path, bytes(bad), f"MEL {at} + {k}", ".j2k")
            outcomes["read" if got is not None else "raised"] += 1
    assert outcomes["read"] >= 10 and outcomes["raised"] >= 20, outcomes


# ---- fixtures ----

def _readings():
    with open(os.path.join(FIXTURES, "sha256.json")) as f:
        return json.load(f)


def _digest(pixels) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(_readings()))
def test_htj2k_fixtures_give_pils_hash(cxx, name):
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


def test_htj2k_fixtures_are_small():
    """The committed HTJ2K files (the 1920x1080 codestream and the 800x800
    frame included) stay under 700 kB together; the 1080p one under 900 kB."""
    names = _readings()
    assert len(names) >= 15
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in names) < 700_000
    assert os.path.getsize(os.path.join(FIXTURES, "ortho_ht_1920x1080.j2k")) < 900_000


# ---- both dataset paths against the JAX package ----

def colmap_views(w, h):
    """HT views: RGB (RCT) and L, cleanup passes; tiled with SigProp and
    MagRef; 9/7 with the ICT as a JP2."""
    a = smooth(h, w, 3, 50)
    return {"v_rgb.j2k": encode(a, style=HT, mct=True),
            "v_grey.j2k": encode(a[..., 1:2], style=HT),
            "v_tiles.j2k": encode(a, style=HT, tile=(16, 16), tile_offset=(2, 1), offset=(2, 1), planes=1,
                                  ht_passes=3),
            "v_97.jp2": jp2_bytes(encode(a, style=HT, irreversible=True, mct=True))}


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_reads_htj2k_views_as_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of HTJ2K views: the Scene's cameras equal the JAX
    package's, images bit for bit."""
    from test_torch_scene import both_scenes

    w, h = 45, 37
    src = str(tmp_path / "ht")
    write_colmap_dataset_of(src, colmap_views(w, h), w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == 4
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


@pytest.mark.parametrize("mode", ["I;16", "LA"])
def test_colmap_refuses_htj2k_modes_that_are_not_the_picture(tmp_path, cxx, mode):
    """The JAX package's COLMAP path would train on np.asarray of a 16-bit
    grey or a grey + alpha HT view: the port refuses each through
    load_camera, naming the file and the mode."""
    data = encode(grey16(4, 11, 13), style=HT, precision=16) if mode == "I;16" else encode(
        smooth(11, 13, 2, 61), style=HT)
    src = str(tmp_path / "data")
    write_colmap_dataset_of(src, {"view.j2k": data}, 13, 11)
    assert Image.open(os.path.join(src, "images", "view.j2k")).mode == mode
    info = dataset_readers.read_colmap_scene(src, None, eval_split=False)
    with pytest.raises(ValueError, match=rf"'view\.j2k' in .*images\.bin: .*view\.j2k: .*\(mode {mode}\)"):
        dataset_readers.load_camera(info.train_cameras[0], 1)


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_reads_htj2k_frames_as_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on HTJ2K frames: an RGBA JP2 (RCT, cleanup
    passes), a lossy RGBA codestream with SigProp and MagRef, grey + alpha,
    an RGBA JP2 whose alpha is subsampled 2x2: PIL's convert("RGBA")
    composited on the background, bit for bit, then load_camera at -r 2."""
    from test_torch_tga import blender_scenes

    w, h = 29, 23
    rgba = smooth(h, w, 4, 64)
    frames = [jp2_bytes(encode(rgba, style=HT, mct=True)),
              encode(rgba, style=HT, mct=True, planes=2, ht_passes=3),
              encode(rgba[..., [0, 3]], style=HT),
              jp2_bytes(encode(rgba, style=HT, subsampling=[(1, 1)] * 3 + [(2, 2)], mct=True))]
    blender_scenes(tmp_path, monkeypatch, frames, white_background, jreaders, dataset_readers)
