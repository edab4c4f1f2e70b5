"""AVIF grid images (libavif's tiled `grid` items and their alpha grids) in the
port's reader (`utils/avif.py`) against PIL 12.1.0 (libavif 1.3.0, dav1d 1.5.1),
and both dataset paths on grid views against the JAX package.

PIL's `save` writes no grid, so the files are written by the libavif PIL
ships, through `torch_image_writers.avif_grid_bytes` (ctypes), or are the
committed fixtures of `tests/fixtures/torch_avif_grid`. PIL's reading of each
file is the rule: `image_io.open_image` gives PIL's mode and pixels bit for
bit. libavif's grid rules are held to PIL on files whose ImageGrid body,
`dimg` list, items and properties are edited (named edits, then seeded random
ones): each reads as PIL reads it, or raises where PIL raises, passed on to
the next reader (`NotThisFormat`) exactly where PIL's plugin raises
SyntaxError. A grid is converted to RGB once, over the assembled planes, as
libavif hands PIL the whole image: the seam test shows that converting cell
by cell would not give PIL's pixels.
"""

import hashlib
import io
import json
import os
import shutil
import struct

import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError, features

import torch_image_writers as writers
from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import avif, image_io
from test_torch_image_forms import cxx, write_colmap_dataset_of  # noqa: F401  (cxx: a fixture)
from test_torch_scene import assert_same_cameras, orbit_frames
from torch_image_writers import heif_file, heif_model, heif_parts

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_avif_grid")
READINGS = json.load(open(os.path.join(FIXTURES, "sha256.json")))
# the live files are written by PIL's own libavif and held to PIL's reading
requires_libavif = pytest.mark.skipif(not features.check("avif") or writers.avif_library() is None,
                                      reason="this PIL has no AVIF support or ships no libavif 1.x")


def sha256_of(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def picture(h, w, seed):
    """A render-like RGB picture with a little noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    a = np.stack([120 + 70 * np.sin(xx / (9 + 3 * c) + yy / (13 + c)) + 30 * ((xx + 2 * yy) / (5 + c) % 2 < 1)
                  for c in range(3)], -1)
    return np.clip(a + rng.normal(0, 4, a.shape), 0, 255).astype(np.uint8)


def alpha_of(h, w, seed):
    yy, xx = np.mgrid[0:h, 0:w]
    a = 255 * np.abs(np.sin(xx / (w / 3 + 1) + yy / (h / 2 + 1) + seed))
    a[: h // 4] = 255
    a[h - h // 4:, : w // 4] = 0
    return a.astype(np.uint8)


def grid_of(h, w, seed, cell=(64, 64), subsampling="4:2:0", full_range=True, alpha=False, **kw) -> bytes:
    planes = writers.yuv_planes(picture(h, w, seed), subsampling, full_range)
    return writers.avif_grid_bytes(planes, cell, subsampling, full_range,
                                   alpha=alpha_of(h, w, seed) if alpha else None, **kw)


def pil_reading(data: bytes):
    """(mode, pixels) as PIL reads the bytes, else the exception PIL raised."""
    try:
        im = Image.open(io.BytesIO(data))
        return im.mode, np.asarray(im)
    except Exception as err:  # noqa: BLE001  (SyntaxError passed on, RuntimeError, OSError: each a refusal)
        return err


def assert_as_pil(tmp_path, data: bytes, label=""):
    """The bytes read as PIL reads them; or PIL raises and so does the
    port: `NotThisFormat` where PIL's plugin passed the file on (PIL then
    finds no reader), another ValueError otherwise, and `open_image` a
    ValueError naming the file. Returns PIL's reading or its exception."""
    want = pil_reading(data)
    path = tmp_path / "grid.avif"
    path.write_bytes(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError) as err:
            avif.decode_avif(data, str(path))
        passed_on = isinstance(want, UnidentifiedImageError)
        assert isinstance(err.value, image_io.NotThisFormat) == passed_on, (label, repr(want), repr(err.value))
        with pytest.raises(ValueError) as err:
            image_io.open_image(path)
        assert str(path) in str(err.value), label
        return want
    got = image_io.open_image(path)
    assert got.mode == want[0], (label, got.mode, want[0])
    assert got.pixels.shape == want[1].shape, (label, got.pixels.shape, want[1].shape)
    np.testing.assert_array_equal(got.pixels, want[1], err_msg=label)
    return want


# ---- the committed fixtures ----

@pytest.mark.parametrize("name", sorted(READINGS["files"]))
def test_committed_grid_fixture_reads_as_pil_and_the_json_say(tmp_path, cxx, name):
    """Each fixture (the 1080p grid and the gain-map file included) is the
    file whose PIL reading sha256.json holds, PIL reads it so (where it has
    AVIF), and the port reads it so."""
    want = READINGS["files"][name]
    data = fixture(name)
    assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    if features.check("avif"):
        im = Image.open(io.BytesIO(data))
        px = np.asarray(im)
        assert (im.mode, list(px.shape), sha256_of(px)) == (want["mode"], want["shape"], want["sha256"])
    got = image_io.open_image(os.path.join(FIXTURES, name))
    assert (got.mode, list(got.pixels.shape), sha256_of(got.pixels)) == (want["mode"], want["shape"], want["sha256"])


def test_fixtures_are_grids_of_their_layouts():
    """The fixtures are what their names say: a grid primary item of the
    layout and output size, cells of one size, an alpha grid beside the
    RGBA ones; the gain-map file's primary item is its `av01` base."""
    layouts = {"2x2": (2, 2), "3x1": (1, 3), "1x3": (3, 1), "crop_170x100": (2, 3), "seams_3x2": (2, 3)}
    for name, want in READINGS["files"].items():
        info = avif.parse(fixture(name), name)
        if name.startswith("gain_map"):
            assert isinstance(info["color"], bytes)
            continue
        g = info["color"]
        rows_cols = next(v for k, v in layouts.items() if k in name)
        assert isinstance(g, avif._Grid) and (g.rows, g.cols) == rows_cols, name
        assert (g.height, g.width) == tuple(want["shape"][:2]) and len(set(g.sizes)) == 1, name
        assert isinstance(info["alpha"], avif._Grid) == (want["mode"] == "RGBA"), name
        assert info["premultiplied"] == ("premultiplied" in name), name
    crop = avif.parse(fixture("grid_420_crop_170x100.avif"), "x")["color"]
    assert crop.sizes[0] == (64, 64) and 3 * 64 > crop.width and 2 * 64 > crop.height


def test_gain_map_file_keeps_its_base_as_the_primary_item():
    """libavif's gain-map file (avifImageComputeGainMap, written beside
    its base): `pitm` names the `av01` base, which PIL shows; the `tmap`
    item derives from the base and the gain map (`dimg`). So the port reads
    it through the base item, bit-equal to PIL (the fixture test)."""
    data = fixture("gain_map_128x128.avif")
    ftyp, meta = heif_parts(data)
    assert b"tmap" in ftyp[8:]
    items = heif_model(data)
    types = {it["id"]: it["type"] for it in items["items"]}
    assert types[items["primary"]] == b"av01" and sorted(types.values()) == [b"av01", b"av01", b"tmap"]
    tmap = next(i for i, t in types.items() if t == b"tmap")
    assert [b"dimg", tmap, [items["primary"], max(types)]] in items["refs"]


# ---- live files: every subsampling and layout, alpha grids ----

LAYOUTS = {"2x2": (128, 128, (64, 64)), "crop": (100, 170, (64, 64)), "3x1": (64, 192, (64, 64)),
           "1x3": (192, 64, (64, 64)), "wide cells": (130, 256, (128, 66))}


@requires_libavif
@pytest.mark.parametrize("range_", ["full", "limited"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
def test_libavif_grids_read_bit_equal(tmp_path, cxx, subsampling, layout, range_):
    h, w, cell = LAYOUTS[layout]
    data = grid_of(h, w, 7, cell, subsampling, range_ == "full", quality=55)
    assert isinstance(avif.parse(data, "x")["color"], avif._Grid)
    assert assert_as_pil(tmp_path, data, layout)[0] == "RGB"


@requires_libavif
@pytest.mark.parametrize("range_", ["full", "limited"])
@pytest.mark.parametrize("premultiplied", [False, True])
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4", "4:0:0"])
def test_alpha_grids_read_bit_equal(tmp_path, cxx, subsampling, premultiplied, range_):
    data = grid_of(100, 170, 8, (64, 64), subsampling, range_ == "full", alpha=True, premultiplied=premultiplied)
    info = avif.parse(data, "x")
    assert isinstance(info["alpha"], avif._Grid) and info["premultiplied"] == premultiplied
    assert assert_as_pil(tmp_path, data)[0] == "RGBA"


def test_the_seams_match_pil_only_when_converted_once(cxx):
    """libavif copies the cells into one image and PIL converts it once:
    libyuv's bilinear chroma upsampling reads across the seams. The seam
    fixtures' chroma jumps at every seam; the port's reading is PIL's
    (sha256.json), and converting each cell on its own differs at the seam
    columns and rows, and nowhere else, under 4:2:0 and 4:2:2."""
    import ctypes

    for name in ("grid_420_seams_3x2.avif", "grid_422_seams_3x2.avif"):
        data = fixture(name)
        whole = image_io.open_image(os.path.join(FIXTURES, name)).pixels
        assert sha256_of(whole) == READINGS["files"][name]["sha256"]
        g = avif.parse(data, name)["color"]
        lib = avif._library(name)
        apart = np.empty_like(whole)
        for k, cell in enumerate(g.cells):
            y, u, v, seq = avif.av1_planes(cell, name)
            h, w = y.shape
            out = np.empty((h, w, 3), np.uint8)
            msg = ctypes.create_string_buffer(256)
            assert not lib.gs_yuv_to_rgb(y.ctypes.data, u.ctypes.data, v.ctypes.data, None, w, h, 8, 0,
                                         seq["ss_x"], seq["ss_y"], 6, 1, 1, 0, out.ctypes.data, msg, len(msg))
            r, c = divmod(k, g.cols)
            apart[r * h:(r + 1) * h, c * w:(c + 1) * w] = out
        off = np.any(apart != whole, axis=2)
        assert off.any(), name
        cols = {x for x in range(1, whole.shape[1]) if x % 64 in (0, 63)}
        rows = {y for y in range(1, whole.shape[0]) if y % 64 in (0, 63)} if seq["ss_y"] else set()
        ys, xs = np.nonzero(off)
        assert all(x in cols or y in rows for y, x in zip(ys, xs)), name
        assert {int(x) for x in xs} & cols, name


# ---- libavif's rules, on edited files ----

def item(m, iid):
    return next(it for it in m["items"] if it["id"] == iid)


def set_prop(m, iid, prop, essential=False):
    """Associate a new property with the item, in place of its property of
    that kind."""
    m["props"].append(list(prop))
    kinds = [m["props"][i - 1][0] for i, _ in m["assoc"][iid]]
    entry = [len(m["props"]), essential]
    if prop[0] in kinds:
        m["assoc"][iid][kinds.index(prop[0])] = entry
    else:
        m["assoc"][iid].append(entry)


def drop_prop(m, iid, kind):
    m["assoc"][iid] = [a for a in m["assoc"][iid] if m["props"][a[0] - 1][0] != kind]


def ispe(w, h):
    return [b"ispe", bytes(4) + struct.pack(">II", w, h)]


def grid_body(version=0, flags=0, rows=2, cols=2, w=128, h=128, extra=b""):
    """An ImageGrid body: version, flags, rows - 1, columns - 1 and the
    output size, 32-bit where flags & 1."""
    n = 4 if flags & 1 else 2
    return bytes([version, flags, rows - 1, cols - 1]) + w.to_bytes(n, "big") + h.to_bytes(n, "big") + extra


def set_body(body):
    return lambda m: item(m, 1).__setitem__("payload", body)


def set_dimg(to, of=1):
    def edit(m):
        next(r for r in m["refs"] if r[0] == b"dimg" and r[1] == of)[2] = to
    return edit


def cell_from(data, iid, props=True):
    """Cell `iid`'s AV1 data (and, with `props`, its ispe and av1C) in place
    of the same cell's, from the file `data()`."""
    def edit(m):
        o = heif_model(data())
        item(m, iid)["payload"] = item(o, iid)["payload"]
        for kind in (b"ispe", b"av1C") if props else ():
            prop = next(o["props"][i - 1] for i, _ in o["assoc"][iid] if o["props"][i - 1][0] == kind)
            set_prop(m, iid, prop, kind == b"av1C")
    return edit


def alpha_ids(m):
    return [it["id"] for it in m["items"] if it["name"].startswith(b"Alpha")]


def without_items(m, ids):
    m["items"] = [it for it in m["items"] if it["id"] not in ids]
    m["refs"] = [[k, f, [t for t in to if t not in ids]] for k, f, to in m["refs"] if f not in ids]
    m["refs"] = [r for r in m["refs"] if r[2]]
    for i in ids:
        m["assoc"].pop(i, None)


def alpha_from(data):
    """The alpha grid (or item) of the file `data()` and its cells in place
    of the file's own."""
    def edit(m):
        without_items(m, alpha_ids(m))
        o = heif_model(data())
        ids = alpha_ids(o)
        new = {i: max(it["id"] for it in m["items"]) + 1 + k for k, i in enumerate(ids)}
        for it in o["items"]:
            if it["id"] in new:
                m["items"].append({**it, "id": new[it["id"]]})
                m["assoc"][new[it["id"]]] = []
                for i, ess in o["assoc"].get(it["id"], []):
                    m["props"].append(list(o["props"][i - 1]))
                    m["assoc"][new[it["id"]]].append([len(m["props"]), ess])
        for kind, frm, to in o["refs"]:
            if frm in new:
                m["refs"].append([kind, new[frm], [new.get(t, m["primary"]) for t in to]])
    return edit


def alpha_per_cell(m, auxc=True):
    """No alpha grid: each colour cell's alpha item names the cell (`auxl`)."""
    grid = next(i for i in alpha_ids(m) if item(m, i)["type"] == b"grid")
    cells = next(r for r in m["refs"] if r[0] == b"dimg" and r[1] == grid)[2]
    colour = next(r for r in m["refs"] if r[0] == b"dimg" and r[1] == 1)[2]
    without_items(m, [grid])
    m["refs"] += [[b"auxl", a, [c]] for a, c in zip(cells, colour)]
    if not auxc:
        for a in cells:
            drop_prop(m, a, b"auxC")


NCLX_709_LIMITED = [b"colr", b"nclx" + struct.pack(">HHHB", 1, 1, 1, 0)]
PIXI_10 = [b"pixi", bytes(4) + bytes([3, 10, 10, 10])]


def base():
    return fixture("grid_420_2x2.avif")


def rgba():
    return fixture("grid_rgba_420_2x2.avif")


# name: (the file to edit, the edit); cells are items 2-5 of grid 1; the RGBA
# file's alpha grid is item 6, its cells 7-10
GRID_EDITS = {
    "ImageGrid version 1": (base, set_body(grid_body(version=1))),
    "body cut to 7 bytes": (base, set_body(grid_body()[:7])),
    "body cut to 4 bytes": (base, set_body(grid_body()[:4])),
    "empty body": (base, set_body(b"")),
    "a byte after the body": (base, set_body(grid_body(extra=b"\0"))),
    "32-bit output size": (base, set_body(grid_body(flags=1))),
    "flags 1 with a 16-bit body": (base, set_body(bytes([0, 1]) + grid_body()[2:])),
    "flags 2": (base, set_body(grid_body(flags=2))),
    "body in idat": (base, lambda m: item(m, 1).__setitem__("method", 1)),
    "3 rows of 4 cells": (base, set_body(grid_body(rows=3))),
    "1 column of 4 cells": (base, set_body(grid_body(cols=1))),
    "dimg of 3 cells": (base, set_dimg([2, 3, 4])),
    "dimg of 5 items": (base, set_dimg([2, 3, 4, 5, 1])),
    "dimg naming a cell twice": (base, set_dimg([2, 2, 4, 5])),
    "dimg in reverse": (base, set_dimg([5, 4, 3, 2])),
    "dimg naming no item": (base, set_dimg([2, 3, 4, 99])),
    "two dimg boxes": (base, lambda m: (set_dimg([2, 3])(m), m["refs"].append([b"dimg", 1, [4, 5]]))),
    "cells short of the output": (base, set_body(grid_body(w=130))),
    "last column outside": (base, set_body(grid_body(w=64))),
    "last row outside": (base, set_body(grid_body(h=62))),
    "odd output width at 4:2:0": (base, set_body(grid_body(w=127))),
    "odd output height at 4:2:0": (base, set_body(grid_body(h=127))),
    "output width 0": (base, set_body(grid_body(w=0))),
    "output height 0": (base, set_body(grid_body(h=0))),
    "output past libavif's limits": (base, set_body(grid_body(flags=1, w=40000, h=64))),
    "ispe smaller than the output": (base, lambda m: set_prop(m, 1, ispe(100, 90))),
    "ispe taller than the output": (base, lambda m: set_prop(m, 1, ispe(128, 130))),
    "ispe of another shape": (base, lambda m: set_prop(m, 1, ispe(120, 136))),
    "output smaller than ispe": (base, set_body(grid_body(w=100, h=90))),
    "grid without ispe": (base, lambda m: drop_prop(m, 1, b"ispe")),
    "grid without colr": (base, lambda m: drop_prop(m, 1, b"colr")),
    "grid without pixi": (base, lambda m: drop_prop(m, 1, b"pixi")),
    "grid pixi of 10 bits": (base, lambda m: set_prop(m, 1, PIXI_10)),
    "cell pixi of 10 bits": (base, lambda m: set_prop(m, 3, PIXI_10)),
    "grid colr BT.709 limited": (base, lambda m: set_prop(m, 1, NCLX_709_LIMITED)),
    "no grid colr, cells BT.709 limited": (base, lambda m: (drop_prop(m, 1, b"colr"),
                                                            [set_prop(m, i, NCLX_709_LIMITED) for i in (2, 3, 4, 5)])),
    "cell of type hvc1": (base, lambda m: item(m, 3).__setitem__("type", b"hvc1")),
    "first cell of type hvc1": (base, lambda m: item(m, 2).__setitem__("type", b"hvc1")),
    "cell of type grid": (base, lambda m: item(m, 3).__setitem__("type", b"grid")),
    "cell without ispe": (base, lambda m: drop_prop(m, 3, b"ispe")),
    "cell without av1C": (base, lambda m: drop_prop(m, 3, b"av1C")),
    "first cell without av1C": (base, lambda m: drop_prop(m, 2, b"av1C")),
    "cell av1C 4:4:4": (base, lambda m: set_prop(m, 3, [b"av1C", bytes([0x81, 0x20, 0, 0])], True)),
    "cell av1C 10-bit": (base, lambda m: set_prop(m, 3, [b"av1C", bytes([0x81, 0, 0x4C, 0])], True)),
    "cell av1C of another level": (base, lambda m: set_prop(m, 3, [b"av1C", bytes([0x81, 1, 0x0C, 0])], True)),
    "cell av1C delay byte": (base, lambda m: set_prop(m, 3, [b"av1C", bytes([0x81, 0, 0x0C, 0x10])], True)),
    "cell of an unknown essential property": (base, lambda m: set_prop(m, 3, [b"abcd", bytes(4)], True)),
    "cell of an unknown property": (base, lambda m: set_prop(m, 3, [b"abcd", bytes(4)])),
    "cell not hidden": (base, lambda m: item(m, 3).__setitem__("flags", 0)),
    "cell with no data": (base, lambda m: item(m, 3).__setitem__("payload", b"")),
    "first cell with no data": (base, lambda m: item(m, 2).__setitem__("payload", b"")),
    "cell without iloc": (base, lambda m: item(m, 3).__setitem__("payload", None)),
    "cell of 2 bytes": (base, lambda m: item(m, 3).__setitem__("payload", b"\x12\x00")),
    "cell cut short": (base, lambda m: item(m, 3).__setitem__("payload", item(m, 3)["payload"][:40])),
    "cell of limited range": (base, cell_from(lambda: grid_of(128, 128, 3, full_range=False), 3, props=False)),
    "cell of 4:4:4 data": (base, cell_from(lambda: grid_of(128, 128, 3, subsampling="4:4:4"), 3, props=False)),
    "cell of 4:4:4 with its av1C": (base, cell_from(lambda: grid_of(128, 128, 3, subsampling="4:4:4"), 3)),
    "cell of 4:0:0 with its av1C": (base, cell_from(lambda: grid_of(128, 128, 3, subsampling="4:0:0"), 3)),
    "cell of 80x80": (base, cell_from(lambda: grid_of(160, 160, 3, (80, 80)), 3)),
    "last cell of 80x80": (base, cell_from(lambda: grid_of(160, 160, 3, (80, 80)), 5)),
    "cell ispe 62x64": (base, lambda m: set_prop(m, 3, ispe(62, 64))),
    "alpha grid of another layout": (rgba, alpha_from(lambda: grid_of(128, 128, 4, (128, 64), alpha=True))),
    "alpha grid of another size": (rgba, alpha_from(lambda: grid_of(128, 120, 4, alpha=True))),
    "alpha grid body of another size": (rgba, lambda m: item(m, 6).__setitem__("payload", grid_body(w=120))),
    "alpha grid of version 1": (rgba, lambda m: item(m, 6).__setitem__("payload", grid_body(version=1))),
    "alpha grid without auxC": (rgba, lambda m: drop_prop(m, 6, b"auxC")),
    "alpha grid premultiplied": (rgba, lambda m: m["refs"].append([b"prem", 1, [6]])),
    "alpha cell av1C not 4:0:0": (rgba, lambda m: set_prop(m, 8, [b"av1C", bytes([0x81, 0, 0x0C, 0])], True)),
    "alpha cell of limited range": (rgba, cell_from(lambda: grid_of(128, 128, 5, alpha=True, full_range=False), 8,
                                                    props=False)),
    "alpha item for a grid": (rgba, alpha_from(lambda: writers.avif_grid_bytes(
        writers.yuv_planes(picture(128, 128, 6)), (128, 128), alpha=alpha_of(128, 128, 6)))),
    "alpha item of another size": (rgba, alpha_from(lambda: writers.avif_grid_bytes(
        writers.yuv_planes(picture(128, 120, 6)), (120, 128), alpha=alpha_of(128, 120, 6)))),
    "an alpha item for each cell": (rgba, alpha_per_cell),
    "an alpha item for each cell but one": (rgba, lambda m: (alpha_per_cell(m), m["refs"].pop())),
    "auxiliary items without auxC for each cell": (rgba, lambda m: alpha_per_cell(m, auxc=False)),
    "cell naming the grid as auxl": (base, lambda m: m["refs"].append([b"auxl", 3, [1]])),
}


@requires_libavif
@pytest.mark.parametrize("edit", list(GRID_EDITS))
def test_grid_rules_read_or_fail_as_pil(tmp_path, cxx, edit):
    """libavif's grid rules on an edited 2x2 grid (or RGBA grid): the
    ImageGrid body (version 0, its length, 16- or 32-bit output sizes of
    at least 1 within libavif's limits), `dimg` (rows x columns cells, each
    named once, in order, one box), the cells (`av01`, data, no unknown
    essential property, `ispe`, the first cell's `av1C` and the others'
    equal to it; size, subsampling and range as the first cell's; covering
    the output, the last row and column inside it, at least 64 pixels, even
    under chroma subsampling), the grid's own `ispe` (PIL's size: its rows
    cut from libavif's buffer), `pixi` and `colr` (else the first cell's
    sequence header, never a cell's `colr`), the alpha grid or item (any
    layout, the colour's size) and an alpha item for each cell. Each file
    reads as PIL reads it, or raises where PIL raises."""
    source, change = GRID_EDITS[edit]
    m = heif_model(source())
    change(m)
    assert_as_pil(tmp_path, heif_file(m), edit)


@requires_libavif
def test_the_editor_keeps_the_files_as_they_were(tmp_path, cxx):
    """heif_file(heif_model(f)) reads as f does, for every fixture grid."""
    for name in READINGS["files"]:
        data = fixture(name)
        assert_as_pil(tmp_path, heif_file(heif_model(data)), name)


def random_body(rng):
    """An ImageGrid body near the 2x2 fixture's: version 0 or 1, either
    field size, 1-3 rows and columns, output sizes around 128."""
    flags = int(rng.choice([0, 1, 3]))
    body = grid_body(int(rng.choice([0, 0, 0, 1])), flags, int(rng.integers(1, 4)), int(rng.integers(1, 4)),
                     int(rng.choice([0, 64, 100, 127, 128, 129, 192])), int(rng.choice([0, 62, 90, 128, 130])))
    cut = int(rng.integers(-2, 2))
    return body[:cut] if cut < 0 else body + bytes(cut)


def random_dimg(rng):
    """The fixture's four cells, dropped, repeated, joined by other items
    and shuffled."""
    cells = [2, 3, 4, 5]
    to = list(rng.permutation(cells))
    if rng.random() < 0.3:
        to.pop(int(rng.integers(0, len(to))))
    if rng.random() < 0.3:
        to.insert(int(rng.integers(0, len(to) + 1)), int(rng.choice(cells + [1, 9])))
    return [int(t) for t in to]


@requires_libavif
@pytest.mark.parametrize("seed", range(24))
def test_seeded_grid_bodies_read_or_fail_as_pil(tmp_path, cxx, seed):
    rng = np.random.default_rng(seed)
    m = heif_model(base())
    set_body(random_body(rng))(m)
    assert_as_pil(tmp_path, heif_file(m), f"seed {seed}")


@requires_libavif
@pytest.mark.parametrize("seed", range(16))
def test_seeded_dimg_lists_read_or_fail_as_pil(tmp_path, cxx, seed):
    rng = np.random.default_rng(100 + seed)
    m = heif_model(base())
    set_dimg(random_dimg(rng))(m)
    assert_as_pil(tmp_path, heif_file(m), f"seed {seed}")


@requires_libavif
def test_cells_that_libavif_scales_are_refused_by_name(tmp_path, cxx):
    """libavif scales an item whose AV1 frame is not its `ispe` size to
    that size (libyuv's scaler), and PIL reads the result; the port reads
    no scaled item and raises, naming it."""
    m = heif_model(rgba())
    item(m, 8)["payload"] = item(heif_model(grid_of(160, 160, 3, (80, 80))), 3)["payload"]  # an 80x80 alpha cell
    data = heif_file(m)
    assert pil_reading(data)[0] == "RGBA"
    path = tmp_path / "scaled.avif"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="libavif scales it") as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)


def test_decode_split_of_a_grid_sums_the_cells(monkeypatch, cxx):
    """A grid's split names every step and its cells' copies; each AV1 step
    is the sum over the colour and the alpha cells (here each cell's decode
    reports 1 s a step)."""
    decode = avif.av1_planes

    def one_second_a_step(av1, name, times=None, tools=None):
        out = decode(av1, name, times, tools)
        if times is not None:
            times.update(dict.fromkeys(avif.AV1_KEYS, 1.0))
        return out

    monkeypatch.setattr(avif, "av1_planes", one_second_a_step)
    split = {}
    avif.decode_avif(fixture("grid_rgba_420_2x2.avif"), "x", split=split)
    assert sorted(split) == sorted(avif.SPLIT_KEYS + (avif.GRID_KEY,)) and all(v >= 0 for v in split.values())
    assert all(split[key] == 8.0 for key in avif.AV1_KEYS)


# ---- both dataset paths against the JAX package ----

def grid_views(w, h):
    """Grid views of one size: 4:2:0, 4:2:2 limited, 4:4:4, 4:0:0, RGBA
    with an alpha grid (premultiplied too), opaque RGBA, cells in one row."""
    opaque = np.full((h, w), 255, np.uint8)
    yuv = writers.yuv_planes
    return {
        "g_420.avif": grid_of(h, w, 20),
        "g_422_limited.avif": grid_of(h, w, 21, subsampling="4:2:2", full_range=False),
        "g_444.avif": grid_of(h, w, 22, (128, 64), "4:4:4", quality=80),
        "g_400.avif": grid_of(h, w, 23, subsampling="4:0:0"),
        "g_rgba.avif": grid_of(h, w, 24, alpha=True),
        "g_rgba_premultiplied.avif": grid_of(h, w, 25, subsampling="4:4:4", alpha=True, premultiplied=True),
        "g_rgba_opaque.avif": writers.avif_grid_bytes(yuv(picture(h, w, 26)), (64, 64), alpha=opaque),
        "g_row.avif": grid_of(h, w, 27, (w, 64)),
    }


@requires_libavif
@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_grid_views_match_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of AVIF grid views (170x100: a cropped right column
    and bottom row): the Scene's cameras equal the JAX package's, images
    bit for bit."""
    from test_torch_scene import both_scenes

    w, h = 170, 100
    views = grid_views(w, h)
    src = str(tmp_path / "grid")
    write_colmap_dataset_of(src, views, w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == len(views)
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


@requires_libavif
@pytest.mark.parametrize("white_background", [False, True])
def test_blender_grid_frames_match_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on AVIF grid frames (named .png, as the transforms
    file names them): PIL's convert("RGBA") through the composite, bit for
    bit, then load_camera at -r 2."""
    frames = list(grid_views(170, 100).values())
    d = tmp_path / "scene"
    (d / "train").mkdir(parents=True)
    listing = []
    for i, data in enumerate(frames):
        (d / "train" / f"r_{i}.png").write_bytes(data)
        listing.append({"file_path": f"./train/r_{i}", "transform_matrix": orbit_frames(len(frames))[i]})
    (d / "transforms_train.json").write_text(json.dumps({"camera_angle_x": 0.69, "frames": listing}))
    monkeypatch.setenv("GS_TPU_BLENDER_INIT_POINTS", "50")
    infos = []
    for pkg, name in ((jreaders, "jax"), (dataset_readers, "port")):
        shutil.copytree(d, tmp_path / name)
        np.random.seed(3)
        infos.append(pkg.read_blender_scene(str(tmp_path / name), white_background, eval_split=False))
    want, got = infos
    assert len(got.train_cameras) == len(frames)
    for i, (g, wnt) in enumerate(zip(got.train_cameras, want.train_cameras)):
        np.testing.assert_array_equal(g.image, np.asarray(wnt.image), err_msg=f"frame {i}")
        assert (g.width, g.height, g.fovx, g.fovy) == (wnt.width, wnt.height, wnt.fovx, wnt.fovy)
        assert_same_cameras([dataset_readers.load_camera(g, 2)], [jreaders.load_camera(wnt, 2)])
