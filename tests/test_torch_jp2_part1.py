"""JPEG 2000 Part 1 features that PIL's writer never sets, in the port
(`utils/jp2.py` and the compiled `csrc/jp2_decode.cc`) against PIL 12
(OpenJPEG 2.5), on files from the test-side encoder
`tests/torch_j2k_writer.py`: SOP / EPH markers, packet headers in PPM and
PPT segments, progression order changes (POC) in the main header and in
tile-part headers, the six code-block styles (BYPASS, RESET, TERMALL, VSC,
PTERM, SEGSYM), RGN maxshift, component subsampling, unknown markers and
JPX files with two codestreams.

The writer is checked first: PIL decodes each lossless write (every pass
in one layer) to the picture itself, and each subsampled write to the
replication of the subsampled components by PIL's unpackers, computed in
numpy. Then the port is held to PIL's reading of the same bytes.

Tolerances: every comparison is bit-equal. For each file the port's
`image_io.open_image` must give PIL's mode and `np.asarray(Image.open(f))`
(a channel axis kept) and `to_rgba` PIL's `convert("RGBA")`, or raise a
`ValueError` naming the file where PIL raises. Pictures are at most 67x45,
made from `np.random.default_rng(seed)`; the committed fixtures
(`tests/fixtures/torch_jp2_part1`, a 1920x1080 one included) are held to
PIL's hashes.
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

from gaussian_splatting_torch.utils import image_io
from test_torch_image_forms import assert_follows_pil, cxx, smooth  # noqa: F401  (cxx: a fixture)
from torch_image_writers import j2k_join, j2k_markers, jp2_box, jp2_bytes
from torch_j2k_writer import (
    ALL_STYLES, BYPASS, PTERM, RESET, SEGSYM, TERMALL, VSC, components_of, encode,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_jp2_part1")
STYLES = {"BYPASS": BYPASS, "RESET": RESET, "TERMALL": TERMALL, "VSC": VSC, "PTERM": PTERM, "SEGSYM": SEGSYM}
PRECINCTS = [(4, 4), (4, 4), (4, 4), (5, 5), (5, 5), (5, 5)]


def picture(c=3, seed=1, h=45, w=67):
    return smooth(h, w, c, seed)


# ---- the writer against PIL ----

# (name, components, options): lossless (one layer, every pass)
LOSSLESS = [
    ("plain", 3, {}),
    ("grey", 1, {}),
    ("grey + alpha", 2, {}),
    ("RGBA", 4, {"mct": True}),
    ("RCT", 3, {"mct": True}),
    ("no decomposition", 3, {"levels": 0}),
    ("2 levels, code-blocks 8x16", 3, {"levels": 2, "cblk": (3, 4)}),
    ("code-blocks 4x4", 3, {"cblk": (2, 2), "levels": 3}),
    ("precincts", 3, {"precincts": PRECINCTS, "cblk": (3, 3)}),
    ("tiles and offsets", 3, {"tile": (32, 16), "tile_offset": (1, 2), "offset": (3, 3)}),
    ("tile-parts", 3, {"tile": (32, 32), "tile_parts": 3}),
    ("SOP", 3, {"sop": True}),
    ("EPH", 3, {"eph": True}),
    ("SOP and EPH, tiles", 3, {"sop": True, "eph": True, "tile": (32, 32), "tile_parts": 2}),
    ("PPM", 3, {"headers": "ppm", "tile": (32, 32), "tile_parts": 2}),
    ("PPM in 23-byte segments", 3, {"headers": "ppm", "split": 23, "tile": (32, 32), "tile_parts": 2, "sop": True,
                                   "eph": True}),
    ("PPT", 3, {"headers": "ppt", "tile": (32, 32), "tile_parts": 2}),
    ("PPT in 11-byte segments", 3, {"headers": "ppt", "split": 11, "tile": (32, 32), "tile_parts": 2, "eph": True}),
    ("POC", 3, {"poc": [(0, 0, 1, 6, 3, "RLCP"), (0, 0, 3, 6, 3, "CPRL")]}),
    ("POC, three entries, precincts, tiles", 3, {
        "poc": [(0, 0, 1, 3, 2, "PCRL"), (2, 1, 3, 6, 3, "LRCP"), (0, 0, 3, 6, 3, "RPCL")],
        "precincts": PRECINCTS, "cblk": (3, 3), "tile": (32, 32)}),
    ("POC in tile-part headers", 3, {"poc": [(0, 0, 1, 6, 3, "RLCP")], "tile": (32, 32), "tile_poc": {
        0: [(0, 0, 3, 6, 3, "CPRL")], 1: [(0, 0, 3, 6, 3, "LRCP")],
        2: [(0, 0, 2, 6, 3, "PCRL"), (0, 0, 3, 6, 3, "RPCL")],
        3: [(0, 0, 3, 6, 3, "RLCP")], 4: [(0, 1, 3, 6, 3, "RPCL"), (0, 0, 3, 6, 1, "LRCP")],
        5: [(0, 0, 3, 6, 3, "PCRL")]}}),
    ("RGN", 3, {"roi": {0: 10, 2: 10}, "roi_rect": (10, 5, 40, 30), "levels": 3, "cblk": (4, 4)}),
    ("RGN, every component", 3, {"roi": {0: 12, 1: 12, 2: 12}, "mct": True}),
] + [(f"style {name}", 3, {"style": bit, "mct": True, "cblk": (4, 4), "levels": 3}) for name, bit in STYLES.items()] + [
    ("all six styles", 3, {"style": ALL_STYLES, "mct": True, "cblk": (4, 4), "levels": 3}),
    ("BYPASS and TERMALL", 3, {"style": BYPASS | TERMALL, "cblk": (4, 4)}),
    ("all six styles, SOP, EPH, POC, PPT, RGN", 3, {
        "style": ALL_STYLES, "sop": True, "eph": True, "headers": "ppt", "tile": (32, 32), "roi": {1: 10},
        "poc": [(0, 0, 1, 6, 3, "RLCP"), (0, 0, 3, 6, 3, "CPRL")]}),
]
LAYERED = {"layers": [2, 5, None]}


@pytest.mark.parametrize("j2k", [True, False], ids=["j2k", "jp2"])
@pytest.mark.parametrize("case", LOSSLESS, ids=[c[0] for c in LOSSLESS])
def test_writer_decodes_in_pil_to_the_picture(case, j2k):
    """Every option of the writer, lossless: PIL's pixels are the picture,
    in one layer and in three (the first two carrying 2 and 5 passes)."""
    name, c, options = case
    a = picture(c, len(name))
    for extra in ({}, LAYERED):
        data = encode(a, **options, **extra)
        data = data if j2k else jp2_bytes(data, colr=(1, 17 if c <= 2 else 16))
        got = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(got.reshape(a.shape), a, err_msg=f"{name} {extra}")


def pil_replication(a, sub, offset=(0, 0), tile=None, tile_offset=(0, 0), ycc=False):
    """PIL's reading of a lossless subsampled file, in numpy: each tile's
    components as OpenJPEG packs them (each at its own size, the rest of
    the buffer zero), read back by PIL's unpackers with strides w / dx and
    h / dy; `ycc`: then PIL's YCbCr conversion."""
    h, w, nc = a.shape
    x0, y0 = offset
    x1, y1 = x0 + w, y0 + h
    tdx, tdy = tile or (x1, y1)
    tx0, ty0 = tile_offset if tile else (0, 0)
    planes = components_of(a, sub, offset)
    out = np.zeros(a.shape, np.uint8)
    for t in range(-(-(x1 - tx0) // tdx) * -(-(y1 - ty0) // tdy)):
        p, q = t % -(-(x1 - tx0) // tdx), t // -(-(x1 - tx0) // tdx)
        a0, b0 = max(tx0 + p * tdx, x0), max(ty0 + q * tdy, y0)
        a1, b1 = min(tx0 + (p + 1) * tdx, x1), min(ty0 + (q + 1) * tdy, y1)
        tw, th = a1 - a0, b1 - b0
        buf, at, starts = np.zeros(nc * tw * th, np.uint8), 0, []
        for c, (dx, dy) in enumerate(sub):
            cx, cy = -(-x0 // dx), -(-y0 // dy)
            part = planes[c][-(-b0 // dy) - cy:-(-b1 // dy) - cy, -(-a0 // dx) - cx:-(-a1 // dx) - cx].ravel()
            buf[at:at + part.size] = part
            at += part.size
        yy, xx = np.mgrid[0:th, 0:tw]
        at = 0
        for c, (dx, dy) in enumerate(sub):
            out[b0 - y0:b1 - y0, a0 - x0:a1 - x0, c] = buf[at + (yy // dy) * (tw // dx) + xx // dx]
            at += (tw // dx) * (th // dy)
        if ycc:
            block = out[b0 - y0:b1 - y0, a0 - x0:a1 - x0, :3]
            out[b0 - y0:b1 - y0, a0 - x0:a1 - x0, :3] = np.asarray(Image.fromarray(block, "YCbCr").convert("RGB"))
    return out


# (name, components, subsampling, options, colour: None for a raw codestream, else the colr box's enumerated space)
SUBSAMPLED = [
    ("4:2:0 sYCC JP2", 3, [(1, 1), (2, 2), (2, 2)], {}, 18),
    ("4:2:2 sYCC JP2", 3, [(1, 1), (2, 1), (2, 1)], {}, 18),
    ("4:2:0 raw codestream (sYCC guessed)", 3, [(1, 1), (2, 2), (2, 2)], {}, None),
    ("4:2:0 sRGB JP2", 3, [(1, 1), (2, 2), (2, 2)], {}, 16),
    ("4:2:0, offsets and tiles not multiples of 2", 3, [(1, 1), (2, 2), (2, 2)],
     {"tile": (15, 13), "tile_offset": (1, 2), "offset": (3, 5)}, None),
    ("3x2 and 4x3", 3, [(1, 1), (3, 2), (4, 3)], {"tile": (13, 11), "tile_offset": (2, 1), "offset": (3, 3)}, 16),
    ("component 0 subsampled (sRGB)", 3, [(2, 2), (1, 1), (1, 1)], {}, None),
    ("alpha subsampled", 4, [(1, 1), (1, 1), (1, 1), (2, 2)], {"tile": (7, 9)}, None),
    ("4:2:0 with alpha at 2x2", 4, [(1, 1), (2, 2), (2, 2), (2, 2)], {"tile": (16, 16), "offset": (1, 1),
                                                                        "tile_offset": (1, 1)}, 18),
    ("4:2:0, RPCL precincts, layers", 3, [(1, 1), (2, 2), (2, 2)],
     {"progression_order": "RPCL", "precincts": [(3, 3)] * 6, "tile": (32, 32), "layers": [2, None]}, 18),
    ("4:2:0, CPRL, all six styles", 3, [(1, 1), (2, 2), (2, 2)],
     {"progression_order": "CPRL", "precincts": [(4, 4)] * 4, "levels": 3, "style": ALL_STYLES}, None),
]


@pytest.mark.parametrize("case", SUBSAMPLED, ids=[c[0] for c in SUBSAMPLED])
def test_subsampled_writes_decode_in_pil_to_the_replication(case):
    """A subsampled write decodes in PIL to PIL's replication of the
    subsampled components (sYCC where the colr box says so, or where it
    says nothing and component 1 or 2 is subsampled)."""
    name, c, sub, options, colour = case
    a = picture(c, len(name), 30, 37)
    data = encode(a, subsampling=sub, **options)
    if colour is not None:
        data = jp2_bytes(data, colr=(1, colour))
    ycc = colour == 18 or (colour is None and sub[0] == (1, 1) and (sub[1] != (1, 1) or sub[2] != (1, 1)))
    want = pil_replication(a, sub, options.get("offset", (0, 0)), options.get("tile"), options.get("tile_offset",
                                                                                                  (0, 0)), ycc)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), want)


# ---- the port against PIL ----

@functools.cache
def feature_views():
    """The writer's files, lossless and lossy, and the edge cases of each
    feature: {name: codestream}."""
    a, b = picture(3, 1), picture(4, 2, 30, 37)
    views = {name: encode(picture(c, len(name)), **options) for name, c, options in LOSSLESS}
    views.update({f"{name}, layers": encode(picture(c, len(name)), **options, **LAYERED)
                  for name, c, options in LOSSLESS})
    views.update({f"{name}, lossy": encode(picture(c, len(name)), **options, layers=[3, 9])
                  for name, c, options in LOSSLESS if "style" in options})
    views.update({name: encode(picture(c, len(name), 30, 37), subsampling=sub, **options)
                  for name, c, sub, options, _ in SUBSAMPLED})
    views.update({
        "RGN, too small a shift (PIL's reading)": encode(a, roi={0: 6, 2: 7}, roi_rect=(10, 5, 40, 30), levels=3),
        "RGN, lossy, all six styles": encode(a, roi={1: 8}, roi_rect=(10, 5, 40, 30), style=ALL_STYLES,
                                             layers=[4, 10], cblk=(4, 4), levels=3),
        "RGN 20": encode(a, roi={1: 20}, levels=3, cblk=(4, 4)),
        "RGN 25: past OpenJPEG's 31 bit-planes": encode(a, roi={1: 25}, levels=3, cblk=(4, 4)),
        "POC names layer 0 only": encode(a, poc=[(0, 0, 1, 6, 3, "RLCP")], layers=[2, 4, None]),
        "POC in one tile-part header, layers": encode(a, poc=[(0, 0, 1, 6, 3, "RLCP")], tile=(32, 32), layers=[2, None],
                                                     tile_poc={0: [(0, 0, 3, 6, 3, "CPRL")]}),
        "POC leaves out component 1's top resolution": encode(
            a, poc=[(0, 0, 3, 6, 1, "RLCP"), (0, 1, 3, 5, 2, "RLCP"), (0, 2, 3, 6, 3, "LRCP")], layers=[2, 4, None]),
        "POC leaves out a resolution, tiles": encode(
            a, poc=[(0, 0, 3, 6, 1, "RLCP"), (0, 1, 3, 5, 2, "RLCP"), (0, 2, 3, 6, 3, "LRCP")], tile=(32, 32)),
        "POC leaves out component 0's top resolution, RCT": encode(
            a, poc=[(0, 0, 3, 5, 1, "RLCP"), (0, 1, 3, 6, 3, "RLCP")], mct=True),
        "POC leaves out component 2": encode(a, poc=[(0, 0, 1, 6, 2, "LRCP")]),
        "POC with an unknown order": encode(a, poc=[(0, 0, 1, 6, 3, 7)]),
        "POC starting past the components": encode(a, poc=[(0, 0, 1, 6, 3, "LRCP"), (0, 3, 1, 6, 3, "LRCP")]),
        "POC past the resolutions and layers": encode(a, poc=[(0, 0, 9, 40, 3, "RPCL")], layers=[2, None]),
        "RCT flag on subsampled components": encode(a, subsampling=[(1, 1), (2, 2), (2, 2)], mct=True),
        "grey + alpha, alpha subsampled": encode(b[..., :2], subsampling=[(1, 1), (2, 2)]),
        "grey subsampled": encode(b[..., :1], subsampling=[(2, 2)]),
        "SOP with other Nsop values": encode(a, sop=True, nsop=lambda n: 7 * n + 3),
        "POC: tile 0's own, tile 1 leaving out a resolution": encode(
            a, tile=(32, 45), poc=[(0, 0, 1, 6, 1, "LRCP"), (0, 1, 1, 5, 2, "LRCP"), (0, 2, 1, 6, 3, "LRCP")],
            tile_poc={0: [(0, 0, 1, 6, 3, "LRCP")]}),
        "POC: tile 1 without component 1": encode(a, tile=(32, 45), tile_poc={0: [(0, 0, 1, 6, 3, "LRCP")]},
                                                 poc=[(0, 0, 1, 6, 1, "LRCP"), (0, 2, 1, 6, 3, "LRCP")]),
        "POC from resolution 1, tiles (empty bands' precincts in the area of interest)": encode(
            picture(4, 106, 27, 31), levels=4, cblk=(5, 2), eph=True, tile=(10, 29), tile_offset=(1, 1),
            offset=(6, 3), tile_parts=2, precincts=[(3, 4), (1, 2), (6, 1), (4, 5), (6, 5)],
            poc=[(1, 0, 3, 4, 3, "RLCP")], tile_poc={0: [(0, 0, 3, 5, 4, "CPRL")]}),
        "POC from resolution 1, 3x3 subsampling (a 1x1 resolution skipped)": encode(
            picture(3, 88, 17, 23), levels=4, cblk=(4, 4), layers=[4, 8, 25], subsampling=[(3, 3), (1, 3), (3, 3)],
            poc=[(1, 0, 1, 3, 3, "PCRL")]),
    })
    c = smooth(8, 37, 1, 3)
    for levels in (16, 31, 32):  # precinct exponent + level past 31 bits
        for order in ("RPCL", "PCRL", "CPRL"):
            views[f"{order}, {levels} decompositions of 37x8"] = encode(c, levels=levels, cblk=(5, 5),
                                                                       progression_order=order)
    return views


@functools.cache
def _edited_views():
    """Marker edits of the writer's files: SOP / EPH missing, unknown
    markers, PPM / PPT segments out of order, POC placement."""
    a = picture(3, 1, 20, 23)
    views = {}
    sop, eph = encode(a, layers=[2, None], eph=True), encode(a, layers=[2, None], sop=True)
    for name, cs, bit in (("SOP signalled, none written", sop, 2), ("EPH signalled, none written", eph, 4)):
        main, parts = j2k_markers(cs)
        cod = bytearray(main[1][1])
        cod[0] |= bit
        views[name] = j2k_join([main[0], (0xFF52, bytes(cod))] + main[2:], parts)
    one = encode(a[..., :1], levels=0, eph=True)
    main, parts = j2k_markers(one)
    data = parts[0][4]
    at = data.index(b"\xff\x92")
    views["EPH replaced by 00 00"] = j2k_join(main, [parts[0][:4] + (data[:at] + b"\0\0" + data[at + 2:],)])
    main, parts = j2k_markers(encode(a, layers=[2, None], sop=True, eph=True))
    for name, body in (("even", b"\x00\x00"), ("odd", b"\x00\x00\x01"),
                       ("holding COM", b"\x00\x00\xff\x64\x00\x04\x00\x01"),
                       ("holding 0xFF30 and COD", b"\xff\x30\xff\x52")):
        views[f"an unknown marker, {name} body"] = j2k_join(main[:3] + [(0xFF6A, body)] + main[3:], parts)
    views["an unknown marker before COD"] = j2k_join(main[:1] + [(0xFF6A, b"\x00\x00")] + main[1:], parts)
    views["EOC, SOD and EPH segments in the main header"] = j2k_join(
        main + [(0xFFD9, b"\x00\x00"), (0xFF93, b"\x00\x00"), (0xFF92, b"\x00\x00")], parts)
    views["SOP segment in the main header"] = j2k_join(main + [(0xFF91, b"\x00\x00")], parts)
    whole = j2k_join(main, parts)
    at = whole.index(b"\xff\x90")
    views["ending on the first SOT marker"] = whole[:at + 2]
    views["ending on a tile-part header's marker"] = j2k_join(main, [p[:3] + ([(0xFF64, b"\x00\x01")], p[4])
                                                                     for p in parts])[:at + 14]
    views["ending on SOD"] = whole[:at + 14]
    for name, poc in (("COD's order unknown, a POC", [(0xFF5F, b"\x00\x00\x00\x02\x06\x03\x01")]),
                      ("COD's order unknown, no POC", [])):
        cod = bytearray(main[1][1])
        cod[1] = 9
        views[name] = j2k_join([main[0], (0xFF52, bytes(cod))] + main[2:] + poc, parts)
    views["an unknown marker, then SIZ"] = j2k_join(main + [(0xFF6A, b"\x00\x00"), (0xFF51, main[0][1])], parts)
    views["an unknown marker in a tile-part header"] = j2k_join(
        main, [p[:3] + ([(0xFF6A, b"\x00\x00")] + p[3], p[4]) for p in parts])
    main, parts = j2k_markers(encode(a, tile=(12, 20), tile_parts=2, layers=[2, None]))
    unknown = [p[:2] + (0,) + p[3:] for p in parts]  # TNsot 0
    cut = len(j2k_join(main, parts[:1])) - 2 + 14
    views.update({  # a stream ending on a marker code: what is decoded after that point fails
        "two tile-parts a tile, ending on SOT": j2k_join(main, parts, end=b"\xff\x90"),
        "tile 0 whole, ending on SOT": j2k_join(main, parts[:2], end=b"\xff\x90"),
        "tile 1 half, ending on SOT": j2k_join(main, parts[:3], end=b"\xff\x90"),
        "TNsot 0, ending on SOT": j2k_join(main, unknown, end=b"\xff\x90"),
        "tile 0's second tile-part ending on a COM marker code": j2k_join(
            main, parts[:1] + [parts[1][:3] + ([(0xFF64, b"\0\1")], parts[1][4])])[:cut],
        "tile 1's second tile-part missing, then EOC": j2k_join(main, parts[:-1]),
    })
    main, parts = j2k_markers(encode(a, headers="ppm", split=40, tile=(16, 16)))
    ppm, rest = [m for m in main if m[0] == 0xFF60], [m for m in main if m[0] != 0xFF60]
    views.update({
        "PPM segments in reverse order": j2k_join(rest + ppm[::-1], parts),
        "PPM Zppm with gaps": j2k_join(rest + [(0xFF60, bytes([2 * b[0]]) + b[1:]) for _, b in ppm], parts),
        "PPM Zppm twice": j2k_join(rest + ppm + ppm[:1], parts),
        "PPM segment missing": j2k_join(rest + ppm[:1] + ppm[2:], parts),
        "PPM and PPT": j2k_join(main, [p[:3] + ([(0xFF61, b"\x00\x00")] + p[3], p[4]) for p in parts]),
        "PPM in a tile-part header": j2k_join(rest, [p[:3] + (ppm + p[3], p[4]) if k == 0 else p
                                                     for k, p in enumerate(parts)]),
        "PPM of one byte": j2k_join(rest + [(0xFF60, b"\x00")], parts),
    })
    main, parts = j2k_markers(encode(a, headers="ppt", split=9, tile=(16, 16), tile_parts=2))
    views.update({
        "PPT segments in reverse order": j2k_join(main, [p[:3] + (p[3][::-1], p[4]) for p in parts]),
        "PPT Zppt with gaps": j2k_join(main, [p[:3] + ([(m, bytes([2 * b[0]]) + b[1:]) for m, b in p[3]], p[4])
                                              for p in parts]),
        "PPT in the main header": j2k_join(main + [(0xFF61, b"\x00\x00")], parts),
        "PPT of one byte": j2k_join(main, [p[:3] + (p[3] + [(0xFF61, b"\x7f")], p[4]) for p in parts]),
    })
    main, parts = j2k_markers(encode(a, layers=[2, None], poc=[(0, 0, 2, 6, 3, "RLCP")]))
    poc, rest = [m for m in main if m[0] == 0xFF5F], [m for m in main if m[0] != 0xFF5F]
    views.update({
        "POC before COD (no layers yet)": j2k_join(rest[:1] + poc + rest[1:], parts),
        "two POC segments": j2k_join(rest + [(0xFF5F, b"\x00\x00\x00\x01\x06\x03\x01"),
                                             (0xFF5F, b"\x00\x00\x00\x02\x06\x03\x02")], parts),
        "POC of a bad length": j2k_join(rest + [(0xFF5F, poc[0][1] + b"\x00")], parts),
        "RGN of a bad component": j2k_join(rest + [(0xFF5E, b"\x05\x00\x02")], parts),
        "RGN with Srgn 1": j2k_join(rest + [(0xFF5E, b"\x01\x01\x03")], parts),
        "RGN of a bad length": j2k_join(rest + [(0xFF5E, b"\x01\x00\x03\x00")], parts),
        "RGN in a tile-part header": j2k_join(rest, [p[:3] + ([(0xFF5E, b"\x00\x00\x04")] + p[3], p[4])
                                                     for p in parts]),
    })
    cs = encode(a, style=ALL_STYLES, sop=True, eph=True)
    views["JPX with two codestreams"] = jp2_bytes(cs, brand=b"jpx ") + jp2_box(b"jp2c", encode(a[::-1]))
    return views


FEATURE_VIEWS = sorted(feature_views())


@pytest.mark.parametrize("j2k", [True, False], ids=["j2k", "jp2"])
@pytest.mark.parametrize("view", FEATURE_VIEWS)
def test_port_follows_pil_on_the_writers_files(tmp_path, cxx, view, j2k):
    """Each feature, lossless, layered and lossy, and each edge case, as a
    raw codestream and as a JP2: PIL's mode, pixels and RGBA, or a raise
    where PIL raises."""
    cs = feature_views()[view]
    nc = struct.unpack_from(">H", cs, 40)[0]
    data = cs if j2k else jp2_bytes(cs, colr=(1, 17 if nc <= 2 else 16))
    assert_follows_pil(tmp_path, data, view, ".j2k" if j2k else ".jp2")


EDITED_VIEWS = sorted(_edited_views())


@pytest.mark.parametrize("view", EDITED_VIEWS)
def test_port_follows_pil_on_marker_edits(tmp_path, cxx, view):
    """Missing SOP (OpenJPEG warns) and EPH (it fails), unknown markers
    (skipped two bytes at a time in the main header, refused in a tile-part
    header), PPM / PPT segments by their Z index and their errors, POC and
    RGN edge cases, a JPX file's second codestream (PIL reads the first)."""
    data = _edited_views()[view]
    got = assert_follows_pil(tmp_path, data, view, ".jp2" if data.startswith(b"\0\0\0\x0cjP") else ".j2k")
    if view in ("SOP signalled, none written", "an unknown marker, even body", "PPM segments in reverse order",
                "PPT segments in reverse order", "JPX with two codestreams"):
        assert got is not None, view


# ---- fixtures ----

def _readings():
    with open(os.path.join(FIXTURES, "sha256.json")) as f:
        return json.load(f)


def _digest(pixels) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(_readings()))
def test_part1_fixtures_give_pils_hash(cxx, name):
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


def test_part1_fixtures_are_small():
    """The committed Part 1 files (the 1920x1080 one included) stay under
    1 MB together."""
    names = _readings()
    assert len(names) >= 15
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in names) < 1_000_000
