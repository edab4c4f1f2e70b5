"""The port's IM, IMT, IPTC, McIDAS, MSP, PCD, PIXAR, SPIDER, SUN, XBM, XPM
and XV thumbnail readers, and its refusal of MPEG, WMF and EMF, against
PIL 12.1.0; both dataset paths on views in those forms against the JAX
package.

Every file is made here from `np.random.default_rng(seed)` (small sizes)
by PIL where PIL writes the form (IM, MSP version 1, SPIDER, XBM), else by
`tests/torch_image_writers.py`. PIL's reading of it, by its path and
loaded, is the rule: `image_io.open_image` gives PIL's mode and pixels,
`to_rgba` its `convert("RGBA")`, bit for bit, and where PIL raises the
port raises a `ValueError` naming the file.
"""

import hashlib
import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import im, image_codecs, image_io, msp, pcd, sun, xbm, ycbcr
from test_torch_image_forms import cxx, smooth, write_colmap_dataset_of  # noqa: F401  (cxx: a fixture)
from test_torch_jpeg import fake_cxx  # noqa: F401  (a fixture)
from test_torch_rare_forms import follows_pil, pil_save
from test_torch_scene import assert_same_cameras, orbit_frames
from torch_image_writers import (emf_bytes, im_bits, im_bytes, imt_bytes, iptc_bytes, iptc_field, mcidas_bytes,
                                 mpeg_bytes, msp_bytes, msp_rle_row, pack_raw, pcd_bytes, pcd_ycc, pixar_bytes,
                                 spider_bytes, sun_bytes, wmf_bytes, xbm_bytes, xpm_bytes, xv_bytes)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import pil_rest_files, sha256_of  # noqa: E402  (the repo root: phase 5p's files)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_pil_rest")


def grey(seed=0, w=11, h=7):
    return smooth(h, w, 1, seed)[..., 0]


def colour(seed=0, w=11, h=7, c=3):
    return smooth(h, w, c, seed)


def ramp_lut(colour_lut: bool):
    """(256, 3): a colour LUT, or a grey one that is not linear."""
    i = np.arange(256)
    if colour_lut:
        return np.stack([i, 255 - i, (i * 7) % 256], -1).astype(np.uint8)
    return np.stack([255 - i] * 3, -1).astype(np.uint8)


# ---- the forms and their branches ----

def im_cases():
    g, rgb = grey(1), colour(2)
    w, h = 11, 7
    rng = np.random.default_rng(3)
    i16 = rng.integers(0, 65536, (h, w))
    i32 = rng.integers(-2**31, 2**31, (h, w))
    f32 = rng.normal(0, 100, (h, w)).astype(np.float32)

    def raw(image_type, px, rawmode, **kw):
        return im_bytes(image_type, w, h, pack_raw(px, rawmode, bottom_up=True), **kw)

    cases = {
        "PIL's L": pil_save(Image.fromarray(g), "IM"),
        "PIL's RGB": pil_save(Image.fromarray(rgb), "IM"),
        "PIL's P (colour LUT)": pil_save(Image.fromarray(rgb).quantize(20), "IM"),
        "PIL's LA": pil_save(Image.fromarray(colour(4, c=2), "LA"), "IM"),
        "PIL's RGBA": pil_save(Image.fromarray(colour(5, c=4)), "IM"),
        "PIL's CMYK": pil_save(Image.fromarray(colour(6, c=4), "CMYK"), "IM"),
        "PIL's YCbCr": pil_save(Image.fromarray(rgb).convert("YCbCr"), "IM"),
        "PIL's 1": pil_save(Image.fromarray(g > 128), "IM"),
        "PIL's I": pil_save(Image.fromarray(i32.astype(np.int32)), "IM"),
        "PIL's F": pil_save(Image.fromarray(f32), "IM"),
        "PIL's I;16": pil_save(Image.fromarray(i16.astype(np.uint16)), "IM"),
        "L 16L": raw("L 16L image", i16, "I;16L"),
        "L 16B": raw("L 16B image", i16, "I;16B"),
        "L 32S": raw("L 32S image", i32, "I;32S"),
        "L 32 F (uint32 to float)": raw("L 32 F image", i32 % 2**32, "F;32"),
        "L 8": raw("L 8 image", g, "F;8"),
        "L 8S": raw("L 8S image", g, "F;8S"),
        "L 16 F": raw("L*16 image", i16, "F;16"),
        "L 16S": raw("L 16S image", i16, "F;16S"),
        "L*32F": raw("L*32F image", f32, "F;32F"),
        "RGB X 24": raw("X 24 image", rgb, "RGB"),
        "RGBX": raw("RGBX image", rgb, "RGBX;L"),
        "B2 (no LUT: black palette)": raw("B2 image", g % 4, "P;2"),
        "B4": raw("B4 image", g % 16, "P;4"),
        "B1": raw("B1 image", g > 100, "1"),
        "L 1": raw("L 1 image", g > 100, "1"),
        "Grayscale spelling": raw("Grayscale image", g, "L"),
        "RGB3 (planes to G, R, B)": im_bytes("RGB3 image", w, h, b"".join(pack_raw(rgb[..., k], "L", True)
                                                                         for k in range(3))),
        "RYB3": im_bytes("RYB3 image", w, h, b"".join(pack_raw(rgb[..., k], "L", True) for k in range(3))),
        "RLB (PIL: unknown raw mode)": raw("RLB image", rgb, "RGB;L"),
        "PA without a LUT (PIL: unknown raw mode)": raw("PA image", colour(7, c=2), "LA;L"),
        "PA with a colour LUT": raw("PA image", colour(7, c=2), "LA;L", lut=ramp_lut(True)),
        "LA with a colour LUT": raw("LA image", colour(7, c=2), "LA;L", lut=ramp_lut(True)),
        "LA with a grey LUT (PA;L: PIL cannot load)": raw("PA image", colour(7, c=2), "LA;L", lut=ramp_lut(False)),
        "L with a grey LUT, not linear": raw("Greyscale image", g, "L", lut=ramp_lut(False)),
        "L with a linear grey LUT": raw("Greyscale image", g, "L", lut=np.repeat(np.arange(256)[:, None], 3, 1)),
        "B4 with a colour LUT (read 8-bit)": raw("B4 image", g, "L", lut=ramp_lut(True)),
        "RGB with a LUT": raw("RGB image", rgb, "RGB;L", lut=ramp_lut(True)),
        "a literal mode L": raw("L", g, "L"),
        "a literal mode RGB (raw mode L)": raw("RGB", rgb, "RGB;L"),
        "an unknown image type": raw("foo image", g, "L"),
        "an empty image type": raw("", g, "L"),
        "no padding before 0x1A": raw("Greyscale image", g, "L", pad=False),
        "comments and a name": raw("Greyscale image", g, "L", lines=["Comment: a", "Comment: b", "Name: x.im",
                                                                      "Scale (x,y): 1*1", "Date: today"]),
        "a size of one number": im_bytes("Greyscale image", w, h, b"").replace(b"(x*y): 11*7", b"(x*y): 11"),
        "a size of three numbers": im_bytes("Greyscale image", w, h, b"").replace(b"11*7", b"11*7*2"),
        "a float size": im_bytes("Greyscale image", w, h, b"").replace(b"11*7", b"11.5*7"),
        "a size that is not a number": im_bytes("Greyscale image", w, h, b"").replace(b"11*7", b"a*7"),
        "a zero width": im_bytes("Greyscale image", w, h, b"").replace(b"11*7", b"0*7"),
        "no known key": b"Foo: 1\r\n\x1a" + bytes(100),
        "a line PIL's pattern rejects": b"Image type: Greyscale image\r\n1bad line\r\n\x1a" + bytes(100),
        "a line of over 100 bytes": b"Comment: " + b"x" * 100 + b"\r\n\x1a" + bytes(100),
        "no line feed in 100 bytes": b"Image type: Greyscale image" + bytes(200),
        "no 0x1A": im_bytes("Greyscale image", w, h, b"")[:-1],
        "a LUT cut short": raw("Greyscale image", g, "L", lut=ramp_lut(True))[:530],
        "pixel data cut short": raw("Greyscale image", g, "L")[:-5],
        "RGB data cut short": raw("RGB image", rgb, "RGB;L")[:-5],
        "default size 512x512 (data short)": b"Image type: Greyscale image\r\n\x1a" + bytes(100),
        "\\n\\r line ends": b"Image type: Greyscale image\n\rImage size (x*y): 11*7\n\r\x1a" + pack_raw(g, "L", True),
    }
    for bits in (2, 3, 12, 24, 31):
        cases[f"L*{bits} (PIL's bit decoder)"] = im_bytes(f"L*{bits} image", w, h,
                                                          im_bits(rng.integers(0, 1 << bits, (h, w)), bits))
    cases["L*12 cut short"] = cases["L*12 (PIL's bit decoder)"][:-3]
    cases["L*5 of random bytes"] = im_bytes("L*5 image", w, h, rng.bytes(200))
    return cases


def imt_cases():
    g = grey(10)
    return {
        "L": imt_bytes(g),
        "a comment line": imt_bytes(g, [b"* made here", b"width 11", b"height 7", b"pixel n8"]),
        "no pixel line (no mode)": imt_bytes(g, [b"width 11", b"height 7"]),
        "pixel n16 (no mode)": imt_bytes(g, [b"width 11", b"height 7", b"pixel n16"]),
        "a width that is not a number": imt_bytes(g, [b"width x1", b"height 7", b"pixel n8"]),
        "an empty width": imt_bytes(g, [b"width ", b"height 7", b"pixel n8"]),
        "a line the pattern rejects first": imt_bytes(g, [b"Width 11", b"height 7", b"pixel n8"]),
        "no form feed": imt_bytes(g)[:-(77 + 1)] + imt_bytes(g)[-77:],
        "data cut short": imt_bytes(g)[:-4],
        "more data": imt_bytes(g) + bytes(9),
        "a long line": imt_bytes(g, [b"width 11", b"height 7", b"x" * 120, b"pixel n8"]),
        "no line feed in 100 bytes": b"width 11 height 7" + bytes(120),
        "a header past 100 bytes": imt_bytes(g, [b"* " + b"c" * 90, b"* " + b"d" * 60, b"width 11", b"height 7",
                                                 b"pixel n8"]),
    }


def mcidas_cases():
    g = grey(20)
    s16 = np.random.default_rng(21).integers(0, 65536, (7, 11))
    s32 = np.random.default_rng(22).integers(-2**31, 2**31, (7, 11))
    return {
        "8-bit": mcidas_bytes(g, 1),
        "16-bit": mcidas_bytes(s16, 2),
        "32-bit": mcidas_bytes(s32, 4),
        "8-bit, a row prefix": mcidas_bytes(g, 1, prefix=5),
        "16-bit, a row prefix": mcidas_bytes(s16, 2, prefix=3),
        "32-bit, a row prefix": mcidas_bytes(s32, 4, prefix=2),
        "8-bit, data at 300": mcidas_bytes(g, 1, offset=300),
        "8-bit, 2 bands in the stride": mcidas_bytes(np.concatenate([g, g], 1), 1, words={10: 11, 14: 2}),
        "8-bit, a stride below the row (mapped)": mcidas_bytes(g, 1, words={14: 0, 15: 3}),
        "32-bit, a stride below the row": mcidas_bytes(s32, 4, words={14: 0}),
        "8-bit, a stride past the end of the file (decoded)": mcidas_bytes(g, 1, words={14: 2}),
        "8-bit, cut short": mcidas_bytes(g, 1)[:-3],
        "a depth of 3": mcidas_bytes(g, 1, words={11: 3}),
        "a width of 0": mcidas_bytes(g, 1, words={10: 0}),
        "a directory cut short": mcidas_bytes(g, 1)[:200],
        "a negative offset": mcidas_bytes(g, 1, words={34: -300}),
    }


def pixar_cases():
    rgb = colour(30)
    return {
        "RGB": pixar_bytes(rgb),
        "more data": pixar_bytes(rgb) + bytes(10),
        "cut short": pixar_bytes(rgb)[:-6],
        "channels / depth (14, 1) (no mode)": pixar_bytes(rgb, 14, 1),
        "channels / depth (15, 2) (no mode)": pixar_bytes(rgb, 15, 2),
        "a height of 0": pixar_bytes(rgb[:0]),
        "a header cut short": pixar_bytes(rgb)[:420],
    }


def spider_cases():
    f = np.random.default_rng(40).normal(0, 50, (7, 11)).astype(np.float32)
    wide = np.random.default_rng(41).normal(0, 50, (3, 300)).astype(np.float32)
    return {
        "PIL's": pil_save(Image.fromarray(f), "SPIDER"),
        "big-endian": spider_bytes(f, big=True),
        "little-endian": spider_bytes(f),
        "a wide image (one header record)": spider_bytes(wide),
        "a stack": spider_bytes(f, stack=3),
        "a stack, big-endian": spider_bytes(f, big=True, stack=2),
        "an image of a stack alone (PIL: AttributeError)": spider_bytes(f, values={27: 1}),
        "inconsistent stack values": spider_bytes(f, values={24: -1}),
        "iform 3 (not 2-D)": spider_bytes(f, values={5: 3}),
        "iform 2 (not SPIDER)": spider_bytes(f, values={5: 2}),
        "labbyt not labrec x lenbyt": spider_bytes(f, values={22: 100}),
        "a stack number of NaN": spider_bytes(f, values={24: float("nan")}),
        "a width of 0": spider_bytes(f, values={12: 0}),
        "a width that is not an integer": spider_bytes(f, values={12: 2.5}),
        "cut short": spider_bytes(f)[:-8],
        "a header cut short": spider_bytes(f)[:100],
    }


def sun_cases():
    g, rgb = grey(50), colour(51)
    w, h = 11, 7
    rng = np.random.default_rng(52)
    idx = rng.integers(0, 40, (h, w)).astype(np.uint8)
    pal = rng.integers(0, 256, (40, 3))
    flat = np.full((h, w), 0x80, np.uint8)
    flat[2:4] = 7
    cases = {}
    for ftype, label in ((1, "raw"), (2, "RLE")):
        cases[f"1-bit, {label}"] = sun_bytes(w, h, 1, pack_raw(g > 128, "1"), ftype)
        cases[f"4-bit, {label}"] = sun_bytes(w, h, 4, pack_raw(g // 16, "P;4"), ftype)
        cases[f"8-bit, {label}"] = sun_bytes(w, h, 8, g, ftype)
        cases[f"8-bit palette, {label}"] = sun_bytes(w, h, 8, idx, ftype, palette=pal)
        cases[f"4-bit palette, {label}"] = sun_bytes(w, h, 4, pack_raw(idx % 16, "P;4"), ftype, palette=pal[:16])
        cases[f"24-bit BGR, {label}"] = sun_bytes(w, h, 24, pack_raw(rgb, "BGR"), ftype)
        cases[f"32-bit BGRX, {label}"] = sun_bytes(w, h, 32, pack_raw(rgb, "BGRX"), ftype)
        cases[f"runs and 0x80s, {label}"] = sun_bytes(w, h, 8, flat, ftype)
    cases.update({
        "24-bit RGB (type 3)": sun_bytes(w, h, 24, pack_raw(rgb, "RGB"), 3),
        "32-bit RGBX (type 3)": sun_bytes(w, h, 32, pack_raw(rgb, "RGBX"), 3),
        "type 0, 4 and 5 raw": sun_bytes(w, h, 8, g, 0),
        "type 4": sun_bytes(w, h, 8, g, 4),
        "type 5": sun_bytes(w, h, 8, g, 5),
        "type 6": sun_bytes(w, h, 8, g, 6),
        "depth 16": sun_bytes(w, h, 16, pack_raw(g, "L"), 1),
        "a palette on RGB (PIL: unrecognized mode)": sun_bytes(w, h, 24, pack_raw(rgb, "BGR"), 1, palette=pal),
        "a palette on 1-bit": sun_bytes(w, h, 1, pack_raw(g > 128, "1"), 1, palette=pal[:2]),
        "a palette of type 2": sun_bytes(w, h, 8, idx, 1, palette=pal, palette_type=2),
        "a palette of 2000 bytes": sun_bytes(w, h, 8, idx, 1, palette=np.zeros((667, 3))),
        "a runs stream cut short": sun_bytes(w, h, 8, g, 2)[:-2],
        "raw cut short": sun_bytes(w, h, 8, g, 1)[:-3],
        "a run across rows": sun_bytes(w, h, 8, np.full((h, w), 9), 2),
        "a width of 0": sun_bytes(0, h, 8, np.zeros((h, 0)), 1),
        "a header cut short": sun_bytes(w, h, 8, g)[:20],
    })
    body = bytearray(sun_bytes(w, h, 8, idx, 1, palette=pal))
    struct.pack_into(">I", body, 28, 100)  # a colour map of 100 bytes: 33 entries, one byte left over
    cases["a palette of 100 bytes"] = bytes(body)
    odd = bytearray(sun_bytes(3, h, 8, np.ones((h, 3)), 2))  # RLE rows padded as the format pads them
    cases["RLE of odd rows (PIL: unpadded)"] = bytes(odd)
    return cases


def msp_cases():
    g = grey(60, 19, 9) > 128
    n = (19 + 7) // 8
    raw = pack_raw(g, "1")
    rows = [msp_rle_row(raw[y * n:(y + 1) * n]) for y in range(9)]
    return {
        "PIL's version 1": pil_save(Image.fromarray(g), "MSP"),
        "version 2": msp_bytes(g),
        "version 2, a blank row": msp_bytes(g, rows=rows[:3] + [b""] + rows[4:]),
        "version 2, a long row": msp_bytes(g, rows=rows[:3] + [b"\x00\x09\xaa"] + rows[4:]),
        "version 2, a short row": msp_bytes(g, rows=[b"\x01\xff"] * 9),
        "version 2, a literal past the row": msp_bytes(g, rows=rows[:3] + [b"\x09\x01\x02"] + rows[4:]),
        "version 2, a run cut short": msp_bytes(g, rows=rows[:3] + [b"\x00\x09"] + rows[4:]),
        "version 2, a row cut short": msp_bytes(g)[:-2],
        "version 2, the row map cut short": msp_bytes(g)[:40],
        "version 1, cut short": msp_bytes(g, 1)[:-1],
        "a bad checksum": msp_bytes(g)[:24] + b"\1\0" + msp_bytes(g)[26:],
        "a width of 0": msp_bytes(g[:, :0]),
        "a header cut short": msp_bytes(g)[:20],
    }


def xbm_cases():
    g = grey(70, 13, 6) > 120
    base = xbm_bytes(g)
    return {
        "PIL's": pil_save(Image.fromarray(g), "XBM"),
        "PIL's with a hotspot": pil_save(Image.fromarray(g), "XBM", hotspot=(3, 4)),
        "16 to a line, other names": xbm_bytes(g, name=b"icon", per_line=16),
        "upper-case hex and odd separators": base.replace(b"0x", b"0X").replace(b"0X", b"0x", 3).replace(b",", b" ; "),
        "a digit that is not hex": base.replace(b"0x", b"0xg", 1),
        "data cut short": base[:-30],
        "leading blanks": b"   \n" + base,
        "ten leading blanks (PIL's 16-byte test fails)": b" " * 10 + base,
        "a width of 0": xbm_bytes(g[:, :0]),
        "no _bits[]": base.replace(b"_bits[]", b"_bytes[]"),
        "CRLF lines": base.replace(b"\n", b"\r\n"),
    }


def with_first_key(data: bytes, key: bytes) -> bytes:
    """An XPM file with its first pixel's key replaced."""
    at = data.index(b'/* pixels */\n"') + len(b'/* pixels */\n"')
    return data[:at] + key + data[at + len(key):]


def xpm_cases():
    rng = np.random.default_rng(80)
    w, h = 9, 5
    pal = rng.integers(0, 256, (12, 3))
    idx = rng.integers(0, 12, (h, w))
    big = rng.integers(0, 256, (300, 3))
    bidx = rng.integers(0, 300, (h, w))
    cases = {
        "P": xpm_bytes(idx, pal),
        "P, two-character keys": xpm_bytes(idx, pal, bpp=2),
        "P, a None colour unused": xpm_bytes(idx, pal, none_key=b"~"),
        "P, a None colour used (PIL: not in the palette)": with_first_key(xpm_bytes(idx, pal, none_key=b"~"), b"~"),
        "P, 256 colours": xpm_bytes(rng.integers(0, 256, (h, w)), rng.integers(0, 256, (256, 3)), bpp=2),
        "RGB, 300 colours": xpm_bytes(bidx, big, bpp=2),
        "RGB, a None colour": xpm_bytes(bidx, big, bpp=2, none_key=b"~~"),
        "no /* pixels */ line": xpm_bytes(idx, pal, pixels_comment=False),
        "a colour of another spec": xpm_bytes(idx, pal, colour_lines=[b'"%s c red",' % k for k in
                                                                     [bytes((35 + i,)) for i in range(12)]]),
        "a colour of bad hex": xpm_bytes(idx, pal).replace(b"c #", b"c #zz", 1),
        "a colour line without c": xpm_bytes(idx, pal).replace(b" c #", b" m #", 1),
        "a c key without a value": xpm_bytes(idx, pal).replace(b" c #", b" c", 1).replace(b'",\n"$', b' ",\n"$', 1),
        "a pixel key not among the colours": xpm_bytes(idx, pal).replace(b'"#', b'"!', 1),
        "rows cut short": xpm_bytes(idx, pal)[:-30],
        "a row longer than the width": xpm_bytes(idx, pal).replace(b'",\n};', b'##",\n};'),
        "no header line": b"/* XPM */\nstatic char *x[] = {\n",
        "a header of empty fields": b'/* XPM */\n"   "\n',
        "a width of 0": xpm_bytes(idx[:, :0], pal),
        "a key width of 0": xpm_bytes(idx, pal).replace(b'"9 5 12 1"', b'"9 5 12 0"'),
        "duplicate keys": xpm_bytes(idx, pal).replace(b'"$ c', b'"# c', 1),
    }
    return cases


def xv_cases():
    idx = np.random.default_rng(90).integers(0, 256, (7, 11)).astype(np.uint8)
    return {
        "XV thumbnail": xv_bytes(idx),
        "no comments": xv_bytes(idx, comments=()),
        "a size line of one word": xv_bytes(idx, size_line=b"11"),
        "a size that is not a number": xv_bytes(idx, size_line=b"11 x 255"),
        "a size of 0": xv_bytes(idx, size_line=b"0 7 255"),
        "ends in its comments": b"P7 332\n#XVVERSION\n#END",
        "cut short": xv_bytes(idx)[:-3],
        "P7 (PAM) refused": b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n" + bytes(6),
        "PF (colour PFM) refused": b"PF\n3 2\n-1.0\n" + bytes(72),
    }


def pcd_picture(seed=100):
    rgb = smooth(512, 768, 3, seed)
    return pcd_ycc(rgb)


def pcd_cases():
    y, c1, c2 = pcd_picture()
    rng = np.random.default_rng(101)
    ry, rc1, rc2 = (rng.integers(0, 256, s).astype(np.uint8) for s in ((512, 768), (256, 384), (256, 384)))
    return {
        "base image": pcd_bytes(y, c1, c2),
        "random samples": pcd_bytes(ry, rc1, rc2),
        "orientation 1 (90 degrees)": pcd_bytes(y, c1, c2, orientation=1),
        "orientation 2": pcd_bytes(y, c1, c2, orientation=2),
        "orientation 3 (270 degrees)": pcd_bytes(y, c1, c2, orientation=3),
        "orientation byte 0xFD": pcd_bytes(y, c1, c2, orientation=0xFD),
        "cut short": pcd_bytes(y, c1, c2, cut=96 * 2048 + 2304 * 100 + 7),
        "a header cut short": pcd_bytes(y, c1, c2, cut=2048 + 1000),
        "no PCD_": pcd_bytes(y, c1, c2)[:2048] + b"PCX_" + pcd_bytes(y, c1, c2)[2052:],
    }


def iptc_cases():
    g = grey(110, 11, 7)
    w, h = 11, 7
    jpeg_grey = pil_save(Image.fromarray(g), "JPEG", quality=90)
    jpeg_rgb = pil_save(Image.fromarray(colour(111)), "JPEG", quality=90)
    return {
        "raw L": iptc_bytes(w, h, g.tobytes()),
        "raw L in three fields": iptc_bytes(w, h, g.tobytes(), pieces=3),
        "raw L, an extended length": iptc_bytes(w, h, b"")[:-5] + iptc_field(8, 10, g.tobytes(), extended=True),
        "JPEG L": iptc_bytes(w, h, jpeg_grey, compression=5),
        "raw RGB, band 1": iptc_bytes(w, h, g.tobytes(), 3, 1),
        "raw RGB, band 3": iptc_bytes(w, h, g.tobytes(), 3, 1, band=3),
        "raw RGB, band 0 (PIL's -1: the last)": iptc_bytes(w, h, g.tobytes(), 3, 1, band=0),
        "raw RGB, band 4 (past the bands)": iptc_bytes(w, h, g.tobytes(), 3, 1, band=4),
        "raw CMYK, band 2": iptc_bytes(w, h, g.tobytes(), 4, 1, band=2),
        "JPEG RGB data for a band (PIL: wrong mode)": iptc_bytes(w, h, jpeg_rgb, 3, 1, 5),
        "JPEG RGB data for band 2 (PIL: mode mismatch)": iptc_bytes(w, h, jpeg_rgb, 3, 1, 5, band=2),
        "two layers (no mode)": iptc_bytes(w, h, g.tobytes(), 2, 1),
        "compression 2": iptc_bytes(w, h, g.tobytes(), compression=2),
        "no compression field": iptc_bytes(w, h, g.tobytes()).replace(iptc_field(3, 120, b"\1"), b""),
        "no size field": iptc_bytes(w, h, g.tobytes()).replace(iptc_field(3, 20, struct.pack(">H", w)), b""),
        "no (3, 60) field": iptc_bytes(w, h, g.tobytes()).replace(iptc_field(3, 60, b"\1\0"), b""),
        "a repeated (3, 60) field": iptc_field(3, 60, b"\1\0") + iptc_bytes(w, h, g.tobytes()),
        "a zero-length (3, 20) field": iptc_bytes(w, h, g.tobytes()).replace(iptc_field(3, 20, struct.pack(">H", w)),
                                                                           iptc_field(3, 20, b"")),
        "no image data": iptc_bytes(w, h, g.tobytes())[:-(5 + w * h)],
        "raw data cut short": iptc_bytes(w, h, g.tobytes())[:-5],
        "a field length over 132": iptc_bytes(w, h, g.tobytes()).replace(b"\x1c\x03\x78\x00\x01",
                                                                          b"\x1c\x03\x78\x90\x01"),
        "a field length of 128": iptc_bytes(w, h, g.tobytes()).replace(b"\x1c\x02\x00\x00\x02\x00\x02",
                                                                        b"\x1c\x02\x00\x80\x00\x02"),
        "an unknown record": b"\x1c\x0a\x00\x00\x01\x00" + iptc_bytes(w, h, g.tobytes()),
        "a field cut short": b"\x1c\x02\x00",
        "the data's field length over 132": iptc_bytes(w, h, g.tobytes())[:-(5 + w * h)] + b"\x1c\x08\x0a\x90" +
        bytes(80),
        "a width of 0": iptc_bytes(0, h, g.tobytes()),
    }


def refused_cases():
    return {
        "MPEG": mpeg_bytes(352, 240),
        "MPEG of width 0": mpeg_bytes(0, 240),
        "MPEG cut short": mpeg_bytes(352, 240)[:6],
        "placeable WMF": wmf_bytes(),
        "placeable WMF of 0 units per inch": wmf_bytes(inch=0),
        "placeable WMF without the metafile header": wmf_bytes(standard=False),
        "placeable WMF of an empty box": wmf_bytes(bbox=(10, 10, 10, 50)),
        "EMF": emf_bytes(),
        "EMF of a frame without width": emf_bytes(frame=(5, 0, 5, 100)),
        "01 00 00 00 without EMF": emf_bytes()[:40] + b"XEMF" + emf_bytes()[44:],
        "EMF of an empty box": emf_bytes(bounds=(0, 0, -5, 10)),
    }


FORMS = {"IM": im_cases, "IMT": imt_cases, "MCIDAS": mcidas_cases, "PIXAR": pixar_cases, "SPIDER": spider_cases,
         "SUN": sun_cases, "MSP": msp_cases, "XBM": xbm_cases, "XPM": xpm_cases, "XV": xv_cases, "PCD": pcd_cases,
         "IPTC": iptc_cases, "refused": refused_cases}
CASES = [(form, case) for form, make in FORMS.items() for case in make()]


@pytest.mark.parametrize("form,case", CASES, ids=[f"{f}: {c}" for f, c in CASES])
def test_form_reads_as_pil_reads_it(tmp_path, cxx, form, case):
    """Each form and branch: PIL's mode, pixels and RGBA, or a raise where
    PIL raises; a file PIL passes on goes on to the later readers."""
    follows_pil(tmp_path, FORMS[form]()[case], f"{form}: {case}")


def test_the_branches_are_covered():
    """The cases reach every IM image type of PIL's table that loads (and
    some that do not), SUN's every depth and both codings, MSP's two
    versions, both XPM modes and every PhotoCD orientation."""
    types = {line.split(b": ", 1)[1].decode() for data in im_cases().values()
             for line in data.split(b"\x1a")[0].replace(b"\0", b"").split(b"\r\n") if line.startswith(b"Image type")}
    loads = {t for t, (mode, raw) in im.OPEN.items() if raw not in ("RLB",) and not raw.startswith("PA")}
    assert {"Greyscale image", "RGB image", "YCC image", "RGBA image", "CMYK image", "LA image", "L 16L image",
            "L 16B image", "L 32S image", "L 32 F image", "B2 image", "B4 image", "RGB3 image", "RYB3 image",
            "X 24 image", "RGBX image"} <= types
    assert len(types & loads) >= 25
    sun_kinds = {struct.unpack_from(">I", d, 12)[0] * 10 + struct.unpack_from(">I", d, 20)[0]
                 for d in sun_cases().values() if len(d) >= 32}
    assert {11, 12, 41, 42, 81, 82, 241, 242, 243, 321, 322, 323} <= sun_kinds
    assert {d[:4] for d in msp_cases().values()} >= {b"DanM", b"LinS"}
    assert {d[2048 + 1538] & 3 for d in pcd_cases().values() if len(d) > 3586} == {0, 1, 2, 3}


# ---- the compiled loops against their plain versions ----

def test_sun_rle_compiled_equals_plain(cxx):
    """`gs_sun_rle_decode` against `sun.plain_rle` on seeded streams of
    runs, literal 0x80s and plain bytes, rows of 1-40 bytes, cut short too."""
    rng = np.random.default_rng(200)
    for t in range(400):
        parts = []
        for _ in range(int(rng.integers(1, 60))):
            r = rng.random()
            if r < 0.3:
                parts += [0x80, int(rng.integers(1, 256)), int(rng.integers(0, 256))]
            elif r < 0.4:
                parts += [0x80, 0]
            else:
                parts.append(int(rng.integers(0, 256)))
        data = bytes(parts)[:int(rng.integers(1, len(parts) + 1))]
        row, rows = int(rng.integers(1, 41)), int(rng.integers(1, 6))
        got, want = image_codecs.sun_rle_decode(data, 0, row, rows, "t"), sun.plain_rle(data, 0, row, rows)
        assert (got is None) == (want is None), t
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=str(t))


def test_msp_compiled_equals_plain(cxx):
    """`gs_msp_decode` against `msp.plain_decode` on seeded row maps and
    runs: blank rows, long and short rows, runs and literals cut short."""
    rng = np.random.default_rng(201)
    for t in range(300):
        h, w = int(rng.integers(1, 9)), int(rng.integers(1, 40))
        rows = []
        for _ in range(h):
            n = int(rng.integers(0, 12))
            rows.append(bytes(rng.integers(0, 4 if rng.random() < 0.5 else 256, n).astype(np.uint8)))
        data = msp_bytes(np.zeros((h, w), bool), rows=rows)
        data = data[:int(rng.integers(32, len(data) + 1))] if rng.random() < 0.3 else data
        need = (w + 7) // 8 * h
        outcomes = []
        for fn in (lambda: image_codecs.msp_decode(data, h, need, w, "t"),
                   lambda: msp.plain_decode(data, h, need, "t")):
            try:
                outcomes.append(fn())
            except ValueError:
                outcomes.append("raises")
        assert outcomes[0] == outcomes[1], t


def test_xbm_compiled_equals_plain(cxx):
    """`gs_xbm_decode` against `xbm.plain_decode` on seeded text of hex
    pairs, odd separators and characters that are not hex digits."""
    rng = np.random.default_rng(202)
    alphabet = list(b"0x123456789abcdefABCDEFgz, \n\t}")
    for t in range(400):
        text = bytes(rng.choice(alphabet, int(rng.integers(0, 120))).astype(np.uint8))
        row, rows = int(rng.integers(1, 4)), int(rng.integers(1, 5))
        got, want = image_codecs.xbm_decode(text, row, rows, "t"), xbm.plain_decode(text, row, rows)
        assert (got is None) == (want is None), t
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=str(t))


def test_pcd_compiled_equals_plain(cxx):
    """`gs_pcd_decode` against `pcd.plain_decode` on random samples: every
    luma and chroma value through the tables."""
    body = np.random.default_rng(203).integers(0, 256, 3 * 768 * 256).astype(np.uint8).tobytes()
    np.testing.assert_array_equal(image_codecs.pcd_decode(body, 768, 512, "t"), pcd.plain_decode(body))


def test_pcd_tables_are_pils_over_every_input():
    """PIL's "YCC;P" unpacker on every (Y, C1, C2) equals `pcd.ycc_to_rgb`."""
    v = np.arange(1 << 24, dtype=np.uint32)
    ycc = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    pil = np.asarray(Image.frombytes("RGB", (4096, 4096), ycc.tobytes(), "raw", "YCC;P")).reshape(-1, 3)
    np.testing.assert_array_equal(pcd.ycc_to_rgb(ycc[:, 0], ycc[:, 1], ycc[:, 2]), pil)


def test_im_bits_compiled_equals_plain(cxx):
    """`gs_im_bit_decode` against `im.plain_bits` at every bit count PIL's
    bit decoder reads for IM, on random bytes."""
    rng = np.random.default_rng(204)
    for bits in range(2, 32):
        if bits in (8, 16):
            continue
        w, h = int(rng.integers(1, 9)), int(rng.integers(1, 5))
        data = rng.bytes(h * ((w * bits + 7) // 8))
        np.testing.assert_array_equal(image_codecs.im_bit_decode(data, bits, w, h, "t"),
                                      im.plain_bits(data, bits, w, h), err_msg=str(bits))


@pytest.mark.parametrize("form", ["SUN", "MSP", "XBM", "PCD", "IM"])
def test_plain_reader_equals_compiled(tmp_path, cxx, form):
    """Each reader with its plain loop (`plain=True`) gives the compiled
    reading on the form's cases PIL reads."""
    decode = {"SUN": sun.decode_sun, "MSP": msp.decode_msp, "XBM": xbm.decode_xbm, "PCD": pcd.decode_pcd,
              "IM": im.decode_im}[form]
    read = 0
    for case, data in FORMS[form]().items():
        try:
            want = decode(data, case)
        except ValueError:
            continue
        got = decode(data, case, plain=True)
        assert got.mode == want.mode and got.pixels.tobytes() == want.pixels.tobytes(), case
        read += 1
    assert read >= 3


# ---- XV thumbnails through the PPM reader's magics ----

def test_xv_thumbnail_passes_the_ppm_reader(tmp_path, cxx):
    """`P7 332` reads as PIL's XVThumb ("P", the 3-3-2 palette) through
    open_image; a PAM `P7` and a colour `PF` are still refused, naming
    what they are."""
    idx = np.arange(77, dtype=np.uint8).reshape(7, 11) * 3
    got = follows_pil(tmp_path, xv_bytes(idx), "XV")
    assert got.mode == "P" and got.palette.shape == (256, 3)
    for data, what in ((xv_cases()["P7 (PAM) refused"], r"PAM file \(P7\)"),
                       (xv_cases()["PF (colour PFM) refused"], r"colour PFM file \(PF\)")):
        path = tmp_path / "v.pnm"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=what):
            image_io.open_image(path)


# ---- YCbCr ----

def test_ycbcr_to_rgba_is_pils_over_every_triple():
    """`to_rgba` of a "YCbCr" picture equals PIL's convert("RGBA") on all
    2^24 (Y, Cb, Cr)."""
    v = np.arange(1 << 24, dtype=np.uint32)
    ycc = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    want = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGBA"))
    np.testing.assert_array_equal(image_io.to_rgba(image_io.Picture(ycc, "YCbCr")), want)
    assert tuple(ycbcr.ycbcr_to_rgb(np.array([128, 0, 255], np.uint8))) == (255, 81, 0)


# ---- mutations ----

def mutants(form, n, seed):
    """`n` seeded mutations of a file of `form`: bytes set or flipped past
    the first `start`, sometimes cut short."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w, h = int(rng.integers(1, 14)), int(rng.integers(1, 9))
        px = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        g = px[..., 0]
        if form == "IM":
            kind, raw = [("Greyscale image", "L"), ("RGB image", "RGB;L"), ("YCC image", "YCbCr;L"),
                         ("L 16L image", "I;16L"), ("B4 image", "P;4")][int(rng.integers(0, 5))]
            src = {"L": g, "RGB;L": px, "YCbCr;L": px, "I;16L": g.astype(np.int64) * 257, "P;4": g % 16}[raw]
            data, start = im_bytes(kind, w, h, pack_raw(src, raw, True), pad=False), 0
        elif form == "IMT":
            data, start = imt_bytes(g), 0
        elif form == "MCIDAS":
            data, start = mcidas_bytes(g, int(rng.choice([1, 2, 4])), prefix=int(rng.integers(0, 3))), 8
        elif form == "PIXAR":
            data, start = pixar_bytes(px), 4
        elif form == "SPIDER":
            data, start = spider_bytes(px[..., 0].astype(np.float32), big=bool(rng.random() < 0.5)), 0
        elif form == "SUN":
            depth = int(rng.choice([1, 8, 24]))
            rows = {1: pack_raw(g > 128, "1"), 8: g, 24: pack_raw(px, "BGR")}[depth]
            data, start = sun_bytes(w, h, depth, rows, int(rng.choice([1, 2]))), 4
        elif form == "MSP":
            data, start = msp_bytes(g > 128, int(rng.choice([1, 2]))), 4
        elif form == "XBM":
            data, start = xbm_bytes(g > 128), 0
        elif form == "XPM":
            data, start = xpm_bytes(g % 5, rng.integers(0, 256, (5, 3))), 9
        elif form == "XV":
            data, start = xv_bytes(g), 6
        elif form == "PCD":
            data, start = pcd_bytes(*pcd_picture(int(rng.integers(0, 4)))), 0
        else:  # IPTC
            data, start = iptc_bytes(w, h, g.tobytes(), *([3, 1] if rng.random() < 0.3 else [1, 0])), 0
        d = bytearray(data)
        hi = len(d) if form != "PCD" else 96 * 2048 + 2304 * 4
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(start, hi)) if form != "PCD" or rng.random() < 0.5 else 2048 + int(rng.integers(0, 4))
            d[i] = int(rng.integers(0, 256)) if rng.random() < 0.7 else d[i] ^ (1 << int(rng.integers(0, 8)))
        if rng.random() < 0.2:
            d = d[:int(rng.integers(start, len(d)))]
        out.append(bytes(d))
    return out


MUTATED = ["IM", "IMT", "MCIDAS", "PIXAR", "SPIDER", "SUN", "MSP", "XBM", "XPM", "XV", "PCD", "IPTC"]


@pytest.mark.parametrize("form", MUTATED)
def test_mutated_files_read_as_pil_reads_them(tmp_path, cxx, form):
    """Seeded mutations: PIL's mode, pixels and RGBA, or a raise where PIL
    raises; a file PIL's plugin passes on reaches the next reader."""
    for i, data in enumerate(mutants(form, 12 if form == "PCD" else 50, 300 + len(form))):
        follows_pil(tmp_path, data, f"{form} mutant {i}")


# ---- no fallback ----

def test_failed_codec_build_raises_naming_the_source(tmp_path, fake_cxx):
    """SUN's RLE, MSP v2, XBM, PhotoCD and IM's bit-packed floats cannot
    be read without their compiled loops: each read raises naming the
    source and the file; the raw forms need no build."""
    fake_cxx(fail=True)
    g = grey(210, 16, 8)
    y, c1, c2 = pcd_picture()
    needs = {"v.ras": sun_bytes(16, 8, 8, g, 2), "v.msp": msp_bytes(g > 100), "v.xbm": xbm_bytes(g > 100),
             "v.pcd": pcd_bytes(y, c1, c2), "v.im": im_bytes("L*12 image", 16, 8, im_bits(g, 12))}
    for name, data in needs.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(RuntimeError, match="csrc/image_codecs.cc") as err:
            image_io.open_image(path)
        assert str(path) in str(err.value)
    free = {"w.im": im_bytes("Greyscale image", 16, 8, pack_raw(g, "L", True)), "w.imt": imt_bytes(g),
            "w.ras": sun_bytes(16, 8, 8, g, 1), "w.pxr": pixar_bytes(colour(211, 16, 8))}
    for name, data in free.items():
        path = tmp_path / name
        path.write_bytes(data)
        assert image_io.open_image(path).pixels.shape[:2] == (8, 16)


# ---- the writers against PIL's own files ----

def test_writers_match_pils_files():
    """Where PIL writes the form, the numpy writers write its bytes: IM
    (grey, RGB, YCbCr), MSP version 1, SPIDER and XBM (a hotspot too)."""
    g, rgb = grey(220, 19, 9), colour(221, 19, 9)
    assert pil_save(Image.fromarray(g), "IM") == im_bytes("Greyscale image", 19, 9, pack_raw(g, "L", True))
    assert pil_save(Image.fromarray(rgb), "IM") == im_bytes("RGB image", 19, 9, pack_raw(rgb, "RGB;L", True))
    assert pil_save(Image.fromarray(rgb, "YCbCr"), "IM") == im_bytes("YCC image", 19, 9,
                                                                     pack_raw(rgb, "YCbCr;L", True))
    assert pil_save(Image.fromarray(g > 128), "MSP") == msp_bytes(g > 128, 1)
    f = (g.astype(np.float32) - 100) / 7
    assert pil_save(Image.fromarray(f), "SPIDER") == spider_bytes(f)
    assert pil_save(Image.fromarray(g > 90), "XBM", hotspot=(2, 5)) == xbm_bytes(g > 90, (2, 5))


# ---- phase 5p's files ----

def _json():
    with open(os.path.join(FIXTURES, "sha256.json")) as f:
        return json.load(f)


def test_chip_smoke_forms_read_as_the_json_says(tmp_path, cxx):
    """Phase 5p's files, written again here by chip_smoke.py's
    `pil_rest_files`, are the bytes whose PIL reading sha256.json holds,
    and the port reads each as PIL did."""
    readings = _json()["chip_smoke"]
    made = pil_rest_files()
    assert sorted(made) == sorted(readings)
    for name, data in made.items():
        want = readings[name]
        assert hashlib.sha256(data).hexdigest() == want["file_sha256"], name
        path = tmp_path / "form"
        path.write_bytes(data)
        pic = image_io.open_image(path)
        assert (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels)) == \
            (want["mode"], want["shape"], want["sha256"]), name


# ---- both dataset paths against the JAX package ----

def colmap_views(w, h):
    """Views whose loaded pixels are the picture: RGB and L."""
    a = smooth(h, w, 3, 230)
    g = a[..., 0]
    return {
        "v_im_rgb.im": im_bytes("RGB image", w, h, pack_raw(a, "RGB;L", True)),
        "v_im_grey.im": im_bytes("Greyscale image", w, h, pack_raw(g, "L", True)),
        "v_imt.imt": imt_bytes(g),
        "v_mcidas.area": mcidas_bytes(g, 1, prefix=2),
        "v_pixar.pxr": pixar_bytes(a),
        "v_sun_bgr.ras": sun_bytes(w, h, 24, pack_raw(a, "BGR"), 1),
        "v_sun_rle.ras": sun_bytes(w, h, 24, pack_raw(a, "BGR"), 2),
        "v_sun_grey.ras": sun_bytes(w, h, 8, g, 2),
        "v_xpm_rgb.xpm": xpm_bytes(np.arange(w * h).reshape(h, w) % 300,
                                   np.random.default_rng(231).integers(0, 256, (300, 3)), bpp=2),
        "v_iptc.iim": iptc_bytes(w, h, g.tobytes()),
    }


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_pil_rest_views_match_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of views in the new forms: the Scene's cameras
    equal the JAX package's, images bit for bit."""
    from test_torch_scene import both_scenes

    w, h = 16, 12
    src = str(tmp_path / "forms")
    views = colmap_views(w, h)
    write_colmap_dataset_of(src, views, w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == len(views)
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


def refused_views():
    g = grey(240, 13, 11)
    rng = np.random.default_rng(241)
    s16 = rng.integers(0, 65536, (11, 13))
    return {
        "XBM (1)": ("view.xbm", xbm_bytes(g > 128), "1"),
        "MSP (1)": ("view.msp", msp_bytes(g > 128), "1"),
        "XPM (P)": ("view.xpm", xpm_bytes(g % 7, rng.integers(0, 256, (7, 3))), "P"),
        "XV thumbnail (P)": ("view.xv", xv_bytes(g), "P"),
        "IM colour LUT (P)": ("view.im", im_bytes("Greyscale image", 13, 11, pack_raw(g, "L", True),
                                                  lut=ramp_lut(True)), "P"),
        "SPIDER (F)": ("view.spi", spider_bytes(g.astype(np.float32)), "F"),
        "IM YCC (YCbCr)": ("view.im", im_bytes("YCC image", 13, 11, pack_raw(colour(242, 13, 11), "YCbCr;L", True)),
                           "YCbCr"),
        "IM L 16L (I;16L)": ("view.im", im_bytes("L 16L image", 13, 11, pack_raw(s16, "I;16L", True)), "I;16L"),
        "McIDAS 16-bit (I;16B)": ("view.area", mcidas_bytes(s16, 2), "I;16B"),
    }


@pytest.mark.parametrize("form", list(refused_views()))
def test_colmap_refuses_modes_that_are_not_the_picture(tmp_path, cxx, form):
    """The JAX package's COLMAP path trains on np.asarray of these (0 / 1,
    palette indices, floats, Y / Cb / Cr, 16-bit integers): the port
    refuses each through load_camera, naming the file and the mode."""
    name, data, mode = refused_views()[form]
    src = str(tmp_path / "data")
    write_colmap_dataset_of(src, {name: data}, 13, 11)
    assert Image.open(os.path.join(src, "images", name)).mode == mode
    info = dataset_readers.read_colmap_scene(src, None, eval_split=False)
    with pytest.raises(ValueError, match=rf"'{name}' in .*images\.bin: .*{name}: .*\(mode {mode}\)"):
        dataset_readers.load_camera(info.train_cameras[0], 1)


def blender_frames(w, h):
    """Frames (named .png, as the transforms file names them) in each new
    form and mode: PIL's convert("RGBA") is what the Blender path reads."""
    rng = np.random.default_rng(250)
    a, rgba = smooth(h, w, 3, 251), smooth(h, w, 4, 252)
    g = a[..., 0]
    s16 = rng.integers(0, 1000, (h, w))
    y, c1, c2 = (rng.integers(0, 256, s).astype(np.uint8) for s in ((512, 768), (256, 384), (256, 384)))
    return [
        im_bytes("RGBA image", w, h, pack_raw(rgba, "RGBA;L", True)),
        im_bytes("YCC image", w, h, pack_raw(a, "YCbCr;L", True)),
        im_bytes("LA image", w, h, pack_raw(rgba[..., :2], "LA;L", True), lut=ramp_lut(True)),
        im_bytes("CMYK image", w, h, pack_raw(rgba, "CMYK;L", True)),
        im_bytes("L 16L image", w, h, pack_raw(s16, "I;16L", True)),
        im_bytes("L*12 image", w, h, im_bits(s16, 12)),
        imt_bytes(g),
        mcidas_bytes(s16, 2),
        spider_bytes(s16.astype(np.float32) / 3 - 20),
        sun_bytes(w, h, 8, g % 40, 2, palette=rng.integers(0, 256, (40, 3))),
        sun_bytes(w, h, 1, pack_raw(g > 128, "1"), 1),
        msp_bytes(g > 128),
        xbm_bytes(g > 100),
        xpm_bytes(g % 9, rng.integers(0, 256, (9, 3)), none_key=b"~"),
        xv_bytes(g),
        iptc_bytes(w, h, g.tobytes(), 3, 1, band=2),
        pcd_bytes(y, c1, c2),
    ]


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_pil_rest_frames_match_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on frames in every new form: PIL's
    convert("RGBA") through the composite, bit for bit, then load_camera at
    -r 2 (the PhotoCD frame 768x512, the others 16x12)."""
    w, h = 16, 12
    frames = blender_frames(w, h)
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
