"""The port's BLP, FITS, FLI / FLC, FTEX, GBR, ICNS and EPS readers, and its
refusal of BUFR, GRIB and HDF5, against PIL 12.1.0; both dataset paths on
views in those forms against the JAX package.

Every file is made here from `np.random.default_rng(seed)` (small sizes)
by PIL where PIL writes the form (BLP from mode "P", ICNS, JPEG and JPEG
2000 entries), else by `tests/torch_image_writers.py`. PIL's reading of it,
by its path and loaded (as both dataset paths load an image before they
read its pixels), is the rule: `image_io.open_image` gives PIL's mode and
pixels, `to_rgba` its `convert("RGBA")`, bit for bit, and where PIL raises
the port raises a `ValueError` naming the file.
"""

import hashlib
import io
import json
import os
import shutil
import stat
import struct
import sys

import numpy as np
import pytest
from PIL import EpsImagePlugin, Image

from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import blp, eps, fli, icns, image_io
from test_torch_image_forms import cxx, smooth, write_colmap_dataset_of  # noqa: F401  (cxx: a fixture)
from test_torch_jpeg import encode_jpeg, fake_cxx  # noqa: F401  (fake_cxx: a fixture)
from test_torch_scene import assert_same_cameras, orbit_frames
from torch_image_writers import (bc1_blocks, bc2_blocks, bc3_blocks, blp1_bytes, blp2_bytes, eps_bytes, fits_bytes,
                                 fits_card, fits_gzip_bytes, fits_unit, fli_brun, fli_bytes, fli_chunk, fli_frame,
                                 fli_lc, fli_palette, fli_ss2, ftex_bytes, gbr_bytes, icns_bytes, icns_rgb, png_bytes)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import rare_form_files, sha256_of  # noqa: E402  (the repo root: phase 5o's files)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_rare_forms")


def pil_reading(path):
    """(mode, pixels with a channel axis, convert("RGBA") or the error it
    raised) of PIL's loaded image of `path`."""
    with Image.open(path) as im:
        im.load()
        a = np.asarray(im)
        try:
            rgba = np.asarray(im.convert("RGBA"))
        except Exception as err:  # noqa: BLE001  (PIL's conversion error: to_rgba must raise too)
            rgba = err
        return im.mode, a[..., None] if a.ndim == 2 else a, rgba


def follows_pil(tmp_path, data: bytes, label=""):
    """The port reads `data` as PIL reads the file (mode, pixels with their
    dtype and shape, convert("RGBA")) and returns the `Picture`, or raises
    naming the file where PIL raises and returns None."""
    path = tmp_path / "form.img"
    path.write_bytes(data)
    try:
        want = pil_reading(path)
    except Exception:  # noqa: BLE001  (any of PIL's errors: the port must raise too)
        with pytest.raises(ValueError) as err:
            image_io.open_image(path)
        assert not isinstance(err.value, image_io.NotThisFormat), label
        assert str(path) in str(err.value), label
        return None
    got = image_io.open_image(path)
    assert (got.mode, got.pixels.dtype, got.pixels.shape) == (want[0], want[1].dtype, want[1].shape), label
    if want[1].dtype == bool:  # PIL's "1" array holds 255 in its bytes
        np.testing.assert_array_equal(got.pixels, want[1], err_msg=label)
    else:  # bit for bit, NaN included
        assert got.pixels.tobytes() == want[1].tobytes(), label
    if isinstance(want[2], Exception):
        with pytest.raises(ValueError):
            image_io.to_rgba(got)
    else:
        np.testing.assert_array_equal(image_io.to_rgba(got), want[2], err_msg=label)
    return got


def pil_save(im, fmt, **options) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **options)
    return buf.getvalue()


def picture(seed=0, w=23, h=17, c=3):
    return smooth(h, w, c, seed)


# ---- the forms and their branches ----

def blp_cases():
    a = picture(1, 16, 12)
    jpg = pil_save(Image.fromarray(a), "JPEG", quality=90)
    grey = pil_save(Image.fromarray(a[..., 0]), "JPEG", quality=90)
    cmyk = np.concatenate([a, a[..., :1]], -1)
    rng = np.random.default_rng(2)
    pal = rng.integers(0, 256, (256, 4)).astype(np.uint8)
    idx = rng.integers(0, 256, 9 * 7).astype(np.uint8).tobytes()
    cases = {
        "BLP1 JPEG": blp1_bytes(16, 12, 0, jpeg=jpg),
        "BLP1 JPEG, alpha flagged": blp1_bytes(16, 12, 0, alpha=8, jpeg=jpg),
        "BLP1 JPEG, the BLP narrower (PIL's stream at its width)": blp1_bytes(13, 12, 0, jpeg=jpg),
        "BLP1 JPEG, the BLP larger than the JPEG": blp1_bytes(16, 13, 0, jpeg=jpg),
        "BLP1 JPEG, grey": blp1_bytes(16, 12, 0, alpha=1, jpeg=grey),
        "BLP1 JPEG, CMYK": blp1_bytes(16, 12, 0, jpeg=encode_jpeg(cmyk, 90, (1, 1), adobe=0)),
        "BLP1 JPEG, CMYK without Adobe": blp1_bytes(16, 12, 0, jpeg=encode_jpeg(cmyk, 90, (1, 1))),
        "BLP1 JPEG, YCCK (read as CMYK)": blp1_bytes(16, 12, 0, jpeg=encode_jpeg(cmyk, 90, (2, 2), adobe=2)),
        "BLP1 JPEG, an 8-byte shared header": blp1_bytes(16, 12, 0, jpeg=jpg, header_size=8),
        "BLP1 JPEG, mipmap 0 after a gap": blp1_bytes(16, 12, 0, jpeg=jpg, offsets=[len(jpg) + 600] + [0] * 15,
                                                     lengths=[0] * 16)[:-len(jpg)],
        "BLP1 JPEG, mipmap 0 cut short": blp1_bytes(16, 12, 0, jpeg=jpg)[:-40],
        "BLP1 JPEG, no JPEG": blp1_bytes(16, 12, 0, jpeg=b"\xff\xda\0\2" + bytes(30)),
        "BLP1 palette, encoding 5": blp1_bytes(9, 7, 1, encoding=5, palette=pal, indices=idx),
        "BLP1 palette, encoding 4, alpha": blp1_bytes(9, 7, 1, alpha=8, encoding=4, palette=pal, indices=idx),
        "BLP1 palette, more indices than pixels": blp1_bytes(5, 7, 1, palette=pal, indices=idx),
        "BLP1 palette, too few indices": blp1_bytes(9, 8, 1, palette=pal, indices=idx),
        "BLP1 palette, encoding 3": blp1_bytes(9, 7, 1, encoding=3, palette=pal, indices=idx),
        "BLP1 compression 2": blp1_bytes(9, 7, 2, palette=pal, indices=idx),
        "BLP1 palette cut short": blp1_bytes(9, 7, 1, palette=pal, indices=idx)[:600],
        "BLP2 palette": blp2_bytes(9, 7, idx, palette=pal),
        "BLP2 palette, alpha": blp2_bytes(9, 7, idx, alpha_depth=8, palette=pal),
        "BLP2 palette, raw BGRA encoding 3": blp2_bytes(9, 7, idx, encoding=3, palette=pal),
        "BLP2 JPEG compression 0": blp2_bytes(9, 7, idx, compression=0, palette=pal),
        "BLP2 DXT, alpha encoding 8": blp2_bytes(8, 8, bytes(64), encoding=2, alpha_depth=8, alpha_encoding=8),
        "BLP2 tables cut short": blp2_bytes(9, 7, idx, palette=pal)[:100],
        "BLP2 header cut short": b"BLP2\1\0\0\0\1",
        "BLP2 of width 0": blp2_bytes(0, 7, idx, palette=pal),
    }
    for w, h in ((16, 12), (9, 7), (1, 5), (6, 4)):
        px = smooth(h, w, 4, w)
        px[..., 3] = np.where(px[..., 3] > 128, 255, 0)
        for kind, blocks, ae in ((1, bc1_blocks(px[..., :3]), 0), (3, bc2_blocks(px), 1), (5, bc3_blocks(px), 7)):
            for depth in (0, 8):
                cases[f"BLP2 DXT{kind} {w}x{h}, alpha depth {depth}"] = blp2_bytes(
                    w, h, blocks.tobytes(), encoding=2, alpha_depth=depth, alpha_encoding=ae)
    random_blocks = np.random.default_rng(3).integers(0, 256, 16 * 9, dtype=np.uint8).tobytes()
    for kind, ae in ((1, 0), (3, 1), (5, 7)):  # every 5:6:5 order and alpha code
        cases[f"BLP2 DXT{kind} of random blocks"] = blp2_bytes(12, 12, random_blocks, encoding=2, alpha_depth=1,
                                                             alpha_encoding=ae)
        cases[f"BLP2 DXT{kind} cut short"] = blp2_bytes(12, 12, random_blocks[:50], encoding=2, alpha_depth=1,
                                                      alpha_encoding=ae)
    p = Image.fromarray(a).quantize(40)
    cases["PIL's BLP2 of a P image"] = pil_save(p, "BLP")
    cases["PIL's BLP1 of a P image"] = pil_save(p, "BLP", blp_version="BLP1")
    rgba_p = Image.fromarray(smooth(12, 16, 4, 5)).quantize(30)
    cases["PIL's BLP2 of an RGBA-palette P image"] = pil_save(rgba_p.convert("RGBA").quantize(30, method=2), "BLP")
    return cases


def fits_cases():
    rng = np.random.default_rng(10)
    s8, s16 = rng.integers(0, 256, (7, 11)), rng.integers(0, 65536, (7, 11)) - 32768
    s32, f = rng.integers(-2**31, 2**31, (7, 11)), rng.normal(0, 300, (7, 11))
    f[0, :3] = [np.nan, np.inf, -np.inf]
    w8 = rng.integers(0, 256, (9, 6))
    cases = {
        "8-bit": fits_bytes(s8, 8),
        "16-bit (PIL: byte-swapped)": fits_bytes(s16, 16),
        "32-bit": fits_bytes(s32, 32),
        "-32 float": fits_bytes(f, -32),
        "-64 float (PIL: half the bytes as float32)": fits_bytes(f, -64),
        "one axis": fits_unit([("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "1"), ("NAXIS1", "13")], bytes(range(13))),
        "an IMAGE extension after a primary of NAXIS 0": fits_bytes(s8, 8, empty_primary=True),
        "a comment and a slash in a value": fits_bytes(s8, 8, cards=[("COMMENT", None), ("OBJECT", "'M31 / a b'")]),
        "three axes": fits_unit([("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "3"), ("NAXIS1", "5"), ("NAXIS2", "4"),
                                 ("NAXIS3", "2")], bytes(range(40))),
        "data unit not padded": fits_bytes(s8, 8, pad=False),
        "gzip table, 8 bits": fits_gzip_bytes(w8, 8),
        "gzip table, 16 bits, 3 members": fits_gzip_bytes(rng.integers(0, 65536, (9, 6)), 16, members=3),
        "gzip table, 32 bits": fits_gzip_bytes(rng.integers(0, 2**32, (9, 6)), 32),
        "gzip table, padded heap": fits_gzip_bytes(w8, 8, pad=True),
        "gzip table, ZBITPIX -32 (PIL: no bytes)": fits_gzip_bytes(w8, -32),
        "gzip table, short heap": fits_gzip_bytes(rng.integers(0, 256, (40, 30)), 8)[:-5],
        "BITPIX 64 (no mode: passed on)": fits_bytes(s8, 8).replace(b" " * 19 + b"8", b" " * 18 + b"64", 1),
        "SIMPLE = F": fits_bytes(s8, 8).replace(b"                   T", b"                   F", 1),
        "no image (NAXIS 0 only)": fits_unit([("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "0")]) + bytes(2880),
        "NAXIS of no number": fits_unit([("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "X")], bytes(16)),
        "no NAXIS1 (KeyError)": fits_unit([("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "2"), ("NAXIS2", "3")],
                                          bytes(16)),
        "data cut short": fits_bytes(s8, 8, pad=False)[:-9],
        "32-bit data cut short": fits_bytes(s32, 32, pad=False)[:-9],
        "ends in its header": fits_bytes(s8, 8)[:400],
    }
    return cases


def fli_cases():
    rng = np.random.default_rng(20)
    w, h = 21, 9
    idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
    runs = np.repeat(rng.integers(0, 256, (h, 3)), 7, axis=1).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    brun = fli_frame([fli_palette(pal), fli_brun(idx)])
    cases = {
        "FLC, BRUN": fli_bytes(w, h, [brun]),
        "FLI (0xAF11), BRUN of runs": fli_bytes(w, h, [fli_frame([fli_palette(pal), fli_brun(runs)])], magic=0xAF11,
                                               flags=0),
        "COPY": fli_bytes(w, h, [fli_frame([fli_palette(pal), fli_chunk(16, idx.tobytes())])]),
        "COLOR_64": fli_bytes(w, h, [fli_frame([fli_palette(pal >> 2, 11), fli_brun(idx)])]),
        "a palette of 10 entries from 100": fli_bytes(w, h, [fli_frame([fli_palette(pal[:10], 4, 100),
                                                                        fli_brun(idx)])]),
        "no palette: the grey ramp": fli_bytes(w, h, [fli_frame([fli_brun(idx)])]),
        "the palette in the second subchunk": fli_bytes(w, h, [fli_frame([fli_brun(idx), fli_palette(pal)])]),
        "BLACK": fli_bytes(w, h, [fli_frame([fli_palette(pal), fli_chunk(13, b"")])]),
        "LC on the blank frame": fli_bytes(w, h, [fli_frame([fli_palette(pal), fli_lc(2, [
            [(3, idx[0, :5].tobytes()), (2, (4, 77))], [], [(0, (21, 9))]])])]),
        "SS2 on the blank frame": fli_bytes(20, h, [fli_frame([fli_palette(pal), fli_ss2([
            ([], [(2, idx[0, :6].tobytes()), (1, (3, b"\x05\x06"))]),
            ([0x10000 - 3, 0x8000 | 99], [(0, idx[1, :4].tobytes())]),
            ([], [])])])]),
        "two frames (frame 0 read)": fli_bytes(w, h, [brun, fli_frame([fli_chunk(13, b"")])]),
        "a frame of a PSTAMP and BRUN": fli_bytes(w, h, [fli_frame([fli_chunk(18, bytes(20)), fli_palette(pal),
                                                                    fli_brun(idx)])]),
        "a prefix chunk (PIL decodes it as frame 0)": fli_bytes(w, h, [brun], prefix=bytes(10)),
        "flags 1 (not FLI)": fli_bytes(w, h, [brun], flags=1),
        "a frame count of 0": fli_bytes(w, h, [brun], header={6: b"\0\0"}),
        "a byte 44 not zero": fli_bytes(w, h, [brun], header={44: b"\1"}),
        "a BRUN row of too few pixels": fli_bytes(w + 1, h, [brun]),
        "an unknown subchunk": fli_bytes(w, h, [fli_frame([fli_chunk(99, bytes(8))])]),
        "a COPY cut short": fli_bytes(w, h, [fli_frame([fli_chunk(16, idx.tobytes()[:100])])]),
        "a frame cut short": fli_bytes(w, h, [brun])[:-30],
        # PIL's decoder compares the size unsigned: it waits for 2^31 bytes, and the file ends
        "a frame size of 2^31": fli_bytes(w, h, [struct.pack("<I", 2**31) + brun[4:]]),
        "no frame": fli_bytes(w, h, []),
        "a palette entry past 255": fli_bytes(w, h, [fli_frame([fli_palette(pal[:10], 4, 250), fli_brun(idx)])]),
        "an empty size": fli_bytes(0, h, [brun]),
    }
    return cases


def ftex_cases():
    rng = np.random.default_rng(30)
    px = smooth(12, 9, 3, 31)
    blocks = bc1_blocks(px).tobytes()
    return {
        "raw RGB": ftex_bytes(9, 12, px.tobytes()),
        "DXT1": ftex_bytes(9, 12, blocks, fmt=0),
        "DXT1 of random blocks": ftex_bytes(8, 8, rng.integers(0, 256, 32, dtype=np.uint8).tobytes(), fmt=0),
        "raw RGB, the mipmap size -1 (PIL reads to the end)": ftex_bytes(9, 12, px.tobytes(), mipmap_size=-1),
        "raw RGB, the mipmap size -2 (PIL: a negative read length)": ftex_bytes(9, 12, px.tobytes(), mipmap_size=-2),
        "raw RGB at offset 100": ftex_bytes(9, 12, px.tobytes(), where=100),
        "two formats (PIL: an assertion)": ftex_bytes(9, 12, px.tobytes(), format_count=2),
        "format 2": ftex_bytes(9, 12, px.tobytes(), fmt=2),
        "DXT1 cut short": ftex_bytes(9, 12, blocks[:40], fmt=0),
        "raw RGB cut short": ftex_bytes(9, 12, px.tobytes()[:-1]),
        "a header cut short": ftex_bytes(9, 12, b"")[:20],
        "an empty size": ftex_bytes(0, 12, px.tobytes()),
    }


def gbr_cases():
    rgba, grey = smooth(9, 13, 4, 40), smooth(9, 13, 1, 41)
    return {
        "version 2, RGBA": gbr_bytes(rgba),
        "version 2, grey": gbr_bytes(grey),
        "version 1, grey": gbr_bytes(grey, version=1),
        "version 1, RGBA, a long comment": gbr_bytes(rgba, version=1, comment=b"a brush\0" * 30),
        "version 2, a header size of 27 (PIL reads the comment to the end)": gbr_bytes(rgba, header_size=27),
        "version 2, a header size of 24 (PIL: a negative read length)": gbr_bytes(rgba, header_size=24),
        "version 2 without GIMP": gbr_bytes(rgba, magic=b"PMIG"),
        "colour depth 3": gbr_bytes(smooth(9, 13, 3, 42)),
        "pixels cut short": gbr_bytes(rgba)[:-1],
        "a header cut short": gbr_bytes(rgba)[:18],
        "an empty size": gbr_bytes(rgba[:, :0]),
        "version 3 (GBR does not accept it)": gbr_bytes(rgba).replace(b"\0\0\0\2", b"\0\0\0\3", 1),
    }


def icns_cases():
    rng = np.random.default_rng(50)
    a = smooth(16, 16, 4, 51)
    mask = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
    px128 = (smooth(128, 128, 3, 52) // 40 * 40).astype(np.uint8)  # runs for the RLE
    modes = {m: pil_save(Image.fromarray(a).convert(m), "PNG") for m in ("RGB", "RGBA", "L", "LA", "1", "I;16")}
    modes["P"] = pil_save(Image.fromarray(a[..., :3]).quantize(12), "PNG", transparency=2)
    cases = {f"icp4 PNG {m}": icns_bytes([(b"icp4", d)]) for m, d in modes.items()}
    j2k = pil_save(Image.fromarray(a[..., :3]), "JPEG2000", no_jp2=True)
    cases.update({
        "it32 + t8mk": icns_bytes([(b"it32", icns_rgb(px128, it32=True)), (b"t8mk", mask * 64)]),
        "it32 raw": icns_bytes([(b"it32", icns_rgb(px128, rle=False, it32=True))]),
        "ih32 + h8mk": icns_bytes([(b"ih32", icns_rgb(px128[:48, :48])), (b"h8mk", mask * 9)]),
        "il32 raw + l8mk": icns_bytes([(b"il32", icns_rgb(px128[:32, :32], rle=False)), (b"l8mk", mask * 4)]),
        "is32 + s8mk, and a 16x16 PNG": icns_bytes([(b"is32", icns_rgb(px128[:16, :16])), (b"s8mk", mask),
                                                    (b"icp4", modes["RGBA"])]),
        "ic07 PNG beside it32 and t8mk": icns_bytes([(b"it32", icns_rgb(px128, it32=True)), (b"t8mk", mask * 64),
                                                     (b"ic07", png_bytes(smooth(128, 128, 4, 53)))]),
        "ic11 (16x16 at scale 2) of a 32x32 PNG": icns_bytes([(b"ic11", png_bytes(smooth(32, 32, 3, 54))),
                                                              (b"icp4", modes["RGB"])]),
        "icp4 raw codestream JPEG 2000": icns_bytes([(b"icp4", j2k)]),
        "icp4 JP2 of RGBA": icns_bytes([(b"icp4", pil_save(Image.fromarray(a), "JPEG2000"))]),
        "icp4 JP2 of grey": icns_bytes([(b"icp4", pil_save(Image.fromarray(a[..., 0]), "JPEG2000"))]),
        "two is32 blocks (the last kept)": icns_bytes([(b"is32", icns_rgb(px128[:16, :16], rle=False)),
                                                       (b"is32", icns_rgb(px128[16:32, :16]))]),
        "a file size past the blocks (passed on)": icns_bytes([(b"icp4", modes["RGB"])], size=10**6),
        "a block of size 0 (passed on)": icns_bytes([(b"icp4", modes["RGB"])])[:12] + bytes(4),
        "no icon PIL lists (passed on)": icns_bytes([(b"TOC ", bytes(8))]),
        "it32 without its zero signature": icns_bytes([(b"it32", b"\1" + icns_rgb(px128, it32=True)[1:])]),
        "is32 whose bands overrun": icns_bytes([(b"is32", b"\xff\x07" * 200)]),
        "is32 cut short": icns_bytes([(b"is32", icns_rgb(px128[:16, :16])[:100])]),
        "s8mk cut short": icns_bytes([(b"is32", icns_rgb(px128[:16, :16])), (b"s8mk", mask[:100])]),
        "s8mk alone": icns_bytes([(b"s8mk", mask)]),
        "icp4 of another format": icns_bytes([(b"icp4", b"GIF89a" + bytes(40))]),
        "icp4 PNG of the wrong size": icns_bytes([(b"icp4", png_bytes(a[:8, :, :3]))]),
        "icp4 PNG cut short": icns_bytes([(b"icp4", modes["RGB"][:60])]),
    })
    return cases


def eps_cases():
    return {
        "EPS": eps_bytes(),
        "DOS EPS": eps_bytes(dos=True),
        "an %ImageData size": eps_bytes(lines=[b"%ImageData: 20 10 8 3 0 1 1 \"beginimage\""], bbox=(5, 5, 50, 30)),
        "a bounding box at the end": eps_bytes(bbox=None, lines=[b"%%BoundingBox: (atend)"],
                                               body=b"%%Page: 1 1\n%%Trailer\n%%BoundingBox: 0 0 30 20\n%%EOF\n"),
        # the line after %%EndComments joins it in PIL's buffer: this %%Trailer is not seen
        "a trailer right after %%EndComments": eps_bytes(bbox=None, lines=[b"%%BoundingBox: (atend)"],
                                                         body=b"%%Trailer\n%%BoundingBox: 0 0 30 20\n%%EOF\n"),
        "%%BeginBinary": eps_bytes(body=b"%%BeginBinary: 5\nab\ncd%%EOF\n"),
        "no bounding box": eps_bytes(bbox=None),
        "no %!PS-Adobe (passed on)": eps_bytes(adobe=b"%!PS"),
        "an %ImageData mode of 7 (passed on)": eps_bytes(lines=[b"%ImageData: 20 10 8 7 0 1 1 \"b\""]),
        "an %ImageData of two numbers": eps_bytes(lines=[b"%ImageData: 20 10"]),
        "a comment line of 300 bytes (passed on)": eps_bytes(lines=[b"%" + b"x" * 300]),
    }


def stub_cases():
    return {
        "BUFR": b"BUFR" + bytes(40),
        "BUFR (ZCZC)": b"ZCZC" + bytes(40),
        "GRIB edition 1": b"GRIB\0\0\0\1" + bytes(40),
        "GRIB edition 2 (GRIB does not accept it)": b"GRIB\0\0\0\2" + bytes(40),
        "HDF5": b"\x89HDF\r\n\x1a\n" + bytes(40),
    }


FORMS = {"BLP": blp_cases, "FITS": fits_cases, "FLI": fli_cases, "FTEX": ftex_cases, "GBR": gbr_cases,
         "ICNS": icns_cases, "EPS": eps_cases, "stub": stub_cases}
CASES = [(form, case) for form, make in FORMS.items() for case in make()]


@pytest.mark.parametrize("form,case", CASES, ids=[f"{f}: {c}" for f, c in CASES])
def test_form_reads_as_pil_reads_it(tmp_path, cxx, form, case):
    """Each form and branch: PIL's mode, pixels and RGBA, or a raise where
    PIL raises (EPS here has no Ghostscript, as PIL has none: both raise)."""
    follows_pil(tmp_path, FORMS[form]()[case], case)


def test_the_branches_are_covered():
    """The cases reach what PIL reads: both BLP versions' every encoding,
    each BITPIX and the gzip table, every FLI chunk PIL decodes, both FTEX
    formats, both brush versions and depths, every icns reader."""
    seen = set()
    for data in blp_cases().values():
        if data.startswith(b"BLP1") and len(data) > 24:
            seen.add(("BLP1", struct.unpack_from("<i", data, 4)[0], struct.unpack_from("<i", data, 20)[0]))
        elif len(data) > 12:
            seen.add(("BLP2", data[8], data[10]))
    assert {("BLP1", 0, 5), ("BLP1", 1, 4), ("BLP1", 1, 5), ("BLP2", 1, 0), ("BLP2", 2, 0), ("BLP2", 2, 1),
            ("BLP2", 2, 7)} <= seen
    kinds = set()
    for data in fli_cases().values():
        pos = 128
        while pos + 16 <= len(data):
            size, kind, chunks = struct.unpack_from("<IHH", data, pos)
            at = pos + 16
            for _ in range(chunks if kind == 0xF1FA else 0):
                kinds.add(struct.unpack_from("<H", data, at + 4)[0])
                at += struct.unpack_from("<I", data, at)[0]
            pos += max(size, 1)
    assert {4, 7, 11, 12, 13, 15, 16, 18} <= kinds
    blocks = set()
    for data in icns_cases().values():
        pos = 8
        while pos + 8 <= len(data) and struct.unpack_from(">I", data, pos + 4)[0] >= 8:
            blocks.add(data[pos:pos + 4])
            pos += struct.unpack_from(">I", data, pos + 4)[0]
    assert {b"it32", b"ih32", b"il32", b"is32", b"icp4", b"ic07", b"ic11"} <= blocks


# ---- the compiled loops against their plain versions ----

def test_blp_dxt_compiled_equals_plain(cxx):
    """`gs_blp_dxt_decode` against numpy's `plain_dxt` on 4,096 random blocks
    of each kind, with and without alpha, and against PIL's own decoders."""
    from PIL import BlpImagePlugin

    rng = np.random.default_rng(60)
    for kind in (1, 3, 5):
        blocks = rng.integers(0, 256, 4096 * (8 if kind == 1 else 16), dtype=np.uint8).tobytes()
        for alpha in (False, True):
            got = blp.blp_dxt_decode(blocks, kind, alpha, 256, 64, "blocks")
            plain = blp.blp_dxt_decode(blocks, kind, alpha, 256, 64, "blocks", plain=True)
            np.testing.assert_array_equal(got, plain, err_msg=f"DXT{kind} alpha {alpha}")
        line = blocks[:64 * (8 if kind == 1 else 16)]  # one row of 64 blocks through PIL's decoder
        rows = {1: lambda d: BlpImagePlugin.decode_dxt1(d, True), 3: BlpImagePlugin.decode_dxt3,
                5: BlpImagePlugin.decode_dxt5}[kind](line)
        np.testing.assert_array_equal(blp.blp_dxt_decode(line, kind, True, 256, 4, "row"),
                                      np.frombuffer(b"".join(rows), np.uint8), err_msg=f"DXT{kind} against PIL")


def fli_frames():
    """Every case's file and the mutants of the FLI form."""
    return [d for d in fli_cases().values()] + mutants("FLI", 80, 61)


def test_fli_compiled_equals_plain(cxx):
    """`gs_fli_decode` and `fli.plain_decode` give the same picture or the
    same refusal on every FLI case and mutant."""
    for i, data in enumerate(fli_frames()):
        out = []
        for plain in (False, True):
            try:
                pic = fli.decode_fli(data, "frame", plain=plain)
                out.append((pic.pixels.tobytes(), pic.palette.tobytes()))
            except ValueError as err:
                out.append(type(err).__name__ + str(err))
        assert out[0] == out[1], i


def test_icns_rle_compiled_equals_plain(cxx):
    """`gs_icns_rle_decode` and `icns.plain_rle` on random bytes from every
    start and for band sizes that end in, on and past the data."""
    rng = np.random.default_rng(62)
    for trial in range(200):
        data = rng.integers(0, 256, int(rng.integers(1, 300)), dtype=np.uint8).tobytes()
        start, n = int(rng.integers(0, len(data))), int(rng.integers(1, 400))
        got = icns.icns_rle_decode(data, start, n, "band")
        want = icns.plain_rle(data, start, n)
        assert got[1:] == want[1:] and got[0].tobytes() == want[0].tobytes(), trial


# ---- mutated files: PIL's reading or a raise, nothing else ----

def mutants(form, n, seed):
    """Seeded mutations of small files of `form` (bytes replaced or
    flipped, the file cut short)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = int(rng.integers(1, 9)), int(rng.integers(1, 13))
        px = (rng.integers(0, 3, (h, w, 4)) * 100).astype(np.uint8)
        if form == "BLP1":
            if rng.random() < 0.5:
                data = blp1_bytes(w, h, 1, alpha=int(rng.integers(0, 2)), encoding=5,
                                  palette=rng.integers(0, 256, (256, 4)), indices=px[..., 0].tobytes())
                start = 20
            else:
                data, start = blp1_bytes(w, h, 0, jpeg=pil_save(Image.fromarray(px[..., :3]), "JPEG")), 20
        elif form == "BLP2":
            kind = int(rng.choice([0, 1, 3, 5]))
            if kind == 0:
                data = blp2_bytes(w, h, px[..., 1].tobytes(), palette=rng.integers(0, 256, (256, 4)),
                                  alpha_depth=int(rng.integers(0, 2)))
            else:
                blocks = {1: bc1_blocks(px[..., :3]), 3: bc2_blocks(px), 5: bc3_blocks(px)}[kind]
                data = blp2_bytes(w, h, blocks.tobytes(), encoding=2, alpha_depth=int(rng.integers(0, 2)),
                                  alpha_encoding={1: 0, 3: 1, 5: 7}[kind])
            start = 8
        elif form == "FITS":
            if rng.random() < 0.3:
                data = fits_gzip_bytes(px[..., 0], int(rng.choice([8, 16, 32])))
            else:
                data = fits_bytes(px[..., 0].astype(np.int64) * 3, int(rng.choice([8, 16, 32, -32, -64])),
                                  pad=rng.random() < 0.5)
            start = 0
            if rng.random() < 0.5:  # a card's value, or a byte of the data
                d = bytearray(data)
                card = int(rng.integers(1, 6))
                d[card * 80 + 29] = int(rng.choice([ord(c) for c in "0123456789-T "]))
                data = bytes(d)
        elif form == "FLI":
            idx = px[..., 0]
            chunks = [fli_palette(rng.integers(0, 256, (int(rng.integers(1, 257)), 3)), int(rng.choice([4, 11]))),
                      [fli_brun(idx), fli_chunk(16, idx.tobytes()), fli_chunk(13, b""),
                       fli_lc(0, [[(1, idx[0, :2].tobytes())]] * min(h, 2))][int(rng.integers(0, 4))]]
            data, start = fli_bytes(w, h, [fli_frame(chunks)]), 128
        elif form == "FTEX":
            fmt = int(rng.integers(0, 2))
            body = bc1_blocks(px[..., :3]).tobytes() if fmt == 0 else px[..., :3].tobytes()
            data, start = ftex_bytes(w, h, body, fmt=fmt), 4
        elif form == "GBR":
            c = int(rng.choice([1, 4]))
            data, start = gbr_bytes(px[..., :c], version=int(rng.integers(1, 3))), 0
        elif form == "ICNS":
            size = int(rng.choice([16, 32, 48]))
            body = icns_rgb(np.resize(px[..., :3], (size, size, 3)), rle=rng.random() < 0.7)
            code, mk = {16: (b"is32", b"s8mk"), 32: (b"il32", b"l8mk"), 48: (b"ih32", b"h8mk")}[size]
            blocks = [(code, body), (mk, bytes(size * size))] if rng.random() < 0.5 else [(code, body)]
            if rng.random() < 0.3:
                blocks.append((b"icp4", png_bytes(px[..., :3])))
            data, start = icns_bytes(blocks), 4
        else:  # EPS
            data, start = eps_bytes(bbox=(0, 0, w, h), lines=[b"%%Title: x", b"%ImageData: 4 4 8 3 0 1 1 \"b\""]), 4
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(start, len(d)))
            d[i] = int(rng.integers(0, 256)) if rng.random() < 0.7 else d[i] ^ (1 << int(rng.integers(0, 8)))
        if rng.random() < 0.2:
            d = d[:int(rng.integers(start, len(d)))]
        out.append(bytes(d))
    return out


@pytest.mark.parametrize("form", ["BLP1", "BLP2", "FITS", "FLI", "FTEX", "GBR", "ICNS", "EPS"])
def test_mutated_files_read_as_pil_reads_them(tmp_path, cxx, form):
    """Seeded mutations: PIL's mode, pixels and RGBA, or a raise where PIL
    raises; a file PIL's plugin passes on reaches the next reader."""
    for i, data in enumerate(mutants(form, 60, 70 + len(form))):
        follows_pil(tmp_path, data, f"{form} mutant {i}")


# ---- EPS through Ghostscript ----

STUB_GS = """#!{python}
import sys
args = sys.argv[1:]
if args == ["--version"]:
    print("10.0.0")
    sys.exit(0)
with open({log!r}, "a") as f:
    f.write(repr(args) + "\\n")
size = next(a[2:] for a in args if a.startswith("-g"))
out = next(a[len("-sOutputFile="):] for a in args if a.startswith("-sOutputFile="))
w, h = (int(v) for v in size.split("x"))
body = bytes((3 * x + 7 * y + 11 * k) % 256 for y in range(h) for x in range(w) for k in range(3))
with open(out, "wb") as f:
    f.write(b"P6\\n%d %d\\n255\\n" % (w, h) + body)
"""


@pytest.fixture
def stub_gs(tmp_path, monkeypatch):
    """A stand-in `gs` on PATH that writes a P6 of the size it is asked
    for and logs its arguments; PIL's cached Ghostscript lookup is reset
    before and after."""
    bindir = tmp_path / "gsbin"
    bindir.mkdir()
    log = tmp_path / "gs.log"
    gs = bindir / "gs"
    gs.write_text(STUB_GS.format(python=sys.executable, log=str(log)))
    gs.chmod(gs.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(EpsImagePlugin, "gs_binary", None)
    yield log
    EpsImagePlugin.gs_binary = None


@pytest.mark.parametrize("case", ["EPS", "DOS EPS", "an %ImageData size", "a bounding box at the end"])
def test_eps_through_ghostscript_as_pil(tmp_path, stub_gs, case):
    """With a `gs` on PATH, PIL and the port run it with the same
    arguments (but the output file's name) and read the same picture."""
    got = follows_pil(tmp_path, eps_cases()[case], case)
    assert got is not None and got.mode == "RGB"
    runs = [eval(line) for line in stub_gs.read_text().splitlines()]  # noqa: S307  (the stub's own repr lines)
    assert len(runs) == 2

    def same(argv):
        return [a if not a.startswith("-sOutputFile=") else "-sOutputFile=" for a in argv]

    assert same(runs[0]) == same(runs[1]), runs


def test_eps_without_ghostscript_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.setattr(eps, "has_ghostscript", lambda: False)
    path = tmp_path / "v.eps"
    path.write_bytes(eps_bytes())
    with pytest.raises(ValueError, match="Ghostscript") as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)


# ---- no fallback ----

def test_failed_codec_build_raises_naming_the_source(tmp_path, fake_cxx):
    """BLP2's DXT blocks, FLI frames and icns runs cannot be read without
    their compiled loops: each read raises naming the source and the file;
    a BLP palette, a FITS, a GBR and a raw FTEX need no build."""
    fake_cxx(fail=True)
    px = smooth(8, 8, 4, 80)
    needs = {"v.blp": (blp2_bytes(8, 8, bc1_blocks(px).tobytes(), encoding=2), "csrc/bcn_decode.cc"),
             "v.flc": (fli_bytes(8, 8, [fli_frame([fli_brun(px[..., 0])])]), "csrc/image_codecs.cc"),
             "v.icns": (icns_bytes([(b"is32", icns_rgb(np.resize(px[..., :3], (16, 16, 3))))]),
                        "csrc/image_codecs.cc")}
    for name, (data, source) in needs.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(RuntimeError, match=source) as err:
            image_io.open_image(path)
        assert str(path) in str(err.value)
    free = {"w.blp": blp2_bytes(8, 8, px[..., 0].tobytes(), palette=np.zeros((256, 4))),
            "w.fits": fits_bytes(px[..., 0], 8), "w.gbr": gbr_bytes(px), "w.ftc": ftex_bytes(8, 8, bytes(192))}
    for name, data in free.items():
        path = tmp_path / name
        path.write_bytes(data)
        assert image_io.open_image(path).pixels.shape[:2] == (8, 8)


# ---- the committed fixtures and phase 5o's files ----

def _json():
    with open(os.path.join(FIXTURES, "sha256.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_json()["files"]))
def test_committed_fixture_reads_as_pil_and_the_json_say(tmp_path, cxx, name):
    want = _json()["files"][name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == want["file_sha256"]
    mode, px, rgba = pil_reading(path)
    assert (mode, list(px.shape), sha256_of(px), sha256_of(rgba)) == \
        (want["mode"], want["shape"], want["sha256"], want["rgba_sha256"])
    got = image_io.open_image(path)
    assert (got.mode, list(got.pixels.shape), sha256_of(got.pixels), sha256_of(image_io.to_rgba(got))) == \
        (want["mode"], want["shape"], want["sha256"], want["rgba_sha256"])


def test_chip_smoke_forms_read_as_the_json_says(tmp_path, cxx):
    """Phase 5o's files, written again here by chip_smoke.py's
    `rare_form_files`, are the bytes whose PIL reading sha256.json holds,
    and the port reads each as PIL did."""
    readings = _json()["chip_smoke"]
    made = rare_form_files()
    assert sorted(made) == sorted(readings)
    for name, data in made.items():
        want = readings[name]
        assert hashlib.sha256(data).hexdigest() == want["file_sha256"], name
        path = tmp_path / "form"
        path.write_bytes(data)
        pic = image_io.open_image(path)
        assert (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels)) == \
            (want["mode"], want["shape"], want["sha256"]), name


ROOT_FIXTURES = os.path.dirname(FIXTURES)
SMALL = 1 << 18  # pixels: the earlier folders' small fixtures, not their 1080p files


def earlier_fixtures(folder):
    """[(file, (mode, shape, pixels' SHA-256) or None, the .npz of PIL's
    reading or None)] of an earlier fixture folder's small files: those
    its sha256.json reads (under "files", or at its top level) and those
    beside an .npz of PIL's pixels."""
    d = os.path.join(ROOT_FIXTURES, folder)
    out = []
    if os.path.exists(os.path.join(d, "sha256.json")):
        with open(os.path.join(d, "sha256.json")) as f:
            table = json.load(f)
        for name, want in sorted(table.get("files", table).items()):
            if isinstance(want, dict) and {"mode", "shape", "sha256"} <= set(want) and \
                    os.path.exists(os.path.join(d, name)) and want["shape"][0] * want["shape"][1] <= SMALL:
                out.append((name, (want["mode"], want["shape"], want["sha256"]), None))
    for npz in sorted(n for n in os.listdir(d) if n.endswith(".npz")):
        stem = npz[:-4]
        images = [n for n in os.listdir(d) if n.startswith(stem + ".") and n != npz]
        if len(images) == 1:
            out.append((images[0], None, npz))
    return out


EARLIER = sorted(f for f in os.listdir(ROOT_FIXTURES) if f.startswith("torch_") and earlier_fixtures(f))


@pytest.mark.parametrize("folder", EARLIER)
def test_earlier_fixtures_read_as_before_through_the_longer_order(cxx, folder):
    """GBR's and FLI's loose first-bytes tests, FITS's, EPS's and the
    stubs' sit before TIFF, ICO and TGA, and IM, IMT, IPTC, PCD and
    SPIDER, which test no first bytes, before TIFF, PSD, QOI, SGI, TGA and
    WebP: every small committed fixture of the earlier forms (this file's
    own included) still reads as PIL's committed reading of it (its
    sha256.json, or the .npz beside it) says."""
    for name, want, npz in earlier_fixtures(folder):
        path = os.path.join(ROOT_FIXTURES, folder, name)
        if npz is None:
            got = image_io.open_image(path)
            px = got.pixels if list(got.pixels.shape) == want[1] else got.pixels[..., 0]
            assert (got.mode, list(px.shape), sha256_of(px)) == want, (folder, name)
            continue
        ref = np.load(os.path.join(ROOT_FIXTURES, folder, npz))
        try:
            got = image_io.open_image(path)
        except ValueError:
            assert "pixels" not in ref, (folder, name)  # a refusal the .npz records
            continue
        if "mode" in ref:
            assert got.mode == str(ref["mode"]), (folder, name)
        np.testing.assert_array_equal(got.pixels.reshape(ref["pixels"].shape), ref["pixels"], err_msg=name)
        if "rgba" in ref:
            np.testing.assert_array_equal(image_io.to_rgba(got), ref["rgba"], err_msg=name)


# ---- both dataset paths against the JAX package ----

def colmap_views(w, h):
    """Views whose loaded pixels are the picture: RGB, RGBA and L."""
    a = smooth(h, w, 3, 90)
    rgba = np.concatenate([a, np.full((h, w, 1), 255, np.uint8)], -1)
    grey = a[..., :1]
    return {
        "v_blp2_dxt1.blp": blp2_bytes(w, h, bc1_blocks(a).tobytes(), encoding=2),
        "v_blp2_dxt5.blp": blp2_bytes(w, h, bc3_blocks(rgba).tobytes(), encoding=2, alpha_depth=8,
                                      alpha_encoding=7),
        "v_blp1_jpeg.blp": blp1_bytes(w, h, 0, jpeg=pil_save(Image.fromarray(a), "JPEG", quality=92)),
        "v_blp1_palette.blp": blp1_bytes(w, h, 1, palette=np.arange(1024).reshape(256, 4) % 256,
                                         indices=a[..., 0].tobytes()),
        "v_ftex_dxt1.ftc": ftex_bytes(w, h, bc1_blocks(a).tobytes(), fmt=0),
        "v_ftex_raw.ftu": ftex_bytes(w, h, a.tobytes()),
        "v_gbr_rgba.gbr": gbr_bytes(rgba),
        "v_gbr_grey.gbr": gbr_bytes(grey, version=1),
        "v_fits_grey.fits": fits_bytes(grey[..., 0], 8),
        "v_icns_is32.icns": icns_bytes([(b"is32", icns_rgb(np.resize(a, (16, 16, 3))))]),
    }


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_rare_views_match_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of views in the new forms (the icon 16x16, resized
    by both packages): the Scene's cameras equal the JAX package's, images
    bit for bit."""
    from test_torch_scene import both_scenes

    w, h = 16, 16
    src = str(tmp_path / "forms")
    views = colmap_views(w, h)
    write_colmap_dataset_of(src, views, w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == len(views)
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


def refused_views():
    rng = np.random.default_rng(100)
    s = rng.integers(0, 256, (11, 13))
    idx = rng.integers(0, 256, (11, 13)).astype(np.uint8)
    return {
        "FLI (P)": ("view.flc", fli_bytes(13, 11, [fli_frame([fli_brun(idx)])]), "P"),
        "FITS 16-bit (I;16)": ("view.fits", fits_bytes(s, 16), "I;16"),
        "FITS 32-bit (I)": ("view.fits", fits_bytes(s, 32), "I"),
        "FITS -32 (F)": ("view.fits", fits_bytes(s / 3, -32), "F"),
        "FITS -64 (F)": ("view.fits", fits_bytes(s / 3, -64), "F"),
    }


@pytest.mark.parametrize("form", list(refused_views()))
def test_colmap_refuses_modes_that_are_not_the_picture(tmp_path, cxx, form):
    """The JAX package's COLMAP path trains on np.asarray of these (palette
    indices, 16- and 32-bit integers, floats): the port refuses each
    through load_camera, naming the file as images.bin lists it and the
    mode."""
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
    rng = np.random.default_rng(110)
    a, rgba = smooth(h, w, 3, 111), smooth(h, w, 4, 112)
    s = rng.integers(0, 1000, (h, w))
    idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
    return [
        blp2_bytes(w, h, bc3_blocks(rgba).tobytes(), encoding=2, alpha_depth=8, alpha_encoding=7),
        blp2_bytes(w, h, bc2_blocks(rgba).tobytes(), encoding=2, alpha_depth=8, alpha_encoding=1),
        blp2_bytes(w, h, bc1_blocks(a).tobytes(), encoding=2, alpha_depth=1),
        blp2_bytes(w, h, idx.tobytes(), alpha_depth=8, palette=rng.integers(0, 256, (256, 4))),
        blp1_bytes(w, h, 0, alpha=8, jpeg=pil_save(Image.fromarray(a), "JPEG")),
        ftex_bytes(w, h, bc1_blocks(rgba).tobytes(), fmt=0),
        gbr_bytes(rgba),
        fits_bytes(s, 16),
        fits_bytes(s - 500, 32),
        fits_bytes(s / 3 - 20, -32),
        fits_gzip_bytes(s % 256, 8),
        fli_bytes(w, h, [fli_frame([fli_palette(rng.integers(0, 256, (256, 3))), fli_brun(idx)])]),
        icns_bytes([(b"is32", icns_rgb(np.resize(a, (16, 16, 3)))), (b"s8mk", rng.bytes(256))]),
    ]


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_rare_frames_match_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on frames in every new form: PIL's
    convert("RGBA") through the composite, bit for bit, then load_camera at
    -r 2."""
    w, h = 16, 16
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


def test_fits_card_writer_matches_the_standard():
    """The writer's cards are 80 bytes, keyword in columns 1-8 and '= ' in
    9-10, as FITS and PIL's parse expect."""
    card = fits_card("NAXIS1", "13")
    assert len(card) == 80 and card[:8] == b"NAXIS1  " and card[8:10] == b"= "
