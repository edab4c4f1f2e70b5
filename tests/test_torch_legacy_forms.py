"""The port's DIB, QOI, PCX / DCX, SGI, ICO / CUR and PSD readers against PIL
12.1.0, and both dataset paths on views in those forms against the JAX
package.

Every file is made here from `np.random.default_rng(seed)` (at most
129x97) by PIL where PIL writes the form, else by
`tests/torch_image_writers.py`; PIL's reading of it is the rule:
`image_io.open_image` gives PIL's mode and pixels, `to_rgba` its
`convert("RGBA")`, bit for bit, and where PIL raises the port raises a
`ValueError` naming the file.
"""

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import cuda_build, image_io
from test_torch_image_forms import (assert_follows_pil, cxx, smooth,  # noqa: F401  (cxx: a fixture)
                                    write_colmap_dataset_of)
from test_torch_jpeg import fake_cxx  # noqa: F401  (a fixture)
from test_torch_scene import assert_same_cameras, orbit_frames
from torch_image_writers import (bmp_bytes, dcx_bytes, dib_bytes, icon_bytes, icon_dib, padded_rows, pcx_bytes,
                                 pcx_lines, png_bytes, psd_bytes, psd_resource, qoi_bytes, rle_encode, sgi_bytes,
                                 tga_bytes)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import legacy_form_files, sha256_of  # noqa: E402  (the repo root: phase 5h's files)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_legacy_forms")
W, H = 53, 37  # odd widths: padded strides and rows


def follows_pil(tmp_path, data: bytes, label=""):
    """`assert_follows_pil` with PIL reading the file by its path, as the
    JAX package opens its views (PIL reads a PCX's trailing palette by a
    seek from the end, which fails on a short file and not in memory)."""
    path = tmp_path / "pil.img"
    path.write_bytes(data)
    try:
        with Image.open(path) as im:
            np.asarray(im)
    except Exception:  # noqa: BLE001  (any of PIL's errors: the port must raise too)
        with pytest.raises(ValueError) as err:
            image_io.open_image(path)
        assert str(path) in str(err.value), label
        return None
    return assert_follows_pil(tmp_path, data, label)


def pil_save(a, fmt, mode=None, **options) -> bytes:
    buf = io.BytesIO()
    im = Image.fromarray(a)
    (im.convert(mode) if mode else im).save(buf, fmt, **options)
    return buf.getvalue()


def picture(seed=0, w=W, h=H, c=3):
    return smooth(h, w, c, seed)


def rgba_picture(seed=1, w=W, h=H):
    a = smooth(h, w, 4, seed)
    a[..., 3] = np.where(a[..., 3] > 150, 255, np.where(a[..., 3] < 90, 0, a[..., 3]))
    return a


def palette(n, seed=2):
    return np.random.default_rng(seed).integers(0, 256, (n, 3)).astype(np.uint8)


def indices(bits, seed=3, w=W, h=H):
    return np.random.default_rng(seed).integers(0, 1 << bits, (h, w)).astype(np.uint8)


# ---- the forms and modes, each bit-equal to PIL ----

def dib_cases():
    a = picture(10)
    idx = indices(8, 11)
    idx4 = indices(4, 12, w=54)
    v565 = np.random.default_rng(13).integers(0, 1 << 16, (H, W)).astype("<u2").view(np.uint8).reshape(H, -1)
    bgra = rgba_picture(14)[..., [2, 1, 0, 3]].reshape(H, -1)
    return {
        "PIL's RGB": pil_save(a, "DIB"),
        "PIL's L": pil_save(a, "DIB", "L"),
        "PIL's P": pil_save(a, "DIB", "P"),
        "PIL's 1": pil_save(a, "DIB", "1"),
        "PIL's RGBA (32-bit BI_RGB: RGB)": pil_save(rgba_picture(15), "DIB"),
        "OS/2 12-byte header, 8-bit palette": dib_bytes(padded_rows(idx), W, H, 8, header_size=12,
                                                        palette=palette(256)),
        "4-bit, 16 colours, top-down": dib_bytes(padded_rows(idx4[::-1, 0::2] << 4 | idx4[::-1, 1::2]), 54, H, 4,
                                                 palette=palette(16), colors=16, top_down=True),
        "5-6-5 bitfields after a 40-byte header": dib_bytes(padded_rows(v565), W, H, 16, compression=3,
                                                            masks=(0xF800, 0x7E0, 0x1F), masks_after_header=True),
        "V5 header, 32-bit bitfields with alpha": dib_bytes(padded_rows(bgra), W, H, 32, 124, compression=3,
                                                            masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "RLE8": dib_bytes(rle_encode(idx, False), W, H, 8, compression=1, palette=palette(256), colors=256),
        "RLE4": dib_bytes(rle_encode(idx4[:, :W] & 15, True), W, H, 4, compression=2, palette=palette(16),
                          colors=16),
        "a short palette (5 colours)": dib_bytes(padded_rows(indices(8, 16) % 7), W, H, 8, palette=palette(5),
                                                 colors=5),
        # PIL's raw decoder skips a row's padding only before the next row
        "the last row's padding cut": dib_bytes(padded_rows(a[..., ::-1].reshape(H, -1)), W, H, 24)[:-1],
        "a BMP file, the last row's padding cut": bmp_bytes(padded_rows(a[..., ::-1].reshape(H, -1)), W, H, 24)[:-1],
    }


def qoi_ops_stream():
    """8 pixels of a 4x2 RGBA QOI, one op each kind: RGB (10, 20, 30), DIFF
    (+1, -1, 0), LUMA (dg +5, dr - dg +2, db - dg -3), RGBA (1, 2, 3, 128),
    INDEX of the first pixel's slot, a RUN of 2, INDEX of a slot never
    filled (PIL: 0, 0, 0, 0)."""
    first_slot = (10 * 3 + 20 * 5 + 30 * 7 + 255 * 11) % 64
    return (b"\xfe\x0a\x14\x1e" + bytes([0x40 | 3 << 4 | 1 << 2 | 2]) + bytes([0x80 | 37, (10 << 4) | 5])
            + b"\xff\x01\x02\x03\x80" + bytes([first_slot]) + bytes([0xC0 | 1]) + bytes([63]))


def qoi_cases():
    a, rgba = picture(20), rgba_picture(21)
    flat = np.repeat(np.repeat(picture(22, 9, 7), 6, 0), 6, 1)  # runs, repeats and small steps
    return {
        "RGB": qoi_bytes(a),
        "RGBA": qoi_bytes(rgba),
        "RGB of runs and repeated colours": qoi_bytes(flat),
        "PIL's RGB": pil_save(a, "QOI"),
        "PIL's RGBA": pil_save(rgba, "QOI"),
        "every op": qoi_bytes(width=4, height=2, channels=4, ops=qoi_ops_stream()),
        "every op, 3 channels": qoi_bytes(width=4, height=2, channels=3, ops=qoi_ops_stream()),
        # a run first repeats (0, 0, 0, 255), which PIL does not enter in the table: slot 53 reads 0, 0, 0, 0
        "a run first, then its slot": qoi_bytes(width=3, height=1, channels=4, ops=bytes([0xC1, 53])),
        "channel count 5 (RGBA), colour space 1": qoi_bytes(width=4, height=2, channels=5, colorspace=1,
                                                            ops=qoi_ops_stream()),
        "no end marker": qoi_bytes(a, end=False),
    }


def pcx_cases():
    a = picture(30)
    pal16, pal256 = palette(16, 31), palette(256, 32)
    cases = {f"PIL's {m}": pil_save(a, "PCX", m) for m in ("1", "L", "P", "RGB")}
    for planes in (2, 4):
        idx = indices(planes, 33 + planes)
        s = (W + 7) // 8
        cases[f"1 bit x {planes} planes (P;{planes}L)"] = pcx_bytes(pcx_lines(idx, 1, planes, s), W, H, 1, planes,
                                                                    version=2, stride=s, header_palette=pal16)
        cases[f"1 bit x {planes} planes, padded stride"] = pcx_bytes(pcx_lines(idx, 1, planes, s + 1), W, H, 1,
                                                                     planes, version=2, header_palette=pal16)
    for w in (1, 3, 5, 54):  # padded 8-bit planes: PIL moves them together from width 5 on
        pw = w + w % 2
        cases[f"RGB of width {w}"] = pcx_bytes(pcx_lines(picture(37, w), 8, 3, pw), w, H, 8, 3)
    cases["8-bit, a palette at the end"] = pcx_bytes(np.pad(indices(8, 38), ((0, 0), (0, 1))), W, H, 8, 1,
                                                     tail_palette=pal256)
    cases["8-bit, a grey ramp at the end (L)"] = pcx_bytes(np.pad(a[..., 0], ((0, 0), (0, 1))), W, H, 8, 1,
                                                           tail_palette=np.arange(256).repeat(3))
    cases["8-bit, no palette (L)"] = pcx_bytes(np.pad(np.tile(a[..., 0], (2, 1)), ((0, 0), (0, 1))), W, 2 * H,
                                               8, 1)
    cases["a box from (3, 2)"] = pcx_bytes(pcx_lines(a, 8, 3, 54), W, H, 8, 3, box=(3, 2, W + 2, H + 1))
    cases["1 bit, a stride of 8 bytes"] = pcx_bytes(pcx_lines(indices(1, 39), 1, 1, 8), W, H, 1, 1, version=2)
    cases["DCX of two frames"] = dcx_bytes([pcx_bytes(pcx_lines(a, 8, 3, 54), W, H, 8, 3),
                                            pil_save(a, "PCX", "L")])
    cases["DCX whose first frame is 1 bit"] = dcx_bytes([pil_save(a, "PCX", "1"), pil_save(a, "PCX", "RGB")])
    return cases


def sgi_cases():
    cases = {}
    for c, mode in ((1, "L"), (3, "RGB"), (4, "RGBA")):
        a = rgba_picture(40 + c)[..., :c]
        wide = a.astype(np.uint16) * 257 + np.random.default_rng(c).integers(0, 256, a.shape).astype(np.uint16)
        for rle in (False, True):
            kind = "RLE" if rle else "verbatim"
            cases[f"{mode} 8-bit {kind}"] = sgi_bytes(a, 1, rle)
            cases[f"{mode} 16-bit {kind}"] = sgi_bytes(wide, 2, rle)
    a = picture(45)
    cases["L of dimension 1"] = sgi_bytes(a[:1, :, :1], 1, dimension=1)
    cases["PIL's RGB"] = pil_save(a, "SGI")
    cases["PIL's L"] = pil_save(a, "SGI", "L")
    cases["PIL's RGBA 16-bit"] = pil_save(rgba_picture(46), "SGI", bpc=2)
    return cases


def bad_idat_crc(png: bytes) -> bytes:
    """A PNG whose last IDAT chunk (the one before its 12-byte IEND) has
    a bad CRC, which PIL does not check."""
    return png[:-13] + bytes([png[-13] ^ 0xFF]) + png[-12:]


def icon_cases():
    a, rgba = picture(50, 32, 32), rgba_picture(51, 32, 32)
    bgr = a[..., ::-1].reshape(32, -1)
    bgra = rgba[..., [2, 1, 0, 3]].reshape(32, -1)
    mask = indices(1, 52, 32, 32)
    idx = indices(8, 53, 32, 32)
    idx4 = indices(4, 54, 32, 32)
    p_png = pil_save(a, "PNG", "P", transparency=4)  # PIL does not pass the tRNS on
    big = icon_dib(padded_rows(picture(55, 48, 48)[..., ::-1].reshape(48, -1)), 48, 48, 24,
                   and_mask=indices(1, 56, 48, 48))
    return {
        "ICO: PIL's PNG entries": pil_save(rgba_picture(57, 64, 64), "ICO", sizes=[(16, 16), (32, 32), (48, 48)]),
        "ICO: PIL's 32-bit BMP entries": pil_save(rgba_picture(58, 64, 64), "ICO", sizes=[(16, 16), (48, 48)],
                                                  bitmap_format="bmp"),
        "ICO: PIL's 24-bit BMP entry": pil_save(a, "ICO", sizes=[(32, 32)], bitmap_format="bmp"),
        "ICO: PIL's 8-bit BMP entry": pil_save(a, "ICO", "P", sizes=[(32, 32)], bitmap_format="bmp"),
        "ICO: PIL's 1-bit BMP entry": pil_save(a, "ICO", "1", sizes=[(32, 32)], bitmap_format="bmp"),
        "ICO: a P PNG entry with tRNS": icon_bytes([(32, 32, 0, 8, p_png)]),
        "ICO: an L PNG entry": icon_bytes([(32, 32, 0, 8, png_bytes(a[..., :1]))]),
        "ICO: a 256x256 PNG entry": icon_bytes([(256, 256, 0, 32, png_bytes(rgba_picture(59, 256, 256)))]),
        "ICO: a PNG entry with a bad IDAT CRC": icon_bytes([(32, 32, 0, 32, bad_idat_crc(png_bytes(rgba)))]),
        "ICO: a P PNG entry with a bad IDAT CRC": icon_bytes([(32, 32, 0, 8, bad_idat_crc(p_png))]),
        "ICO: a PNG entry with bad IDAT and IEND CRCs": icon_bytes([(32, 32, 0, 24, bad_idat_crc(
            png_bytes(a))[:-1] + b"\0")]),
        "ICO: 32-bit BMP, alpha from its fourth bytes": icon_bytes([(32, 32, 0, 32, icon_dib(
            padded_rows(bgra), 32, 32, 32, and_mask=mask))]),
        "ICO: 24-bit BMP and its AND mask": icon_bytes([(32, 32, 0, 24, icon_dib(padded_rows(bgr), 32, 32, 24,
                                                                                 and_mask=mask))]),
        "ICO: 8-bit BMP and its AND mask": icon_bytes([(32, 32, 0, 8, icon_dib(
            padded_rows(idx), 32, 32, 8, and_mask=mask, palette=palette(256, 60), colors=256))]),
        "ICO: 4-bit BMP and its AND mask": icon_bytes([(32, 32, 16, 0, icon_dib(
            padded_rows(idx4[:, 0::2] << 4 | idx4[:, 1::2]), 32, 32, 4, and_mask=mask, palette=palette(16, 61),
            colors=16))]),
        "ICO: the largest entry": icon_bytes([(32, 32, 0, 32, png_bytes(rgba)), (48, 48, 0, 24, big),
                                              (16, 16, 0, 32, png_bytes(rgba[:16, :16]))]),
        "ICO: of two 32x32, the lowest depth": icon_bytes([(32, 32, 0, 32, png_bytes(rgba)),
                                                           (32, 32, 0, 24, icon_dib(padded_rows(bgr), 32, 32, 24,
                                                                                    and_mask=mask))]),
        "ICO: depth from the colour count": icon_bytes([(32, 32, 0, 0, png_bytes(rgba)),
                                                        (32, 32, 4, 0, png_bytes(a))]),
        "CUR: 32-bit BMP at byte 22 (RGBA)": icon_bytes([(32, 32, 0, 32, icon_dib(padded_rows(bgra), 32, 32, 32))],
                                                        kind=2),
        "CUR: 32-bit BMP elsewhere (RGB)": icon_bytes([(32, 32, 0, 32, icon_dib(padded_rows(bgra), 32, 32, 32)),
                                                       (16, 16, 0, 32, icon_dib(padded_rows(bgra[:16, :64]), 16, 16,
                                                                                32))], kind=2),
        "CUR: 24-bit BMP": icon_bytes([(32, 32, 0, 24, icon_dib(padded_rows(bgr), 32, 32, 24, and_mask=mask))],
                                      kind=2),
        "CUR: 8-bit BMP": icon_bytes([(32, 32, 0, 8, icon_dib(padded_rows(idx), 32, 32, 8, and_mask=mask,
                                                              palette=palette(256, 62), colors=256))], kind=2),
        "CUR: a larger later entry": icon_bytes([(16, 16, 0, 24, icon_dib(padded_rows(bgr[:16, :48]), 16, 16, 24)),
                                                 (32, 32, 0, 24, icon_dib(padded_rows(bgr), 32, 32, 24))], kind=2),
    }


def psd_cases():
    a = picture(70)
    rgba = rgba_picture(71)
    bits = np.packbits(indices(1, 72), axis=1)
    pal = palette(256, 73).T.tobytes()  # a plane a colour
    extra = psd_resource(1005, b"\0" * 16) + psd_resource(1039, b"icc", name=b"ICC")
    layers = b"\0\0\0\x08" + bytes(8)
    cases = {}
    for comp, kind in ((0, "raw"), (1, "PackBits")):
        cases.update({
            f"bitmap (1) {kind}": psd_bytes(bits[None], 0, bits=1, compression=comp, width=W),
            f"grey (L) {kind}": psd_bytes(a[None, ..., 0], 1, compression=comp),
            f"grey colour mode 0 (L) {kind}": psd_bytes(a[None, ..., 1], 0, compression=comp),
            f"duotone (L) {kind}": psd_bytes(a[None, ..., 2], 8, compression=comp, colour_data=b"dt" * 10),
            f"multichannel (L) {kind}": psd_bytes(a.transpose(2, 0, 1), 7, compression=comp),
            f"indexed (P) {kind}": psd_bytes(indices(8, 74)[None], 2, compression=comp, colour_data=pal),
            f"RGB {kind}": psd_bytes(a.transpose(2, 0, 1), 3, compression=comp, resources=extra, layers=layers),
            f"RGBA {kind}": psd_bytes(rgba.transpose(2, 0, 1), 3, compression=comp),
            f"RGB of 5 channels {kind}": psd_bytes(np.concatenate([rgba, a[..., :1]], -1).transpose(2, 0, 1), 3,
                                                   compression=comp),
            f"CMYK {kind}": psd_bytes(np.concatenate([a, rgba[..., 3:]], -1).transpose(2, 0, 1), 4,
                                      compression=comp),
            f"Lab {kind}": psd_bytes(a.transpose(2, 0, 1), 9, compression=comp),
        })
    cases["indexed without 768 bytes of colour data (black)"] = psd_bytes(indices(8, 75)[None], 2,
                                                                          colour_data=pal[:300])
    return cases


FORMS = {"DIB": dib_cases, "QOI": qoi_cases, "PCX": pcx_cases, "SGI": sgi_cases, "ICO": icon_cases,
         "PSD": psd_cases}
CASES = [(form, case) for form, make in FORMS.items() for case in make()]


@pytest.mark.parametrize("form,case", CASES, ids=[f"{f}: {c}" for f, c in CASES])
def test_form_reads_as_pil_reads_it(tmp_path, cxx, form, case):
    data = FORMS[form]()[case]
    got = follows_pil(tmp_path, data, f"{form} {case}")
    assert got is not None, f"PIL refuses {form} {case}"


def test_every_qoi_op_and_pcx_branch_is_taken():
    """The QOI files hold each op, the PCX files each branch of PIL's
    `_open`: what the cases above claim to cover."""
    ops = qoi_ops_stream()
    assert ops[0] == 0xFE and ops[4] >> 6 == 1 and ops[5] >> 6 == 2 and ops[7] == 0xFF
    assert ops[12] >> 6 == 0 and ops[13] >> 6 == 3 and ops[14] >> 6 == 0
    big = qoi_bytes(np.repeat(np.repeat(picture(22, 9, 7), 6, 0), 6, 1))[14:-8]
    tags = {b >> 6 for b in big} | {b for b in big if b >= 0xFE}
    assert {0, 1, 2, 3, 0xFE} <= tags
    seen = set()
    for data in pcx_cases().values():
        at = 0 if data[0] == 10 else int.from_bytes(data[4:8], "little")  # a DCX's first frame
        version, bits, planes = data[at + 1], data[at + 3], data[at + 65]
        tail = len(data) >= 769 and data[-769] == 12 and data[-768:] != bytes(np.arange(256).repeat(3))
        seen.add((bits, planes, version == 5 and tail and bits == 8 and planes == 1))
    assert {(1, 1, False), (1, 2, False), (1, 4, False), (8, 1, True), (8, 1, False), (8, 3, False)} <= seen


# ---- refusals: where PIL raises, the port raises naming the file and the feature ----

def refused_files():
    a = picture(80)
    pc = pcx_bytes(pcx_lines(a, 8, 3, 54), W, H, 8, 3)
    sg = sgi_bytes(a, 1, True)
    ps = psd_bytes(a.transpose(2, 0, 1), 3, compression=1)
    bad_run = pcx_bytes(np.zeros((H, 54 * 3), np.uint8), W, H, 8, 3, body=bytes([0xFF, 7]) * 400)  # 63 a run
    return {
        "QOI: a stream cut short": (qoi_bytes(a)[:200], "QOI data ends before the last pixel"),
        "PCX: 4 bits x 1 plane": (pcx_bytes(indices(4)[:, :27], W, H, 4, 1),
                                  r"4 bits and 1 planes \(PIL: unknown PCX mode\)"),
        "PCX: a run across the end of a row": (bad_run, r"crosses the end of its row .*buffer overrun"),
        "PCX: grey shorter than its 769-byte palette": (pcx_bytes(np.zeros((4, 6), np.uint8), 5, 4, 8, 1),
                                                        "shorter than its 769-byte palette"),
        "PCX: data cut short": (pc[:400], "PCX data ends before the last row"),
        "DCX: a frame of 4 bits x 1 plane": (dcx_bytes([pcx_bytes(np.zeros((H, 27), np.uint8), W, H, 4, 1)]),
                                             "unknown PCX mode"),
        "SGI: 3 bytes a channel": (sg[:3] + b"\x03" + sg[4:], r"3 bytes a channel.*Unsupported SGI image mode"),
        "SGI: dimension 3, 1 channel": (sgi_bytes(a[..., :1], 1, dimension=3), "Unsupported SGI image mode"),
        "SGI: compression 2": (sgi_bytes(a, 1, compression=2), r"SGI compression 2 \(PIL: cannot load"),
        "SGI: verbatim data cut short": (sgi_bytes(a, 1)[:2000], "truncated SGI pixel data"),
        "SGI: an RLE offset inside the header": (sg[:512] + (100).to_bytes(4, "big") + sg[516:],
                                                 "SGI RLE data past its row or its file"),
        "PSD: 16 bits": (psd_bytes(a.transpose(2, 0, 1), 3, bits=16), "a PSD of colour mode 3 at 16 bits"),
        "PSD: RGB of 2 channels": (psd_bytes(a.transpose(2, 0, 1)[:2], 3), r"not enough channels"),
        "PSD: ZIP": (psd_bytes(a.transpose(2, 0, 1), 3, compression=2), r"PSD compression 2 \(PIL: cannot load"),
        "PSD: PackBits cut short": (ps[:len(ps) - 40], "PackBits data ends before the last row"),
        "PSD: duotone 16 bits": (psd_bytes(a[None, ..., 0], 8, bits=16), "colour mode 8 at 16 bits"),
        "ICO: a BMP entry of an unknown header": (icon_bytes([(8, 8, 0, 24, (99).to_bytes(4, "little") + bytes(99))]),
                                                  "a BMP header of 99 bytes"),
        "ICO: a 32-bit entry cut short": (icon_bytes([(8, 8, 0, 32, dib_bytes(bytes(64), 8, 16, 32))]),
                                          "truncated BMP pixel data"),
        "ICO: no entries": (b"\0\0\1\0\0\0" + bytes(40), "an ICO directory of no entries"),
        "CUR: a PNG entry": (icon_bytes([(8, 8, 0, 32, png_bytes(a[:8, :8]))], kind=2),
                             "a BMP header of 1196314761 bytes"),
        "DIB: BI_JPEG": (dib_bytes(bytes(64), 4, 4, 24, compression=4), r"BMP compression 4 \(BI_JPEG\)"),
        "DIB: pixel data cut short": (dib_bytes(padded_rows(a.reshape(H, -1)), W, H, 24)[:3000],
                                      "truncated BMP pixel data"),
    }


@pytest.mark.parametrize("case", list(refused_files()))
def test_refusals_name_the_file_and_the_feature(tmp_path, cxx, case):
    data, match = refused_files()[case]
    assert follows_pil(tmp_path, data, case) is None, f"PIL reads {case}"
    path = tmp_path / "refused.img"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)


# ---- PIL's order of formats: heads that two readers take ----

def crafted_heads():
    """Files whose first bytes more than one of PIL's plugins accepts; PIL
    tries them in `Image.ID` order and passes a file on where a plugin's
    open fails with SyntaxError, IndexError, TypeError or struct.error."""
    rows = np.random.default_rng(90).integers(0, 256, (6, 15)).astype(np.uint8)
    plain = tga_bytes(rows, 5, 6, 2, 24)
    ident = bytearray(tga_bytes(rows, 5, 6, 2, 24, ident=b"0123456789"))
    empty_box = ident.copy()
    empty_box[5] = 5  # a colour map length, no map: PCX's x0 of 1280 past its x1 of 1
    literal = np.random.default_rng(91).integers(0, 0xC0, (40, 120)).astype(np.uint8)  # no PCX run bytes
    as_pcx = bytearray(tga_bytes(literal, 40, 40, 2, 24, ident=b"0123456789"))
    as_pcx[3], as_pcx[65] = 1, 1  # a map index PCX reads as 1 bit, a pixel byte as 1 plane: a 1x1 PCX
    long_cur = bytearray(tga_bytes(literal, 40, 40, 2, 24))
    long_cur[5] = 1  # 256 CUR entries, all there; the one picked points past the end (struct.error)
    return {
        # 00 00 02 00: CUR's signature; a directory of 0 entries passes it on (TypeError)
        "TGA true colour, no ID (CUR accepts, no entries)": (plain, "TGA"),
        # a colour map length of 1 with no map: CUR reads 256 entries, runs out (IndexError), TGA reads it
        "TGA whose map length CUR takes for 256 entries": (tga_bytes(rows, 5, 6, 2, 24)[:5] + b"\x01"
                                                           + plain[6:], "TGA"),
        # a 10-byte ID, no map: PCX accepts (10, 0); its box is (0, 0)-(1, 1), 0 bits: unknown PCX mode, raised
        "TGA of a 10-byte ID (PCX: unknown mode)": (bytes(ident), None),
        # the same with a box PCX reads as empty: bad PCX image size, passed on
        "TGA of a 10-byte ID, PCX's box empty": (bytes(empty_box), "TGA"),
        "TGA that PIL reads as a 1x1 PCX": (bytes(as_pcx), "PCX"),
        "TGA whose 256 CUR entries are all there": (bytes(long_cur), "TGA"),
        # 00 00 01 00: ICO's signature; a type-1 TGA without a map, which no one reads
        "ICO's signature, no entries": (tga_bytes(rows[:, :5], 5, 6, 1, 8), None),
        "ICO's signature, an entry past the end": (b"\0\0\1\0\1\0" + bytes([8, 8, 0, 0, 1, 0, 24, 0])
                                                   + (40).to_bytes(4, "little") + (500).to_bytes(4, "little"), None),
        # DIB's test is the header size alone
        "DIB's header size, a header cut short": ((40).to_bytes(4, "little") + bytes(20), None),
        "DCX without frames": ((0x3ADE68B1).to_bytes(4, "little") + bytes(4), None),
        "SGI's magic, a header cut short": (b"\x01\xda\x00\x01\x00\x01", None),
        "PSD's signature, version 2": (b"8BPS\0\2" + bytes(40), None),
        "QOI of no width": (b"qoif" + bytes(4) + b"\0\0\0\x04\x03\0" + bytes(8), None),
    }


@pytest.mark.parametrize("case", list(crafted_heads()))
def test_crafted_heads_read_as_pil_reads_them(tmp_path, cxx, case):
    data, fmt = crafted_heads()[case]
    got = follows_pil(tmp_path, data, case)
    if fmt is None:
        assert got is None, case
    else:
        assert Image.open(io.BytesIO(data)).format == fmt and got is not None, case


def pils_order() -> list:
    """PIL's `Image.ID` as a fresh interpreter builds it (`Image.preinit()`,
    then `Image.init()`): the order `Image.open` tries the formats in when
    nothing else has imported a plugin. In a process that has imported
    plugins already (another test file's), `Image.ID` holds them in the
    order they were imported, which is not the order to hold the port to."""
    probe = "import json; from PIL import Image; Image.preinit(); Image.init(); print(json.dumps(Image.ID))"
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=120, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_readers_follow_pils_order():
    """`image_io.READERS` is PIL 12.1.0's `Image.ID` order of the formats the
    port reads (from a fresh interpreter, so whichever test ran before in
    this process), and each reader's test of the first bytes is PIL's; a
    format PIL registers without one (`Image.OPEN[name][1]` None: IM, IMT,
    IPTC, PCD, SPIDER) is tried on every file, as the port's is."""
    Image.init()
    ported = [name for name, _, _ in image_io.READERS]
    assert ported == [f for f in pils_order() if f in ported]
    heads = {"BMP": b"BM", "DIB": (40).to_bytes(4, "little"), "CUR": b"\0\0\2\0", "ICO": b"\0\0\1\0",
             "PCX": b"\x0a\x05", "DCX": (0x3ADE68B1).to_bytes(4, "little"), "PSD": b"8BPS", "QOI": b"qoif",
             "SGI": b"\x01\xda", "DDS": b"DDS ", "BLP": b"BLP2", "BUFR": b"ZCZC", "EPS": b"%!PS-Adobe",
             "FITS": b"SIMPLE  =", "FLI": bytes(4) + b"\x12\xaf" + bytes(10), "FTEX": b"FTEX",
             "GBR": (28).to_bytes(4, "big") + (2).to_bytes(4, "big"), "GRIB": b"GRIB\0\0\0\1",
             "HDF5": b"\x89HDF\r\n\x1a\n", "ICNS": b"icns", "MCIDAS": bytes(7) + b"\4", "MPEG": b"\0\0\1\xb3",
             "MSP": b"LinS", "PIXAR": b"\x80\xe8\0\0", "SUN": b"\x59\xa6\x6a\x95", "WMF": b"\xd7\xcd\xc6\x9a\0\0",
             "XBM": b" #define", "XPM": b"/* XPM */", "XVTHUMB": b"P7 332", "IM": b"Image type:", "IMT": b"width",
             "IPTC": b"\x1c\x02\0", "PCD": bytes(16), "SPIDER": bytes(16)}
    always = {"IM", "IMT", "IPTC", "PCD", "SPIDER"}
    # TGA registers none either: the port's test of its first bytes is its `_open`'s checks of the header
    assert always | {"TGA"} == {name for name, _, _ in image_io.READERS if Image.OPEN[name][1] is None}
    xbm_blanks = b" " * 10 + b"#define"  # past the 16 bytes PIL tests
    for name, accepts, _ in image_io.READERS:
        pil_accepts = Image.OPEN[name][1] or (lambda prefix: True)
        if name in heads:
            head = heads[name].ljust(18, b"\x01")
            assert accepts(head) and pil_accepts(head[:16]), name
            for other, h in [*heads.items(), ("XBM past 16 bytes", xbm_blanks)]:
                if other != name:
                    assert bool(accepts(h.ljust(18, b"\x01"))) == bool(pil_accepts(h.ljust(18, b"\x01")[:16])), \
                        (name, other)


# ---- mutated files: PIL's reading or a raise, nothing else ----

def mutants(form, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = int(rng.integers(1, 9)), int(rng.integers(1, 13))
        c = int(rng.choice([1, 3, 4]))
        if form == "SGI":
            bpc = int(rng.integers(1, 3))
            px = (rng.integers(0, 4, (h, w, c)) * (60 if bpc == 1 else 16000)).astype(np.uint16 if bpc == 2
                                                                                       else np.uint8)
            data, start = sgi_bytes(px, bpc, True), 512
        elif form == "QOI":
            data, start = qoi_bytes(rng.integers(0, 3, (h, w, max(c, 3))).astype(np.uint8) * 3), 14
        elif form == "PCX":
            lines = rng.integers(0, 3, (h, 3 * (w + w % 2))).astype(np.uint8) * 100
            data, start = pcx_bytes(lines, w, h, 8, 3, stride=w + w % 2), int(rng.choice([0, 128]))
        elif form == "PSD":
            planes = rng.integers(0, 3, (c if c > 1 else 1, h, w)).astype(np.uint8) * 7
            data, start = psd_bytes(planes, 3 if c > 1 else 1, compression=1), 26
        elif form == "ICO":
            rows = padded_rows(rng.integers(0, 256, (h, 3 * w)).astype(np.uint8))
            mask = rng.integers(0, 2, (h, w))
            data, start = icon_bytes([(w, h, 0, 24, icon_dib(rows, w, h, 24, and_mask=mask))]), 0
        elif form == "CUR":
            rows = padded_rows(rng.integers(0, 256, (h, 4 * w)).astype(np.uint8))
            data, start = icon_bytes([(w, h, 0, 32, icon_dib(rows, w, h, 32))], kind=2), 0
        else:
            rows = padded_rows(rng.integers(0, 256, (h, 3 * w)).astype(np.uint8))
            data, start = dib_bytes(rows, w, h, 24), 0
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(start, len(d)))
            d[i] = int(rng.integers(0, 256)) if rng.random() < 0.7 else d[i] ^ (1 << int(rng.integers(0, 8)))
        if rng.random() < 0.2:
            d = d[:int(rng.integers(start, len(d)))]
        out.append(bytes(d))
    return out


@pytest.mark.parametrize("form", ["QOI", "PCX", "SGI", "PSD", "ICO", "CUR", "DIB"])
def test_mutated_files_read_as_pil_reads_them(tmp_path, cxx, form):
    """Seeded mutations of small files (bytes replaced or flipped, the file
    cut short): PIL's pixels and RGBA, or a raise where PIL raises."""
    for i, data in enumerate(mutants(form, 60, 100 + len(form))):
        follows_pil(tmp_path, data, f"{form} mutant {i}")


# ---- no fallback ----

def test_failed_codec_build_raises_naming_the_source(tmp_path, fake_cxx):
    """QOI, PCX, SGI RLE and PSD PackBits cannot be read without the
    compiled codecs: each read raises, naming csrc/image_codecs.cc and the
    file; verbatim SGI, raw PSD, a DIB and an icon of BMP entries need no
    build."""
    fake_cxx(fail=True)
    a = picture(95, 9, 7)
    needs = {"v.qoi": qoi_bytes(a), "v.pcx": pcx_bytes(pcx_lines(a, 8, 3, 10), 9, 7, 8, 3),
             "v.sgi": sgi_bytes(a, 1, True), "v.psd": psd_bytes(a.transpose(2, 0, 1), 3, compression=1)}
    for name, data in needs.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(RuntimeError, match="csrc/image_codecs.cc") as err:
            image_io.open_image(path)
        assert str(path) in str(err.value)
    assert not cuda_build.host_library_path("image_codecs").exists()
    free = {"w.sgi": sgi_bytes(a, 1), "w.psd": psd_bytes(a.transpose(2, 0, 1), 3),
            "w.dib": dib_bytes(padded_rows(a.reshape(7, -1)), 9, 7, 24),
            "w.ico": icon_bytes([(9, 7, 0, 24, icon_dib(padded_rows(a.reshape(7, -1)), 9, 7, 24,
                                                        and_mask=np.zeros((7, 9))))])}
    for name, data in free.items():
        path = tmp_path / name
        path.write_bytes(data)
        assert image_io.open_image(path).pixels.shape[:2] == (7, 9)


# ---- the committed fixtures ----

@pytest.mark.parametrize("name", sorted(json.load(open(os.path.join(FIXTURES, "sha256.json")))["files"]))
def test_committed_fixture_reads_as_pil_and_the_json_say(tmp_path, cxx, name):
    with open(os.path.join(FIXTURES, "sha256.json")) as f:
        want = json.load(f)["files"][name]
    path = os.path.join(FIXTURES, name)
    im = Image.open(path)
    px = np.asarray(im)
    px = px[..., None] if px.ndim == 2 else px
    assert (im.mode, list(px.shape), sha256_of(px), sha256_of(np.asarray(im.convert("RGBA")))) == \
        (want["mode"], want["shape"], want["sha256"], want["rgba_sha256"])
    got = image_io.open_image(path)
    assert (got.mode, list(got.pixels.shape), sha256_of(got.pixels), sha256_of(image_io.to_rgba(got))) == \
        (want["mode"], want["shape"], want["sha256"], want["rgba_sha256"])


def test_chip_smoke_forms_read_as_the_json_says(cxx):
    """Phase 5h's files, written again here by chip_smoke.py's
    `legacy_form_files` (tests/torch_image_writers.py), are the bytes whose
    PIL reading sha256.json holds, and the port reads each as PIL did."""
    with open(os.path.join(FIXTURES, "sha256.json")) as f:
        readings = json.load(f)["chip_smoke"]
    made = legacy_form_files()
    assert sorted(made) == sorted(readings) and len(made) == 9
    for name, data in made.items():
        want = readings[name]
        assert hashlib.sha256(data).hexdigest() == want["file_sha256"], name
        assert want["shape"][:2] == ([256, 256] if name.startswith("ICO") else [1080, 1920]), name
        pic = _read_bytes(data, name)
        assert (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels)) == \
            (want["mode"], want["shape"], want["sha256"]), name


def _read_bytes(data: bytes, name: str):
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "form")
        with open(path, "wb") as f:
            f.write(data)
        return image_io.open_image(path)


# ---- both dataset paths against the JAX package ----

def colmap_views(w, h):
    """Views whose np.asarray is the picture: each form in each of its
    modes L, RGB and RGBA."""
    a, rgba = picture(110, w, h), rgba_picture(111, w, h)
    bgra = rgba[..., [2, 1, 0, 3]].reshape(h, -1)
    return {
        "v_dib24.dib": dib_bytes(padded_rows(a[..., ::-1].reshape(h, -1)), w, h, 24),
        "v_dib_grey.dib": pil_save(a, "DIB", "L"),
        "v_qoi_rgb.qoi": qoi_bytes(a),
        "v_qoi_rgba.qoi": qoi_bytes(rgba),
        "v_pcx_rgb.pcx": pil_save(a, "PCX"),
        "v_pcx_grey.pcx": pil_save(a, "PCX", "L"),
        "v_dcx.dcx": dcx_bytes([pil_save(a, "PCX")]),
        "v_sgi_grey16_rle.sgi": sgi_bytes(a[..., :1].astype(np.uint16) * 257, 2, True),
        "v_sgi_rgb_rle.sgi": sgi_bytes(a, 1, True),
        "v_sgi_rgba16.sgi": sgi_bytes(rgba.astype(np.uint16) * 257, 2),
        "v_ico_bmp.ico": icon_bytes([(w, h, 0, 32, icon_dib(padded_rows(bgra), w, h, 32,
                                                            and_mask=np.zeros((h, w))))]),
        "v_ico_png.ico": icon_bytes([(w, h, 0, 24, png_bytes(a))]),
        "v_cur24.cur": icon_bytes([(w, h, 0, 24, icon_dib(padded_rows(a[..., ::-1].reshape(h, -1)), w, h, 24))],
                                  kind=2),
        "v_psd_rgb_rle.psd": psd_bytes(a.transpose(2, 0, 1), 3, compression=1),
        "v_psd_rgba.psd": psd_bytes(rgba.transpose(2, 0, 1), 3),
        "v_psd_grey_rle.psd": psd_bytes(a[None, ..., 0], 1, compression=1),
    }


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_legacy_views_match_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of views in every new form and picture mode: the
    Scene's cameras equal the JAX package's, images bit for bit."""
    from test_torch_scene import both_scenes

    w, h = 45, 37
    src = str(tmp_path / "forms")
    views = colmap_views(w, h)
    write_colmap_dataset_of(src, views, w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == len(views)
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


def refused_views():
    a = picture(120, 13, 11)
    bits = np.packbits(a[..., 0] > 128, axis=1)
    return {
        "palette PCX": ("view.pcx", pil_save(a, "PCX", "P"), "P"),
        "1-bit PCX": ("view.pcx", pil_save(a, "PCX", "1"), "1"),
        "bitmap PSD": ("view.psd", psd_bytes(bits[None], 0, bits=1, width=13), "1"),
        "indexed PSD": ("view.psd", psd_bytes(a[None, ..., 0], 2, colour_data=palette(256).T.tobytes()), "P"),
        "CMYK PSD": ("view.psd", psd_bytes(np.concatenate([a, a[..., :1]], -1).transpose(2, 0, 1), 4), "CMYK"),
        "Lab PSD": ("view.psd", psd_bytes(a.transpose(2, 0, 1), 9, compression=1), "LAB"),
        "ICO of a P PNG": ("view.ico", icon_bytes([(13, 11, 0, 8, pil_save(a, "PNG", "P"))]), "P"),
        "palette DIB": ("view.dib", pil_save(a, "DIB", "P"), "P"),
        "palette CUR": ("view.cur", icon_bytes([(13, 11, 0, 8, icon_dib(
            padded_rows(a[..., 0]), 13, 11, 8, palette=palette(256), colors=256))], kind=2), "P"),
    }


@pytest.mark.parametrize("form", list(refused_views()))
def test_colmap_refuses_modes_that_are_not_the_picture(tmp_path, cxx, form):
    """The JAX package's COLMAP path trains on np.asarray of these (indices,
    0 or 1, C, M, Y and K, L, a and b): the port refuses each through
    load_camera, naming the file as images.bin lists it and the mode."""
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
    a, rgba = picture(130, w, h), rgba_picture(131, w, h)
    bgra = rgba[..., [2, 1, 0, 3]].reshape(h, -1)
    return [
        pil_save(a, "DIB", "P"),
        dib_bytes(padded_rows(bgra), w, h, 32, 124, compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        qoi_bytes(rgba),
        pil_save(a, "PCX", "1"),
        pcx_bytes(pcx_lines(indices(4, 132, w, h), 1, 4, (w + 7) // 8), w, h, 1, 4, version=2,
                  header_palette=palette(16, 133)),
        dcx_bytes([pil_save(a, "PCX", "P")]),
        sgi_bytes(rgba, 1, True),
        sgi_bytes(rgba[..., :1].astype(np.uint16) * 300, 2),
        icon_bytes([(w, h, 0, 24, icon_dib(padded_rows(a[..., ::-1].reshape(h, -1)), w, h, 24,
                                           and_mask=indices(1, 134, w, h)))]),
        icon_bytes([(w, h, 0, 32, icon_dib(padded_rows(bgra), w, h, 32))], kind=2),
        psd_bytes(rgba.transpose(2, 0, 1), 3, compression=1),
        psd_bytes(np.concatenate([a, rgba[..., 3:]], -1).transpose(2, 0, 1), 4),
        psd_bytes(a.transpose(2, 0, 1), 9, compression=1),  # PIL's RGBA of it: alpha 0
        psd_bytes(indices(8, 135, w, h)[None], 2, colour_data=palette(256, 136).T.tobytes(), compression=1),
    ]


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_legacy_frames_match_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on frames in every new form: PIL's
    convert("RGBA") through the composite, bit for bit, then load_camera at
    -r 2."""
    w, h = 45, 37
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
