"""Generate the fixtures of tests/test_torch_legacy_forms.py and of
chip_smoke.py's phase 5h: small DIB, QOI, PCX, DCX, SGI, ICO, CUR and PSD
files and PIL's reading of each, and PIL's reading of each 1080p file
phase 5h writes.

- Small files (64x48 at most), one a form and mode, written by
  `tests/torch_image_writers.py` (PIL writes only some of them).
- `sha256.json`: under "files", PIL's reading of each small file (its
  mode, the shape of `np.asarray(Image.open(f))` with a channel axis, the
  SHA-256 of those pixels' bytes and of `convert("RGBA")`); under
  "chip_smoke", PIL's reading of each file `chip_smoke.legacy_form_files()`
  makes, with the SHA-256 of the file itself: the card's machine, which
  has no PIL 12.1.0, writes those files again and holds the port to these
  hashes.

Run from the repo root:  python tests/fixtures/torch_legacy_forms/make_fixtures.py
(about 20 s). The files are checked in; regenerate only if the cases change.
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def digest(a) -> str:
    """The SHA-256 of pixels' bytes (mode "1": as 0 / 1 bytes), as
    chip_smoke.sha256_of."""
    a = a.astype(np.uint8) if a.dtype == bool else a
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def reading(data: bytes, rgba: bool) -> dict:
    im = Image.open(io.BytesIO(data))
    px = np.asarray(im)
    px = px[..., None] if px.ndim == 2 else px
    out = {"mode": im.mode, "shape": list(px.shape), "sha256": digest(px)}
    if rgba:
        out["rgba_sha256"] = digest(np.asarray(im.convert("RGBA")))
    return out


def small_files() -> dict:
    import torch_image_writers as w

    rng = np.random.default_rng(2022)
    h, wd = 48, 63
    yy, xx = np.mgrid[0:h, 0:wd]
    rgb = np.clip(np.stack([128 + 90 * np.sin(xx / (5 + 2 * i) + yy / (7 + i)) for i in range(3)], -1)
                  + rng.normal(0, 6, (h, wd, 3)), 0, 255).astype(np.uint8)
    alpha = np.where(xx < 20, 0, np.where(xx > 40, 255, 6 * xx)).astype(np.uint8)
    rgba = np.concatenate([rgb, alpha[..., None]], -1)
    idx = (rgb[..., 0] // 16).astype(np.uint8)
    pal16 = rng.integers(0, 256, (16, 3))
    pal256 = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    bgr = rgb[..., ::-1].reshape(h, -1)
    p_png = io.BytesIO()
    Image.fromarray(rgb[:32, :32]).quantize(20).save(p_png, "PNG", transparency=3)
    return {
        "dib_os2_8bit.dib": w.dib_bytes(w.padded_rows(rgb[..., 1]), wd, h, 8, header_size=12,
                                        palette=pal256),
        "qoi_rgba.qoi": w.qoi_bytes(rgba),
        "pcx_p4_padded.pcx": w.pcx_bytes(w.pcx_lines(idx, 1, 4, 8), wd, h, 1, 4, version=2, header_palette=pal16),
        "pcx_palette.pcx": w.pcx_bytes(np.pad(rgb[..., 2], ((0, 0), (0, 1))), wd, h, 8, 1, tail_palette=pal256),
        "dcx_two_frames.dcx": w.dcx_bytes([w.pcx_bytes(w.pcx_lines(rgb, 8, 3, 64), wd, h, 8, 3),
                                           w.pcx_bytes(np.pad(rgb[..., 0], ((0, 0), (0, 1))), wd, h, 8, 1,
                                                       tail_palette=pal256)]),
        "sgi_rle_16bit_rgba.sgi": w.sgi_bytes(rgba.astype(np.uint16) * 257 + xx[..., None].astype(np.uint16), 2,
                                              rle=True),
        "ico_png_p_and_bmp.ico": w.icon_bytes([(32, 32, 20, 8, p_png.getvalue()),
                                               (24, 24, 0, 24, w.icon_dib(w.padded_rows(bgr[:24, :72]), 24, 24, 24,
                                                                          and_mask=(idx[:24, :24] > 7)))]),
        "ico_bmp_4bit_mask.ico": w.icon_bytes([(32, 32, 16, 4, w.icon_dib(
            w.padded_rows(idx[:32, 0:32:2] << 4 | idx[:32, 1:32:2]), 32, 32, 4, and_mask=rgb[:32, :32, 1] > 128,
            palette=pal16, colors=16))]),
        "cur_32bit.cur": w.icon_bytes([(32, 32, 0, 32, w.icon_dib(w.padded_rows(
            rgba[:32, :32, [2, 1, 0, 3]].reshape(32, -1)), 32, 32, 32))], kind=2),
        "psd_rle_cmyk.psd": w.psd_bytes(np.concatenate([rgb, rgb[..., :1]], -1).transpose(2, 0, 1), 4,
                                        compression=1, resources=w.psd_resource(1005, b"\0" * 16)),
        "psd_raw_lab.psd": w.psd_bytes(rgb.transpose(2, 0, 1), 9),
        "psd_rle_palette.psd": w.psd_bytes(idx[None], 2, compression=1, colour_data=pal256.T.tobytes()),
    }


def main():
    from chip_smoke import legacy_form_files

    readings = {"files": {}, "chip_smoke": {}}
    for name, data in small_files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        readings["files"][name] = reading(data, rgba=True)
    for name, data in legacy_form_files().items():
        readings["chip_smoke"][name] = {**reading(data, rgba=False), "file_sha256": hashlib.sha256(data).hexdigest()}
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(readings, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
