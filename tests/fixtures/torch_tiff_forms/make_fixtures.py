"""Generate the ZSTD and LZMA TIFF fixtures of tests/test_torch_tiff_forms.py
and chip_smoke.py, and PIL's reading of the 1080p files chip_smoke.py
writes itself.

- `zstd_rgb_1920x1080.tif`: a 1920x1080 RGB TIFF PIL writes with
  compression "zstd" (libtiff: one Zstandard frame a strip), and
  `lzma_rgb_predictor_1920x1080.tif`, the same picture with compression
  "lzma" (one .xz stream a strip) and Predictor 2. The picture is smooth
  waves in steps of 8 levels, so that both files stay small.
- `sha256.json`: PIL's reading of each (its mode, the shape of
  `np.asarray(Image.open(f))` and the SHA-256 of those pixels' bytes),
  and of each file `chip_smoke.form_files()` makes (YCbCr JPEG-in-TIFF,
  planar LZMA BigTIFF, 16-bit planar deflate, BigTIFF deflate), with the
  SHA-256 of the file itself for the JPEG one (its encoder is this repo's;
  the lossless ones hold their picture whatever the coder's bytes).

The machine with the card reads these files and writes chip_smoke's own
there; the port is held to these hashes.

Run from the repo root:  python tests/fixtures/torch_tiff_forms/make_fixtures.py
(about a minute). The files are checked in; regenerate only if the cases
change.
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

W, H = 1920, 1080


def picture(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / (97 + 31 * i) + yy / (143 + 17 * i))
                  + 20 * np.cos((xx + 2 * yy) / (211 + 13 * i)) for i in range(3)], -1)
    return (np.clip(a, 0, 255).astype(np.uint8) // 8 * 8).astype(np.uint8)


def reading(data: bytes) -> dict:
    im = Image.open(io.BytesIO(data))
    px = np.asarray(im)
    px = px[..., None] if px.ndim == 2 else px
    return {"mode": im.mode, "shape": list(px.shape), "sha256": hashlib.sha256(np.ascontiguousarray(px).tobytes())
            .hexdigest()}


def main():
    from chip_smoke import form_files

    px = picture(H, W)
    readings = {}
    for name, options in (("zstd_rgb_1920x1080.tif", {"compression": "zstd"}),
                          ("lzma_rgb_predictor_1920x1080.tif", {"compression": "lzma", "tiffinfo": {317: 2}})):
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "TIFF", **options)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(buf.getvalue())
        readings[name] = reading(buf.getvalue())
    for name, data in form_files().items():
        readings[name] = reading(data)
        if "JPEG" in name:
            readings[name]["file_sha256"] = hashlib.sha256(data).hexdigest()
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(readings, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
