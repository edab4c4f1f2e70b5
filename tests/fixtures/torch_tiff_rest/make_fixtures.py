"""Generate the TIFF fixtures of tests/test_torch_tiff_rest.py and
chip_smoke.py: fax, old-style JPEG, YCbCr and CIELab without JPEG,
float, palette + alpha and ThunderScan files, and PIL's reading of each.

- Small files (64x48 at most), PIL-written where PIL writes the form:
  modified Huffman, Group 3 1-D and 2-D, Group 4 (bilevel), CIELab LZW,
  float32 deflate with Predictor 3, palette + alpha deflate; written by
  `tests/torch_image_writers.py` where PIL does not write it: old-style
  JPEG with its tables in tags and with a JPEGInterchangeFormat stream,
  ThunderScan, YCbCr LZW 4:2:0 and YCbCr deflate 4:1 in tiles.
- `bilevel_g4_1920x1080.tif`, `bilevel_g3_2d_1920x1080.tif`: PIL-written
  Group 4 and Group 3 2-D files of chip_smoke.py's 1080p bilevel picture.
- `sha256.json`: PIL's reading of each (its mode, the shape of
  `np.asarray(Image.open(f))`, the SHA-256 of those pixels' bytes, and for
  the small files the SHA-256 of `convert("RGBA")`), and of each 1080p
  file `chip_smoke.rest_form_files()` makes, with the SHA-256 of the file
  itself for the old-style JPEG (its encoder is this repo's; the lossless
  ones hold their picture whatever the coder's bytes).

The machine with the card reads these files and writes chip_smoke's own
there; the port is held to these hashes.

Run from the repo root:  python tests/fixtures/torch_tiff_rest/make_fixtures.py
(about 30 s). The files are checked in; regenerate only if the cases change.
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
    """The SHA-256 of pixels' bytes (mode "1": as 0 / 1 bytes; PIL's
    np.asarray holds its bools in other bytes), as chip_smoke.sha256_of."""
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


def pil_tiff(im, **options) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "TIFF", **options)
    return buf.getvalue()


def jpeg(a, subsampling, restart_rows=None) -> bytes:
    buf = io.BytesIO()
    options = {"quality": 90, "subsampling": subsampling}
    if restart_rows:
        options["restart_marker_rows"] = restart_rows
    Image.fromarray(a).save(buf, "JPEG", **options)
    return buf.getvalue()


def small_files() -> dict:
    from torch_image_writers import ojpeg_tiff, thunderscan_encode, tiff_bytes

    rng = np.random.default_rng(2020)
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.clip(np.stack([128 + 90 * np.sin(xx / (5 + 2 * i) + yy / (7 + i)) for i in range(3)], -1)
                  + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
    bw = (rgb[..., 0] > 128) ^ (rng.random((h, w)) < 0.03)
    lum = ((rgb.astype(np.int64) * [299, 587, 114]).sum(-1) // 1000)
    pa = Image.new("PA", (w, h))
    pa.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
    pa.putdata(list(zip((lum // 8).ravel().tolist(), rgb[..., 2].ravel().tolist())))
    return {
        "fax_mh.tif": pil_tiff(Image.fromarray(bw), compression="tiff_ccitt"),
        "fax_g3_1d.tif": pil_tiff(Image.fromarray(bw), compression="group3"),
        "fax_g3_2d.tif": pil_tiff(Image.fromarray(bw), compression="group3", tiffinfo={292: 1, 278: 16}),
        "fax_g4.tif": pil_tiff(Image.fromarray(bw), compression="group4"),
        "lab_lzw.tif": pil_tiff(Image.fromarray(rgb, "LAB"), compression="tiff_lzw"),
        "float_deflate_p3.tif": pil_tiff(Image.fromarray((lum.astype(np.float32) - 100) / 7, "F"),
                                         compression="tiff_adobe_deflate", tiffinfo={317: 3}),
        "palette_alpha_deflate.tif": pil_tiff(pa, compression="tiff_adobe_deflate"),
        "ojpeg_tags_420.tif": ojpeg_tiff([jpeg(rgb, 2, 1)], w, h, rows_per_strip=16),
        "ojpeg_jif_422.tif": ojpeg_tiff([jpeg(rgb, 1, 2)], w, h, rows_per_strip=16, jif=True),
        "thunderscan.tif": tiff_bytes((lum >> 4)[..., None], 4, 1, compression=32809, rows_per_strip=16,
                                      encode=lambda c: thunderscan_encode(c[..., 0])),
        "ycbcr_lzw_420.tif": tiff_bytes(rgb.astype(np.int64), 8, 6, compression=5, rows_per_strip=16,
                                        ycbcr=(2, 2)),
        "ycbcr_deflate_41_tiles.tif": tiff_bytes(rgb.astype(np.int64), 8, 6, compression=8, tile=(32, 32),
                                                 ycbcr=(4, 1)),
    }


def main():
    from chip_smoke import REST_G3, REST_G4, bilevel_picture, rest_form_files

    readings = {}
    for name, data in small_files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        readings[name] = reading(data, rgba=True)
    bw = Image.fromarray(bilevel_picture())
    for name, options in ((REST_G4, {"compression": "group4"}),
                          (REST_G3, {"compression": "group3", "tiffinfo": {292: 1}})):
        data = pil_tiff(bw, **options)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        readings[name] = reading(data, rgba=False)
    for name, data in rest_form_files().items():
        readings[name] = reading(data, rgba=False)
        if "JPEG" in name:
            readings[name]["file_sha256"] = hashlib.sha256(data).hexdigest()
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(readings, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
