"""Generate the fixtures of tests/test_torch_avif_grid.py and of chip_smoke.py's
phase 5q: AVIF grid images (and one file with a gain map) written by the
libavif 1.3.0 that PIL 12.1.0 ships, through tests/torch_image_writers.py's
`avif_grid_bytes` and `avif_gain_map_bytes`, from seeded numpy pictures, and
PIL's reading of each.

- Small grids of 64x64 cells (libavif's least): 2x2 at 4:2:0, 4:2:2, 4:4:4
  and 4:0:0; 3x2 of a 170x100 picture, whose right column (42 px) and
  bottom row (36 px) libavif pads and the reader crops; RGBA with an alpha
  grid, at 4:2:0 and premultiplied at 4:4:4; limited range at 4:2:2;
  3x1 and 1x3; and, at 4:2:0 and 4:2:2, chroma that jumps between two
  colours at every cell seam (libyuv's upsampling reads across the seams).
- One 1920x1080 grid, 2x2 cells of 960x540 at 4:2:0.
- One 128x128 picture with a gain map: libavif's `av01` primary item (the
  SDR base PIL shows), a `tmap` item and the gain map's `av01` item.
- `sha256.json`: for each file, PIL's mode, the shape of
  `np.asarray(Image.open(f))`, the SHA-256 of those pixels' bytes and of
  the file itself. It holds the port to PIL where the machine's PIL has
  no AVIF.

Run from the repo root:  python tests/fixtures/torch_avif_grid/make_fixtures.py
(about 10 s). The files are checked in; regenerate only if the cases change.
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
import torch_image_writers as writers  # noqa: E402  (tests/, beside the fixtures)


def picture(h, w, seed):
    """A render-like RGB picture: smooth shading, oriented edges, a flat
    patch and a little noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    s = max(h, w) / 256.0
    out = []
    for c in range(3):
        v = 120 + 60 * np.sin(xx / (23 * s + 4 * c) + yy / (31 * s + 3 * c))
        v += 40 * (((np.cos(0.4 + c) * xx + np.sin(0.4 + c) * yy) / (17 * s + 1)) % 2 < 1)
        out.append(v)
    a = np.stack(out, -1) + rng.normal(0, 2.5, (h, w, 3))
    a[h // 3:h // 2, w // 5:w // 3] = 90 + 30 * np.arange(3)
    return np.clip(a, 0, 255).astype(np.uint8)


def alpha_of(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    a = 255 * np.abs(np.sin(xx / (w / 3 + 1) + yy / (h / 2 + 1)))
    a[: h // 4] = 255
    a[h - h // 4:, : w // 4] = 0
    return a.astype(np.uint8)


def seam_planes(h, w, cell, subsampling, seed):
    """Y from a picture; U and V that jump between two far-apart values
    from one cell to the next, across every seam."""
    y, u, v = writers.yuv_planes(picture(h, w, seed), subsampling)
    sx, sy = writers.AVIF_SUBSAMPLING[subsampling]
    cy, cx = np.mgrid[0:u.shape[0], 0:u.shape[1]]
    col, row = (cx << sx) // cell[0], (cy << sy) // cell[1]
    return y, np.where((col + row) % 2, 230, 25).astype(np.uint8), np.where(col % 2, 30, 220).astype(np.uint8)


def cases():
    """file name: the bytes (None where PIL ships no libavif)."""
    g = writers.avif_grid_bytes
    yuv = writers.yuv_planes
    p = picture(128, 128, 1)
    return {
        "grid_420_2x2.avif": g(yuv(p, "4:2:0"), (64, 64), "4:2:0"),
        "grid_422_2x2.avif": g(yuv(picture(128, 128, 2), "4:2:2"), (64, 64), "4:2:2", quality=70),
        "grid_444_2x2.avif": g(yuv(picture(128, 128, 3), "4:4:4"), (64, 64), "4:4:4", quality=80),
        "grid_400_2x2.avif": g(yuv(p, "4:0:0"), (64, 64), "4:0:0"),
        "grid_420_crop_170x100.avif": g(yuv(picture(100, 170, 4), "4:2:0"), (64, 64), "4:2:0"),
        "grid_rgba_420_2x2.avif": g(yuv(picture(128, 128, 5), "4:2:0"), (64, 64), "4:2:0",
                                    alpha=alpha_of(128, 128)),
        "grid_rgba_444_premultiplied_2x2.avif": g(yuv(picture(128, 128, 6), "4:4:4"), (64, 64), "4:4:4",
                                                  alpha=alpha_of(128, 128), premultiplied=True),
        "grid_422_limited_2x2.avif": g(yuv(picture(128, 128, 7), "4:2:2", False), (64, 64), "4:2:2",
                                       full_range=False),
        "grid_420_3x1.avif": g(yuv(picture(64, 192, 8), "4:2:0"), (64, 64), "4:2:0"),
        "grid_420_1x3.avif": g(yuv(picture(192, 64, 9), "4:2:0"), (64, 64), "4:2:0"),
        "grid_420_seams_3x2.avif": g(seam_planes(128, 192, (64, 64), "4:2:0", 10), (64, 64), "4:2:0", quality=90),
        "grid_422_seams_3x2.avif": g(seam_planes(128, 192, (64, 64), "4:2:2", 11), (64, 64), "4:2:2", quality=90),
        "1080p_grid_420_2x2.avif": g(yuv(picture(1080, 1920, 12), "4:2:0"), (960, 540), "4:2:0", speed=8),
        "gain_map_128x128.avif": writers.avif_gain_map_bytes(yuv(picture(128, 128, 13), "4:4:4"),
                                                            yuv(255 - picture(128, 128, 14), "4:4:4"), (64, 64)),
    }


def digest(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def main():
    readings = {}
    for name, data in cases().items():
        if data is None:
            raise SystemExit("this PIL ships no libavif 1.x (pillow.libs/libavif-*.so*)")
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        im = Image.open(io.BytesIO(data))
        a = np.asarray(im)
        readings[name] = {"mode": im.mode, "shape": list(a.shape), "sha256": digest(a.tobytes()),
                          "file_sha256": digest(data)}
        print(f"{name}: {len(data)} bytes, {im.mode} {a.shape}")
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump({"pil": Image.__version__, "libavif": writers.avif_library().avifVersion().decode(),
                   "files": readings}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
