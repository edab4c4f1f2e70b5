"""Generate the fixtures of tests/test_torch_avif.py and of chip_smoke.py's
phases 5j and 5k: AVIF files written by PIL 12.1.0 (libavif 1.3.0, aom
3.12.1) from seeded numpy pictures, and PIL's reading of each.

- Small files: RGBA with premultiplied alpha (65x33), limited-range 4:2:2
  (130x67), 4:0:0 (7x5), 2x2 tiles (256x256) and an EXIF orientation of 6
  (1x1); and three that use AV1's CDEF and loop restoration: 4:2:2 with
  CDEF (130x67), 4:0:0 with self-guided restoration (160x96), RGBA with
  128x128 superblocks (130x67).
- Seven 1920x1080 files, the views of phase 5j: 4:2:0 at quality 75 and
  PIL's default speed, 4:4:4 at quality 90, 4:0:0, RGBA, limited range,
  2x2 tiles, and 4:2:0 at quality 50 and speed 10.
- Three 1920x1080 files of phase 5k, with CDEF and loop restoration: 4:2:0
  at quality 50 and speed 2 with CDEF on, 4:4:4 at quality 60 and speed 4
  with CDEF on, 4:2:0 at quality 50 and speed 0.
- `sha256.json`: for each file, PIL's mode, the shape of
  `np.asarray(Image.open(f))`, the SHA-256 of those pixels' bytes and of
  the file itself. It holds the port to PIL where the machine's PIL has
  no AVIF.

Run from the repo root:  python tests/fixtures/torch_avif/make_fixtures.py
(about 40 s). The files are checked in; regenerate only if the cases change.
"""

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
CDEF_ON = {"enable-cdef": "1"}  # aom 3.12.1 leaves CDEF off for still pictures unless asked


def picture(h, w, channels, seed):
    """A render-like picture: smooth shading, oriented edges, a flat patch
    and a little noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    s = max(h, w) / 256.0
    out = []
    for c in range(channels):
        v = 120 + 60 * np.sin(xx / (23 * s + 4 * c) + yy / (31 * s + 3 * c))
        v += 40 * (((np.cos(0.4 + c) * xx + np.sin(0.4 + c) * yy) / (17 * s + 1)) % 2 < 1)
        out.append(v)
    a = np.stack(out, -1) + rng.normal(0, 2.5, (h, w, channels))
    a[h // 3:h // 2, w // 5:w // 3] = 90 + 30 * np.arange(channels)
    return np.clip(a, 0, 255).astype(np.uint8)


def alpha_picture(h, w, seed):
    a = picture(h, w, 4, seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a[..., 3] = np.clip(255 * np.abs(np.sin(xx / (w / 3 + 1) + yy / (h / 2 + 1))), 0, 255).astype(np.uint8)
    return a


def cases():
    """file name: (picture, PIL's save options)."""
    exif = Image.Exif()
    exif[0x0112] = 6
    return {
        "rgba_premultiplied_65x33.avif": (alpha_picture(33, 65, 1), dict(quality=60, alpha_premultiplied=True)),
        "limited_422_130x67.avif": (picture(67, 130, 3, 2), dict(quality=50, subsampling="4:2:2", range="limited")),
        "mono_7x5.avif": (picture(5, 7, 3, 3), dict(quality=75, subsampling="4:0:0")),
        "tiles_2x2_256x256.avif": (picture(256, 256, 3, 4), dict(quality=70, tile_rows=1, tile_cols=1)),
        "exif6_1x1.avif": (picture(1, 1, 3, 5), dict(quality=90, exif=exif)),
        "1080p_420_q75.avif": (picture(1080, 1920, 3, 10), dict(quality=75)),
        "1080p_444_q90.avif": (picture(1080, 1920, 3, 11), dict(quality=90, subsampling="4:4:4")),
        "1080p_400_q75.avif": (picture(1080, 1920, 3, 12), dict(quality=75, subsampling="4:0:0")),
        "1080p_rgba_q75.avif": (alpha_picture(1080, 1920, 13), dict(quality=75)),
        "1080p_limited_q75.avif": (picture(1080, 1920, 3, 14), dict(quality=75, range="limited")),
        "1080p_tiles_2x2_q75.avif": (picture(1080, 1920, 3, 15), dict(quality=75, tile_rows=1, tile_cols=1)),
        "1080p_420_q50_s10.avif": (picture(1080, 1920, 3, 16), dict(quality=50, speed=10)),
        "cdef_422_130x67.avif": (picture(67, 130, 3, 6), dict(quality=60, speed=4, subsampling="4:2:2",
                                                               advanced=CDEF_ON)),
        "sgrproj_400_160x96.avif": (picture(96, 160, 3, 7), dict(quality=50, speed=4, subsampling="4:0:0")),
        "rgba_sb128_130x67.avif": (alpha_picture(67, 130, 8), dict(quality=50, speed=2,
                                                                  advanced={**CDEF_ON, "sb-size": "128"})),
        "1080p_420_q50_s2_cdef.avif": (picture(1080, 1920, 3, 17), dict(quality=50, speed=2, advanced=CDEF_ON)),
        "1080p_444_q60_s4_cdef.avif": (picture(1080, 1920, 3, 18), dict(quality=60, speed=4, subsampling="4:4:4",
                                                                        advanced=CDEF_ON)),
        "1080p_420_q50_s0.avif": (picture(1080, 1920, 3, 19), dict(quality=50, speed=0)),
    }


def digest(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def main():
    readings = {}
    for name, (px, options) in cases().items():
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "AVIF", **options)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        im = Image.open(io.BytesIO(data))
        a = np.asarray(im)
        readings[name] = {"mode": im.mode, "shape": list(a.shape), "sha256": digest(a.tobytes()),
                          "file_sha256": digest(data)}
        print(f"{name}: {len(data)} bytes, {im.mode} {a.shape}")
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump({"pil": Image.__version__, "files": readings}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
