"""Generate the fixtures of tests/test_torch_avif_hbd.py and of chip_smoke.py's
phase 5r: 10- and 12-bit AVIF files made by relabelling 8-bit files
(tests/torch_image_writers.py's `avif_high_depth`: AV1's syntax below the
sequence header is the same at every depth but for palette colours), and
PIL 12.1.0's reading of each.

- Small files, written by PIL 12.1.0 (libavif 1.3.0, aom 3.12.1) or by the
  libavif it ships (grids, `avif_grid_bytes`) from seeded numpy pictures,
  then relabelled and checked in: 4:2:2 at 10 bits (profile 2) at 64x64,
  96x64 and 128x128; 12 bits at 4:2:0 (RGB and RGBA), 4:4:4 and 4:0:0;
  10-bit premultiplied RGBA at 4:4:4; 10-bit Wiener and self-guided
  restoration at speed 0 with CDEF (200x131); 2x2 grids of 64x64 cells at
  10 bits (4:2:0) and 12 bits (RGBA 4:4:4).
- The committed fixtures of tests/fixtures/torch_avif (but the two whose
  screen content uses palette colours) relabelled to 10 and 12 bits at
  test time: no file is written for them here, only PIL's reading.
- `sha256.json`: "files", for each small file PIL's mode, the shape of
  `np.asarray(Image.open(f))`, the SHA-256 of those pixels' bytes and of
  the file; "relabelled", the same for each "<fixture>@<depth>" (the
  relabelled file's own SHA-256 too). It holds the port to PIL where the
  machine's PIL has no AVIF, or another version of it.

Run from the repo root:  python tests/fixtures/torch_avif_hbd/make_fixtures.py
(about 15 s). The files are checked in; regenerate only if the cases change.
"""

import glob
import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, TESTS)
import torch_image_writers as writers  # noqa: E402  (tests/, beside the fixtures)

EIGHT_BIT = os.path.join(TESTS, "fixtures", "torch_avif")
PALETTE = ("1080p_screen_420_q60.avif", "1080p_screen_444_q75.avif")  # PIL fails on these above 8 bits


def picture(h, w, seed, channels=3):
    """A render-like picture: smooth shading, oriented edges, a flat patch
    and a little noise (alpha, where asked, a smooth wave)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    s = max(h, w) / 256.0
    out = []
    for c in range(3):
        v = 120 + 60 * np.sin(xx / (23 * s + 4 * c) + yy / (31 * s + 3 * c))
        v += 40 * (((np.cos(0.4 + c) * xx + np.sin(0.4 + c) * yy) / (17 * s + 1)) % 2 < 1)
        out.append(v)
    if channels == 4:
        out.append(255 * np.abs(np.sin(xx / (w / 3 + 1) + yy / (h / 2 + 1))))
    a = np.stack(out, -1) + rng.normal(0, 2.5, (h, w, channels))
    a[h // 3:h // 2, w // 5:w // 3, :3] = 90 + 30 * np.arange(3)
    return np.clip(a, 0, 255).astype(np.uint8)


def pil_avif(px, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "AVIF", **options)
    return buf.getvalue()


def grid(h, w, seed, subsampling, alpha=False, premultiplied=False):
    px = picture(h, w, seed, 4 if alpha else 3)
    planes = writers.yuv_planes(px, subsampling)
    return writers.avif_grid_bytes(planes, (64, 64), subsampling, alpha=px[..., 3] if alpha else None,
                                   premultiplied=premultiplied)


def cases():
    """file name: a function making the 8-bit file, and the depth."""
    return {
        "hbd10_422_64x64.avif": (lambda: pil_avif(picture(64, 64, 1), quality=60, subsampling="4:2:2"), 10),
        "hbd10_422_96x64.avif": (lambda: pil_avif(picture(64, 96, 2), quality=50, subsampling="4:2:2"), 10),
        "hbd10_422_128x128.avif": (lambda: pil_avif(picture(128, 128, 3), quality=70, subsampling="4:2:2",
                                                    range="limited"), 10),
        "hbd12_420_64x64.avif": (lambda: pil_avif(picture(64, 64, 4), quality=60), 12),
        "hbd12_420_rgba_64x64.avif": (lambda: pil_avif(picture(64, 64, 5, 4), quality=60), 12),
        "hbd12_444_96x64.avif": (lambda: pil_avif(picture(64, 96, 6), quality=75, subsampling="4:4:4"), 12),
        "hbd12_400_96x64.avif": (lambda: pil_avif(picture(64, 96, 7), quality=65, subsampling="4:0:0"), 12),
        "hbd10_444_rgba_premultiplied_96x64.avif": (lambda: pil_avif(
            picture(64, 96, 8, 4), quality=70, subsampling="4:4:4", alpha_premultiplied=True), 10),
        "hbd10_lr_cdef_200x131.avif": (lambda: pil_avif(picture(131, 200, 9), quality=40, speed=0,
                                                        advanced={"enable-cdef": "1"}), 10),
        "hbd10_grid_420_2x2.avif": (lambda: grid(128, 128, 10, "4:2:0"), 10),
        "hbd12_grid_rgba_444_2x2.avif": (lambda: grid(128, 128, 11, "4:4:4", alpha=True, premultiplied=True), 12),
    }


def relabelled_fixtures():
    """The committed 8-bit fixtures relabelled at test time: "<name>@<depth>"."""
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(EIGHT_BIT, "*.avif")))
    return [f"{name}@{depth}" for name in names if name not in PALETTE for depth in (10, 12)]


def relabelled(key: str) -> bytes:
    name, depth = key.split("@")
    with open(os.path.join(EIGHT_BIT, name), "rb") as f:
        return writers.avif_high_depth(f.read(), int(depth))


def digest(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def reading(data: bytes) -> dict:
    im = Image.open(io.BytesIO(data))
    a = np.asarray(im)
    return {"mode": im.mode, "shape": list(a.shape), "sha256": digest(a.tobytes()), "file_sha256": digest(data)}


def main():
    files, more = {}, {}
    for name, (make, depth) in cases().items():
        data = writers.avif_high_depth(make(), depth)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        files[name] = reading(data)
        print(f"{name}: {len(data)} bytes, {files[name]['mode']} {files[name]['shape']}")
    for key in relabelled_fixtures():
        more[key] = reading(relabelled(key))
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump({"pil": Image.__version__, "files": files, "relabelled": more}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
