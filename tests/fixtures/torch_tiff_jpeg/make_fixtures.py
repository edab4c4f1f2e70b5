"""Generate the JPEG-in-TIFF fixtures of tests/test_torch_image_forms.py and
chip_smoke.py.

- `rgb_q75_1920x1080.tif`: a 1920x1080 RGB JPEG-in-TIFF PIL writes
  (libtiff: strips of 8 rows, each an abbreviated JPEG stream after the
  JPEGTables tag) from one smooth picture at quality 75. `sha256.json`
  holds PIL's reading of it: its mode, the shape of
  `np.asarray(Image.open(f))` and the SHA-256 of those pixels' bytes.
- Small files (67x45) with `<name>.npz` beside each, PIL's reading: `mode`,
  `pixels` (a channel axis kept) and `rgba` (`convert("RGBA")`): RGB and
  grey strips PIL writes at q75 and q90, and RGB tiles of 32x16 (PIL
  cannot write tiles: each tile is the strip PIL writes for its samples,
  put in a tiled TIFF by tests/torch_image_writers.tiff_bytes).

The machine with the card has no PIL, so the port's TIFF reader is held
to these there.

Run from the repo root:  python tests/fixtures/torch_tiff_jpeg/make_fixtures.py
(a few seconds). The files are checked in; regenerate only if the cases
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
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from torch_image_writers import tiff_bytes  # noqa: E402

W, H = 1920, 1080


def picture(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / (97 + 31 * i) + yy / (143 + 17 * i))
                  + 20 * np.cos((xx + 2 * yy) / (211 + 13 * i)) for i in range(3)], -1)
    return np.clip(a, 0, 255).astype(np.uint8)


def waves(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 120 * np.sin(xx / (2 + i) + yy / (3 + i)) for i in range(3)], -1)
    return np.clip(a, 0, 255).astype(np.uint8)


def pil_saved(pixels, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "TIFF", compression="jpeg", **options)
    return buf.getvalue()


def pil_tiles(pixels, quality, tile) -> bytes:
    """A tiled JPEG-in-TIFF: each tile the one strip PIL writes for it."""
    def strip(samples):
        data = pil_saved(np.ascontiguousarray(samples).astype(np.uint8), quality=quality, strip_size=2**30)
        tags = Image.open(io.BytesIO(data)).tag_v2
        return data[tags[273][0]:tags[273][0] + tags[279][0]], bytes(tags[347])

    tables = strip(pixels[:8, :8])[1]
    return tiff_bytes(pixels, 8, 2, compression=7, tile=tile, encode=lambda c: strip(c)[0],
                      tags={347: (7, list(tables))})


def small_cases():
    a = waves(45, 67)
    return {
        "rgb_q75_67x45.tif": pil_saved(a, quality=75),
        "rgb_q90_strips_67x45.tif": pil_saved(a, quality=90, strip_size=67 * 3 * 16),
        "grey_q90_67x45.tif": pil_saved(np.ascontiguousarray(a[..., 1]), quality=90),
        "rgb_q90_tiles_32x16_67x45.tif": pil_tiles(a, 90, (32, 16)),
    }


def main():
    for name, data in small_cases().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        im = Image.open(io.BytesIO(data))
        pixels = np.asarray(im)
        np.savez_compressed(os.path.join(HERE, os.path.splitext(name)[0] + ".npz"), mode=np.array(im.mode),
                            pixels=pixels[..., None] if pixels.ndim == 2 else pixels,
                            rgba=np.asarray(im.convert("RGBA")))
        print(f"{name}: {im.mode} {im.size}, {len(data)} bytes")
    name = f"rgb_q75_{W}x{H}.tif"
    data = pil_saved(picture(H, W), quality=75)
    with open(os.path.join(HERE, name), "wb") as f:
        f.write(data)
    im = Image.open(io.BytesIO(data))
    got = np.asarray(im)
    readings = {name: {"mode": im.mode, "shape": list(got.shape), "sha256": hashlib.sha256(got.tobytes()).hexdigest()}}
    print(f"{name}: {im.mode} {im.size}, {len(data)} bytes")
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(readings, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
