"""Generate the 1920x1080 WebP files chip_smoke.py decodes and times.

Three files PIL writes from one smooth picture (long-period waves, each
channel in steps of 4, so the lossless file stays small): lossy RGB at
quality 90, lossy with alpha (ALPH, alpha_quality 90) and lossless RGBA.
`sha256.json` beside them holds PIL's reading of each: its mode, the shape
of `np.asarray(Image.open(f))` and the SHA-256 of those pixels' bytes. The
machine with the card has no PIL, so the port's WebP reader is held to
these there.

Run from the repo root:  python tests/fixtures/torch_webp/make_fixtures.py
(a few seconds). The files are checked in; regenerate only if the cases
change.
"""

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080


def picture():
    yy, xx = np.mgrid[0:H, 0:W]
    a = np.stack([128 + 100 * np.sin(xx / (97 + 31 * i) + yy / (143 + 17 * i))
                  + 20 * np.cos((xx + 2 * yy) / (211 + 13 * i)) for i in range(4)], -1)
    return np.clip(a, 0, 255).astype(np.uint8) // 4 * 4


def cases():
    a = picture()
    return {
        "lossy_q90_1920x1080.webp": (a[..., :3], dict(quality=90)),
        "lossy_alpha_q90_1920x1080.webp": (a, dict(quality=90, alpha_quality=90)),
        "lossless_rgba_1920x1080.webp": (a, dict(lossless=True, quality=50, method=4)),
    }


def main():
    readings = {}
    for name, (pixels, options) in cases().items():
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(pixels)).save(buf, "WEBP", **options)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(buf.getvalue())
        im = Image.open(io.BytesIO(buf.getvalue()))
        got = np.asarray(im)
        readings[name] = {"mode": im.mode, "shape": list(got.shape),
                          "sha256": hashlib.sha256(got.tobytes()).hexdigest()}
        print(f"{name}: {im.mode} {im.size}, {len(buf.getvalue())} bytes")
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(readings, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
