"""Generate the fixture of chip_smoke.py's phase 5p: PIL's reading of
each file phase 5p writes.

- `sha256.json`: under "chip_smoke", each file
  `chip_smoke.pil_rest_files()` makes (IM RGB, YCbCr and P of a colour
  LUT, IM Tools, McIDAS 8- and 16-bit, PIXAR, SPIDER, SUN raw and RLE,
  MSP v2, XBM, XPM, an XV thumbnail at 1920x1080, PhotoCD at 768x512 and
  turned, IPTC raw grey): its SHA-256 and PIL's reading of it (its mode,
  the shape of the loaded image's `np.asarray` with a channel axis, the
  SHA-256 of those pixels' bytes). The card's machine, whose PIL is
  another, writes those files again and holds the port to these hashes.
  Every file comes from tests/torch_image_writers.py's integer-only
  writers, so no binary file is committed.

Run from the repo root:  python tests/fixtures/torch_pil_rest/make_fixtures.py
(about 15 s: PIL's Python MSP and XPM decoders read 1080p files).
Regenerate only if the files change.
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
    """The SHA-256 of pixels' bytes, as chip_smoke.sha256_of."""
    a = a.astype(np.uint8) if a.dtype == bool else a
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def reading(data: bytes) -> dict:
    """PIL's reading of the loaded image."""
    im = Image.open(io.BytesIO(data))
    im.load()
    px = np.asarray(im)
    px = px[..., None] if px.ndim == 2 else px
    return {"file_sha256": hashlib.sha256(data).hexdigest(), "mode": im.mode, "shape": list(px.shape),
            "sha256": digest(px)}


def main():
    from chip_smoke import pil_rest_files

    table = {"chip_smoke": {name: reading(data) for name, data in pil_rest_files().items()}}
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    for name, want in table["chip_smoke"].items():
        print(f"{name}: {want['mode']} {want['shape']}")


if __name__ == "__main__":
    main()
