"""Generate the arithmetic-coded JPEG fixtures of chip_smoke.py's phase 5n
and tests/test_torch_jpeg_arith.py: PIL 12.1.0 (libjpeg-turbo 3.1.3) JPEGs
of three 1920x1080 orbit renders of trained_r5, transcoded to arithmetic
coding by libjpeg-turbo's own encoder (jpeg_writer.c, built by
tests/torch_jpeg_tools.py, as `jpegtran -arithmetic` transcodes), and PIL's
reading of each.

PIL hands libjpeg a JPEG file in 65536-byte blocks, and libjpeg's
arithmetic decoder cannot wait for the next block, so PIL reads a 1080p
arithmetic file only where each scan's data lies in the blocks read by
the time the scan starts: the three views are at qualities that fit, and
a fourth file, the first view at quality 95, is one PIL refuses.

- `1080p_seq_420_q60_rows4.jpg`: view_00, sequential (SOF9) 4:2:0 at
  quality 60, a restart marker every 4 MCU rows;
- `1080p_prog_420_q55.jpg`: view_01, progressive (SOF10) 4:2:0 at quality
  55, jpeg_simple_progression's ten scans;
- `1080p_seq_444_q40_dac.jpg`: view_02, sequential 4:4:4 at quality 40,
  DAC conditioning L 1, U 3 (DC) and Kx 10 (AC) in place of the defaults;
- `1080p_seq_420_q95_refused.jpg`: view_00, sequential 4:2:0 at quality
  95 (about 187 KB): PIL raises "broken data stream".
- `sha256.json`: for each file, the SHA-256 of the file, and PIL's mode,
  the shape of `np.asarray(Image.open(f))` and the SHA-256 of those pixels'
  bytes, or "raises".

The renders come from render_views.py, run where the card is. Run from the
repo root, VIEWS_DIR holding its view_00.png to view_02.png:

    python tests/fixtures/torch_jpeg_arith/make_fixtures.py VIEWS_DIR

The files are checked in; regenerate only if the cases change.
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

import torch_jpeg_tools  # noqa: E402

# name: (view, PIL's save options, the transcoder's options)
FILES = {
    "1080p_seq_420_q60_rows4.jpg": ("view_00", {"quality": 60, "subsampling": "4:2:0"}, {"rows": 4}),
    "1080p_prog_420_q55.jpg": ("view_01", {"quality": 55, "subsampling": "4:2:0", "progressive": True}, {}),
    "1080p_seq_444_q40_dac.jpg": ("view_02", {"quality": 40, "subsampling": "4:4:4"}, {"L": 1, "U": 3, "K": 10}),
    "1080p_seq_420_q95_refused.jpg": ("view_00", {"quality": 95, "subsampling": "4:2:0"}, {}),
}


def reading(data: bytes) -> dict:
    out = {"file_sha256": hashlib.sha256(data).hexdigest()}
    try:
        im = Image.open(io.BytesIO(data))
        a = np.asarray(im)
    except OSError:
        return {**out, "pil": "raises"}
    return {**out, "mode": im.mode, "shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def main(views: str):
    why = torch_jpeg_tools.missing()
    if why:
        raise SystemExit(why)
    readings = {}
    for name, (view, save, transcode) in FILES.items():
        buf = io.BytesIO()
        Image.open(os.path.join(views, f"{view}.png")).convert("RGB").save(buf, "JPEG", **save)
        data = torch_jpeg_tools.arith(buf.getvalue(), **transcode)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        readings[name] = reading(data)
        print(name, len(data), readings[name].get("pil", "read"))
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump({"files": readings}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1])
