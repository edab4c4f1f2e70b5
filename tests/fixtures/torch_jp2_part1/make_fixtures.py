"""Generate the JPEG 2000 Part 1 fixtures of tests/test_torch_jp2_part1.py
and chip_smoke.py with the test-side encoder `tests/torch_j2k_writer.py`:
the features PIL's writer never sets, one small file each (48x40, seeded
numpy pictures), and one 1920x1080 RGB file.

- small files: SOP / EPH, PPM, PPT, a POC in the main header and in a
  tile-part header, each of the six code-block styles alone and all six
  together, RGN, 4:2:0 and 4:2:2 sYCC JP2s, a raw 4:2:0 codestream (PIL
  guesses sYCC), an RGBA JP2 with subsampled alpha, an unknown marker in the
  main header, a JPX file with two codestreams;
- `ortho_part1_1920x1080.j2k`: the form `opj_compress -SOP -EPH -M 63 -POC
  ...` writes: all six code-block styles, SOP and EPH, RCT, 5 decompositions,
  64x64 code-blocks, 2 layers, a two-entry POC (layer 0 in RLCP, then layer
  1 in CPRL), made lossy by leaving out the passes below bit-plane 2; the
  picture of tests/fixtures/torch_jp2's 1080p files;
- `sha256.json`: PIL's reading of each file: its mode, the shape of
  `np.asarray(Image.open(f))` (a channel axis kept) and the SHA-256 of
  those pixels' bytes, and the SHA-256 of its `convert("RGBA")`.

The port is held to these hashes here and on the card's machine, which
has no PIL.

Run from the repo root:  python tests/fixtures/torch_jp2_part1/make_fixtures.py
(about a minute; the 1080p file takes most of it). The files are checked
in; regenerate only if the cases change.
"""

import hashlib
import json
import os
import struct
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, TESTS)
sys.path.insert(0, os.path.join(TESTS, "fixtures", "torch_jp2"))

from make_fixtures import picture  # noqa: E402  (the torch_jp2 1080p files' picture)
from torch_image_writers import j2k_join, j2k_markers, jp2_box, jp2_bytes  # noqa: E402
from torch_j2k_writer import ALL_STYLES, encode  # noqa: E402

LARGE = "ortho_part1_1920x1080.j2k"
STYLES = ("bypass", "reset", "termall", "vsc", "pterm", "segsym")


def small(h, w, c, seed):
    """Waves with noise at a small size (every bit-plane coded)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / (5 + 2 * i) + yy / (7 + i)) for i in range(c)], -1)
    return np.clip(a + rng.normal(0, 4, a.shape), 0, 255).astype(np.uint8)


def large() -> bytes:
    return encode(picture(1080, 1920), levels=5, cblk=(6, 6), style=ALL_STYLES, sop=True, eph=True, mct=True,
                  layers=[10, None], poc=[(0, 0, 1, 6, 3, "RLCP"), (0, 0, 2, 6, 3, "CPRL")], planes=2)


def files() -> dict:
    a, rgba = small(40, 48, 3, 1), small(40, 48, 4, 2)
    out = {
        "sop_eph.j2k": encode(a, sop=True, eph=True, layers=[3, None]),
        "ppm.j2k": encode(a, headers="ppm", tile=(32, 32), tile_parts=2, split=60, eph=True),
        "ppt.jp2": jp2_bytes(encode(a, headers="ppt", tile=(32, 32), tile_parts=2, sop=True)),
        "poc.j2k": encode(a, poc=[(0, 0, 1, 6, 3, "RLCP"), (0, 0, 3, 6, 3, "CPRL")], layers=[2, 6, None],
                          precincts=[(4, 4)] * 3 + [(5, 5)] * 3),
        "poc_tile.j2k": encode(a, poc=[(0, 0, 1, 6, 3, "RLCP")], tile=(32, 32),
                               tile_poc={0: [(0, 0, 3, 6, 3, "CPRL")], 3: [(0, 0, 2, 6, 3, "PCRL")]},
                               layers=[2, None]),
        "styles_all.j2k": encode(a, style=ALL_STYLES, mct=True, cblk=(4, 4), layers=[4, None]),
        "rgn.j2k": encode(a, roi={0: 10, 2: 10}, roi_rect=(8, 6, 30, 28), levels=3, cblk=(4, 4)),
        "sycc_420.jp2": jp2_bytes(encode(a, subsampling=[(1, 1), (2, 2), (2, 2)]), colr=(1, 18)),
        "sycc_422.jp2": jp2_bytes(encode(a, subsampling=[(1, 1), (2, 1), (2, 1)]), colr=(1, 18)),
        "raw_420.j2k": encode(a, subsampling=[(1, 1), (2, 2), (2, 2)], tile=(21, 17), offset=(1, 3)),
        "rgba_alpha_2x2.jp2": jp2_bytes(encode(rgba, subsampling=[(1, 1), (1, 1), (1, 1), (2, 2)], mct=True)),
        "jpx_two_codestreams.jp2": jp2_bytes(encode(a, style=ALL_STYLES), brand=b"jpx ")
        + jp2_box(b"jp2c", encode(a[::-1])),
    }
    for k, name in enumerate(STYLES):
        out[f"style_{name}.j2k"] = encode(a, style=1 << k, mct=True, cblk=(4, 4), layers=[5, None])
    main, parts = j2k_markers(encode(a, sop=True))
    out["unknown_marker.j2k"] = j2k_join(main[:3] + [(0xFF6A, struct.pack(">HH", 7, 11))] + main[3:], parts)
    return out


def reading(path) -> dict:
    im = Image.open(path)
    px = np.asarray(im)
    px = px[..., None] if px.ndim == 2 else px
    rgba = np.asarray(im.convert("RGBA"))
    return {"mode": im.mode, "shape": list(px.shape), "sha256": hashlib.sha256(px.tobytes()).hexdigest(),
            "rgba_sha256": hashlib.sha256(np.ascontiguousarray(rgba).tobytes()).hexdigest()}


def main():
    made = files()
    made[LARGE] = large()
    readings = {}
    for name, data in sorted(made.items()):
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        readings[name] = reading(path)
        print(f"{name}: {len(data)} bytes, {readings[name]['mode']} {readings[name]['shape']}")
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(readings, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
