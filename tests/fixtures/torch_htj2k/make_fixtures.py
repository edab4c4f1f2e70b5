"""Generate the HTJ2K fixtures of tests/test_torch_htj2k.py and
chip_smoke.py with the test-side encoder `tests/torch_j2k_writer.py`
(JPEG 2000 Part 15, ITU-T T.814: HT code-blocks), which PIL 12 reads
through OpenJPEG 2.5.

- small files (48x40, seeded numpy pictures): HT-only 5/3 cleanup passes
  (RGB with the RCT), 9/7 with the ICT, cleanup + SigProp + MagRef, grey,
  16-bit grey (I;16), an RGBA JP2, tiles with precincts in RPCL under a
  POC, two layers (TERMALL, whose cleanup and refinement segments
  OpenJPEG reads in separate layers), 4:2:0 sYCC, SigProp with VSC; and
  the files PIL refuses or reads with edits: MIXED code-blocks (style
  0xC0), CAP with other content, no CAP / CPF, a CAP in a tile-part
  header, an HT file read as Part 1 (style bit cleared);
- `ortho_ht_1920x1080.j2k`: the form OpenJPH writes by default (5
  decompositions, 64x64 code-blocks, RPCL, one layer, cleanup passes
  only), RGB with the RCT, made lossy by coding bit-planes from 2 up;
  the picture of tests/fixtures/torch_jp2's 1080p files;
- `frame_rgba_ht_800x800.jp2`: an 800x800 RGBA HT JP2 frame (the disc of
  tests/fixtures/torch_jp2's RGBA frame), the RCT on its colour, coded
  from bit-plane 2 up;
- `sha256.json`: PIL's reading of each file: its mode, the shape of
  `np.asarray(Image.open(f))` (a channel axis kept) and the SHA-256 of
  those pixels' bytes, and the SHA-256 of its `convert("RGBA")`; or
  `"raises": true` where PIL raises.

The port is held to these here and on the card's machine, which has no
PIL.

Run from the repo root:  python tests/fixtures/torch_htj2k/make_fixtures.py
(about two minutes; the 1080p file takes most of it). The files are
checked in; regenerate only if the cases change.
"""

import hashlib
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, TESTS)
sys.path.insert(0, os.path.join(TESTS, "fixtures", "torch_jp2"))

from make_fixtures import frame_rgba, picture  # noqa: E402  (tests/fixtures/torch_jp2's pictures)
from torch_image_writers import j2k_join, j2k_markers, jp2_bytes  # noqa: E402
from torch_j2k_writer import HT, HT_MIXED, TERMALL, VSC, encode  # noqa: E402

LARGE, FRAME = "ortho_ht_1920x1080.j2k", "frame_rgba_ht_800x800.jp2"
COD = 0xFF52


def small(h, w, c, seed):
    """Waves with noise at a small size (every bit-plane coded)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / (5 + 2 * i) + yy / (7 + i)) for i in range(c)], -1)
    return np.clip(a + rng.normal(0, 4, a.shape), 0, 255).astype(np.uint8)


def large() -> bytes:
    return encode(picture(1080, 1920), style=HT, levels=5, cblk=(6, 6), progression_order="RPCL", mct=True,
                  planes=2)


def frame() -> bytes:
    return jp2_bytes(encode(frame_rgba(), style=HT, levels=5, cblk=(6, 6), mct=True, planes=2))


def edited(cs: bytes, edit) -> bytes:
    """`cs` with its main header's segments [(marker, body)] and
    tile-parts passed through `edit`."""
    main, parts = j2k_markers(cs)
    return j2k_join(*edit(main, parts))


def files() -> dict:
    a, rgba = small(40, 48, 3, 1), small(40, 48, 4, 2)
    grey16 = (small(40, 48, 1, 3).astype(np.uint16) * 257 + np.random.default_rng(3).integers(
        0, 256, (40, 48, 1))).astype(np.uint16)
    plain = encode(a, style=HT, mct=True)
    out = {
        "cleanup_53_rct.j2k": plain,
        "ict_97.j2k": encode(a, style=HT, irreversible=True, mct=True),
        "refine_53.j2k": encode(a, style=HT, mct=True, planes=2, ht_passes=3),
        "refine_vsc_sigprop.j2k": encode(a, style=HT | VSC, planes=1, ht_passes=2, cblk=(4, 4), levels=3),
        "grey.j2k": encode(a[..., :1], style=HT),
        "grey16.j2k": encode(grey16, style=HT, precision=16),
        "rgba.jp2": jp2_bytes(encode(rgba, style=HT, mct=True)),
        "tiles_rpcl_poc.j2k": encode(a, style=HT, tile=(32, 24), precincts=[(4, 4)] * 3 + [(5, 5)] * 3, cblk=(4, 4),
                                     progression_order="RPCL", poc=[(0, 0, 1, 6, 3, "PCRL")], planes=1,
                                     ht_passes=3),
        "layers_termall.j2k": encode(a, style=HT | TERMALL, layers=[1, 3], planes=2, ht_passes=3, mct=True),
        "sycc_420.jp2": jp2_bytes(encode(a, style=HT, subsampling=[(1, 1), (2, 2), (2, 2)]), colr=(1, 18)),
        "mixed.j2k": encode(a, style=HT | HT_MIXED, mct=True),
        "cap_other.j2k": edited(plain, lambda m, p: ([(k, b"\x00\x02\x40\x00\xa5\x5a" if k == 0xFF50 else b)
                                                     for k, b in m], p)),
        "no_cap_cpf.j2k": edited(plain, lambda m, p: ([(k, b) for k, b in m if k not in (0xFF50, 0xFF59)], p)),
        "cap_in_tile_header.j2k": edited(plain, lambda m, p: (m, [t[:3] + ([(0xFF50, b"\x00\x02\x00\x00\x00\x00")]
                                                                          + t[3], t[4]) for t in p])),
        "read_as_part1.j2k": edited(plain, lambda m, p: ([(k, b[:8] + bytes([b[8] & ~HT]) + b[9:] if k == COD else b)
                                                         for k, b in m], p)),
    }
    return out


def reading(path) -> dict:
    try:
        im = Image.open(path)
        px = np.asarray(im)
    except Exception:  # noqa: BLE001  (any of PIL's errors)
        return {"raises": True}
    px = px[..., None] if px.ndim == 2 else px
    rgba = np.asarray(im.convert("RGBA"))
    return {"mode": im.mode, "shape": list(px.shape), "sha256": hashlib.sha256(px.tobytes()).hexdigest(),
            "rgba_sha256": hashlib.sha256(np.ascontiguousarray(rgba).tobytes()).hexdigest()}


def main():
    made = files()
    made[FRAME] = frame()
    made[LARGE] = large()
    readings = {}
    for name, data in sorted(made.items()):
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        readings[name] = reading(path)
        print(f"{name}: {len(data)} bytes, {readings[name].get('mode', 'PIL raises')} {readings[name].get('shape')}")
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(readings, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
