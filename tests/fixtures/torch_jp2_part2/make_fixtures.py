"""Generate the JPEG 2000 Part 2 and high-precision fixtures of
tests/test_torch_jp2_part2.py and chip_smoke.py with the test-side encoder
`tests/torch_j2k_writer.py` and marker edits (`tests/torch_image_writers`),
which PIL 12 reads through OpenJPEG 2.5.

- small files (48x40, seeded numpy pictures): Rsiz bit 15 on a Part 1 and
  on an HTJ2K codestream; an MCO of no stage (every DC level shift 0); an
  MCT offset array named by an MCC and an MCO (int32, and float32 in a
  tile-part header), which becomes the DC level shift; MCT and MCC with no
  MCO; a CBD of other depths; NLT, ATK and 0xFF7A-0xFF7D markers with
  bodies, skipped; samples of 17, 20, 24 and 31 bits (grey "I;16", LA,
  RGB, RGBA; signed and unsigned; 5/3 and 9/7; MQ and HT code-blocks); and
  the files PIL refuses: a CBD and an MCO of a wrong length, SGcod MCT 2,
  five components in a JP2;
- `ortho_part2_1920x1080.j2k`: a 1920x1080 RGB codestream of 20-bit
  samples (the picture of tests/fixtures/torch_jp2's 1080p files in the
  top 8 bits), 9/7 with the ICT, Rsiz bit 15, a CBD of the SIZ depths and
  an int32 MCT offset array named by an MCC and an MCO (the DC level
  shift moved by a few steps a component), coded from bit-plane 13 up;
- `frame_rgba_part2_800x800.jp2`: an 800x800 RGBA JP2 frame (the disc of
  tests/fixtures/torch_jp2's RGBA frame), 5/3 with the RCT, Rsiz bit 15,
  an MCT / MCC / MCO in its tile-part header moving the colour
  components' DC level shift, a CBD, coded from bit-plane 2 up;
- `sha256.json`: PIL's reading of each file: its mode, the shape of
  `np.asarray(Image.open(f))` (a channel axis kept) and the SHA-256 of
  those pixels' bytes, and the SHA-256 of its `convert("RGBA")`; or
  `"raises": true` where PIL raises.

The port is held to these here and on the card's machine, which has no
PIL.

Run from the repo root:  python tests/fixtures/torch_jp2_part2/make_fixtures.py
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

from make_fixtures import frame_rgba, picture  # noqa: E402  (tests/fixtures/torch_jp2's pictures)
from torch_image_writers import j2k_join, j2k_markers, jp2_bytes  # noqa: E402
from torch_j2k_writer import HT, cbd, deep_samples, edited, encode, mcc, mco, mct  # noqa: E402

LARGE, FRAME = "ortho_part2_1920x1080.j2k", "frame_rgba_part2_800x800.jp2"
SIZ, COD, MCO, CBD = 0xFF51, 0xFF52, 0xFF77, 0xFF78


# ---- pictures ----

def small(h, w, c, seed):
    """Waves with noise at a small size (every bit-plane coded)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / (5 + 2 * i) + yy / (7 + i)) for i in range(c)], -1)
    return np.clip(a + rng.normal(0, 4, a.shape), 0, 255).astype(np.uint8)


def large() -> bytes:
    yy, xx = np.mgrid[0:1080, 0:1920]
    low = ((7 * xx + 13 * yy) & 0xFFF)[..., None]
    a = (picture(1080, 1920).astype(np.uint32) << 12) | low.astype(np.uint32)
    cs = encode(a, precision=20, irreversible=True, mct=True, levels=5, cblk=(6, 6), planes=13)
    return edited(cs, [cbd([19] * 3), mct(1, 1, [(1 << 19) + 4096, 1 << 19, (1 << 19) - 8192]), mcc(1, 3, offset=1),
                       mco(1)], rsiz=0x8000)


def frame() -> bytes:
    cs = encode(frame_rgba(), levels=5, cblk=(6, 6), mct=True, planes=2)
    return jp2_bytes(edited(cs, [cbd([7] * 4)], [mct(2, 0, [124, 128, 134, 128]), mcc(5, 4, offset=2), mco(5)],
                            rsiz=0x8000))


def files() -> dict:
    a, rgba = small(40, 48, 3, 1), small(40, 48, 4, 2)
    plain = encode(a, mct=True)
    skipped = [(m, bytes(range(1, 1 + n))) for m, n in ((0xFF76, 6), (0xFF79, 10), (0xFF7A, 2), (0xFF7B, 4),
                                                          (0xFF7C, 8), (0xFF7D, 0))]
    return {
        "rsiz_part2.j2k": edited(plain, rsiz=0x8000),
        "rsiz_part2_ht.j2k": edited(encode(a, style=HT, mct=True), rsiz=0xC000),
        "mco_no_stage.j2k": edited(plain, [mco()], rsiz=0x8000),
        "mct_offsets_int32.j2k": edited(plain, [mct(1, 1, [10, 20, 30]), mcc(1, 3, offset=1), mco(1)], rsiz=0x8000),
        "mct_offsets_float_tile.j2k": edited(encode(a, mct=True, tile=(24, 24)), (),
                                             [mct(3, 2, [-2.5, 127.9, 300.0]), mcc(1, 3, offset=3), mco(1)],
                                             rsiz=0x8000),
        "mct_mcc_without_mco.j2k": edited(plain, [mct(1, 1, [10, 20, 30]), mcc(1, 3, offset=1)], rsiz=0x8000),
        "cbd_12_bits.j2k": edited(plain, [cbd([11, 11, 11])], rsiz=0x8000),
        "markers_skipped.j2k": edited(plain, skipped, rsiz=0x8000),
        "cbd_bad_length.j2k": edited(plain, [(CBD, struct.pack(">H", 3) + bytes([7, 7]))], rsiz=0x8000),
        "mco_bad_length.j2k": edited(plain, [(MCO, b"\x01\x01\x01")], rsiz=0x8000),
        "cod_mct_2.j2k": edited(plain, main_edit=lambda m: [(k, b[:4] + b"\x02" + b[5:] if k == COD else b)
                                                            for k, b in m]),
        "grey_20.j2k": encode(deep_samples(a[..., :1], 20), precision=20, levels=3),
        "grey_31_signed.j2k": encode(deep_samples(a[..., :1], 31, True, 1, headroom=2), precision=31, signed=True,
                                     levels=3),
        "rgb_24_97.j2k": encode(deep_samples(a, 24, seed=2), precision=24, irreversible=True, mct=True, planes=12),
        "rgba_17_signed.jp2": jp2_bytes(encode(deep_samples(rgba, 17, True, 3), precision=17, signed=True, mct=True),
                                        bpc=0x80 | 16),
        "la_24.j2k": encode(deep_samples(rgba[..., [0, 3]], 24, seed=4), precision=24, planes=10),
        "rgb_20_ht.j2k": encode(deep_samples(a, 20, seed=5), precision=20, style=HT, mct=True, planes=8),
        "five_components.jp2": jp2_bytes(five_components(plain), 3),
    }


def five_components(cs: bytes) -> bytes:
    """`cs` with SIZ saying 5 components (the data has 3)."""
    main, parts = j2k_markers(cs)
    siz = main[0][1]
    five = siz[:34] + struct.pack(">H", 5) + siz[36:] + siz[36:39] * 2
    return j2k_join([(SIZ, five)] + main[1:], parts)


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
