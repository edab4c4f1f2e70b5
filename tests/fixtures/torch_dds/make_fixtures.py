"""Generate the fixtures of tests/test_torch_dds.py and of chip_smoke.py's
phase 5i: small DDS files and PIL's reading of each, and PIL's reading of
each 1080p file phase 5i writes.

- Small files (64x48 at most), written by `tests/torch_image_writers.py`
  (PIL writes only a few DDS forms): a BC7 image of 5x7 pixels, random
  BC6H SF16 blocks, a mipmapped DXT1, an A1R5G5B5 image, a palette image,
  an LA16 image, BC5S blocks and a DX10 R8G8B8A8 array of 6.
- `sha256.json`: under "files", PIL's reading of each small file (its
  mode, the shape of `np.asarray(Image.open(f))` with a channel axis, the
  SHA-256 of those pixels' bytes and of `convert("RGBA")`); under
  "chip_smoke", PIL's reading of each file `chip_smoke.dds_form_files()`
  makes, with the SHA-256 of the file itself: the card's machine writes
  those files again and holds the port to these hashes.

Run from the repo root:  python tests/fixtures/torch_dds/make_fixtures.py
(about a minute: PIL decodes the uncompressed forms in Python). The files
are checked in; regenerate only if the cases change.
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
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def reading(data: bytes, rgba: bool) -> dict:
    im = Image.open(io.BytesIO(data))
    px = np.asarray(im)
    px = px[..., None] if px.ndim == 2 else px
    out = {"mode": im.mode, "shape": list(px.shape), "sha256": digest(px)}
    if rgba:
        out["rgba_sha256"] = digest(np.asarray(im.convert("RGBA")))
    return out


def small_files() -> dict:
    import torch_image_writers as w

    rng = np.random.default_rng(2023)
    h, wd = 48, 63
    yy, xx = np.mgrid[0:h, 0:wd]
    rgb = np.clip(np.stack([128 + 90 * np.sin(xx / (5 + 2 * i) + yy / (7 + i)) for i in range(3)], -1)
                  + rng.normal(0, 6, (h, wd, 3)), 0, 255).astype(np.uint8)
    alpha = np.where(xx < 20, 0, np.where(xx > 40, 255, 6 * xx)).astype(np.uint8)
    rgba = np.concatenate([rgb, alpha[..., None]], -1)
    F, A = w.DDPF_FOURCC, w.DDPF_ALPHAPIXELS
    pal = np.concatenate([rng.integers(0, 256, (256, 3)), np.arange(256)[:, None]], -1).astype(np.uint8)
    mips = w.bc1_blocks(rgb).tobytes() + w.bc1_blocks(rgb[::2, ::2]).tobytes() + w.bc1_blocks(rgb[::4, ::4]).tobytes()
    argb1555 = (0x7C00, 0x3E0, 0x1F, 0x8000)
    return {
        "bc7_5x7.dds": w.dds_bytes(w.bc7_blocks(rgba[:7, :5]).tobytes(), 5, 7, F, dxgi=98),
        "bc6h_sf16_random.dds": w.dds_bytes(rng.integers(0, 256, 64 * 16, dtype=np.uint8).tobytes(), 32, 32, F,
                                            dxgi=96),
        "dxt1_mipmapped.dds": w.dds_bytes(mips, wd, h, F, b"DXT1", mipmaps=3),
        "a1r5g5b5.dds": w.dds_bytes(w.dds_masked(rgba, 16, argb1555), wd, h, w.DDPF_RGB | A, bitcount=16,
                                    masks=argb1555),
        "p8.dds": w.dds_bytes(pal.tobytes() + rgb[..., 0].tobytes(), wd, h, w.DDPF_PALETTEINDEXED8, bitcount=8),
        "la16.dds": w.dds_bytes(np.stack([rgb[..., 1], alpha], -1).tobytes(), wd, h, w.DDPF_LUMINANCE | A,
                                bitcount=16),
        "bc5s.dds": w.dds_bytes(w.bc5_blocks(rgb, signed=True).tobytes(), wd, h, F, b"BC5S"),
        "r8g8b8a8_array6.dds": w.dds_bytes(np.tile(rgba[:16, :16].tobytes(), 6), 16, 16, F, dxgi=28,
                                           array_size=6),
    }


def main():
    from chip_smoke import dds_form_files

    readings = {"files": {}, "chip_smoke": {}}
    for name, data in small_files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        readings["files"][name] = reading(data, rgba=True)
    for name, data in dds_form_files().items():
        readings["chip_smoke"][name] = {**reading(data, rgba=False), "file_sha256": hashlib.sha256(data).hexdigest()}
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(readings, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
