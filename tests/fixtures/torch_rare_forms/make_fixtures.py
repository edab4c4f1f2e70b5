"""Generate the fixtures of tests/test_torch_rare_forms.py and of
chip_smoke.py's phase 5o: small BLP files PIL writes, the icns files of
phase 5o, and PIL's reading of each, and of each 1080p file phase 5o
writes.

- Files PIL writes and another PIL might write otherwise: BLP1 and BLP2
  of a "P" image (PIL's quantiser picks the palette), a 1024x1024 icns by
  PIL's own writer (ic07-ic14 PNGs, read through ic10), and a 1024x1024
  icns whose ic10 is a JPEG 2000 codestream PIL wrote (wrapped by
  `tests/torch_image_writers.icns_bytes`).
- `sha256.json`: under "files", each committed file's SHA-256 and PIL's
  reading of it (its mode, the shape of the loaded image's
  `np.asarray` with a channel axis, the SHA-256 of those pixels' bytes
  and of `convert("RGBA")`); under "chip_smoke", the same (without RGBA)
  of each file `chip_smoke.rare_form_files()` makes: the card's machine,
  whose PIL is another, writes those files again and holds the port to
  these hashes.

Run from the repo root:  python tests/fixtures/torch_rare_forms/make_fixtures.py
(about 40 s: PIL's Python BLP decoders read three 1080p files). The
files are checked in; regenerate only if the cases change.
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


def reading(data: bytes, rgba: bool) -> dict:
    """PIL's reading of the loaded image (an icns image packs its pixels
    otherwise before it loads)."""
    im = Image.open(io.BytesIO(data))
    im.load()
    px = np.asarray(im)
    px = px[..., None] if px.ndim == 2 else px
    out = {"file_sha256": hashlib.sha256(data).hexdigest(), "mode": im.mode, "shape": list(px.shape),
           "sha256": digest(px)}
    if rgba:
        out["rgba_sha256"] = digest(np.asarray(im.convert("RGBA")))
    return out


def icon(size: int = 1024) -> np.ndarray:
    """(size, size, 4) uint8: a seeded grid of colours every 128 pixels,
    bilinearly blended and posterised to steps of 32 (flat bands, which PNG
    keeps small), inside a disc of alpha with a soft edge (integers only)."""
    rng = np.random.default_rng(2029)
    step = 128
    grid = rng.integers(0, 256, (size // step + 2, size // step + 2, 3), dtype=np.int64)
    yy, xx = np.mgrid[0:size, 0:size]
    y0, x0, fy, fx = yy // step, xx // step, (yy % step)[..., None], (xx % step)[..., None]
    rgb = (grid[y0, x0] * (step - fy) * (step - fx) + grid[y0 + 1, x0] * fy * (step - fx)
           + grid[y0, x0 + 1] * (step - fy) * fx + grid[y0 + 1, x0 + 1] * fy * fx) // (step * step) // 32 * 32
    r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
    alpha = np.clip((size * size // 4 - r2) // (size * 4), 0, 255)
    return np.concatenate([rgb, alpha[..., None]], -1).astype(np.uint8)


def committed_files() -> dict:
    import torch_image_writers as w

    rng = np.random.default_rng(2029)
    h, wd = 48, 64
    yy, xx = np.mgrid[0:h, 0:wd]
    rgb = np.clip(np.stack([128 + 90 * np.sin(xx / (5 + 2 * i) + yy / (7 + i)) for i in range(3)], -1)
                  + rng.normal(0, 6, (h, wd, 3)), 0, 255).astype(np.uint8)
    rgba = np.concatenate([rgb, np.where(xx < 20, 0, np.where(xx > 40, 255, 6 * xx))[..., None]], -1).astype(np.uint8)
    out = {}
    for version in ("BLP1", "BLP2"):
        buf = io.BytesIO()
        Image.fromarray(rgb).quantize(64).save(buf, "BLP", blp_version=version)
        out[f"{version.lower()}_palette_pil.blp"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rgba).quantize(48, method=Image.Quantize.FASTOCTREE).save(buf, "BLP")
    out["blp2_palette_rgba_pil.blp"] = buf.getvalue()
    big = icon()
    buf = io.BytesIO()
    Image.fromarray(big).save(buf, "ICNS")
    out["icns_1024_ic10_png.icns"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(big[..., :3]).save(buf, "JPEG2000", no_jp2=True, irreversible=True, quality_mode="rates",
                                       quality_layers=[60])
    out["icns_1024_ic10_jp2.icns"] = w.icns_bytes([(b"ic10", buf.getvalue())])
    return out


def main():
    from chip_smoke import rare_form_files

    files = committed_files()
    for name, data in files.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    table = {"files": {name: reading(data, True) for name, data in sorted(files.items())},
             "chip_smoke": {name: reading(data, False) for name, data in rare_form_files().items()}}
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    for name, data in files.items():
        print(f"{name}: {len(data)} bytes, {table['files'][name]['mode']} {table['files'][name]['shape']}")


if __name__ == "__main__":
    main()
