"""Generate the JPEG fixtures of tests/test_torch_jpeg.py and chip_smoke.py.

Each `<name>.jpg` is written by PIL (libjpeg-turbo) from a CPU render of
assets/trained_r5.ply made with the port's plain path; `<name>.npz` beside
it holds `pixels`, PIL's decode of the file (`np.asarray(Image.open(f))`,
the pixels the JAX package trains on). The machine with the card has no
PIL, so the decoders are held to these there.

- two at MipNeRF360's `images_4` size, 1237x822, baseline 4:2:0 q95 and
  progressive q95 (the model seen from far enough that PIL's pixels
  compress to about 300 KB);
- a grid of small crops and downscales of a close view: subsampling
  4:4:4 / 4:2:2 / 4:2:0 / grey, quality 50 to 100, baseline and
  progressive, optimised tables, restart markers every few blocks and
  every row, sizes 1x1 to 129x97, and black-and-white edges at q100 (IDCT
  outputs past the sample range).

Run from the repo root:  python tests/fixtures/torch_jpeg/make_fixtures.py
(about two minutes on a CPU). The files are checked in; regenerate only
if the cases change.
"""

import io
import os
import sys

import numpy as np
import torch
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, ROOT)

from gaussian_splatting_torch import RasterizerConfig, eval_render  # noqa: E402
from gaussian_splatting_torch.ops.projection import preprocess  # noqa: E402
from gaussian_splatting_torch.ops.rasterize import entry_bucket_capacity  # noqa: E402
from gaussian_splatting_torch.scene.cameras import orbit_camera  # noqa: E402
from gaussian_splatting_torch.scene.gaussians import activate, params_from_numpy  # noqa: E402
from gaussian_splatting_torch.scene.ply import load_gaussians_ply  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 1237, 822


def render(model, distance: float) -> np.ndarray:
    """(H, W, 3) uint8 render of the model from `distance` x its 95th
    percentile radius, at angle 0.3 rad on the orbit chip_smoke.py uses."""
    params = params_from_numpy(model, device="cpu")
    center = model["xyz"].mean(axis=0)
    radius = float(np.quantile(np.linalg.norm(model["xyz"] - center, axis=1), 0.95))
    cam = orbit_camera(center, distance * radius, 0.3, W, H, 70.0, 70.0 * H / W).arrays(device="cpu")
    with torch.no_grad():
        n = int(preprocess(*activate(params), 3, cam, W, H, 32, 32).tiles_touched.sum())
        img = eval_render(params, cam, torch.zeros(3), 3, W, H,
                          RasterizerConfig(capacity_exact=entry_bucket_capacity(n, 16, 1.2)))[0]
    return (np.clip(img.numpy(), 0.0, 1.0) * 255 + 0.5).astype(np.uint8)


def save(name: str, pixels: np.ndarray, **options):
    image = Image.fromarray(pixels[..., 0] if pixels.shape[2] == 1 else pixels)
    buf = io.BytesIO()
    image.save(buf, "JPEG", **options)
    data = buf.getvalue()
    with open(os.path.join(HERE, f"{name}.jpg"), "wb") as f:
        f.write(data)
    np.savez_compressed(os.path.join(HERE, f"{name}.npz"),
                        pixels=np.asarray(Image.open(io.BytesIO(data))))
    print(f"{name}: {pixels.shape[1]}x{pixels.shape[0]}, {len(data)} bytes")


def main():
    model = load_gaussians_ply(os.path.join(ROOT, "assets", "trained_r5.ply"))
    far = render(model, 6.0)
    save("images4_q95_420", far, quality=95, subsampling="4:2:0")
    save("images4_q95_420_progressive", far, quality=95, subsampling="4:2:0", progressive=True)

    close = render(model, 2.5)
    crop = close[300:397, 500:629]  # 129 x 97, the dense middle of the view

    def small(w, h):
        return np.asarray(Image.fromarray(close).resize((w, h)))

    grey = crop[..., :1]
    save("q95_420_129x97", crop, quality=95, subsampling="4:2:0")
    save("q50_444_67x45", crop[:45, :67], quality=50, subsampling="4:4:4")
    save("q100_422_129x97", crop, quality=100, subsampling="4:2:2")
    save("grey_q95_67x45", grey[:45, :67], quality=95)
    save("progressive_q90_420_129x97", crop, quality=90, subsampling="4:2:0", progressive=True)
    save("progressive_grey_q75_67x45", grey[20:65, 30:97], quality=75, progressive=True)
    save("optimized_q85_420_67x45", crop[30:75, 40:107], quality=85, subsampling="4:2:0",
         optimize=True)
    save("restart_blocks_q95_420_129x97", crop, quality=95, subsampling="4:2:0",
         restart_marker_blocks=7)
    save("restart_rows_q95_444_67x45", crop[:45, :67], quality=95, subsampling="4:4:4",
         restart_marker_rows=1)
    save("q95_420_1x1", small(1, 1), quality=95, subsampling="4:2:0")
    save("q95_420_7x5", small(7, 5), quality=95, subsampling="4:2:0")
    save("q95_422_16x16", small(16, 16), quality=95, subsampling="4:2:2")
    patch = crop[:45, :67]
    edges = np.where(patch > np.median(patch, axis=(0, 1)), 255, 0).astype(np.uint8)  # saturated
    save("edges_q100_444_67x45", edges, quality=100, subsampling="4:4:4")


if __name__ == "__main__":
    main()
