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
  outputs past the sample range);
- 64x48 crops of the close view damaged where libjpeg only warns and PIL
  still returns an image (`damaged`): extraneous bytes before markers, a
  flipped entropy-coded byte, a restart marker out of sequence and one
  missing, progressive files cut before their last scan and their last two
  (block smoothing), and progressive scans out of order.

Run from the repo root:  python tests/fixtures/torch_jpeg/make_fixtures.py
(about two minutes on a CPU), or with `damaged` to write only the damaged
set. The files are checked in; regenerate only if the cases change.
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


def encode(pixels: np.ndarray, **options) -> bytes:
    image = Image.fromarray(pixels[..., 0] if pixels.shape[2] == 1 else pixels)
    buf = io.BytesIO()
    image.save(buf, "JPEG", **options)
    return buf.getvalue()


def save(name: str, pixels: np.ndarray, **options):
    write(name, encode(pixels, **options), pixels.shape)


def write(name: str, data: bytes, shape):
    with open(os.path.join(HERE, f"{name}.jpg"), "wb") as f:
        f.write(data)
    np.savez_compressed(os.path.join(HERE, f"{name}.npz"),
                        pixels=np.asarray(Image.open(io.BytesIO(data))))
    print(f"{name}: {shape[1]}x{shape[0]}, {len(data)} bytes")


def scan_starts(data: bytes) -> list:
    out, i = [], data.find(b"\xff\xda")
    while i >= 0:
        out.append(i)
        i = data.find(b"\xff\xda", i + 2)
    return out


def damaged(patch: np.ndarray):
    """Files libjpeg only warns about, each of a 64x48 `patch`, which PIL
    decodes (the .npz holds its pixels)."""
    base = encode(patch, quality=90, subsampling="4:2:0")
    sos, dqt = base.index(b"\xff\xda"), base.index(b"\xff\xdb")
    write("damaged_extraneous_q90_420_64x48",
          base[:dqt] + b"\x00\xff\x00\x55" + base[dqt:sos] + b"\x12\x34" + base[sos:], patch.shape)
    start = sos + 2 + int.from_bytes(base[sos + 2:sos + 4], "big")
    flipped = bytearray(base)
    flipped[start + 200] ^= 0x10
    write("damaged_flipped_byte_q90_420_64x48", bytes(flipped), patch.shape)
    restarts = encode(patch, quality=90, subsampling="4:2:0", restart_marker_blocks=2)
    rst = [i for i in range(len(restarts) - 1) if restarts[i] == 0xFF and 0xD0 <= restarts[i + 1] <= 0xD7]
    write("damaged_restart_out_of_sequence_q90_420_64x48",
          restarts[:rst[1] + 1] + b"\xd6" + restarts[rst[1] + 2:], patch.shape)
    write("damaged_restart_missing_q90_420_64x48", restarts[:rst[2]] + restarts[rst[2] + 2:], patch.shape)
    progressive = encode(patch, quality=90, subsampling="4:2:0", progressive=True)
    scans = scan_starts(progressive)
    write("damaged_progressive_cut_last_q90_420_64x48", progressive[:scans[-1]] + b"\xff\xd9", patch.shape)
    write("damaged_progressive_cut_last_two_q90_420_64x48", progressive[:scans[-2]] + b"\xff\xd9",
          patch.shape)
    parts = [progressive[scans[j]:(scans[j + 1] if j + 1 < len(scans) else len(progressive) - 2)]
             for j in range(len(scans))]
    order = [0, 1, 2, 3, 4, 5, 9, 7, 8, 6]  # the last luma refinement before the ones it refines
    write("damaged_progressive_out_of_order_q90_420_64x48",
          progressive[:scans[0]] + b"".join(parts[j] for j in order) + b"\xff\xd9", patch.shape)


def main():
    model = load_gaussians_ply(os.path.join(ROOT, "assets", "trained_r5.ply"))
    if sys.argv[1:] == ["damaged"]:
        damaged(render(model, 2.5)[330:378, 530:594])
        return
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
    damaged(close[330:378, 530:594])


if __name__ == "__main__":
    main()
