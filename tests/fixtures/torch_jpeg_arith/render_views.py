"""Write the seven 1920x1080 orbit renders of assets/trained_r5.ply that
chip_smoke.py's phase 5n trains on (`chip_smoke.orbit_dataset(7, 1920,
1080)`, through the CUDA kernels) as PNGs into OUT_DIR, the input of
make_fixtures.py. Runs where the card is, from the repo root:

    python3 tests/fixtures/torch_jpeg_arith/render_views.py OUT_DIR
"""

import os
import sys

import numpy as np
import torch
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from gaussian_splatting_torch.utils import cuda_build  # noqa: E402

if __name__ == "__main__":
    torch.cuda.set_device(0)
    cuda_build.build()
    out = sys.argv[1]
    os.makedirs(out, exist_ok=True)
    cams, images = chip_smoke.orbit_dataset(7, chip_smoke.W_MAIN, chip_smoke.H_MAIN)
    for cam, px in zip(cams, images):
        Image.fromarray(np.ascontiguousarray(px[..., :3])).save(os.path.join(out, f"{cam.image_name}.png"))
    print(sorted(os.listdir(out)))
