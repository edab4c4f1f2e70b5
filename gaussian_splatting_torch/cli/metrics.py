"""Evaluation CLI — SSIM / PSNR / LPIPS over rendered-vs-GT image dirs.

The counterpart of `gaussian_splatting_tpu/cli/metrics.py` (the reference's
metrics.py:36-103): walks <model>/test/ours_<iter>/{renders,gt}, writes
results.json and per_view.json. SSIM and PSNR are `ops/losses.py`'s on the
card (an in-process caller may pass `main(argv, device="cpu")`), with
cuDNN's TF32 off for the SSIM convolutions. LPIPS is reported as null, as
the JAX CLI reports it without weights: the port's LPIPS (`ops/lpips.py`)
is not written yet. `--lpips_net` is accepted for that.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from gaussian_splatting_torch.ops import losses
from gaussian_splatting_torch.utils.device import require_device
from gaussian_splatting_torch.utils.image_io import read_png


def read_images(renders_dir, gt_dir):
    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        r = np.asarray(read_png(Path(renders_dir) / fname), np.float32) / 255.0
        g = np.asarray(read_png(Path(gt_dir) / fname), np.float32) / 255.0
        renders.append(r[..., :3])
        gts.append(g[..., :3])
        names.append(fname)
    return renders, gts, names


def evaluate(model_paths, lpips_net="vgg", device="cuda"):
    dev = require_device(device)
    full_dict = {}
    per_view_dict = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for scene_dir in model_paths:
            try:
                print("Scene:", scene_dir)
                full_dict[scene_dir] = {}
                per_view_dict[scene_dir] = {}
                test_dir = Path(scene_dir) / "test"
                for method in os.listdir(test_dir):
                    print("Method:", method)
                    method_dir = test_dir / method
                    renders, gts, names = read_images(method_dir / "renders", method_dir / "gt")
                    ssims, psnrs = [], []
                    for r, g in zip(renders, gts):
                        rt, gt = torch.from_numpy(r).to(dev), torch.from_numpy(g).to(dev)
                        ssims.append(float(losses.ssim(rt, gt)))
                        psnrs.append(float(losses.psnr(rt, gt)))
                    print(f"  SSIM : {np.mean(ssims):.7f}")
                    print(f"  PSNR : {np.mean(psnrs):.7f}")
                    full_dict[scene_dir][method] = {
                        "SSIM": float(np.mean(ssims)),
                        "PSNR": float(np.mean(psnrs)),
                        "LPIPS": None,
                    }
                    per_view_dict[scene_dir][method] = {
                        "SSIM": dict(zip(names, map(float, ssims))),
                        "PSNR": dict(zip(names, map(float, psnrs))),
                        "LPIPS": {},
                    }
                with open(scene_dir + "/results.json", "w") as fp:
                    json.dump(full_dict[scene_dir], fp, indent=True)
                with open(scene_dir + "/per_view.json", "w") as fp:
                    json.dump(per_view_dict[scene_dir], fp, indent=True)
            except Exception as e:  # one scene's failure is reported, the rest still run
                print(f"Unable to compute metrics for model {scene_dir}: {e}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return full_dict


def main(argv=None, device="cuda"):
    parser = ArgumentParser(description="Training script parameters")
    parser.add_argument(
        "--model_paths", "-m", required=True, nargs="+", type=str, default=[]
    )
    parser.add_argument(
        "--lpips_net", choices=["vgg", "alex", "squeeze"], default="vgg",
        help="LPIPS backbone (the reference's metrics.py uses vgg); LPIPS is "
             "reported as null until the port has it",
    )
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, lpips_net=args.lpips_net, device=device)


if __name__ == "__main__":
    main()
