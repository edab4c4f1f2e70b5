"""Full evaluation harness — the surface of the reference's full_eval.py.

The counterpart of `gaussian_splatting_tpu/cli/full_eval.py`, with the
same flags and argument checks: trains, renders and evaluates the 13 paper
scenes (MipNeRF360 x9, Tanks&Temples x2, Deep Blending x2) by shelling out
to the port's train / render / metrics CLIs (full_eval.py:15-75), with the
paper's per-dataset resolution policy (outdoor images_4, indoor images_2,
full-res for T&T/DB). `--backend` takes the port's backends (and the JAX
package's names, which map to "auto"). The paper's datasets are JPEG, which
the port reads as the JAX package does through PIL, bit for bit
(`utils/image_io.read_image`, `utils/jpeg.py`).
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]

_PY = sys.executable


def main(argv=None):
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", type=str, default=None)
    parser.add_argument("--tanksandtemples", "-tat", type=str, default=None)
    parser.add_argument("--deepblending", "-db", type=str, default=None)
    parser.add_argument("--backend", type=str, default="auto")
    args = parser.parse_args(argv)

    if not args.skip_training or not args.skip_rendering:
        missing = [
            n for n, v in (
                ("--mipnerf360", args.mipnerf360),
                ("--tanksandtemples", args.tanksandtemples),
                ("--deepblending", args.deepblending),
            ) if v is None
        ]
        if missing:
            parser.error("required dataset paths missing: " + ", ".join(missing))

    if not args.skip_training:
        common = f" --quiet --eval --test_iterations -1 --backend {args.backend} --disable_viewer "
        for scene in MIPNERF360_OUTDOOR:
            src = os.path.join(args.mipnerf360, scene)
            os.system(
                f"{_PY} -m gaussian_splatting_torch.cli.train -s {src} -i images_4 "
                f"-m {args.output_path}/{scene}{common}"
            )
        for scene in MIPNERF360_INDOOR:
            src = os.path.join(args.mipnerf360, scene)
            os.system(
                f"{_PY} -m gaussian_splatting_torch.cli.train -s {src} -i images_2 "
                f"-m {args.output_path}/{scene}{common}"
            )
        for scene in TANKS_AND_TEMPLES:
            src = os.path.join(args.tanksandtemples, scene)
            os.system(
                f"{_PY} -m gaussian_splatting_torch.cli.train -s {src} "
                f"-m {args.output_path}/{scene}{common}"
            )
        for scene in DEEP_BLENDING:
            src = os.path.join(args.deepblending, scene)
            os.system(
                f"{_PY} -m gaussian_splatting_torch.cli.train -s {src} "
                f"-m {args.output_path}/{scene}{common}"
            )

    all_scenes = MIPNERF360_OUTDOOR + MIPNERF360_INDOOR + TANKS_AND_TEMPLES + DEEP_BLENDING

    if not args.skip_rendering:
        all_sources = (
            [os.path.join(args.mipnerf360, s) for s in MIPNERF360_OUTDOOR + MIPNERF360_INDOOR]
            + [os.path.join(args.tanksandtemples, s) for s in TANKS_AND_TEMPLES]
            + [os.path.join(args.deepblending, s) for s in DEEP_BLENDING]
        )
        for scene, source in zip(all_scenes, all_sources):
            for it in (7000, 30000):
                os.system(
                    f"{_PY} -m gaussian_splatting_torch.cli.render --iteration {it} "
                    f"-s {source} -m {args.output_path}/{scene} --quiet --eval --skip_train"
                )

    if not args.skip_metrics:
        scenes_string = " ".join(f"{args.output_path}/{s}" for s in all_scenes)
        os.system(f"{_PY} -m gaussian_splatting_torch.cli.metrics -m {scenes_string}")


if __name__ == "__main__":
    main()
