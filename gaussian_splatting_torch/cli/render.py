"""Offline rendering CLI — the surface of the reference's render.py.

    python -m gaussian_splatting_torch.cli.render -m <model> [--iteration N]

The counterpart of `gaussian_splatting_tpu/cli/render.py`: renders the
train and test cameras of a trained model to PNGs under
<model>/{train,test}/ours_<iter>/{renders,gt}/NNNNN.png (render.py:24-35),
on the card (an in-process caller may pass `main(argv, device="cpu")`).

Tile geometry: inference takes `default_tile_geometry(converged=True)`,
whatever tile size the training run recorded in cfg_args, unless this
command line gives --tile_size or --tile_size_y. The flags default to None,
so argparse itself says whether they were given (in any spelling it
takes, such as --tile_size=16 or the abbreviation --tile_size_ of
--tile_size_y), and the tiles are then this command line's alone:
--tile_size (32 if absent) by --tile_size_y (0 or absent: the same).
Explicit tiles of more than 4096 pixels are refused before anything loads
(`config.check_tile_flags`), as the train CLI refuses them.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser
from dataclasses import fields, replace

import numpy as np
import torch

from gaussian_splatting_torch.config import (
    ModelParams,
    PipelineParams,
    check_tile_flags,
    get_combined_args,
    resolve_backend,
)
from gaussian_splatting_torch.ops.projection import preprocess
from gaussian_splatting_torch.ops.rasterize import (
    RasterizerConfig, default_tile_geometry, entry_bucket_capacity,
)
from gaussian_splatting_torch.scene.gaussians import (
    PAD_FILLS, PARAM_NAMES, GaussianParams, activate, capacity_bucket, params_from_numpy,
)
from gaussian_splatting_torch.scene.scene import Scene
from gaussian_splatting_torch.training import eval_render
from gaussian_splatting_torch.utils.device import require_device
from gaussian_splatting_torch.utils.general import mkdir_p, safe_state
from gaussian_splatting_torch.utils.image_io import write_png

# the flags' defaults, for those that neither this command line nor
# cfg_args set (the flags default to None here so that cfg_args shows)
DEFAULTS = {f.name: f.default for f in fields(ModelParams) + fields(PipelineParams)}


def quantize(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) floats -> uint8 as the JAX CLI writes them."""
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def load_model_padded(scene: Scene, min_capacity: int = 1024, device="cuda") -> GaussianParams:
    """A trained PLY as `GaussianParams` padded to `capacity_bucket` rows,
    `alive` marking the loaded ones."""
    raw = scene.load_gaussians()
    n = raw["xyz"].shape[0]
    cap = capacity_bucket(n, min_capacity)

    def pad(x, fill):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    return params_from_numpy({k: pad(raw[k], PAD_FILLS[k]) for k in PARAM_NAMES},
                             alive=np.arange(cap) < n, device=device)


@torch.no_grad()
def auto_capacity(params: GaussianParams, views, raster_cfg, sh_degree, bits=16):
    """Entry-driven tile-list capacity: the largest true entry count of the
    views, from preprocess alone (as `Trainer._probe_entries`), bucketed
    (`ops/rasterize.entry_bucket_capacity`)."""
    acts = activate(params)
    dev = params.xyz.device
    worst = 0
    for view in views:
        prep = preprocess(acts.xyz, acts.scales, acts.quats, acts.opacities, acts.shs, sh_degree,
                          view.arrays(device=dev), view.width, view.height, raster_cfg.tile_w,
                          raster_cfg.tile_h, alive=params.alive)
        worst = max(worst, int(prep.tiles_touched.sum()))
    return entry_bucket_capacity(worst, bits)


def render_set(model_path, name, iteration, views, params, bg, sh_degree, raster_cfg):
    render_path = os.path.join(model_path, name, f"ours_{iteration}", "renders")
    gts_path = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    mkdir_p(render_path)
    mkdir_p(gts_path)

    for idx, view in enumerate(views):
        img, _ = eval_render(params, view.arrays(device=bg.device), bg, sh_degree,
                             view.width, view.height, raster_cfg)
        write_png(os.path.join(render_path, f"{idx:05d}.png"), quantize(img.cpu().numpy()))
        write_png(os.path.join(gts_path, f"{idx:05d}.png"), quantize(view.image.transpose(1, 2, 0)))
        print(f"\rRendering {name} {idx + 1}/{len(views)}", end="")
    print()


def render_sets(dataset, iteration, pipe, skip_train=False, skip_test=False,
                explicit_tiles=False, device="cuda"):
    dev = require_device(device)
    scene = Scene(
        source_path=dataset.source_path,
        model_path=dataset.model_path,
        images=dataset.images,
        eval_split=dataset.eval,
        white_background=dataset.white_background,
        resolution=dataset.resolution,
        load_iteration=iteration,
        shuffle=False,
        sh_degree=dataset.sh_degree,
    )
    params = load_model_padded(scene, device=dev)
    bg = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0],
                      device=dev)
    if explicit_tiles:
        tile_w, tile_h = pipe.tile_size, (pipe.tile_size_y or pipe.tile_size)
    else:
        tile_w, tile_h = default_tile_geometry(converged=True)
    raster_cfg = RasterizerConfig(tile_w=tile_w, tile_h=tile_h, capacity_mult=pipe.capacity_mult,
                                  backend=resolve_backend(pipe.backend))
    views = (
        ([] if skip_train else scene.get_train_cameras())
        + ([] if skip_test else scene.get_test_cameras())
    )
    if views:
        cap = auto_capacity(params, views, raster_cfg, dataset.sh_degree)
        raster_cfg = replace(raster_cfg, capacity_exact=cap)
    if not skip_train:
        render_set(dataset.model_path, "train", scene.loaded_iter, scene.get_train_cameras(),
                   params, bg, dataset.sh_degree, raster_cfg)
    if not skip_test:
        render_set(dataset.model_path, "test", scene.loaded_iter, scene.get_test_cameras(),
                   params, bg, dataset.sh_degree, raster_cfg)


def main(argv=None, device="cuda"):
    parser = ArgumentParser(description="Testing script parameters")
    ModelParams.add_to_parser(parser, "Loading Parameters", fill_none=True)
    PipelineParams.add_to_parser(parser, "Pipeline Parameters", fill_none=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    argv = sys.argv[1:] if argv is None else argv
    cmdline = parser.parse_args(argv)
    explicit_tiles = cmdline.tile_size is not None or cmdline.tile_size_y is not None
    if explicit_tiles:
        check_tile_flags(parser, cmdline.tile_size or 32, cmdline.tile_size_y or 0)
    args = get_combined_args(parser, argv)
    dev = require_device(device)
    print("Rendering " + args.model_path)
    safe_state(args.quiet)
    for f, default in DEFAULTS.items():
        if getattr(args, f, None) is None:
            setattr(args, f, default)
    if explicit_tiles:  # this command line's tiles, never the training run's
        args.tile_size = cmdline.tile_size or 32
        args.tile_size_y = cmdline.tile_size_y or 0
    render_sets(
        ModelParams.extract(args),
        args.iteration,
        PipelineParams.extract(args),
        skip_train=args.skip_train,
        skip_test=args.skip_test,
        explicit_tiles=explicit_tiles,
        device=dev,
    )


if __name__ == "__main__":
    main()
