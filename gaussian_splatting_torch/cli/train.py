"""Training CLI — the surface of the reference's train.py:244-277.

    python -m gaussian_splatting_torch.cli.train -s <data> -m <out> [flags]

The counterpart of `gaussian_splatting_tpu/cli/train.py`, with its flags
and its order within an iteration: the step with deferred maintenance, the
report, the PLY save, `post_step` (densify, opacity reset), the
checkpoint. It trains on the card; without one it raises. An in-process
caller may pass `main(argv, device="cpu")`; there is no flag for it.

`--detect_anomaly` turns on torch's anomaly detection, and
`--profile_iteration N` writes a `torch.profiler` trace of the steps from
N to N + 5 into <model>/profile. Tensorboard logging and the tqdm progress
bar are used when those packages import, as in the JAX package.
"""

from __future__ import annotations

import os
import sys
import time
import uuid
from argparse import ArgumentParser, Namespace

import torch

from gaussian_splatting_torch.config import (
    ModelParams,
    OptimizationParams,
    PipelineParams,
    resolve_backend,
    write_cfg_args,
)
from gaussian_splatting_torch.ops import losses
from gaussian_splatting_torch.ops.rasterize import RasterizerConfig
from gaussian_splatting_torch.scene.scene import Scene
from gaussian_splatting_torch.trainer import Trainer, _state_to_host
from gaussian_splatting_torch.training import OptimizationConfig, eval_render
from gaussian_splatting_torch.utils.device import require_device
from gaussian_splatting_torch.utils.general import safe_state


def training(
    dataset,
    opt,
    pipe,
    testing_iterations,
    saving_iterations,
    checkpoint_iterations,
    checkpoint,
    ip="127.0.0.1",
    port=6009,
    quiet=False,
    disable_viewer=False,
    profile_iteration=-1,
    debug_from=-1,
    device="cuda",
):
    """Train a scene into `dataset.model_path`; returns (scene, trainer)."""
    dev = require_device(device)
    if not dataset.model_path:
        unique_str = os.getenv("OAR_JOB_ID") or str(uuid.uuid4())
        dataset.model_path = os.path.join("./output/", unique_str[0:10])
    print("Output folder: {}".format(dataset.model_path))
    write_cfg_args(dataset.model_path, Namespace(**vars(dataset)))

    tb_writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter

        tb_writer = SummaryWriter(dataset.model_path)
    except ImportError:
        print("Tensorboard not available: not logging progress")

    scene = Scene(
        source_path=dataset.source_path,
        model_path=dataset.model_path,
        images=dataset.images,
        eval_split=dataset.eval,
        white_background=dataset.white_background,
        resolution=dataset.resolution,
        sh_degree=dataset.sh_degree,
    )

    opt_cfg = OptimizationConfig(
        **{
            k: getattr(opt, k)
            for k in OptimizationConfig.__dataclass_fields__
            if hasattr(opt, k)
        }
    )
    raster_cfg = RasterizerConfig(
        tile_w=pipe.tile_size,
        tile_h=(pipe.tile_size_y or pipe.tile_size),
        capacity_mult=pipe.capacity_mult,
        backend=resolve_backend(pipe.backend),
    )
    trainer = Trainer(
        cameras=scene.get_train_cameras(),
        opt=opt_cfg,
        raster_cfg=raster_cfg,
        sh_degree=dataset.sh_degree,
        white_background=dataset.white_background,
        cameras_extent=scene.cameras_extent,
        spatial_lr_scale=scene.cameras_extent,
        device=dev,
    )
    trainer.init_from_pcd(scene.info.points, scene.info.colors)
    trainer.debug = bool(getattr(pipe, "debug", False))
    if checkpoint:
        trainer.load_checkpoint(checkpoint)

    # live viewer bridge (network_gui protocol)
    gui = None
    if not disable_viewer:
        try:
            from gaussian_splatting_torch.viewer.network_gui import NetworkGUI

            gui = NetworkGUI(ip, port)
            gui.source_path = dataset.source_path
        except OSError as e:
            print(f"network gui disabled: {e}")

    # tqdm progress bar with EMA loss, updated every 10 iters
    # (train.py:73,136-140); falls back to prints when tqdm is absent.
    progress_bar = None
    try:
        from tqdm import tqdm

        progress_bar = tqdm(
            total=opt_cfg.iterations, initial=trainer.iteration,
            desc="Training progress", disable=quiet,
        )
    except ImportError:
        pass
    ema_loss = 0.0

    profiler = None
    t0 = time.time()
    last_log = t0
    while trainer.iteration < opt_cfg.iterations:
        if gui is not None:
            gui.poll(trainer)
        if profile_iteration >= 0 and trainer.iteration + 1 == profile_iteration:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        if debug_from >= 0 and trainer.iteration >= debug_from:
            trainer.debug = True  # train.py:112-113 ((iteration-1)==debug_from)
        # Maintenance (densify + opacity reset) is deferred until after
        # report/save below — reference iteration order (train.py:146-169).
        t_step = time.time()
        m = trainer.step(defer_maintenance=True)
        # Host-wall per-step time: trainer.step copies the metrics to the
        # host, so the step's device work has finished (the analog of the
        # reference's CUDA event pair, logged as `iter_time`, train.py:211).
        iter_time_ms = (time.time() - t_step) * 1e3
        m["iter_time_ms"] = iter_time_ms  # m is the trainer's history entry
        it = trainer.iteration
        if profiler is not None and it == profile_iteration + 5:
            profiler.stop()
            out = os.path.join(dataset.model_path, "profile")
            os.makedirs(out, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(out, f"trace_{profile_iteration}.json"))
            profiler = None
            print(f"[ITER {it}] profiler trace written to {out}")

        ema_loss = 0.4 * m["loss"] + 0.6 * ema_loss  # train.py:136
        if progress_bar is not None:
            if it % 10 == 0:
                progress_bar.set_postfix({"Loss": f"{ema_loss:.7f}"})
                progress_bar.update(10)
            if it == opt_cfg.iterations:
                progress_bar.close()

        if tb_writer and it % 10 == 0:
            tb_writer.add_scalar("train_loss_patches/l1_loss", m["l1"], it)
            tb_writer.add_scalar("train_loss_patches/total_loss", m["loss"], it)
            tb_writer.add_scalar("iter_time", iter_time_ms, it)  # train.py:211
            tb_writer.add_scalar("total_points", trainer.num_live, it)

        if it % 100 == 0 and time.time() - last_log > 5:
            last_log = time.time()
            rate = it / (time.time() - t0)
            print(
                f"[ITER {it}] loss {m['loss']:.5f} psnr {m['psnr']:.2f} "
                f"P {trainer.num_live} ({rate:.2f} it/s)"
            )

        if it in testing_iterations:
            _report(tb_writer, it, scene, trainer,
                    log_gt=it == min(testing_iterations))
        if it in saving_iterations:
            print(f"\n[ITER {it}] Saving Gaussians")
            params, _, _, _, _ = _state_to_host(trainer.state)
            scene.save(it, params)
        # densify/reset AFTER report + PLY save, BEFORE the checkpoint —
        # the reference's order (report :146, save :147, densify :153,
        # checkpoint :178 in train.py).
        trainer.post_step()
        if it in checkpoint_iterations:
            print(f"\n[ITER {it}] Saving Checkpoint")
            trainer.save_checkpoint(
                os.path.join(scene.model_path, f"chkpnt{it}.pth")
            )
    if profiler is not None:  # the run ended inside the profiled window
        profiler.stop()
    return scene, trainer


@torch.no_grad()
def _report(tb_writer, iteration, scene: Scene, trainer: Trainer, log_gt=False):
    """training_report (train.py:207-242): test/train L1 + PSNR, plus the
    reference's image panels (renders for 5 views, GT once), opacity
    histogram, and total_points."""
    dev = trainer.background.device
    configs = [
        ("test", scene.get_test_cameras()),
        (
            "train",
            [
                scene.get_train_cameras()[idx % len(scene.get_train_cameras())]
                for idx in range(5, 30, 5)
            ],
        ),
    ]
    for name, cams in configs:
        if not cams:
            continue
        l1_sum, psnr_sum = 0.0, 0.0
        for idx, cam in enumerate(cams):
            img, _ = eval_render(
                trainer.state.params,
                cam.arrays(device=dev),
                trainer.background,
                trainer.active_sh_degree,
                cam.width,
                cam.height,
                trainer.raster_cfg,
            )
            img = torch.clamp(img, 0.0, 1.0)
            gt = torch.as_tensor(cam.image.transpose(1, 2, 0), device=dev)
            if tb_writer and idx < 5:
                # train.py:223-227: (1, 3, H, W) panels per view
                r = img.permute(2, 0, 1)[None].cpu().numpy()
                tb_writer.add_images(
                    f"{name}_view_{cam.image_name}/render", r, global_step=iteration
                )
                if log_gt:
                    g = gt.permute(2, 0, 1)[None].cpu().numpy()
                    tb_writer.add_images(
                        f"{name}_view_{cam.image_name}/ground_truth",
                        g, global_step=iteration,
                    )
            l1_sum += float(losses.l1_loss(img, gt))
            psnr_sum += float(losses.psnr(img, gt))
        l1_t, psnr_t = l1_sum / len(cams), psnr_sum / len(cams)
        print(f"\n[ITER {iteration}] Evaluating {name}: L1 {l1_t} PSNR {psnr_t}")
        if tb_writer:
            tb_writer.add_scalar(f"{name}/loss_viewpoint - l1_loss", l1_t, iteration)
            tb_writer.add_scalar(f"{name}/loss_viewpoint - psnr", psnr_t, iteration)

    if tb_writer:
        # train.py:239-241: opacity histogram + total point count
        p = trainer.state.params
        opacities = torch.sigmoid(p.opacity[p.alive, 0]).cpu().numpy()  # activated, like get_opacity
        tb_writer.add_histogram("scene/opacity_histogram", opacities, iteration)
        tb_writer.add_scalar("total_points", int(p.alive.sum()), iteration)


def main(argv=None, device="cuda"):
    """Parse the flags and train; returns (scene, trainer)."""
    parser = ArgumentParser(description="Training script parameters")
    ModelParams.add_to_parser(parser, "Loading Parameters")
    OptimizationParams.add_to_parser(parser, "Optimization Parameters")
    PipelineParams.add_to_parser(parser, "Pipeline Parameters")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--disable_viewer", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument(
        "--profile_iteration", type=int, default=-1,
        help="write a torch.profiler trace of the steps from this one to "
             "five after it (into <model>/profile)",
    )
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    args.save_iterations.append(args.iterations)
    dev = require_device(device)

    print("Optimizing " + args.model_path)
    safe_state(args.quiet)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    out = training(
        ModelParams.extract(args),
        OptimizationParams.extract(args),
        PipelineParams.extract(args),
        args.test_iterations,
        args.save_iterations,
        args.checkpoint_iterations,
        args.start_checkpoint,
        ip=args.ip,
        port=args.port,
        quiet=args.quiet,
        disable_viewer=args.disable_viewer,
        profile_iteration=args.profile_iteration,
        debug_from=args.debug_from,
        device=dev,
    )
    print("\nTraining complete.")
    return out


if __name__ == "__main__":
    main()
