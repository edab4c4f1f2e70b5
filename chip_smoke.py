#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is caught and passed over):
  1. device: require CUDA; print the card's name, count, and
     `nvidia-smi --query-gpu=name,power.limit` line.
  2. build: compile every kernel under gaussian_splatting_torch/csrc with
     nvcc (one process per source, all at once) and print ptxas's
     register / shared-memory / spill report.
  3. kernels vs plain: preprocess and bin a scene once, feed the same sorted
     lists to each CUDA kernel and to its plain torch version. Random scenes
     at 128x128 and 333x197 for every supported tile geometry, and the
     trained model (assets/trained_r5.ply) at 1920x1080 (3 camera angles for
     the forward, angle 0 for the backward).
     Forward tolerance: >= 99.9% of pixels within 1e-5 and every pixel
     within 1e-2 on the image and on final_t (the kernels round three
     steps as FMAs, csrc/blend.cuh, which can flip an alpha >= 1/255 or
     T >= 1e-4 decision). The golden scene of tests/test_golden_render.py,
     rendered through `rasterize`, is held to its fixture with the same rule
     at 2e-5.
     Backward and routing, with seeded random cotangents, per gradient
     field: relative L2 error <= 1e-4, and >= 99.9% of rows (entries for the
     backward, Gaussians for the routing) within 1e-3 x the field's max
     |grad|. The backward's replayed final T must equal the forward's
     final_t bit for bit, and two runs of the backward, and of the routing,
     must give the same bits. On every forward input the forward must give
     the bits of its form with the box cull off (`reach` boxes infinite):
     the cull may leave out only pairs the blend skips.
     The transpose (`relayout_to_rows`) at (9, K) and (16, K) for K =
     1,900,544 (the profiler's capacity) and an odd K = 1,339,001 must be
     bit-equal to its plain version: it is a copy. The column sums
     (`consume_rows`, `consume_t`) on seeded (K, 16) tables: per column
     |result - float64 sum| <= 1e-5 x sum |x| for the kernel and for the
     plain version (float32 partials summed in another order), and two runs
     of each kernel give the same bits.
  4. render path: the trained model through the user entry points
     (params_from_ply -> eval_render) at 1920x1080 with 32x32 tiles; 50
     frames after a warm-up; the forward kernel's launch counter must rise
     by exactly 50. Prints the entry count, frame latency (median, p80),
     peak device memory, each stage's stream time (CUDA events), the device
     busy share and top kernels (torch.profiler), the kernel's time (CUDA
     events) beside its bound, and the plain version's time; the (entry,
     32-pixel unit) pairs it evaluates, registers per thread, threads per
     block and resident blocks per SM.
  5. train path: params_from_ply -> init_train_state -> 20 train_steps of
     the trained model at 1920x1080 (camera angle 0, 32x32 tiles, black
     background, SH degree 3, OptimizationConfig() defaults) toward the
     model's own render from angle 0.2 rad. Every step's entry count must
     fit the capacity, every loss be finite, the loss after step 20 be below
     step 1's, and each of the three kernels be launched exactly 20 times.
     Prints step latency (median, p80 of the last 15), peak device memory,
     each stage's stream time, the device busy share and top kernels, and
     the backward and routing kernels' times beside their bounds, their
     plain versions' times and, for routing, `index_add_`'s time and the
     run lengths (max and p99.9 of the entries per Gaussian); the
     backward's (entry, warp band) reductions (pairs of an entry and a warp
     in which some pixel blended it), its (entry, unit) pairs, registers
     per thread and resident blocks per SM.
  5b. trainer path: `Trainer` from a point cloud, at full width: the
     122,535 points of assets/trained_r5.ply with colours from its DC
     coefficients, written and read back through the point-cloud PLY
     functions; 8 orbit cameras at 1920x1080 (fov 70 degrees) whose targets
     are the trained model's renders; `init_from_pcd` (the Morton KNN on
     the card), then 300 steps at `OptimizationConfig()` defaults but the
     cadence (densify every 5 steps from 10 to 295, opacity reset at 200), 32x32
     tiles, auto capacity, seed 0. Fails unless every loss is finite, the
     mean of the last 20 losses is below the first 20's, a densify took the
     device path and one the host path with a capacity growth, every live
     opacity is <= 0.01 after the reset, every step's entry count fit the
     capacity it ran at or the capacity grew right after it, the three
     kernels' counters rose by exactly the step count, a checkpoint
     reloaded into a fresh `Trainer` and saved again holds bit-equal live
     rows, moments, step and statistics and the trainer steps on, the live rows saved as a PLY
     model and reloaded render within the forward's rule of the trainer's
     own render. The three train-path kernels are held to their plain
     versions, by phase 3's rules, at two of the trainer's states: the one
     just after the opacity reset (every opacity <= 0.01, so T never
     saturates and nearly every pair blends) and the final one, after the
     device densifies that followed the reset's compaction, each at
     its own preprocess and binning (live rows, SH degree, entry capacity)
     from a trainer camera. Prints the step latency (median, p80) over the
     steps after the first epoch that run no maintenance beside phase 5's,
     each densify (path, counts, live rows, rows, ms), reset, probe,
     `create_from_pcd` and checkpoint times, the KNN's times (Morton at
     122,535 points, exact at 20,000), first and last loss and PSNR, the
     final live count and peak device memory.
  5c. CLI path: the user's entry path, in process on the card at full
     width. A COLMAP dataset in a temporary directory, written with the
     port's writers: one PINHOLE camera (1920x1080, fov 70 degrees), 16
     orbit views around trained_r5 (world-to-camera quaternion and
     translation), its 122,535 centres coloured clip(0.5 + C0 f_dc) * 255
     as uint8, and each view's `eval_render` of trained_r5 quantised
     clip * 255 + 0.5 as a PNG. The port's readers must give back every
     camera (R, T within 1e-12) and every pixel, and a copy of the first
     view's pixels as a PNG whose rows cycle through all five row filters
     (the Average and Paeth rows of PIL- or libpng-written datasets take
     the reader's anti-diagonal path) must decode bit-equal. Then
     `cli.train.main`
     (-r 1 --eval, 200 iterations, reports at 100 and 200, a PLY at 100 and
     200, a checkpoint at 200, a densify every 20 steps from 40 to 140, the
     opacity reset at 120; 14 train and 2 test views): the files must
     exist, the run reach 200, a densify run, the mean of the last 20
     losses be below the first 20's, and the PLY at 200, reloaded, render
     the bits of the trainer's final state. At that state (its padded
     rows, the dead rows the reset and the prunes left, its entry
     capacity) and the first test camera, the forward, the backward and
     the routing are held to their plain versions by phase 3's rules
     (`check_state`; these launches are not the path's).
     `cli.render.main(["-m", M])`:
     14 + 2 renders and ground truths, each ground truth bit-equal to the
     dataset's PNG, the first test render bit-equal to `eval_render` of the
     reloaded PLY quantised the same way. `cli.metrics.main(["-m", M])`:
     `ours_200` with a finite SSIM and PSNR and a null LPIPS, the PSNR within
     1e-4 dB of a float64 one from the PNGs. The compositing kernels'
     counters must equal the schedule: per train-CLI step one launch of
     each, per report one forward for each of the 2 test views and 5 train
     views; one forward per render-CLI view. Prints the PNG encode and
     decode ms at 1080p (the decode of the port's Sub-filtered files and
     of the five-filter file), one 1920 -> 1600 resize, the train CLI's
     wall time and step median (from the `iter_time_ms` it records in
     each history entry), the time of tensorboard's image panels where
     tensorboard imports and which optional packages import, the render
     CLI's ms per view, the metrics CLI's ms, the phase's peak device
     memory and wall time. `sys.stdout`, which each CLI's `safe_state`
     replaces, is restored after each.
  6. profiler path: `tools/profile_stages.run` at the JAX tool's defaults
     (P = 262,144 random Gaussians, 1920x1080, 32x16 tiles, 10 calls a
     line, best of 3) over every ported stage; prints the stage table, the
     header counts and the sat and roofline tables. Every time must be
     finite; the launch counter of every kernel must rise by exactly the
     calls the stages report making; the entry count must equal this
     script's own preprocess of the profiler's scene. Then the three
     kernels only this path runs are timed at its shapes beside their
     bound, their plain versions and the one PyTorch call that computes
     the same (`x.t().contiguous()`, `x.sum(0)`), and `consume_t`'s
     registers per thread and resident blocks per SM.
  7. the kernels line, then the result line. Each kernel's `launches` is
     the sum of `launches_by_path`: each path's own count, read after its
     own reset (train, trainer, cli_train and cli_render for the
     compositing kernels and the routing, profiler for the other three).

Each phase's wall time is printed. Scenes are made with numpy from fixed
seeds. Imports no JAX.
"""

import importlib.util
import json
import math
import os
import pickle
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from gaussian_splatting_torch import (
    OptimizationConfig, RasterizerConfig, Trainer, eval_render, init_train_state, rasterize,
    train_step,
)
from gaussian_splatting_torch.cli import metrics as metrics_cli
from gaussian_splatting_torch.cli import render as render_cli
from gaussian_splatting_torch.cli import train as train_cli
from gaussian_splatting_torch.ops import binning, gsmath, losses
from gaussian_splatting_torch.ops.composite import (
    CompositeOut, blend_pair_counts, composite_bwd_torch, composite_fwd_torch, route_grads_torch,
)
from gaussian_splatting_torch.ops.knn import mean_knn_dist2_exact, mean_knn_dist2_morton
from gaussian_splatting_torch.ops.composite_cuda import (
    TILE_GEOMETRIES, composite_bwd, composite_bwd_cuda, composite_bwd_occupancy, composite_fwd,
    composite_fwd_cuda, composite_fwd_occupancy, composite_fwd_unculled_cuda, route_grads,
    route_grads_cuda,
)
from gaussian_splatting_torch.ops.projection import preprocess
from gaussian_splatting_torch.ops.rasterize import entry_bucket_capacity
from gaussian_splatting_torch.ops.relayout import (
    relayout_to_rows, relayout_to_rows_cuda, relayout_to_rows_torch,
)
from gaussian_splatting_torch.scene.cameras import orbit_camera
from gaussian_splatting_torch.scene.dataset_readers import (
    load_camera, read_colmap_scene, write_colmap_scene,
)
from gaussian_splatting_torch.scene.gaussians import (
    PARAM_NAMES, activate, capacity_bucket, params_from_ply,
)
from gaussian_splatting_torch.scene.ply import (
    load_gaussians_ply, load_point_cloud_ply, save_gaussians_ply, save_point_cloud_ply,
)
from gaussian_splatting_torch.scene.optim import adam_update
from gaussian_splatting_torch.tools import profile_stages
from gaussian_splatting_torch.tools.consumers import (
    consume_rows, consume_rows_cuda, consume_rows_torch, consume_t, consume_t_cuda,
    consume_t_occupancy, consume_t_torch,
)
from gaussian_splatting_torch.utils import cuda_build, image_io
from gaussian_splatting_torch.utils.roofline import (
    OPS_PER_BLENDED_BWD, OPS_PER_PAIR, bound_ms, pair_ops,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAINED_PLY = os.path.join(ROOT, "assets", "trained_r5.ply")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
W_MAIN, H_MAIN = 1920, 1080
FRAMES = 50  # p80 has 10 frames beyond it
STEPS, TIMED_STEPS = 20, 15  # train steps; latency over the last 15 (p80 has 3 beyond it)

TRAINER_STEPS, TRAINER_CAMERAS = 300, 8
# A densify every 5 steps: at 122,535 points one densify adds a few hundred
# rows, and the run must exhaust the 8,537 free rows of the first capacity
# (131,072) to take the host path once (at a 50-step interval no densify
# of the 300 steps overflowed).
TRAINER_OPT = OptimizationConfig(densify_from_iter=5, densification_interval=5,
                                 densify_until_iter=300, opacity_reset_interval=200)

CLI_VIEWS, CLI_STEPS, CLI_REPORTS, CLI_SAVE = 16, 200, (100, 200), 100
CLI_TRAIN = ["-r", "1", "--eval", "--iterations", str(CLI_STEPS),
             "--test_iterations", *map(str, CLI_REPORTS), "--save_iterations", str(CLI_SAVE),
             "--checkpoint_iterations", str(CLI_STEPS), "--densify_from_iter", "20",
             "--densification_interval", "20", "--densify_until_iter", "160",
             "--opacity_reset_interval", "120", "--disable_viewer", "--quiet"]

SUM_K = (1_900_544, 1_339_001)  # the profiler's capacity at its defaults, and an odd K
LAUNCH_COUNTERS = {"composite_fwd": composite_fwd, "composite_bwd": composite_bwd,
                   "route_grads": route_grads, "relayout_to_rows": relayout_to_rows,
                   "consume_rows": consume_rows, "consume_t": consume_t}

LOOSE, SHARE = 1e-2, 1e-3  # every pixel within LOOSE; at most SHARE over the tight bound
GRAD_L2, GRAD_ROW, GRAD_SHARE = 1e-4, 1e-3, 1e-3  # backward / routing rule, see phase 3


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def make_gaussians(P, seed, spread=1.0, scale_mu=-2.5):
    """Activated random Gaussians (the generator of tests/helpers.py)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, spread, (P, 3)).astype(np.float32)
    scales = np.exp(rng.normal(scale_mu, 0.3, (P, 3))).astype(np.float32)
    quats = rng.normal(0, 1, (P, 4)).astype(np.float32)
    opacities = (1 / (1 + np.exp(-rng.normal(0.5, 1, (P,))))).astype(np.float32)
    shs = rng.normal(0, 0.2, (P, 16, 3)).astype(np.float32)
    shs[:, 0, :] += 1.0
    return means, scales, quats, opacities, shs


def sorted_inputs(acts, cam, W, H, tile, sh=3, alive=None, capacity=None):
    """Preprocess + binning once; the kernels' inputs at exactly this size
    (rows outside `alive` culled, as the train step does; the entry
    capacity `capacity`, or the exact entry count when that is None or
    smaller). Returns the forward kernel's scene arguments, the tile lists
    and the entry count."""
    P = acts[0].shape[0]
    prep = preprocess(*acts, sh, cam, W, H, *tile, alive=alive)
    gx, gy = -(-W // tile[0]), -(-H // tile[1])
    capacity = max(capacity or 0, int(prep.tiles_touched.sum()))
    capacity = RasterizerConfig(capacity_exact=capacity).capacity(P)
    lists = binning.build_tile_lists(prep.rect_min, prep.rect_max, prep.depths,
                                     prep.tiles_touched, gx, gy, capacity)
    if int(lists.total) > capacity:
        fail("tile list overflow in the kernel check")
    return (lists.gauss_id, lists.tile_start, lists.tile_stop, prep.means2d, prep.conic,
            prep.rgb, prep.opacity), lists, int(lists.total)


def compare(name, out, ref, tight):
    """Check a render against a reference; returns the max abs error."""
    errs = []
    for field in ("image", "final_t"):
        a, b = getattr(out, field), getattr(ref, field)
        if a.shape != b.shape:
            fail(f"{name}: {field} shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if not bool(torch.isfinite(a).all()):
            fail(f"{name}: {field} not finite")
        d = (a - b).abs()
        per_pixel = d.amax(dim=-1) if field == "image" else d
        over = float((per_pixel > tight).float().mean())
        mx = float(d.max())
        print(f"  {name:34s} {field:7s} max_abs_err={mx:.3e} share_over_{tight:g}={over:.2e}")
        if mx > LOOSE or over > SHARE:
            fail(f"{name}: {field} outside tolerance (max {mx:.3e}, share {over:.2e})")
        errs.append(mx)
    return max(errs)


def check_cull(name, out, args, bg, W, H, tile):
    """The forward kernel's outputs must be the bits of its form with the
    box cull off: the cull may leave out only pairs the blend skips."""
    full = composite_fwd_unculled_cuda(*args, bg, W, H, *tile)
    torch.cuda.synchronize()
    for field in ("image", "final_t"):
        a, b = getattr(out, field), getattr(full, field)
        if not torch.equal(a, b):
            fail(f"{name}: the box cull changes {field} at {int((a != b).sum())} elements")
    print(f"  {name:34s} image and final_t bit-equal with the box cull off")


def compare_grads(name, got, ref):
    """Check (N, 9) gradient rows against a reference, field by field;
    returns the max abs error."""
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: not finite")
    worst_l2 = worst_share = 0.0
    for f in range(ref.shape[1]):
        d, r = (got[:, f] - ref[:, f]).double(), ref[:, f].double()
        l2 = float(d.norm()) / max(float(r.norm()), 1e-30)
        share = float((d.abs() > GRAD_ROW * float(r.abs().max())).double().mean())
        worst_l2, worst_share = max(worst_l2, l2), max(worst_share, share)
    mx = float((got - ref).abs().max())
    print(f"  {name:42s} max_abs_err={mx:.3e} worst_field_rel_l2={worst_l2:.2e} "
          f"worst_field_share_over={worst_share:.2e}")
    if worst_l2 > GRAD_L2 or worst_share > GRAD_SHARE:
        fail(f"{name}: outside tolerance (rel L2 {worst_l2:.2e}, share {worst_share:.2e})")
    return mx


def check_backward(name, args, lists, bg, W, H, tile, seed):
    """Backward and routing kernels vs their plain versions on the forward
    kernel's outputs and seeded random cotangents; the replayed final T must
    be the forward's, and two runs of each kernel the same bits. Returns
    the max abs errors of the backward's rows and of the routing's sums."""
    dev = bg.device
    fwd = composite_fwd_cuda(*args, bg, W, H, *tile)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g_img = torch.randn((H, W, 3), generator=gen, device=dev)
    g_ft = torch.randn((H, W), generator=gen, device=dev)
    bargs = (*args[:3], lists.entry_src, *args[3:], fwd.image, fwd.final_t, g_img, g_ft, W, H, *tile)
    replay_t = torch.full((H, W), -1.0, device=dev)
    rows = composite_bwd_cuda(*bargs, replay_t=replay_t)
    rows_again = composite_bwd_cuda(*bargs)
    torch.cuda.synchronize()
    if not torch.equal(replay_t, fwd.final_t):
        n_diff = int((replay_t != fwd.final_t).sum())
        fail(f"{name}: the backward's replayed final T differs from the forward's at {n_diff} pixels")
    n, P = int(lists.total), args[3].shape[0]  # rows past n: padding, never written or read
    if not torch.equal(rows[:n], rows_again[:n]):
        fail(f"{name}: two runs of the backward kernel differ")
    rows_ref = composite_bwd_torch(*bargs)
    err_rows = compare_grads(f"{name} backward rows", rows[:n], rows_ref[:n])
    off, cnt = lists.gauss_offset, lists.gauss_count
    sums = route_grads_cuda(rows, off, cnt, P)
    if not torch.equal(sums, route_grads_cuda(rows, off, cnt, P)):
        fail(f"{name}: two runs of the routing kernel differ")
    err_route = compare_grads(f"{name} routing", sums, route_grads_torch(rows, off, cnt, P))
    compare_grads(f"{name} backward+routing", sums, route_grads_torch(rows_ref, off, cnt, P))
    return err_rows, err_route


def check_state(name, params, sh, cam, bg, capacity, tile, seed):
    """The three train-path kernels against their plain versions at a
    training state's own preprocess and binning (its live rows, its SH
    degree and entry capacity): the forward within the forward's rule and
    bit-equal to its unculled form, then check_backward. Returns the max
    abs errors of the forward, the backward's rows and the routing."""
    with torch.no_grad():
        args, lists, total = sorted_inputs(tuple(activate(params)), cam, W_MAIN, H_MAIN, tile,
                                           sh=sh, alive=params.alive, capacity=capacity)
        out = composite_fwd_cuda(*args, bg, W_MAIN, H_MAIN, *tile)
        ref = composite_fwd_torch(*args, bg, W_MAIN, H_MAIN, *tile)
    torch.cuda.synchronize()
    counts = blend_pair_counts(*args, W_MAIN, H_MAIN, *tile)
    print(f"  {name}: K={total} entries, pairs {counts.pairs}, taken {counts.taken}, blended "
          f"{counts.blended} ({counts.blended / max(counts.pairs, 1):.1%} of the evaluated pairs)")
    err_fwd = compare(f"{name} K={total}", out, ref, 1e-5)
    check_cull(name, out, args, bg, W_MAIN, H_MAIN, tile)
    return (err_fwd, *check_backward(name, args, lists, bg, W_MAIN, H_MAIN, tile, seed))


def cuda_time_ms(fn, reps):
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def stage_times_ms(params, cam, bg, cfg, frames=10):
    """Host-clock time of each stage of eval_render's path run alone: the
    device is synchronized before and after every stage, so a stage's time
    is its enqueue and its device work with nothing overlapped. Median over
    `frames` frames."""
    gx, gy = -(-W_MAIN // cfg.tile_w), -(-H_MAIN // cfg.tile_h)
    times = {n: [] for n in ("activate", "preprocess", "binning", "composite")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.no_grad():
        for _ in range(frames):
            acts = timed("activate", lambda: activate(params))
            prep = timed("preprocess", lambda: preprocess(
                acts.xyz, acts.scales, acts.quats, acts.opacities, acts.shs, 3, cam,
                W_MAIN, H_MAIN, cfg.tile_w, cfg.tile_h, alive=params.alive))
            lists = timed("binning", lambda: binning.build_tile_lists(
                prep.rect_min, prep.rect_max, prep.depths, prep.tiles_touched, gx, gy,
                cfg.capacity(params.num_points)))
            timed("composite", lambda: composite_fwd(
                lists, prep.means2d, prep.conic, prep.rgb, prep.opacity, bg,
                W_MAIN, H_MAIN, cfg.tile_w, cfg.tile_h))
    return {n: float(np.median(t)) for n, t in times.items()}


def device_busy_ms(run_once, reps=5):
    """torch.profiler over `reps` calls of run_once(): device (kernel + copy)
    time and device activities per call, and the top kernels by device
    time. None if the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run_once()
        torch.cuda.synchronize()
    per_name, n_events = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            n_events += 1
    if not per_name:
        return None, 0, []
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    return sum(per_name.values()) / reps, n_events / reps, [(n, t / reps) for n, t in top]


def print_busy(busy, per_call, top, call_ms, unit):
    if busy is None:
        print("  device busy share: not measured (the profiler saw no device activity)")
        return
    print(f"  device busy {busy:.3f} ms per {unit} in {per_call:.0f} device activities "
          f"(torch.profiler) = {busy / call_ms:.1%} of the {unit}; idle {1 - busy / call_ms:.1%}")
    for name, t in top:
        print(f"    {t:8.4f} ms  {name[:110]}")


def train_stage_times_ms(state, cam, gt, bg, cfg, opt, steps=5):
    """Stream time (CUDA events) of each stage of a train step run alone,
    the device synchronized between stages: forward (activate + rasterize),
    loss, backward (autograd through the kernels), Adam. Median over
    `steps` steps; the state takes those steps."""
    params = state.params
    times = {n: [] for n in ("forward", "loss", "backward", "adam")}

    def timed(name, fn):
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(stop))
        return out

    for _ in range(steps):
        bias = torch.zeros((params.num_points, 2), device=gt.device, requires_grad=True)

        def forward():
            a = activate(params)
            return rasterize(a.xyz, a.scales, a.quats, a.opacities, a.shs, 3, cam, W_MAIN,
                             H_MAIN, bg, cfg, mean2d_bias=bias, alive=params.alive)

        img, _ = timed("forward", forward)
        loss = timed("loss", lambda: (1 - opt.lambda_dssim) * losses.l1_loss(img, gt)
                     + opt.lambda_dssim * (1 - losses.ssim(img, gt)))
        grads = timed("backward", lambda: torch.autograd.grad(
            loss, [getattr(params, k) for k in PARAM_NAMES] + [bias]))
        lrs = {"xyz": opt.position_lr_init, "features_dc": opt.feature_lr,
               "features_rest": opt.feature_lr / 20, "scaling": opt.scaling_lr,
               "rotation": opt.rotation_lr, "opacity": opt.opacity_lr}
        timed("adam", lambda: adam_update(params, dict(zip(PARAM_NAMES, grads)), state.adam,
                                          lrs, params.alive))
    return {n: float(np.median(t)) for n, t in times.items()}


def reset_launches():
    for counter in LAUNCH_COUNTERS.values():
        counter.launches = 0


def check_transpose_and_sums(dev):
    """The transpose bit-equal to its plain version; the column sums within
    1e-5 x sum |x| of a float64 sum per column, kernel and plain version
    alike, and each kernel bit-identical across two runs. Returns the max
    abs errors of the three kernels against their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(30)
    err = {"relayout_to_rows": 0.0, "consume_rows": 0.0, "consume_t": 0.0}
    for K in SUM_K:
        for R in (9, 16):
            x = torch.randn((R, K), generator=gen, device=dev)
            got, ref = relayout_to_rows_cuda(x), relayout_to_rows_torch(x)
            torch.cuda.synchronize()
            if got.shape != (K, R) or not torch.equal(got, ref):
                fail(f"relayout_to_rows ({R}, {K}) is not bit-equal to x.t().contiguous()")
            print(f"  relayout_to_rows ({R}, {K}) bit-equal to its plain version")
        x = torch.randn((K, 16), generator=gen, device=dev)
        exact = x.double().sum(0)
        tol = 1e-5 * x.double().abs().sum(0)
        for name, kern, plain in (("consume_rows", consume_rows_cuda, consume_rows_torch),
                                  ("consume_t", consume_t_cuda, consume_t_torch)):
            a, b, ref = kern(x), kern(x), plain(x)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"{name} ({K}, 16): two runs differ")
            worst = 0.0
            for what, v in (("kernel", a), ("plain", ref)):
                d = (v.double().reshape(16) - exact).abs()
                worst = max(worst, float((d / tol).max()))
                if not bool((d <= tol).all()):
                    fail(f"{name} ({K}, 16): {what} off the float64 sum by {float(d.max()):.3e}")
            e = float((a - ref).abs().max())
            err[name] = max(err[name], e)
            print(f"  {name} ({K}, 16) max_abs_err vs plain {e:.3e}; worst column "
                  f"{worst:.2e} x its 1e-5 sum|x| limit; two runs bit-identical")
    return err


def trainer_phase(dev, bare_step_ms):
    """Phase 5b: the host training loop from a point cloud at 1920x1080.
    Returns the three train-path kernels' launches and their max abs errors
    against their plain versions at the trainer's states."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        return _trainer_phase(dev, bare_step_ms, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def synced_ms(fn, *args):
    """fn(*args) on the host clock between two device waits; (out, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _trainer_phase(dev, bare_step_ms, tmp):
    bg0 = torch.zeros(3, device=dev)
    # The point cloud: the trained model's centres, coloured by its DC term,
    # through the point-cloud PLY functions.
    model = load_gaussians_ply(TRAINED_PLY)
    colors = np.clip(0.5 + gsmath.SH_C0 * model["features_dc"][:, 0, :], 0.0, 1.0)
    save_point_cloud_ply(os.path.join(tmp, "points3d.ply"), model["xyz"], colors)
    pts, cols, _ = load_point_cloud_ply(os.path.join(tmp, "points3d.ply"))
    if not np.array_equal(pts, model["xyz"]) or float(np.abs(cols - colors).max()) > 1 / 255:
        fail("trainer path: the point cloud did not survive its PLY round trip")

    # Cameras, and their targets: the trained model's renders.
    trained = params_from_ply(TRAINED_PLY)
    center = pts.mean(axis=0)
    dist = 2.5 * float(np.quantile(np.linalg.norm(pts - center, axis=1), 0.95))
    cams = [orbit_camera(center, dist, 2 * math.pi * i / TRAINER_CAMERAS, W_MAIN, H_MAIN, 70.0,
                         70.0 * H_MAIN / W_MAIN) for i in range(TRAINER_CAMERAS)]
    with torch.no_grad():
        acts = tuple(activate(trained))
        for cam in cams:
            arr = cam.arrays()
            n = int(preprocess(*acts, 3, arr, W_MAIN, H_MAIN, 32, 32).tiles_touched.sum())
            img = eval_render(trained, arr, bg0, 3, W_MAIN, H_MAIN,
                              RasterizerConfig(capacity_exact=entry_bucket_capacity(n, 16, 1.2)))[0]
            cam.image = img.clamp(0.0, 1.0).permute(2, 0, 1).cpu().numpy()
    del trained, acts
    centers = np.stack([c.camera_center for c in cams]).astype(np.float64)
    extent = 1.1 * float(np.linalg.norm(centers - centers.mean(axis=0), axis=1).max())

    def new_trainer(raster_cfg=RasterizerConfig(tile_w=32, tile_h=32)):
        return Trainer(cameras=cams, opt=TRAINER_OPT, raster_cfg=raster_cfg, sh_degree=3,
                       cameras_extent=extent, spatial_lr_scale=extent, seed=0)

    # The KNN's two forms on the card.
    pts_t = torch.from_numpy(pts).to(dev)
    morton_ms = cuda_time_ms(lambda: mean_knn_dist2_morton(pts_t), 5)
    exact_ms = cuda_time_ms(lambda: mean_knn_dist2_exact(pts_t[:20_000]), 3)
    del pts_t

    tr = new_trainer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, init_ms = synced_ms(tr.init_from_pcd, pts, cols)
    if tr.state.params.num_points != capacity_bucket(pts.shape[0]) or tr.num_live != pts.shape[0]:
        fail(f"trainer path: init gave {tr.num_live} live rows of {tr.state.params.num_points}")

    def probe(cam):  # the first step's entry probe: a preprocess-only count of the live rows
        with torch.no_grad():
            p = tr.state.params
            return int(preprocess(*activate(p), tr.active_sh_degree, cam.arrays(), W_MAIN, H_MAIN,
                                  32, 32, alive=p.alive).tiles_touched.sum())

    probe(cams[0])
    probe_n, probe_ms = synced_ms(probe, cams[0])

    max_err = {"composite_fwd": 0.0, "composite_bwd": 0.0, "route_grads": 0.0}

    def check_kernels(name, seed):  # the kernels at the state the next step renders
        p = tr.state.params
        errs = check_state(name, p, tr.active_sh_degree, cams[seed % TRAINER_CAMERAS].arrays(),
                           tr.background, tr.raster_cfg.capacity(p.num_points), (32, 32), seed)
        for k, e in zip(max_err, errs):
            max_err[k] = max(max_err[k], e)

    reset_at = TRAINER_OPT.opacity_reset_interval
    reset_launches()
    step_ms, post_ms, rows_before = {}, {}, {}
    for _ in range(TRAINER_STEPS):
        cfg_before = tr.raster_cfg
        rows = tr.state.params.num_points
        m, ms = synced_ms(tr.step, True)
        step_ms[tr.iteration] = ms
        # the first step ran at the capacity its probe set, which a growth
        # right after it replaced: the rule below then reads `after` twice
        ran_at = (cfg_before if cfg_before.capacity_exact is not None else tr.raster_cfg).capacity(rows)
        after = tr.raster_cfg.capacity(rows)
        entries = int(m["num_entries"])
        if not (entries <= ran_at or after >= entries):
            fail(f"trainer path: step {tr.iteration} had {entries} entries at capacity {ran_at} "
                 f"and the capacity did not grow to hold them ({after})")
        rows_before[tr.iteration] = tr.state.params.num_points
        post_ms[tr.iteration] = synced_ms(tr.post_step)[1]
        if tr.iteration == reset_at:
            p = tr.state.params
            top = float(torch.sigmoid(p.opacity.detach()[p.alive]).max())
            if top > 0.01:
                fail(f"trainer path: a live opacity of {top} after the reset")
            # opacities <= 0.01: T never saturates and nearly every pair blends
            launches_so_far = {k: LAUNCH_COUNTERS[k].launches for k in max_err}
            check_kernels(f"trainer after the reset at {reset_at}", 41)
            for k, n in launches_so_far.items():  # the check's launches are not the path's
                LAUNCH_COUNTERS[k].launches = n
    torch.cuda.synchronize()
    launches = {k: LAUNCH_COUNTERS[k].launches for k in max_err}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    hist = tr.history
    step_losses = [h["loss"] for h in hist]
    first20, last20 = float(np.mean(step_losses[:20])), float(np.mean(step_losses[-20:]))
    densified = {d["iteration"]: d for d in tr.densify_history}
    maintenance = set(densified) | set(range(reset_at, TRAINER_STEPS + 1, reset_at))
    quiet = [ms for it, ms in step_ms.items() if it > TRAINER_CAMERAS and it not in maintenance]
    print(f"trainer path: {pts.shape[0]} points from their PLY at {W_MAIN}x{H_MAIN}, "
          f"{TRAINER_CAMERAS} cameras, extent {extent:.4f}, {TRAINER_STEPS} steps; "
          f"launches {launches}; peak device memory {peak_mib:.1f} MiB")
    print(f"  loss {step_losses[0]:.6f} -> {step_losses[-1]:.6f} (mean of the first 20 {first20:.6f}, "
          f"last 20 {last20:.6f}), psnr {hist[0]['psnr']:.3f} -> {hist[-1]['psnr']:.3f} dB; "
          f"live {tr.num_live} of {tr.state.params.num_points} rows; entries "
          f"{int(hist[0]['num_entries'])} -> {int(hist[-1]['num_entries'])}, entry capacity "
          f"{tr.raster_cfg.capacity_exact}")
    print(f"  step latency median {np.median(quiet):.3f} ms, p80 {np.percentile(quiet, 80):.3f} ms "
          f"({len(quiet)} steps after the first epoch that ran no maintenance, host clock, each "
          f"ending in a synchronize); phase 5's bare train_step median {bare_step_ms:.3f} ms")
    for d in tr.densify_history:
        print(f"  densify at {d['iteration']}: {d['path']}, cloned {d['n_cloned']}, split "
              f"{d['n_split']}, pruned {d['n_pruned']}, live {d['live_before']} -> "
              f"{d['live_after']}, rows {d['rows_before']} -> {d['capacity']}, {d['ms']:.3f} ms")
    reset_ms = post_ms[reset_at] - (densified[reset_at]["ms"] if reset_at in densified else 0.0)
    print(f"  reset {reset_ms:.3f} ms (post_step at {reset_at} {post_ms[reset_at]:.3f} ms less its "
          f"densify); probe {probe_ms:.3f} ms ({probe_n} entries, camera 0); create_from_pcd "
          f"{init_ms:.3f} ms; KNN Morton at {pts.shape[0]} points {morton_ms:.3f} ms, exact at "
          f"20000 {exact_ms:.3f} ms")

    if any(n != TRAINER_STEPS for n in launches.values()):
        fail(f"trainer path launches {launches} for {TRAINER_STEPS} steps")
    if not all(math.isfinite(x) for x in step_losses):
        fail("trainer path: a loss is not finite")
    if not last20 < first20:
        fail(f"trainer path: the loss did not fall (first 20 {first20}, last 20 {last20})")
    paths = [d["path"] for d in tr.densify_history]
    grew = [d for d in tr.densify_history if d["path"] == "host" and d["capacity"] > d["rows_before"]]
    if "device" not in paths or not grew:
        fail(f"trainer path: densify paths {paths}; a device densify and a host densify that "
             f"grew the capacity are both needed")
    p = tr.state.params
    dead_inside = int((~p.alive[: int(torch.nonzero(p.alive).max()) + 1]).sum())
    print(f"  final state: {dead_inside} dead rows among the live ones")
    check_kernels("trainer final state", 42)

    # A checkpoint saved on the card, loaded into a fresh trainer and saved
    # again: the two files hold the same live rows, moments, step and
    # statistics, bit for bit.
    ckpt, ckpt2 = os.path.join(tmp, "ckpt.pkl"), os.path.join(tmp, "ckpt2.pkl")
    _, save_ms = synced_ms(tr.save_checkpoint, ckpt)
    tr2 = new_trainer(tr.raster_cfg)
    _, load_ms = synced_ms(tr2.load_checkpoint, ckpt)
    tr2.save_checkpoint(ckpt2)
    with open(ckpt, "rb") as f:  # this run's own files
        mine = pickle.load(f)
    with open(ckpt2, "rb") as f:
        theirs = pickle.load(f)
    for what in ("params", "adam_m", "adam_v", "stats"):
        for k in mine[what]:
            if not np.array_equal(mine[what][k], theirs[what][k]):
                fail(f"trainer path: checkpoint {what}[{k}] differs after the reload")
    if mine["adam_step"] != theirs["adam_step"] or tr2.iteration != tr.iteration:
        fail("trainer path: checkpoint step or iteration differs after the reload")
    more = tr2.step()
    if not math.isfinite(more["loss"]):
        fail("trainer path: the reloaded trainer's step is not finite")
    print(f"  checkpoint of {tr.num_live} rows: save {save_ms:.1f} ms, load {load_ms:.1f} ms, "
          f"{os.path.getsize(ckpt) / 2**20:.1f} MiB; bit-equal after the reload; one more step, "
          f"loss {more['loss']:.6f}")
    del tr2

    # The trained live rows as a PLY model, reloaded and rendered.
    save_gaussians_ply(os.path.join(tmp, "model.ply"), mine["params"])
    reloaded = params_from_ply(os.path.join(tmp, "model.ply"))
    arr = cams[0].arrays()
    with torch.no_grad():
        n = int(preprocess(*activate(tr.state.params), 3, arr, W_MAIN, H_MAIN, 32, 32,
                           alive=tr.state.params.alive).tiles_touched.sum())
    cfg = RasterizerConfig(capacity_exact=entry_bucket_capacity(n, 16, 1.2))
    ours = eval_render(tr.state.params, arr, bg0, 3, W_MAIN, H_MAIN, cfg)
    back = eval_render(reloaded, arr, bg0, 3, W_MAIN, H_MAIN, cfg)
    torch.cuda.synchronize()
    compare("trainer PLY reload vs trainer", CompositeOut(back[0], back[1]["final_t"]),
            CompositeOut(ours[0], ours[1]["final_t"]), 1e-5)
    return launches, max_err


def quantize(img):
    """(H, W, 3) image on the card -> uint8, as the render CLI writes it."""
    return render_cli.quantize(img.cpu().numpy())


def png_every_filter(a):
    """PNG bytes of uint8 pixels a (H, W, C) whose rows cycle through the
    five row filters (None, Sub, Up, Average, Paeth), as adaptive encoders
    such as libpng's mix them; filtered by the PNG specification's
    formulas, compressed at zlib's default level."""
    H, W, C = a.shape
    x = a.astype(np.int16).reshape(H, W * C)
    up = np.concatenate([np.zeros((1, W * C), np.int16), x[:-1]])
    left = np.pad(x, ((0, 0), (C, 0)))[:, :-C]
    upleft = np.pad(up, ((0, 0), (C, 0)))[:, :-C]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    filters = np.arange(H) % 5
    pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])[filters, np.arange(H)]
    rows = np.concatenate([filters[:, None].astype(np.uint8), ((x - pred) & 255).astype(np.uint8)],
                          axis=1)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", W, H, 8, {1: 0, 2: 4, 3: 2, 4: 6}[C], 0, 0, 0)
    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


class PanelTimer:
    """Host time of tensorboard's `SummaryWriter.add_images` while patched
    (`with`), where tensorboard imports: the train CLI's reports log their
    views as image panels, as the reference's training_report does."""

    def __init__(self):
        self.ms = []

    def __enter__(self):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.owner = None
            return self
        self.owner, self.fn = SummaryWriter, SummaryWriter.add_images

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return self.fn(*args, **kw)
            finally:
                self.ms.append((time.perf_counter() - t0) * 1e3)
        SummaryWriter.add_images = timed
        return self

    def __exit__(self, *exc):
        if self.owner is not None:
            self.owner.add_images = self.fn


def in_process(main, *args, **kw):
    """A CLI's main(); safe_state replaces sys.stdout (and drops every line
    with --quiet), so it is restored afterwards."""
    stdout = sys.stdout
    try:
        return main(*args, **kw)
    finally:
        sys.stdout = stdout


def cli_phase(dev):
    """Phase 5c: the user's entry path, the train, render and metrics CLIs
    in process on a COLMAP dataset at 1920x1080. Returns the compositing
    kernels' launches in the train and render CLIs and the max abs errors
    of the forward, the backward and the routing against their plain
    versions at the train CLI's final state."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        return _cli_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cli_phase(dev, tmp):
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    data, model_dir = os.path.join(tmp, "data"), os.path.join(tmp, "model")
    bg0 = torch.zeros(3, device=dev)

    # The dataset: trained_r5's renders from 16 orbit views, its centres
    # coloured by the DC term, through the port's COLMAP and PNG writers.
    model = load_gaussians_ply(TRAINED_PLY)
    colors = (np.clip(0.5 + gsmath.SH_C0 * model["features_dc"][:, 0, :], 0.0, 1.0) * 255
              ).astype(np.uint8)
    trained = params_from_ply(TRAINED_PLY)
    center = model["xyz"].mean(axis=0)
    dist = 2.5 * float(np.quantile(np.linalg.norm(model["xyz"] - center, axis=1), 0.95))
    cams, images = [], []
    with torch.no_grad():
        acts = tuple(activate(trained))
        for i in range(CLI_VIEWS):
            cam = orbit_camera(center, dist, 2 * math.pi * i / CLI_VIEWS, W_MAIN, H_MAIN, 70.0,
                               70.0 * H_MAIN / W_MAIN)
            cam.image_name = f"view_{i:02d}"
            arr = cam.arrays()
            n = int(preprocess(*acts, 3, arr, W_MAIN, H_MAIN, 32, 32).tiles_touched.sum())
            img = eval_render(trained, arr, bg0, 3, W_MAIN, H_MAIN,
                              RasterizerConfig(capacity_exact=entry_bucket_capacity(n, 16, 1.2)))[0]
            cams.append(cam)
            images.append(quantize(img))
    del trained, acts
    t0 = time.perf_counter()
    write_colmap_scene(data, cams, images, model["xyz"], colors)
    write_ms = (time.perf_counter() - t0) * 1e3
    encode_ms = []
    for px in images[:4]:
        _, ms = synced_ms(image_io.write_png, os.path.join(tmp, "encode.png"), px)
        encode_ms.append(ms)
    _, resize_ms = synced_ms(image_io.resize, images[0], (1600, 900))

    # The port's readers give back every camera and every pixel.
    info = read_colmap_scene(data, None, eval_split=False)
    by_name = {c.image_name: c for c in info.train_cameras}
    decode_ms = []
    for cam, px in zip(cams, images):
        got = by_name[cam.image_name]
        if float(np.abs(got.R - cam.R).max()) > 1e-12 or float(np.abs(got.T - cam.T).max()) > 1e-12:
            fail(f"cli path: camera {cam.image_name} did not survive the COLMAP files")
        back, ms = synced_ms(image_io.read_png, got.image_path)
        decode_ms.append(ms)
        if not np.array_equal(back, px):
            fail(f"cli path: image {cam.image_name} did not survive its PNG")
    if not np.array_equal(info.points, model["xyz"]):
        fail("cli path: the points did not survive points3D.bin")
    print(f"cli path: a COLMAP dataset of {CLI_VIEWS} views at {W_MAIN}x{H_MAIN} and "
          f"{len(info.points)} points written in {write_ms:.1f} ms; cameras within 1e-12 and "
          f"pixels bit-equal through the port's readers")
    # A file as PIL or libpng writes one: Average and Paeth rows, which the
    # reader decodes by anti-diagonals (the cost of a real dataset).
    mixed = os.path.join(tmp, "every_filter.png")
    with open(mixed, "wb") as f:
        f.write(png_every_filter(images[0]))
    mixed_ms = []
    for _ in range(3):
        back, ms = synced_ms(image_io.read_png, mixed)
        mixed_ms.append(ms)
        if not np.array_equal(back, images[0]):
            fail("cli path: the PNG with every row filter did not decode to its pixels")
    print(f"  PNG at {W_MAIN}x{H_MAIN} RGB: encode {np.median(encode_ms):.1f} ms, decode "
          f"{np.median(decode_ms):.1f} ms (the port's Sub-filtered files), decode "
          f"{np.median(mixed_ms):.1f} ms (rows cycling through all five filters, as a real "
          f"dataset's; bit-equal) (median, host clock); resize {W_MAIN}x{H_MAIN} -> 1600x900 "
          f"{resize_ms:.1f} ms")

    # Train. Each step's host time is the CLI's own iter_time_ms (the step
    # ends in a copy of its metrics to the host).
    reset_launches()
    with PanelTimer() as panels:
        t0 = time.perf_counter()
        scene, tr = in_process(train_cli.main, ["-s", data, "-m", model_dir, *CLI_TRAIN])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    step_ms = [h["iter_time_ms"] for h in tr.history]
    train_launches = {k: LAUNCH_COUNTERS[k].launches for k in ("composite_fwd", "composite_bwd",
                                                               "route_grads")}
    n_train, n_test = CLI_VIEWS - CLI_VIEWS // 8, CLI_VIEWS // 8  # llffhold=8
    reports = len(CLI_REPORTS) * (n_test + 5)  # each report: the test views and 5 train views
    want = {"composite_fwd": CLI_STEPS + reports, "composite_bwd": CLI_STEPS,
            "route_grads": CLI_STEPS}
    losses_ = [h["loss"] for h in tr.history]
    first20, last20 = float(np.mean(losses_[:20])), float(np.mean(losses_[-20:]))
    print(f"  train CLI: {CLI_STEPS} steps, {n_train} train and {n_test} test views, wall "
          f"{train_s:.2f} s, step median {np.median(step_ms):.3f} ms, p80 "
          f"{np.percentile(step_ms, 80):.3f} ms (its iter_time_ms, host clock, deferred "
          f"maintenance excluded); loss first 20 {first20:.6f}, last 20 {last20:.6f}; "
          f"{len(tr.densify_history)} densifies ({[d['path'] for d in tr.densify_history]}); live "
          f"{tr.num_live}; launches {train_launches}")
    optional = {m: importlib.util.find_spec(m) is not None for m in ("tensorboard", "tqdm", "PIL")}
    print(f"  train CLI: tensorboard image panels {sum(panels.ms):.1f} ms ({len(panels.ms)} "
          f"add_images calls); importable here: {optional}")
    for f in ("cfg_args", "cameras.json", "input.ply", f"point_cloud/iteration_{CLI_SAVE}/point_cloud.ply",
              f"point_cloud/iteration_{CLI_STEPS}/point_cloud.ply", f"chkpnt{CLI_STEPS}.pth"):
        if not os.path.exists(os.path.join(model_dir, f)):
            fail(f"cli path: the train CLI wrote no {f}")
    if tr.iteration != CLI_STEPS or len(step_ms) != CLI_STEPS:
        fail(f"cli path: the train CLI stopped at iteration {tr.iteration}")
    if not tr.densify_history:
        fail("cli path: no densify ran")
    if not all(math.isfinite(x) for x in losses_) or not last20 < first20:
        fail(f"cli path: the loss did not fall (first 20 {first20}, last 20 {last20})")
    if train_launches != want:
        fail(f"cli path: train CLI launches {train_launches}, the schedule gives {want}")

    # The three train-path kernels at the train CLI's final state (its
    # padded rows, the dead ones the reset and prunes left, its capacity)
    # and a test camera, by phase 3's rules; their launches are not the
    # path's (the counters are reset before the render CLI).
    p = tr.state.params
    test_view = scene.get_test_cameras()[0]
    errs = check_state("train CLI final state", p, tr.active_sh_degree, test_view.arrays(device=dev),
                       tr.background, tr.raster_cfg.capacity(p.num_points),
                       (tr.raster_cfg.tile_w, tr.raster_cfg.tile_h), 43)

    # The final PLY, reloaded, renders the bits of the trainer's own state.
    ply_path = os.path.join(model_dir, f"point_cloud/iteration_{CLI_STEPS}/point_cloud.ply")
    saved = params_from_ply(ply_path)
    arr = cams[0].arrays()
    with torch.no_grad():
        n = int(preprocess(*activate(saved), 3, arr, W_MAIN, H_MAIN, 32, 32).tiles_touched.sum())
    cfg = RasterizerConfig(capacity_exact=entry_bucket_capacity(n, 16, 1.2))
    ours = eval_render(tr.state.params, arr, bg0, 3, W_MAIN, H_MAIN, cfg)
    back = eval_render(saved, arr, bg0, 3, W_MAIN, H_MAIN, cfg)
    if not (torch.equal(ours[0], back[0]) and torch.equal(ours[1]["final_t"], back[1]["final_t"])):
        fail("cli path: the PLY at the last iteration does not render the trainer's bits")
    del scene, tr, p, ours, back

    # Render.
    reset_launches()
    _, render_ms = synced_ms(in_process, render_cli.main, ["-m", model_dir])
    render_launches = {k: LAUNCH_COUNTERS[k].launches for k in train_launches}
    if render_launches != {"composite_fwd": CLI_VIEWS, "composite_bwd": 0, "route_grads": 0}:
        fail(f"cli path: render CLI launches {render_launches} for {CLI_VIEWS} views")
    names = sorted(c.image_name for c in cams)
    splits = {"test": names[::8], "train": [n for i, n in enumerate(names) if i % 8]}
    for split, split_names in splits.items():
        out = os.path.join(model_dir, split, f"ours_{CLI_STEPS}")
        for kind in ("renders", "gt"):
            if sorted(os.listdir(os.path.join(out, kind))) != [f"{i:05d}.png" for i in range(len(split_names))]:
                fail(f"cli path: {split}/{kind} holds {os.listdir(os.path.join(out, kind))}")
        for i, name in enumerate(split_names):
            gt = image_io.read_png(os.path.join(out, "gt", f"{i:05d}.png"))
            if not np.array_equal(gt, image_io.read_png(os.path.join(data, "images", name + ".png"))):
                fail(f"cli path: {split} gt {i} is not the dataset's {name}")
    # the render CLI's cameras: the ones its reader gives (R within 1e-12 of the orbit's)
    views = [load_camera(by_name[name], 1) for name in names]
    test_cam = views[names.index(splits["test"][0])]
    rcfg = RasterizerConfig(capacity_exact=render_cli.auto_capacity(saved, views, RasterizerConfig(), 3))
    want_png = quantize(eval_render(saved, test_cam.arrays(), bg0, 3, W_MAIN, H_MAIN, rcfg)[0])
    got_png = image_io.read_png(os.path.join(model_dir, "test", f"ours_{CLI_STEPS}", "renders", "00000.png"))
    if not np.array_equal(got_png, want_png):
        fail(f"cli path: the render CLI's test view differs from eval_render's at "
             f"{int((got_png != want_png).any(-1).sum())} pixels")
    print(f"  render CLI: {CLI_VIEWS} views in {render_ms / 1e3:.2f} s wall, "
          f"{render_ms / CLI_VIEWS:.1f} ms per view (scene load, render, two PNGs); launches "
          f"{render_launches}; gt PNGs bit-equal to the dataset's, test view 0 bit-equal to "
          f"eval_render of the reloaded PLY")

    # Metrics.
    _, metrics_ms = synced_ms(in_process, metrics_cli.main, ["-m", model_dir])
    with open(os.path.join(model_dir, "results.json")) as f:
        result = json.load(f).get(f"ours_{CLI_STEPS}", {})
    if not (math.isfinite(result.get("SSIM", math.nan)) and math.isfinite(result.get("PSNR", math.nan))
            and "LPIPS" in result and result["LPIPS"] is None):
        fail(f"cli path: results.json holds {result}")
    psnrs = []
    for i in range(n_test):
        out = os.path.join(model_dir, "test", f"ours_{CLI_STEPS}")
        r = image_io.read_png(os.path.join(out, "renders", f"{i:05d}.png")).astype(np.float64) / 255
        g = image_io.read_png(os.path.join(out, "gt", f"{i:05d}.png")).astype(np.float64) / 255
        psnrs.append(20 * math.log10(1 / math.sqrt(float(np.mean((r - g) ** 2)))))
    if abs(float(np.mean(psnrs)) - result["PSNR"]) > 1e-4:
        fail(f"cli path: PSNR {result['PSNR']} vs {np.mean(psnrs)} recomputed from the PNGs")
    print(f"  metrics CLI: {metrics_ms:.1f} ms for {n_test} views; SSIM {result['SSIM']:.6f}, PSNR "
          f"{result['PSNR']:.6f} dB (float64 from the PNGs {np.mean(psnrs):.6f}), LPIPS null")

    print(f"  phase peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return train_launches, render_launches, errs


def main():
    phase_t0 = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - phase_t0[0]:.1f} s wall", flush=True)
        phase_t0[0] = now

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script runs on a GPU only")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"device: {kind} (torch sees {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_done("1 device")

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling entry")):
                print(f"  ptxas[{name}]: {line.strip()}")
    phase_done("2 build")

    # ---- 3. kernels vs plain ------------------------------------------
    print("kernels vs plain:")
    max_err = {"composite_fwd": 0.0, "composite_bwd": 0.0, "route_grads": 0.0}

    def note_bwd(errs):
        max_err["composite_bwd"] = max(max_err["composite_bwd"], errs[0])
        max_err["route_grads"] = max(max_err["route_grads"], errs[1])

    for seed, (W, H) in enumerate([(128, 128), (333, 197)]):
        scene = [torch.from_numpy(x).to(dev) for x in make_gaussians(P=3000, seed=seed)]
        cam = orbit_camera((0, 0, 0), 4.0, 0.3 * seed, W, H, 60.0, 60.0 * H / W).arrays()
        for tile in TILE_GEOMETRIES:
            name = f"random {W}x{H} tile {tile[0]}x{tile[1]}"
            args, lists, _ = sorted_inputs(scene, cam, W, H, tile)
            bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
            out = composite_fwd_cuda(*args, bg, W, H, *tile)
            ref = composite_fwd_torch(*args, bg, W, H, *tile)
            torch.cuda.synchronize()
            max_err["composite_fwd"] = max(max_err["composite_fwd"], compare(name, out, ref, 1e-5))
            check_cull(name, out, args, bg, W, H, tile)
            note_bwd(check_backward(name, args, lists, bg, W, H, tile, seed=10 + seed))

    params = params_from_ply(TRAINED_PLY)  # device defaults to the card
    with torch.no_grad():
        acts = tuple(activate(params))
    xyz = params.xyz.detach().cpu().numpy()
    center = xyz.mean(axis=0)
    dist = 2.5 * float(np.quantile(np.linalg.norm(xyz - center, axis=1), 0.95))
    cams = [orbit_camera(center, dist, a, W_MAIN, H_MAIN, 70.0, 70.0 * H_MAIN / W_MAIN)
            for a in (0.0, 2.1, 4.2)]
    bg0 = torch.zeros(3, device=dev)
    with torch.no_grad():
        for i, cam in enumerate(cams):
            name = f"trained 1080p angle {i}"
            args, lists, total = sorted_inputs(acts, cam.arrays(), W_MAIN, H_MAIN, (32, 32))
            out = composite_fwd_cuda(*args, bg0, W_MAIN, H_MAIN, 32, 32)
            ref = composite_fwd_torch(*args, bg0, W_MAIN, H_MAIN, 32, 32)
            torch.cuda.synchronize()
            max_err["composite_fwd"] = max(max_err["composite_fwd"],
                                           compare(f"{name} K={total}", out, ref, 1e-5))
            check_cull(name, out, args, bg0, W_MAIN, H_MAIN, (32, 32))
            if i == 0:
                main_args = args
                note_bwd(check_backward(name, args, lists, bg0, W_MAIN, H_MAIN, (32, 32), seed=20))

    golden = make_gaussians(P=300, seed=5, spread=0.9)
    gcam = orbit_camera((0, 0, 0), 4.0, 0.0, 128, 128, 60.0, 60.0).arrays()
    img, aux = rasterize(*[torch.from_numpy(x).to(dev) for x in golden], 3, gcam, 128, 128,
                         [0.1, 0.2, 0.3], RasterizerConfig(capacity_mult=32))
    fixture = CompositeOut(*(torch.from_numpy(np.load(os.path.join(FIXTURES, f)))
                             for f in ("golden_render_128.npy", "golden_final_t_128.npy")))
    compare("golden 128x128 vs fixture", CompositeOut(img.cpu(), aux["final_t"].cpu()), fixture, 2e-5)
    max_err.update(check_transpose_and_sums(dev))
    phase_done("3 kernels vs plain")

    # ---- 4. render path -----------------------------------------------
    cam = cams[0].arrays()
    with torch.no_grad():
        prep = preprocess(*acts, 3, cam, W_MAIN, H_MAIN, 32, 32)
        n_entries = int(prep.tiles_touched.sum())
    # as bench.py: 2% headroom, snapped to 2^16-entry buckets
    capacity = entry_bucket_capacity(n_entries, bits=16, headroom=1.02)
    cfg = RasterizerConfig(capacity_exact=capacity)
    for _ in range(2):  # warm-up
        eval_render(params, cam, bg0, 3, W_MAIN, H_MAIN, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frame_times = []
    reset_launches()
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        img, aux = eval_render(params, cam, bg0, 3, W_MAIN, H_MAIN, cfg)
        torch.cuda.synchronize()
        frame_times.append((time.perf_counter() - t0) * 1e3)
    launches = composite_fwd.launches
    frame_ms, frame_p80 = np.median(frame_times), np.percentile(frame_times, 80)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if launches != FRAMES or composite_bwd.launches or route_grads.launches:
        fail(f"render path launched the compositing kernels {launches} / {composite_bwd.launches}"
             f" / {route_grads.launches} times for {FRAMES} frames")
    if tuple(img.shape) != (H_MAIN, W_MAIN, 3) or not bool(torch.isfinite(img).all()):
        fail("render path image has the wrong shape or is not finite")
    covered = float((img.amax(dim=-1) > 0.05).float().mean())
    if covered < 0.01:
        fail(f"render path image is background ({covered:.2%} of pixels covered)")
    if int(aux["num_entries"]) != n_entries or n_entries > capacity:
        fail(f"entry count {int(aux['num_entries'])} vs {n_entries}, capacity {capacity}")
    print(f"render path: trained_r5.ply P={params.num_points} at {W_MAIN}x{H_MAIN}, "
          f"K={n_entries} entries (capacity {capacity}), {covered:.1%} of pixels covered")
    print(f"  frame latency median {frame_ms:.3f} ms, p80 {frame_p80:.3f} ms "
          f"({FRAMES} frames, host clock, each ending in a synchronize; "
          f"{1e3 / frame_ms:.1f} frames/s at the median); compositing launches {launches}; "
          f"peak device memory {peak_mib:.1f} MiB")
    stages = stage_times_ms(params, cam, bg0, cfg)
    print("  stages run alone (host clock, synchronized, median): "
          + ", ".join(f"{n} {t:.3f} ms" for n, t in stages.items()))
    print_busy(*device_busy_ms(lambda: eval_render(params, cam, bg0, 3, W_MAIN, H_MAIN, cfg)),
               frame_ms, "frame")

    fwd_ms = cuda_time_ms(lambda: composite_fwd_cuda(*main_args, bg0, W_MAIN, H_MAIN, 32, 32), 20)
    fwd_plain_ms = cuda_time_ms(lambda: composite_fwd_torch(*main_args, bg0, W_MAIN, H_MAIN, 32, 32), 2)
    fcounts = blend_pair_counts(*main_args, W_MAIN, H_MAIN, 32, 32)
    P, T = params.num_points, main_args[1].shape[0]
    # each input read once (ids, 9 float fields per Gaussian, tile ranges, bg),
    # each output written once (image + final_t)
    nbytes = 4 * n_entries + 36 * P + 8 * T + 12 + 16 * W_MAIN * H_MAIN
    fwd_bound = bound_ms(nbytes, pair_ops(fcounts.pairs, fcounts.taken))
    fwd_every_pair = bound_ms(nbytes, OPS_PER_PAIR * fcounts.pairs)[0]
    fwd_occ = composite_fwd_occupancy(32, 32, dev.index)
    print(f"  kernel {fwd_ms:.4f} ms, plain {fwd_plain_ms:.2f} ms; pairs {fcounts.pairs}, taken "
          f"{fcounts.taken}, bytes {nbytes}: {fwd_bound[2]}; {fwd_every_pair:.4f} ms with every "
          f"evaluated pair at {OPS_PER_PAIR} operations")
    print(f"  kernel at 32x32: {fcounts.units} (entry, 32-pixel unit) pairs with an open pixel "
          f"in the entry's box, {fwd_occ['registers']} registers per thread, "
          f"{fwd_occ['threads']} threads per block, {fwd_occ['blocks_per_sm']} resident blocks per SM")
    phase_done("4 render path")

    # ---- 5. train path ------------------------------------------------
    opt = OptimizationConfig()
    with torch.no_grad():  # the target: the model's own render from angle 0.2 rad
        tcam = orbit_camera(center, dist, 0.2, W_MAIN, H_MAIN, 70.0, 70.0 * H_MAIN / W_MAIN).arrays()
        t_entries = int(preprocess(*acts, 3, tcam, W_MAIN, H_MAIN, 32, 32).tiles_touched.sum())
        gt = eval_render(params, tcam, bg0, 3, W_MAIN, H_MAIN,
                         RasterizerConfig(capacity_exact=entry_bucket_capacity(t_entries, 16, 1.2))
                         )[0].clamp(0.0, 1.0)
    del params, acts
    train_capacity = entry_bucket_capacity(n_entries, 16, 1.2)
    tcfg = RasterizerConfig(capacity_exact=train_capacity)
    state = init_train_state(params_from_ply(TRAINED_PLY))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_times, step_losses, step_entries = [], [], []
    reset_launches()
    for it in range(1, STEPS + 1):
        t0 = time.perf_counter()
        m = train_step(state, cam, gt, bg0, it, 3, W_MAIN, H_MAIN, tcfg, opt, spatial_lr_scale=1.0)
        torch.cuda.synchronize()
        step_times.append((time.perf_counter() - t0) * 1e3)
        step_losses.append(float(m["loss"]))
        step_entries.append(int(m["num_entries"]))
    train_launches = {"composite_fwd": composite_fwd.launches,
                      "composite_bwd": composite_bwd.launches, "route_grads": route_grads.launches}
    train_peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if any(n != STEPS for n in train_launches.values()):
        fail(f"train path launches {train_launches} for {STEPS} steps")
    if max(step_entries) > train_capacity:
        fail(f"train path entry count {max(step_entries)} over capacity {train_capacity}")
    if not all(math.isfinite(x) for x in step_losses):
        fail(f"train path loss not finite: {step_losses}")
    if not step_losses[-1] < step_losses[0]:
        fail(f"train path loss did not fall: step 1 {step_losses[0]}, step {STEPS} {step_losses[-1]}")
    timed = step_times[-TIMED_STEPS:]
    step_ms, step_p80 = float(np.median(timed)), float(np.percentile(timed, 80))
    print(f"train path: trained_r5.ply P={state.params.num_points} at {W_MAIN}x{H_MAIN}, "
          f"{STEPS} steps toward the render from 0.2 rad, K={step_entries[0]}..{max(step_entries)} "
          f"entries (capacity {train_capacity}); loss {step_losses[0]:.6f} -> {step_losses[-1]:.6f}, "
          f"psnr {float(m['psnr']):.3f} dB at step {STEPS}; launches {train_launches}")
    print(f"  step latency median {step_ms:.3f} ms, p80 {step_p80:.3f} ms (last {TIMED_STEPS} of "
          f"{STEPS} steps, host clock, each ending in a synchronize; {1e3 / step_ms:.1f} steps/s "
          f"at the median); peak device memory {train_peak_mib:.1f} MiB")
    print("  losses: " + " ".join(f"{x:.6f}" for x in step_losses))

    iteration = [STEPS]  # the profiled steps continue the schedule

    def one_step():
        iteration[0] += 1
        train_step(state, cam, gt, bg0, iteration[0], 3, W_MAIN, H_MAIN, tcfg, opt,
                   spatial_lr_scale=1.0)

    stages = train_stage_times_ms(state, cam, gt, bg0, tcfg, opt)
    print("  stages run alone (stream time, CUDA events, synchronized, median): "
          + ", ".join(f"{n} {t:.3f} ms" for n, t in stages.items()))
    print_busy(*device_busy_ms(one_step, reps=3), step_ms, "step")

    # The backward and routing kernels at the train path's own inputs: the
    # state after the steps above, the loss's image cotangent, no final_t one.
    with torch.no_grad():
        a = activate(state.params)
        args, lists, n_kept = sorted_inputs(tuple(a), cam, W_MAIN, H_MAIN, (32, 32))
        fwd = composite_fwd_cuda(*args, bg0, W_MAIN, H_MAIN, 32, 32)
    img = fwd.image.clone().requires_grad_(True)
    loss = (1 - opt.lambda_dssim) * losses.l1_loss(img, gt) + opt.lambda_dssim * (1 - losses.ssim(img, gt))
    (g_img,) = torch.autograd.grad(loss, [img])
    bargs = (*args[:3], lists.entry_src, *args[3:], fwd.image, fwd.final_t, g_img,
             torch.zeros_like(fwd.final_t), W_MAIN, H_MAIN, 32, 32)
    P = args[3].shape[0]
    off, cnt = lists.gauss_offset, lists.gauss_count
    rows = composite_bwd_cuda(*bargs)
    bwd_ms = cuda_time_ms(lambda: composite_bwd_cuda(*bargs), 20)
    bwd_plain_ms = cuda_time_ms(lambda: composite_bwd_torch(*bargs), 1)
    route_ms = cuda_time_ms(lambda: route_grads_cuda(rows, off, cnt, P), 50)
    route_plain_ms = cuda_time_ms(lambda: route_grads_torch(rows, off, cnt, P), 5)
    seg = torch.repeat_interleave(torch.arange(P, device=dev), cnt.long(), output_size=n_kept)
    src = rows[:n_kept]
    out9 = torch.zeros((P, 9), device=dev)
    index_add_ms = cuda_time_ms(lambda: out9.zero_().index_add_(0, seg, src), 50)

    bwd_occ = composite_bwd_occupancy(32, 32, dev.index)
    counts = blend_pair_counts(*args, W_MAIN, H_MAIN, 32, 32, warps=bwd_occ["threads"] // 32)
    pairs, taken, blended = counts.pairs, counts.taken, counts.blended
    T = args[1].shape[0]
    # each input read once: ids and emission indices of the kept entries,
    # 9 float fields per Gaussian, tile ranges, image + final_t + their
    # cotangents per pixel; each output written once: 9 floats per entry
    bwd_bytes = 8 * n_kept + 36 * P + 8 * T + 32 * W_MAIN * H_MAIN + 36 * n_kept
    bwd_bound = bound_ms(bwd_bytes, pair_ops(pairs, taken) + OPS_PER_BLENDED_BWD * blended)
    bwd_every_pair = bound_ms(bwd_bytes, OPS_PER_PAIR * pairs + OPS_PER_BLENDED_BWD * blended)[0]
    # rows of the kept entries read once, run bounds read, sums written; 9 adds per entry
    route_bytes = 36 * n_kept + 8 * P + 36 * P
    route_bound = bound_ms(route_bytes, 9 * n_kept)
    print(f"  backward kernel {bwd_ms:.4f} ms, plain {bwd_plain_ms:.2f} ms; K={n_kept}, pairs {pairs}, "
          f"taken {taken}, blended {blended}, bytes {bwd_bytes}: {bwd_bound[2]}; "
          f"{bwd_every_pair:.4f} ms with every evaluated pair at {OPS_PER_PAIR} operations")
    print(f"  backward kernel at 32x32: {counts.band_entries} (entry, warp band) reductions, "
          f"{counts.units} (entry, 32-pixel unit) pairs with an open pixel in the entry's box, "
          f"{bwd_occ['registers']} registers per thread, {bwd_occ['threads']} threads per block, "
          f"{bwd_occ['blocks_per_sm']} resident blocks per SM")
    runs = cnt.cpu().numpy()
    print(f"  routing kernel {route_ms:.4f} ms, plain {route_plain_ms:.3f} ms, index_add_ "
          f"{index_add_ms:.4f} ms; bytes {route_bytes}: {route_bound[2]}; entries per Gaussian: "
          f"max {runs.max()}, p99.9 {np.percentile(runs, 99.9):.1f}, median {np.median(runs):.0f}")
    phase_done("5 train path")

    # ---- 5b. trainer path ---------------------------------------------
    trainer_launches, trainer_err = trainer_phase(dev, step_ms)
    for k, e in trainer_err.items():
        max_err[k] = max(max_err[k], e)
    phase_done("5b trainer path")

    # ---- 5c. CLI path -------------------------------------------------
    cli_train_launches, cli_render_launches, cli_errs = cli_phase(dev)
    for k, e in zip(("composite_fwd", "composite_bwd", "route_grads"), cli_errs):
        max_err[k] = max(max_err[k], e)
    phase_done("5c CLI path")

    # ---- 6. profiler path ---------------------------------------------
    reset_launches()
    prof = profile_stages.run(profile_stages.STAGES)  # the tool's defaults, on the card
    prof_launches = {name: c.launches for name, c in LAUNCH_COUNTERS.items()}
    print(f"profiler path: P={prof['P']} entries={prof['entries']} capacity={prof['capacity']} "
          f"tiles={prof['tiles']} on {prof['device']}; launches {prof_launches}")
    bad = {k: v for k, v in prof["ms"].items() if not math.isfinite(v)}
    if bad:
        fail(f"profiler times not finite: {bad}")
    if prof_launches != {name: prof["calls"].get(name, 0) for name in LAUNCH_COUNTERS}:
        fail(f"profiler launches {prof_launches} differ from the calls it reports {prof['calls']}")
    sc = profile_stages.make_scene(prof["P"], W_MAIN, H_MAIN, (32, 16))
    with torch.no_grad():
        own_entries = int(preprocess(*sc.acts, 3, sc.cam, W_MAIN, H_MAIN, 32, 16).tiles_touched.sum())
    del sc
    if prof["entries"] != own_entries:
        fail(f"profiler entry count {prof['entries']} vs {own_entries} from this script's preprocess")
    print(f"  entry count {own_entries} recomputed here; {len(prof['ms'])} lines, all finite")

    # The three kernels of this path at its shapes: (16, K) and (K, 16), K the capacity.
    K = prof["capacity"]
    gen = torch.Generator(device=dev).manual_seed(31)
    xt = torch.randn((16, K), generator=gen, device=dev)
    xs = torch.randn((K, 16), generator=gen, device=dev)
    tp_ms = cuda_time_ms(lambda: relayout_to_rows_cuda(xt), 50)
    tp_plain_ms = cuda_time_ms(lambda: relayout_to_rows_torch(xt), 50)
    tp_lib_ms = cuda_time_ms(lambda: xt.t().contiguous(), 50)
    tp_bound = bound_ms(2 * 64 * K, 0)  # 64 B read and 64 B written per column
    cr_ms = cuda_time_ms(lambda: consume_rows_cuda(xs), 50)
    cr_plain_ms = cuda_time_ms(lambda: consume_rows_torch(xs), 50)
    ct_ms = cuda_time_ms(lambda: consume_t_cuda(xs), 50)
    ct_plain_ms = cuda_time_ms(lambda: consume_t_torch(xs), 50)
    sum_lib_ms = cuda_time_ms(lambda: xs.sum(0), 50)
    sum_bound = bound_ms(64 * K + 64, 16 * K)  # the table read once, 16 sums written; one add per element
    print(f"  relayout_to_rows (16, {K}) {tp_ms:.4f} ms, plain {tp_plain_ms:.4f} ms, "
          f"x.t().contiguous() {tp_lib_ms:.4f} ms; {tp_bound[2]}")
    ct_occ = consume_t_occupancy(16, dev.index)
    print(f"  consume_rows ({K}, 16) {cr_ms:.4f} ms, plain {cr_plain_ms:.4f} ms; consume_t {ct_ms:.4f} ms, "
          f"plain {ct_plain_ms:.4f} ms; x.sum(0) {sum_lib_ms:.4f} ms; {sum_bound[2]}")
    print(f"  consume_t first pass at R=16: {ct_occ['registers']} registers per thread, "
          f"{ct_occ['threads']} threads per block, {ct_occ['blocks_per_sm']} resident blocks per SM")
    phase_done("6 profiler path")

    # ---- 7. result ----------------------------------------------------
    def entry(name, source, replaces, by_path, ms, plain, bound, library):
        return {"name": name, "route": "cuda", "source": f"gaussian_splatting_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library}

    def by_path(name):  # each path's own count, read after its own reset
        if name in train_launches:
            return {"train": train_launches[name], "trainer": trainer_launches[name],
                    "cli_train": cli_train_launches[name], "cli_render": cli_render_launches[name]}
        return {"profiler": prof_launches[name]}

    print(json.dumps({"kernels": [
        entry("composite_fwd", "composite_fwd", "gaussian_splatting_tpu/ops/composite_pallas.py:376",
              by_path("composite_fwd"), fwd_ms, fwd_plain_ms, fwd_bound, None),  # _fwd_kernel
        entry("composite_bwd", "composite_bwd", "gaussian_splatting_tpu/ops/composite_pallas.py:427",
              by_path("composite_bwd"), bwd_ms, bwd_plain_ms, bwd_bound, None),  # _bwd_kernel
        # _to_rows_kernel's one call site: the routing sums
        entry("route_grads", "route_grads", "gaussian_splatting_tpu/ops/relayout.py:50",
              by_path("route_grads"), route_ms, route_plain_ms, route_bound, index_add_ms),
        # tkern, and the function of _to_rows_kernel (gaussian_splatting_tpu/ops/relayout.py:50)
        entry("relayout_to_rows", "relayout", "tools/profile_stages.py:231",
              by_path("relayout_to_rows"), tp_ms, tp_plain_ms, tp_bound, tp_lib_ms),
        entry("consume_rows", "consume", "tools/profile_stages.py:427",  # _sum_rows_kernel
              by_path("consume_rows"), cr_ms, cr_plain_ms, sum_bound, sum_lib_ms),
        entry("consume_t", "consume", "tools/profile_stages.py:451",  # _sum_t_kernel
              by_path("consume_t"), ct_ms, ct_plain_ms, sum_bound, sum_lib_ms),
    ]}))
    phase_done("7 result")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
