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
     final_t bit for bit, and two runs of it must give the same bits.
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
     events) beside its bound, and the plain version's time.
  5. train path: params_from_ply -> init_train_state -> 20 train_steps of
     the trained model at 1920x1080 (camera angle 0, 32x32 tiles, black
     background, SH degree 3, OptimizationConfig() defaults) toward the
     model's own render from angle 0.2 rad. Every step's entry count must
     fit the capacity, every loss be finite, the loss after step 20 be below
     step 1's, and each of the three kernels be launched exactly 20 times.
     Prints step latency (median, p80 of the last 15), peak device memory,
     each stage's stream time, the device busy share and top kernels, and
     the backward and routing kernels' times beside their bounds, their
     plain versions' times and, for routing, `index_add_`'s time.
  6. profiler path: `tools/profile_stages.run` at the JAX tool's defaults
     (P = 262,144 random Gaussians, 1920x1080, 32x16 tiles, 10 calls a
     line, best of 3) over every ported stage; prints the stage table, the
     header counts and the sat and roofline tables. Every time must be
     finite; the launch counter of every kernel must rise by exactly the
     calls the stages report making; the entry count must equal this
     script's own preprocess of the profiler's scene. Then the three
     kernels only this path runs are timed at its shapes beside their
     bound, their plain versions and the one PyTorch call that computes
     the same (`x.t().contiguous()`, `x.sum(0)`).
  7. the kernels line, then the result line.

Each phase's wall time is printed. Scenes are made with numpy from fixed
seeds. Imports no JAX.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from gaussian_splatting_torch import (
    OptimizationConfig, RasterizerConfig, eval_render, init_train_state, rasterize, train_step,
)
from gaussian_splatting_torch.ops import binning, losses
from gaussian_splatting_torch.ops.composite import (
    CompositeOut, blend_pair_counts, composite_bwd_torch, composite_fwd_torch, route_grads_torch,
)
from gaussian_splatting_torch.ops.composite_cuda import (
    TILE_GEOMETRIES, composite_bwd, composite_bwd_cuda, composite_fwd, composite_fwd_cuda,
    route_grads, route_grads_cuda,
)
from gaussian_splatting_torch.ops.projection import preprocess
from gaussian_splatting_torch.ops.rasterize import entry_bucket_capacity
from gaussian_splatting_torch.ops.relayout import (
    relayout_to_rows, relayout_to_rows_cuda, relayout_to_rows_torch,
)
from gaussian_splatting_torch.scene.cameras import Camera
from gaussian_splatting_torch.scene.gaussians import PARAM_NAMES, activate, params_from_ply
from gaussian_splatting_torch.scene.optim import adam_update
from gaussian_splatting_torch.tools import profile_stages
from gaussian_splatting_torch.tools.consumers import (
    consume_rows, consume_rows_cuda, consume_rows_torch, consume_t, consume_t_cuda,
    consume_t_torch,
)
from gaussian_splatting_torch.utils import cuda_build
from gaussian_splatting_torch.utils.roofline import OPS_PER_BLENDED_BWD, OPS_PER_PAIR, bound_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAINED_PLY = os.path.join(ROOT, "assets", "trained_r5.ply")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
W_MAIN, H_MAIN = 1920, 1080
FRAMES = 50  # p80 has 10 frames beyond it
STEPS, TIMED_STEPS = 20, 15  # train steps; latency over the last 15 (p80 has 3 beyond it)

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


def orbit_camera(center, dist, angle, W, H, fovx_deg, fovy_deg):
    """Camera on a circle around `center` in the xz plane, looking at it."""
    c, s = math.cos(angle), math.sin(angle)
    cam_pos = np.asarray(center, np.float64) + np.array([dist * s, 0.0, -dist * c])
    forward = (np.asarray(center) - cam_pos) / dist
    right = np.cross([0.0, 1.0, 0.0], forward)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(forward, right), forward], axis=1)  # C2W
    return Camera(uid=0, colmap_id=0, R=R, T=-R.T @ cam_pos, fovx=math.radians(fovx_deg),
                  fovy=math.radians(fovy_deg), image=None, image_name="smoke", width=W, height=H)


def sorted_inputs(acts, cam, W, H, tile):
    """Preprocess + binning once; the kernels' inputs at exactly this size.
    Returns the forward kernel's scene arguments, the tile lists and the
    entry count."""
    P = acts[0].shape[0]
    prep = preprocess(*acts, 3, cam, W, H, *tile)
    gx, gy = -(-W // tile[0]), -(-H // tile[1])
    capacity = RasterizerConfig(capacity_exact=int(prep.tiles_touched.sum())).capacity(P)
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
    be the forward's, and two runs the same bits. Returns the max abs
    errors of the backward's rows and of the routing's sums."""
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
    err_route = compare_grads(f"{name} routing", sums, route_grads_torch(rows, off, cnt, P))
    compare_grads(f"{name} backward+routing", sums, route_grads_torch(rows_ref, off, cnt, P))
    return err_rows, err_route


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
    pairs, _ = blend_pair_counts(*main_args, W_MAIN, H_MAIN, 32, 32)
    P, T = params.num_points, main_args[1].shape[0]
    # each input read once (ids, 9 float fields per Gaussian, tile ranges, bg),
    # each output written once (image + final_t)
    nbytes = 4 * n_entries + 36 * P + 8 * T + 12 + 16 * W_MAIN * H_MAIN
    fwd_bound = bound_ms(nbytes, OPS_PER_PAIR * pairs)
    print(f"  kernel {fwd_ms:.4f} ms, plain {fwd_plain_ms:.2f} ms; pairs {pairs}, "
          f"bytes {nbytes}: {fwd_bound[2]}")
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

    pairs, blended = blend_pair_counts(*args, W_MAIN, H_MAIN, 32, 32)
    T = args[1].shape[0]
    # each input read once: ids and emission indices of the kept entries,
    # 9 float fields per Gaussian, tile ranges, image + final_t + their
    # cotangents per pixel; each output written once: 9 floats per entry
    bwd_bytes = 8 * n_kept + 36 * P + 8 * T + 32 * W_MAIN * H_MAIN + 36 * n_kept
    bwd_bound = bound_ms(bwd_bytes, OPS_PER_PAIR * pairs + OPS_PER_BLENDED_BWD * blended)
    # rows of the kept entries read once, run bounds read, sums written; 9 adds per entry
    route_bytes = 36 * n_kept + 8 * P + 36 * P
    route_bound = bound_ms(route_bytes, 9 * n_kept)
    print(f"  backward kernel {bwd_ms:.4f} ms, plain {bwd_plain_ms:.2f} ms; K={n_kept}, pairs {pairs}, "
          f"blended {blended}, bytes {bwd_bytes}: {bwd_bound[2]}")
    print(f"  routing kernel {route_ms:.4f} ms, plain {route_plain_ms:.3f} ms, index_add_ "
          f"{index_add_ms:.4f} ms; bytes {route_bytes}: {route_bound[2]}")
    phase_done("5 train path")

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
    print(f"  consume_rows ({K}, 16) {cr_ms:.4f} ms, plain {cr_plain_ms:.4f} ms; consume_t {ct_ms:.4f} ms, "
          f"plain {ct_plain_ms:.4f} ms; x.sum(0) {sum_lib_ms:.4f} ms; {sum_bound[2]}")
    phase_done("6 profiler path")

    # ---- 7. result ----------------------------------------------------
    def entry(name, source, replaces, launches, ms, plain, bound, library):
        return {"name": name, "route": "cuda", "source": f"gaussian_splatting_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": launches, "max_abs_err": max_err[name],
                "ms": ms, "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library}

    print(json.dumps({"kernels": [
        entry("composite_fwd", "composite_fwd", "gaussian_splatting_tpu/ops/composite_pallas.py:376",
              train_launches["composite_fwd"], fwd_ms, fwd_plain_ms, fwd_bound, None),  # _fwd_kernel
        entry("composite_bwd", "composite_bwd", "gaussian_splatting_tpu/ops/composite_pallas.py:427",
              train_launches["composite_bwd"], bwd_ms, bwd_plain_ms, bwd_bound, None),  # _bwd_kernel
        # _to_rows_kernel's one call site: the routing sums
        entry("route_grads", "route_grads", "gaussian_splatting_tpu/ops/relayout.py:50",
              train_launches["route_grads"], route_ms, route_plain_ms, route_bound, index_add_ms),
        # tkern, and the function of _to_rows_kernel (gaussian_splatting_tpu/ops/relayout.py:50)
        entry("relayout_to_rows", "relayout", "tools/profile_stages.py:231",
              prof_launches["relayout_to_rows"], tp_ms, tp_plain_ms, tp_bound, tp_lib_ms),
        entry("consume_rows", "consume", "tools/profile_stages.py:427",  # _sum_rows_kernel
              prof_launches["consume_rows"], cr_ms, cr_plain_ms, sum_bound, sum_lib_ms),
        entry("consume_t", "consume", "tools/profile_stages.py:451",  # _sum_t_kernel
              prof_launches["consume_t"], ct_ms, ct_plain_ms, sum_bound, sum_lib_ms),
    ]}))
    phase_done("7 result")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
