"""Per-stage timing of the port's render and train paths on the card.

The counterpart of the JAX package's `tools/profile_stages.py`: the same
random scene (P = 262,144 Gaussians from `default_rng(0)`, SH degree 3, at
1920x1080 with 32x16 tiles by default), each stage split into its
primitive operations at the real shapes and, in `roofline`, held to the
card's bounds.

    python -m gaussian_splatting_torch.tools.profile_stages [stage ...]

runs on the card (CUDA; it raises without one). The JAX tool's environment
knobs set the sizes: GS_BENCH_P, GS_BENCH_W, GS_BENCH_H, GS_BENCH_ITERS,
GS_BENCH_TILE_W, GS_BENCH_TILE_H, GS_BENCH_BUCKET_BITS. With no stage
named it runs `pre emit render sat`. From Python, `run(stages, ...,
device="cpu")` drives the plain versions of the kernels on the CPU, at
tiny sizes only (the tests do so).

Timing: each line is one operation or chain, called once to warm up and
then `iters` times back to back between two CUDA events; the line reports
the least per-call time over `reps` such runs. Inputs at the default sizes
are larger than the H100's 50 MB L2 cache; a line whose inputs fit in it
says so, since repeated calls may find them there. On the CPU the clock is
the host's, and every line says so.

Stages (the JAX tool's names):
  pre        preprocess
  emit       preprocess + binning.build_tile_lists
  render     rasterize: preprocess, binning, the compositing kernel
  grad       forward + backward of sum(img^2) w.r.t. means and opacities
  train      `iters` chained train_steps on the scene
  sat        final_t statistics, the share of saturated tiles, tiles
             touched and entries per tile
  micro      row gathers, the transpose kernel, sorts, tile ranges
  emitparts  build_tile_lists split into its steps, and the pieces of the
             JAX routing chain
  gforms     gathered tables into the two column-sum kernels
  routing    the JAX routing chain (sort, row cumsum, transpose, boundary
             gathers), its bf16-packed arm, and the port's routing kernel
             and `index_add_` on the same rows
  roofline   HBM calibration, and preprocess, binning and the compositing
             kernel against their bounds
  comm       the bytes the sharded train step (`parallel/sharding.py`)
             all-reduces per step at the scene's P (and 4x, 16x) and image
             size, on 2, 4 and 8 ranks, and, given a link rate
             (GS_LINK_GBPS, GB/s per rank and direction; no default) and a
             single-card step time (this run's `train` stage, else
             GS_STEP_MS), the time on the wire and the efficiency of ideal
             1/n compute with no overlap: a model, not a measurement

Not ported (asking for one raises, and the CLI exits non-zero):
  gather   the port has no record gather before the compositing kernel,
           which gathers each entry's fields by id into shared memory.
  visits   the port has no visit-pair grid; that grid is a TPU layout
           (ROADMAP's rules).

Where the port differs from the JAX tool: it renders and bins at the run's
tile geometry throughout, where the JAX tool renders at its rasterizer's
default 32x32 and, in `sat`, bins at 16x16 but indexes tiles on the 32x16
grid; and `sat` has no real-visit line (no visit grid).

`run` returns the header counts, each line's time, the `sat` statistics,
the `roofline` rows, the `comm` table and the number of calls the stages
made to each kernel wrapper (each a launch on the card), so a caller can
hold the wrappers' launch counters to it.
"""

from __future__ import annotations

import math
import os
import sys
import time
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from gaussian_splatting_torch.ops import binning
from gaussian_splatting_torch.ops.composite import blend_pair_counts
from gaussian_splatting_torch.ops.composite_cuda import composite_fwd, route_grads
from gaussian_splatting_torch.ops.projection import preprocess
from gaussian_splatting_torch.ops.rasterize import RasterizerConfig, rasterize
from gaussian_splatting_torch.ops.relayout import relayout_to_rows
from gaussian_splatting_torch.parallel.sharding import ring_wire_bytes, step_collectives
from gaussian_splatting_torch.scene.cameras import Camera
from gaussian_splatting_torch.scene.gaussians import GaussianParams
from gaussian_splatting_torch.tools.consumers import consume_rows, consume_t
from gaussian_splatting_torch.training import OptimizationConfig, init_train_state, train_step
from gaussian_splatting_torch.utils.device import require_device
from gaussian_splatting_torch.utils.roofline import (
    PEAK_BYTES_PER_S, PEAK_FP32_PER_S, bound_ms, pair_ops,
)

STAGES = ("pre", "emit", "render", "grad", "train", "sat", "micro", "emitparts", "gforms",
          "routing", "roofline", "comm")
DEFAULT_STAGES = ("pre", "emit", "render", "sat")
NOT_PORTED = {
    "gather": "the port has no record gather before the compositing kernel, which gathers "
              "each entry's fields by id into shared memory",
    "visits": "the port has no visit-pair grid, a TPU layout that ROADMAP's rules exclude",
}
COMM_RANKS = (2, 4, 8)  # the cards of one host joined by NVLink
COMM_P_SCALES = (1, 4, 16)
L2_BYTES = 50 * 10**6  # H100 L2 cache
STREAM_BYTES = 512 * 2**20  # the roofline's memory calibration
# Preprocess's FP32 work per Gaussian: view and projection transforms, the
# 3D and 2D covariances, eigenvalues, tile rects and degree-3 SH colour,
# about 300 operations (the JAX tool's count, tools/profile_stages.py:693).
# Its bytes bound it about 20x over this, so the count needs no precision.
PRE_OPS_PER_GAUSSIAN = 300
# Bytes of preprocess per Gaussian: inputs read once (means 12, scales 12,
# quats 16, opacity 4, 48 SH coefficients 192) and outputs written once
# (means2d 8, depth 4, conic 12, rgb 12, opacity 4, radius 4, rect 16,
# tiles touched 4, visible 1).
PRE_BYTES_PER_GAUSSIAN = 236 + 65


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Timer:
    """Times one callable per line and keeps the results of a run."""

    def __init__(self, dev: torch.device, iters: int, reps: int):
        self.dev, self.iters, self.reps = dev, iters, reps
        self.stage = ""
        self.ms: dict[str, float] = {}
        self.calls: Counter = Counter()  # kernel wrapper -> calls made

    def count(self, kernels: Optional[dict], times: int = 1):
        for name, n in (kernels or {}).items():
            self.calls[name] += n * times

    def __call__(self, label: str, fn: Callable, inputs=(), kernels: Optional[dict] = None):
        """Per-call ms of fn(): one warm-up call, then the least of `reps`
        runs of `iters` back-to-back calls. `inputs` are the tensors fn
        reads (for the L2 note); `kernels` maps each kernel wrapper fn
        calls to its calls per fn()."""
        fn()
        best = math.inf
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            for _ in range(self.reps):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(self.iters):
                    fn()
                stop.record()
                stop.synchronize()
                best = min(best, start.elapsed_time(stop) / self.iters)
            clock = "CUDA events"
        else:
            for _ in range(self.reps):
                t0 = time.perf_counter()
                for _ in range(self.iters):
                    fn()
                best = min(best, (time.perf_counter() - t0) * 1e3 / self.iters)
            clock = "host clock on the CPU, not a device time"
        self.count(kernels, 1 + self.reps * self.iters)
        nb = _nbytes(inputs)
        note = f"; inputs {nb / 1e6:.1f} MB fit in L2" if self.dev.type == "cuda" and nb < L2_BYTES else ""
        print(f"  {label:52s} {best:10.4f} ms  [{clock}{note}]", flush=True)
        self.ms[f"{self.stage}: {label}"] = best
        return best


@dataclass
class Scene:
    """The JAX tool's scene (tools/profile_stages.py:33-72) on one device."""

    acts: tuple  # means, scales, quats, opacities, shs: activated, float32
    cam: object  # CameraArrays
    width: int
    height: int
    tile: tuple
    grid_x: int
    grid_y: int
    entries: int
    capacity: int

    @property
    def num_points(self) -> int:
        return self.acts[0].shape[0]

    @property
    def num_tiles(self) -> int:
        return self.grid_x * self.grid_y

    def config(self) -> RasterizerConfig:
        return RasterizerConfig(tile_w=self.tile[0], tile_h=self.tile[1],
                                capacity_exact=self.capacity)

    def prep(self):
        return preprocess(*self.acts, 3, self.cam, self.width, self.height, *self.tile)

    def lists(self, prep):
        return binning.build_tile_lists(prep.rect_min, prep.rect_max, prep.depths,
                                        prep.tiles_touched, self.grid_x, self.grid_y,
                                        self.capacity)


def make_scene(P: int, width: int, height: int, tile=(32, 16), bucket_bits: int = 16,
               device="cuda") -> Scene:
    """P random Gaussians from `default_rng(0)`, made exactly as the JAX tool
    makes them, a camera at z = -4 looking down +z with a 70 degree
    horizontal field of view, and the tool's entry capacity: the entry
    count plus 2 %, rounded up to a multiple of 2^bucket_bits."""
    dev = require_device(device)
    rng = np.random.default_rng(0)
    means = rng.normal(0, 1.0, (P, 3))
    scales = np.exp(rng.normal(-4.2, 0.5, (P, 3)))
    quats = rng.normal(0, 1, (P, 4))
    opacities = 1 / (1 + np.exp(-rng.normal(0.0, 1.0, (P,))))
    shs = rng.normal(0, 0.2, (P, 16, 3)).astype(np.float32)
    shs[:, 0, :] += 1.0
    acts = tuple(torch.tensor(np.asarray(x, np.float32), device=dev)
                 for x in (means, scales, quats, opacities, shs))
    cam = Camera(uid=0, colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]),
                 fovx=math.radians(70), fovy=math.radians(70 * height / width), image=None,
                 image_name="bench", width=width, height=height).arrays(device=dev)
    with torch.no_grad():
        entries = int(preprocess(*acts, 3, cam, width, height, *tile).tiles_touched.sum())
    bucket = 1 << bucket_bits
    capacity = max(bucket, -(int(entries * 1.02) // -bucket) * bucket)
    return Scene(acts=acts, cam=cam, width=width, height=height, tile=tuple(tile),
                 grid_x=-(-width // tile[0]), grid_y=-(-height // tile[1]), entries=entries,
                 capacity=capacity)


def _bg(sc: Scene) -> torch.Tensor:
    return torch.zeros(3, dtype=torch.float32, device=sc.acts[0].device)


def _render(sc: Scene, *acts):
    return rasterize(*(acts or sc.acts), 3, sc.cam, sc.width, sc.height, _bg(sc), sc.config(),
                     return_aux=False)


FWD = {"composite_fwd": 1}
FWD_BWD = {"composite_fwd": 1, "composite_bwd": 1, "route_grads": 1}


def stage_pre(t: _Timer, sc: Scene, out: dict):
    t("preprocess", sc.prep, sc.acts)


def stage_emit(t: _Timer, sc: Scene, out: dict):
    t("pre+emit (preprocess + build_tile_lists)", lambda: sc.lists(sc.prep()), sc.acts)


def stage_render(t: _Timer, sc: Scene, out: dict):
    t("full render (rasterize)", lambda: _render(sc), sc.acts, FWD)


def stage_grad(t: _Timer, sc: Scene, out: dict):
    means = sc.acts[0].clone().requires_grad_(True)
    opac = sc.acts[3].clone().requires_grad_(True)

    def f():
        img = _render(sc, means, sc.acts[1], sc.acts[2], opac, sc.acts[4])
        return torch.autograd.grad((img * img).sum(), [means, opac])

    t("render fwd+bwd of sum(img^2)", f, sc.acts, FWD_BWD)


def stage_train(t: _Timer, sc: Scene, out: dict):
    """`iters` train steps back to back per timed run, as the JAX tool
    chains them; the steps go on updating one state."""
    means, scales, quats, opac, shs = sc.acts
    params = GaussianParams(
        xyz=means.clone(), features_dc=shs[:, :1].clone(), features_rest=shs[:, 1:].clone(),
        scaling=torch.log(scales), rotation=quats.clone(),
        opacity=torch.log(opac / (1.0 - opac))[:, None])
    state = init_train_state(params)
    gt = torch.tensor(np.random.default_rng(9).uniform(size=(sc.height, sc.width, 3)),
                      dtype=torch.float32, device=means.device)
    iteration = [1]

    def step():
        iteration[0] += 1
        return train_step(state, sc.cam, gt, _bg(sc), iteration[0], 3, sc.width, sc.height,
                          sc.config(), OptimizationConfig(), spatial_lr_scale=1.0)

    t("full train step", step, sc.acts, FWD_BWD)


def _stats(x: np.ndarray) -> dict:
    return {"mean": float(x.mean()), "p50": float(np.percentile(x, 50)),
            "p95": float(np.percentile(x, 95)), "max": float(x.max())}


def stage_sat(t: _Timer, sc: Scene, out: dict):
    """How much of the compositing work is skippable: saturation of the
    final transmittance, per pixel and per whole tile, and the spread of
    tiles per Gaussian and entries per tile."""
    img, aux = rasterize(*sc.acts, 3, sc.cam, sc.width, sc.height, _bg(sc), sc.config())
    t.count(FWD)
    ft = aux["final_t"].cpu().numpy()
    tw, th = sc.tile
    hh, ww = sc.height // th * th, sc.width // tw * tw
    tiles_ft = ft[:hh, :ww].reshape(hh // th, th, ww // tw, tw).transpose(0, 2, 1, 3)
    tile_max = tiles_ft.reshape(-1, tw * th).max(axis=1)
    prep = sc.prep()
    lists = sc.lists(prep)
    touched = prep.tiles_touched.cpu().numpy()
    per_tile = (lists.tile_stop - lists.tile_start).cpu().numpy()
    sat = {"final_t_mean": float(ft.mean()), "final_t_share_below_1e-4": float(np.mean(ft < 1e-4)),
           "tiles_all_saturated": float(np.mean(tile_max < 1e-4)),
           "tiles_touched": _stats(touched), "entries_per_tile": _stats(per_tile)}
    print(f"  final_t: mean={sat['final_t_mean']:.4f} "
          f"frac<1e-4={sat['final_t_share_below_1e-4']:.3f}")
    print(f"  tiles all-saturated ({tw}x{th} blocks): {sat['tiles_all_saturated']:.3f}")
    for name in ("tiles_touched", "entries_per_tile"):
        s = sat[name]
        print(f"  {name}: mean={s['mean']:.2f} p50={s['p50']:.0f} p95={s['p95']:.0f} "
              f"max={s['max']:.0f}")
    out["sat"] = sat


def _t(x, dev, dtype=None):
    """A numpy array on `dev` (integers as int64, torch's index type, unless
    `dtype` says otherwise)."""
    return torch.tensor(x, dtype=dtype, device=dev)


def stage_micro(t: _Timer, sc: Scene, out: dict):
    """Gathers, the transpose kernel, sorts and tile ranges at the pipeline's
    sizes (K = the entry capacity)."""
    P, K, T = sc.num_points, sc.capacity, sc.num_tiles
    dev = sc.acts[0].device
    rng = np.random.default_rng(1)
    table = _t(rng.normal(size=(P, 16)), dev, torch.float32)
    idx = _t(rng.integers(0, P, K), dev)
    drec = _t(rng.normal(size=(16, K)), dev, torch.float32)
    ord2 = _t(rng.permutation(K), dev)
    rl = {"relayout_to_rows": 1}

    t(f"gather ({K},16) rows from (P,16)", lambda: table[idx], (table, idx))
    t("gather rows + .T (fwd rec path)", lambda: table[idx].t().contiguous(), (table, idx))
    t("routing: drec.T[ord2].T (r1 path)", lambda: drec.t()[ord2].t().contiguous(), (drec, ord2))
    t("routing: relayout_to_rows then row gather", lambda: relayout_to_rows(drec)[ord2],
      (drec, ord2), rl)
    t("relayout_to_rows (16,K) alone", lambda: relayout_to_rows(drec), (drec,), rl)

    key1 = _t(rng.integers(0, T, K), dev, torch.int32)
    key2 = _t(rng.integers(0, 2**30, K), dev, torch.int32)
    val = _t(rng.integers(0, P, K), dev, torch.int32)
    key = (key1.to(torch.int64) << 32) | key2.to(torch.int64)

    def port_sort():
        _, order = torch.sort(key, stable=True)
        return val[order]

    def three_op():  # the (tile, depth, gid) sort as two stable passes and the gathers
        o1 = torch.argsort(key2, stable=True)
        order = o1[torch.argsort(key1[o1], stable=True)]
        return key1[order], val[order]

    t("port: stable int64 key sort + gid gather", port_sort, (key, val))
    t("(tile,depth,gid) sort: 2 stable passes + gathers", three_op, (key1, key2, val))
    t("(gid,iota) sort", lambda: torch.sort(val), (val,))

    s_tile = torch.sort(key1).values
    ids = torch.arange(T, dtype=torch.int32, device=dev)

    def ss():
        return (torch.searchsorted(s_tile, ids), torch.searchsorted(s_tile, ids, right=True))

    def bscat():
        prev = torch.cat([s_tile.new_full((1,), -1), s_tile[:-1]])
        first = torch.where(s_tile != prev, s_tile, T).to(torch.int64)
        starts = torch.full((T + 1,), K, dtype=torch.int64, device=dev).scatter_reduce(
            0, first, torch.arange(K, device=dev), "amin")
        return torch.flip(torch.cummin(torch.flip(starts, (0,)), 0).values, (0,))

    t("searchsorted ranges x2", ss, (s_tile,))
    t("boundary-scatter ranges (amin + reverse cummin)", bscat, (s_tile,))


def stage_emitparts(t: _Timer, sc: Scene, out: dict):
    """build_tile_lists (ops/binning.py) split into its steps on the scene's
    own preprocess output, each timed alone on the previous steps' results;
    then the pieces of the JAX routing chain at (9, K)."""
    dev = sc.acts[0].device
    P, T, cap, gx = sc.num_points, sc.num_tiles, sc.capacity, sc.grid_x
    i64 = torch.int64
    prep = sc.prep()
    counts_raw = prep.tiles_touched.to(i64)
    t("cumsum of tiles_touched (P,) int64", lambda: torch.cumsum(counts_raw, 0), (counts_raw,))
    ends_raw = torch.cumsum(counts_raw, 0)
    counts = torch.where(ends_raw <= cap, counts_raw, torch.zeros_like(counts_raw))
    offsets = ends_raw - counts_raw
    arange_p = torch.arange(P, device=dev)

    def expand():
        n = int(counts.sum())  # the host sync
        return torch.repeat_interleave(arange_p, counts, output_size=n)

    t("repeat_interleave by tiles touched (host sync)", expand, (counts,))
    gid = expand()
    n = gid.shape[0]
    t("local = arange - offsets[gid] (int64 gather)",
      lambda: torch.arange(n, device=dev) - offsets[gid], (offsets, gid))
    local = torch.arange(n, device=dev) - offsets[gid]

    rmin64 = prep.rect_min.to(i64)
    t("rect_min (int64)[gid] gather", lambda: rmin64[gid], (rmin64, gid))
    t("rect_max[gid, 0] gather", lambda: prep.rect_max[gid, 0], (prep.rect_max, gid))
    rmin, rmax0 = rmin64[gid], prep.rect_max[gid, 0]
    rw = torch.clamp_min(rmax0.to(i64) - rmin[:, 0], 1)

    def divmod_tile():
        return (rmin[:, 1] + local // rw) * gx + rmin[:, 0] + local % rw

    t("rect div/mod -> tile id", divmod_tile, (rmin, rw, local))
    tile = divmod_tile()

    def depth_bits():
        return prep.depths.contiguous().view(torch.int32).to(i64)[gid] & 0xFFFFFFFF

    t("depth-bit gather", depth_bits, (prep.depths, gid))
    bits = depth_bits()

    def fill():
        key = torch.full((cap,), T << 32, dtype=i64, device=dev)
        key[:n] = (tile << 32) | bits
        gid_k = torch.zeros((cap,), dtype=i64, device=dev)
        gid_k[:n] = gid
        return key, gid_k

    t("key fill (tile << 32 | depth bits) + gid fill", fill, (tile, bits, gid))
    key, gid_k = fill()
    t("stable sort of the int64 keys", lambda: torch.sort(key, stable=True), (key,))
    s_key, order = torch.sort(key, stable=True)
    s_tile = (s_key >> 32).to(torch.int32)
    t("searchsorted tile ranges", lambda: binning._tile_ranges(s_tile, T), (s_tile,))
    t("gid_k[order] gather", lambda: gid_k[order].to(torch.int32), (gid_k, order))
    if not torch.equal(gid_k[order].to(torch.int32), sc.lists(prep).gauss_id):
        raise RuntimeError("emitparts: the split steps disagree with build_tile_lists")

    rng = np.random.default_rng(4)
    K = cap
    gid_r = torch.sort(_t(rng.integers(0, P, K), dev, torch.int32)).values
    drec9 = _t(rng.normal(size=(16, K)), dev, torch.float32)[:9].contiguous()
    ord2 = _t(rng.permutation(K), dev)
    rl = {"relayout_to_rows": 1}
    t("routing piece: (gid,iota) sort", lambda: torch.sort(gid_r), (gid_r,))
    t("routing piece: relayout_to_rows (9,K)", lambda: relayout_to_rows(drec9), (drec9,), rl)
    t("routing piece: relayout (9,K) + row gather", lambda: relayout_to_rows(drec9)[ord2],
      (drec9, ord2), rl)
    t("routing piece: row cumsum (9,K)", lambda: torch.cumsum(drec9, 1), (drec9,))


def stage_gforms(t: _Timer, sc: Scene, out: dict):
    """What a gathered (K, 16) table costs its consumer in each form."""
    P, K = sc.num_points, sc.capacity
    dev = sc.acts[0].device
    rng = np.random.default_rng(5)
    table = _t(rng.normal(size=(P, 16)), dev, torch.float32)
    idx = _t(rng.integers(0, P, K), dev)
    bigtab = _t(rng.normal(size=(K, 16)), dev, torch.float32)
    ord2 = _t(rng.permutation(K), dev)
    cr, ct = {"consume_rows": 1}, {"consume_t": 1}

    t("gather (K,16) rows", lambda: table[idx], (table, idx))
    t("gather rows + .T (fwd pipeline)", lambda: table[idx].t().contiguous(), (table, idx))
    t("consume_rows (K,16) alone", lambda: consume_rows(bigtab), (bigtab,), cr)
    t("consume_t (K,16) alone", lambda: consume_t(bigtab), (bigtab,), ct)
    t("gather rows -> consume_rows", lambda: consume_rows(table[idx]), (table, idx), cr)
    t("gather rows -> consume_t", lambda: consume_t(table[idx]), (table, idx), ct)
    t("gather rows from (K,16) table (bwd)", lambda: bigtab[ord2], (bigtab, ord2))
    t("bwd gather -> consume_rows", lambda: consume_rows(bigtab[ord2]), (bigtab, ord2), cr)
    t("bwd gather -> consume_t", lambda: consume_t(bigtab[ord2]), (bigtab, ord2), ct)
    drec16 = _t(rng.normal(size=(16, K)), dev, torch.float32)
    t("relayout_to_rows (16,K) wide blocks", lambda: relayout_to_rows(drec16), (drec16,),
      {"relayout_to_rows": 1})


def _boundary_sums(dsorted, ends):
    """The JAX routing's tail: row prefix sums, the transpose, and each
    Gaussian's run sum as a difference of prefix rows at its run ends."""
    csum = torch.cumsum(dsorted, 1)
    rows = relayout_to_rows(csum)
    top = torch.where((ends > 0)[:, None], rows[torch.clamp_min(ends - 1, 0)], 0.0)
    bot = torch.cat([torch.zeros_like(top[:1]), top[:-1]])
    return top - bot


def stage_routing(t: _Timer, sc: Scene, out: dict):
    """The JAX backward's gradient routing in its shipping form (a sort by
    Gaussian id carrying the 9 gradient rows, a row cumsum, the transpose
    and the boundary gathers), its bf16-packed lossy arm, and beside both
    the port's routing kernel and `index_add_` on the same rows."""
    P, K = sc.num_points, sc.capacity
    dev = sc.acts[0].device
    rng = np.random.default_rng(2)
    gid = torch.sort(_t(rng.integers(0, P, K), dev)).values
    drec = _t(rng.normal(size=(16, K)), dev, torch.float32)
    gcounts = torch.bincount(gid, minlength=P)
    ends = torch.cumsum(gcounts, 0)
    rl = {"relayout_to_rows": 1}

    def chain():
        _, order = torch.sort(gid)
        return _boundary_sums(drec[:9][:, order], ends)

    t("bwd routing chain (sort + 9 payloads, cumsum, relayout, gathers)", chain, (gid, drec), rl)

    def pack(a, b):
        hi = a.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
        lo = b.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
        return (hi << 16) | lo

    def unpack(w):
        hi = (w >> 16).to(torch.int16).view(torch.bfloat16).float()
        lo = (w & 0xFFFF).to(torch.int16).view(torch.bfloat16).float()
        return hi, lo

    def packed_chain():
        z = torch.zeros_like(drec[0])
        packed = torch.stack([pack(drec[0], drec[1]), pack(drec[2], drec[3]),
                              pack(drec[4], drec[5]), pack(drec[6], drec[7]), pack(drec[8], z)])
        _, order = torch.sort(gid)
        cols = [c for w in packed[:, order] for c in unpack(w)]
        return _boundary_sums(torch.stack(cols[:9]), ends)

    t("bwd routing chain, bf16-packed (lossy A/B)", packed_chain, (gid, drec), rl)

    rows = drec[:9].t().contiguous()  # (K, 9), already grouped by Gaussian
    offset, count = (ends - gcounts).to(torch.int32), gcounts.to(torch.int32)
    t("port: route_grads kernel (run sums)", lambda: route_grads(rows, offset, count, P),
      (rows, offset, count), {"route_grads": 1})
    out9 = torch.zeros((P, 9), dtype=torch.float32, device=dev)
    t("index_add_ by Gaussian id", lambda: out9.zero_().index_add_(0, gid, rows), (rows, gid))


def stage_roofline(t: _Timer, sc: Scene, out: dict):
    """Each render stage against the least time the card could take: bytes
    (each input read once, each output written once) over the memory rate,
    FP32 operations over the FP32 rate, whichever is larger. The memory
    rate is calibrated with a streaming copy of 512 MiB, ten times the L2
    cache, and printed beside the published one; the bounds use the
    published peaks (utils/roofline.py). Eager torch does not fuse a chain
    of elementwise operations, so a calibration of the FP32 rate would
    measure memory again; the published 67 TFLOP/s stands."""
    dev = sc.acts[0].device
    n = STREAM_BYTES // 4
    x = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    y = torch.empty_like(x)
    t_copy = t(f"calib: streaming copy y = x * c, {STREAM_BYTES >> 20} MiB",
               lambda: torch.mul(x, 1.0000001, out=y), (x,))
    del x, y
    hbm = 8 * n / (t_copy / 1e3)
    print(f"  memory rate: calibrated {hbm / 1e9:.1f} GB/s, published "
          f"{PEAK_BYTES_PER_S / 1e9:.0f} GB/s; FP32 rate: published "
          f"{PEAK_FP32_PER_S / 1e12:.0f} TFLOP/s (not calibrated)")

    P, T, W, H = sc.num_points, sc.num_tiles, sc.width, sc.height
    prep = sc.prep()
    lists = sc.lists(prep)
    bg = _bg(sc)
    t_pre = t("preprocess", sc.prep, sc.acts)
    t_bin = t("binning (build_tile_lists)", lambda: sc.lists(prep),
              (prep.rect_min, prep.rect_max, prep.depths, prep.tiles_touched))
    kargs = (lists, prep.means2d, prep.conic, prep.rgb, prep.opacity, bg, W, H, *sc.tile)
    t_kern = t("compositing kernel (composite_fwd)", lambda: composite_fwd(*kargs),
               (lists.gauss_id, prep.means2d, prep.conic, prep.rgb, prep.opacity), FWD)
    t_full = t("full render (rasterize)", lambda: _render(sc), sc.acts, FWD)

    K = int(lists.total)
    counts = blend_pair_counts(lists.gauss_id, lists.tile_start, lists.tile_stop, prep.means2d,
                               prep.conic, prep.rgb, prep.opacity, W, H, *sc.tile)
    pairs = counts.pairs
    # binning reads 24 B per Gaussian (rects, depth, tiles touched) and
    # writes 13 B per list slot (id, tile, valid, source), the tile ranges
    # and 8 B of routing runs per Gaussian; it does integer work only.
    bin_bytes = 32 * P + 13 * sc.capacity + 8 * T + 8
    # the kernel: ids, 9 float fields per Gaussian, tile ranges, bg in;
    # image and final_t out (chip_smoke.py's forward bound)
    kern_bytes = 4 * K + 36 * P + 8 * T + 12 + 16 * W * H
    rows = [("preprocess", t_pre, bound_ms(PRE_BYTES_PER_GAUSSIAN * P, PRE_OPS_PER_GAUSSIAN * P)),
            ("binning", t_bin, bound_ms(bin_bytes, 0)),
            ("compositing kernel", t_kern, bound_ms(kern_bytes, pair_ops(pairs, counts.taken)))]
    print(f"\n  {'stage':20s} {'measured':>11s} {'bound':>11s} {'bound by':>11s} {'of bound':>9s}")
    total_bound = 0.0
    table = []
    for name, meas, (b, by, _) in rows:
        total_bound += b
        table.append({"stage": name, "ms": meas, "bound_ms": b, "bound_by": by})
        print(f"  {name:20s} {meas:9.4f}ms {b:9.4f}ms {by:>11s} {100 * b / meas:8.1f}%")
    print(f"  {'TOTAL frame':20s} {t_full:9.4f}ms {total_bound:9.4f}ms")
    print(f"  achieved fps: {1e3 / t_full:.1f}   speed-of-light fps at K={K}: "
          f"{1e3 / total_bound:.1f}   (K={K} entries, {pairs} evaluated pairs)")
    out["roofline"] = {"rows": table, "frame_ms": t_full, "frame_bound_ms": total_bound,
                       "hbm_calibrated_bytes_per_s": hbm, "pairs": pairs}


def _or_dash(x, spec: str) -> str:
    return "-".rjust(len(format(0.0, spec))) if x is None else format(x, spec)


def stage_comm(t: _Timer, sc: Scene, out: dict):
    """The sharded step's collectives per step (`sharding.step_collectives`,
    the all_reduces of its own record, image and count tensors), at P, 4P
    and 16P rows and n = 2, 4, 8 ranks: tensor bytes and each rank's ring
    wire bytes (2 (n - 1) / n of them). With a link rate (GS_LINK_GBPS) and
    a single-card step time (this run's `train` line, else GS_STEP_MS), the
    wire time and the efficiency comp / (comp + comm) of ideal 1/n compute
    (compute taken as linear in P), with no overlap: lower bounds."""
    link = os.environ.get("GS_LINK_GBPS")
    link = float(link) * 1e9 if link else None
    step_ms = t.ms.get("train: full train step")
    source = "this run's train stage"
    if step_ms is None and os.environ.get("GS_STEP_MS"):
        step_ms, source = float(os.environ["GS_STEP_MS"]), "GS_STEP_MS"
    P, (tw, th) = sc.num_points, sc.tile
    print(f"  link rate: {'not given (GS_LINK_GBPS)' if link is None else f'{link / 1e9:g} GB/s'}"
          f" per rank and direction; single-card step: "
          f"{'not given' if step_ms is None else f'{step_ms:.4f} ms ({source})'}; a model of "
          f"ring all_reduces with no overlap")
    print(f"  {'P':>10s} {'n':>3s} {'tensor MB':>10s} {'wire MB':>9s} {'comm ms':>9s} "
          f"{'comp ms':>9s} {'effic':>7s}")
    rows = []
    for scale in COMM_P_SCALES:
        for n in COMM_RANKS:
            coll = step_collectives(P * scale, sc.width, sc.height, tw, th, n)
            tensor = sum(b for _, b in coll)
            wire = sum(ring_wire_bytes(b, n) for _, b in coll)
            comm_ms = wire / link * 1e3 if link else None
            comp_ms = step_ms * scale / n if step_ms is not None else None
            eff = None
            if comm_ms is not None and comp_ms is not None:
                eff = comp_ms / (comp_ms + comm_ms)
            rows.append({"P": P * scale, "n": n, "collectives": coll, "tensor_bytes": tensor,
                         "wire_bytes": wire, "comm_ms": comm_ms, "comp_ms": comp_ms,
                         "efficiency": eff})
            print(f"  {P * scale:10d} {n:3d} {tensor / 1e6:10.2f} {wire / 1e6:9.2f} "
                  f"{_or_dash(comm_ms, '9.4f')} {_or_dash(comp_ms, '9.4f')} "
                  f"{_or_dash(None if eff is None else 100 * eff, '6.1f')}%")
    for what, b in rows[0]["collectives"]:
        print(f"    per step at P={P}, n={COMM_RANKS[0]}: all_reduce of {what}, {b} B")
    out["comm"] = {"link_bytes_per_s": link, "step_ms": step_ms, "rows": rows}


_STAGE_FUNCS = {"pre": stage_pre, "emit": stage_emit, "render": stage_render, "grad": stage_grad,
                "train": stage_train, "sat": stage_sat, "micro": stage_micro,
                "emitparts": stage_emitparts, "gforms": stage_gforms, "routing": stage_routing,
                "roofline": stage_roofline, "comm": stage_comm}


def check_stages(stages) -> list:
    """The stage names, or ValueError naming why one is not available."""
    stages = list(stages)
    for name in stages:
        if name in NOT_PORTED:
            raise ValueError(f"stage {name!r} is not ported: {NOT_PORTED[name]}")
        if name not in _STAGE_FUNCS:
            raise ValueError(f"unknown stage {name!r}; stages: {' '.join(STAGES)}")
    return stages


def run(stages=DEFAULT_STAGES, P: int = 262_144, width: int = 1920, height: int = 1080,
        tile=(32, 16), iters: int = 10, reps: int = 3, bucket_bits: int = 16,
        device="cuda") -> dict:
    """Build the scene and run `stages` in order, printing each line.

    Returns {"P", "entries", "capacity", "tiles": the header counts,
    "device": where it ran, "ms": {"<stage>: <label>": per-call ms},
    "calls": {kernel wrapper: calls made}, and "sat" / "roofline" / "comm"
    when those stages ran}."""
    stages = check_stages(stages)
    dev = require_device(device)
    sc = make_scene(P, width, height, tile, bucket_bits, dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"P={P} entries={sc.entries} capacity={sc.capacity} tiles={sc.num_tiles}", flush=True)
    timer = _Timer(dev, iters, reps)
    out = {"P": P, "entries": sc.entries, "capacity": sc.capacity, "tiles": sc.num_tiles,
           "device": where}
    for name in stages:
        timer.stage = name
        print(f"[{name}] on {where}", flush=True)
        t0 = time.perf_counter()
        with torch.set_grad_enabled(name in ("grad", "train")):
            _STAGE_FUNCS[name](timer, sc, out)
        print(f"[{name}] {time.perf_counter() - t0:.1f} s wall", flush=True)
    out["ms"], out["calls"] = dict(timer.ms), dict(timer.calls)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    try:
        stages = check_stages(argv or DEFAULT_STAGES)
    except ValueError as e:
        print(f"profile_stages: {e}", file=sys.stderr)
        return 2
    env = os.environ.get
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(stages, P=int(env("GS_BENCH_P", 262_144)), width=int(env("GS_BENCH_W", 1920)),
        height=int(env("GS_BENCH_H", 1080)),
        tile=(int(env("GS_BENCH_TILE_W", 32)), int(env("GS_BENCH_TILE_H", 16))),
        iters=int(env("GS_BENCH_ITERS", 10)), bucket_bits=int(env("GS_BENCH_BUCKET_BITS", 16)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
