"""Multi-device training on torch.distributed: Gaussian rows sharded over
ranks, the image's tile rows split into one strip per rank.

The counterpart of `gaussian_splatting_tpu/parallel/sharding.py`, with one
process per rank (`torch.distributed`) where the JAX package has one
program over a device mesh (`shard_map`):

1. **Gaussian sharding.** Rank r holds the contiguous rows
   [r cap/n, (r+1) cap/n) of every row tensor of the training state
   (parameters, Adam moments, `alive`, the three statistics); the Adam
   step count is replicated. Preprocess and its backward run on the
   rank's own rows.
2. **Tile-strip compositing.** After preprocess every rank gathers the
   compact records of all Gaussians (means2d, depth, conic, rgb, opacity;
   tile rect, visible, radius), clips each rect to its own strip of
   `rows_per` tile rows, bins and composites that strip alone with the
   compositing kernels at the strip's first pixel row (`origin_y`). A
   tile's entries never cross strips, so the strips are the full frame's
   tile rows, bit for bit.
3. The strips are gathered into the full image on every rank, and every
   rank computes the same 0.8 L1 + 0.2 (1 - SSIM) loss on it, so SSIM's
   windows see no seams.

Collectives. Every gather is one `all_reduce` (sum) of a zero buffer into
which each rank writes its own rows, the one collective that every backend
has for CUDA tensors (gloo has no all_gather or reduce_scatter for them);
adding zeros changes no bit. The records' gather is differentiable: its
backward is an all_reduce of the record cotangents followed by the rank's
own slice (a reduce-scatter), since each rank's strip adds its own share of
every Gaussian's gradient. The image's gather takes, in its backward, the
rank's slice of the image cotangent and communicates nothing: the loss is
computed identically on every rank from the same full image, so each rank
already holds the whole cotangent. So the gradients are the single-device
step's with no 1/n: JAX's `shard_map` differentiates the sum of the n
replicated losses and divides by n instead.

Setup: `initialize_distributed` (the GS_COORDINATOR / GS_NUM_PROCESSES /
GS_PROCESS_ID variables, as the JAX package's), `make_mesh`,
`shard_train_state`, then the step from `make_sharded_train_step`. Every
rank runs the same host program on the same inputs. `trainer.Trainer`
takes the mesh as its `mesh` field.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from gaussian_splatting_torch.ops import binning, losses
from gaussian_splatting_torch.ops.composite_cuda import composite_fwd
from gaussian_splatting_torch.ops.projection import preprocess
from gaussian_splatting_torch.ops.rasterize import RasterizerConfig
from gaussian_splatting_torch.scene.gaussians import PARAM_NAMES, GaussianParams, activate
from gaussian_splatting_torch.scene.optim import AdamState, adam_update, expon_lr
from gaussian_splatting_torch.training import OptimizationConfig, TrainState

STAT_NAMES = ("max_radii2d", "xyz_grad_accum", "denom")
# Per Gaussian, the records every rank gathers: float32 means2d 2, depth 1,
# conic 3, rgb 3, opacity 1; int32 rect_min 2, rect_max 2, visible 1, radius 1.
RECORD_FLOATS = 10
RECORD_INTS = 6


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join this process to the process group of a multi-process run.

    Reads GS_COORDINATOR ("host:port" of rank 0's TCP store), GS_NUM_PROCESSES
    and GS_PROCESS_ID when the arguments are omitted. Returns False when no
    coordinator is given (a single-process run), True once the group is up.
    Idempotent: a second call returns True. `backend` defaults to "nccl" where
    CUDA is available and "gloo" elsewhere; ranks that share one card need
    "gloo" (NCCL refuses two ranks on one device).
    """
    coordinator_address = coordinator_address or os.environ.get("GS_COORDINATOR")
    if num_processes is None and "GS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["GS_NUM_PROCESSES"])
    if process_id is None and "GS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["GS_PROCESS_ID"])
    if coordinator_address is None:
        return False
    if dist.is_initialized():
        return True
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the number of processes and this process's id "
                         "(GS_NUM_PROCESSES, GS_PROCESS_ID)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True


@dataclass(frozen=True)
class Mesh:
    """The 1-D mesh of the JAX package's "gauss" axis: every rank of the
    default process group, each with one row shard and one strip."""

    size: int
    rank: int


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh of every rank of the initialized process group (one rank per
    device). `n_devices`, if given, must be the group's size."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a group of {world}")
    return Mesh(size=world, rank=dist.get_rank())


def _sum(x: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's (rows, ...) tensor -> the (n rows, ...) tensor of all of
    them in rank order, on every rank (one all_reduce)."""
    rows = x.shape[0]
    buf = x.new_zeros((mesh.size * rows,) + tuple(x.shape[1:]))
    buf[mesh.rank * rows:(mesh.rank + 1) * rows] = x
    return _sum(buf)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of x, on every rank (x is not changed)."""
    return _sum(x.clone())


class _GatherRows(torch.autograd.Function):
    """`gather_rows` with a backward. `reduce_grads`: the cotangents of the
    ranks differ and each rank's rows take their sum (a reduce-scatter);
    otherwise every rank holds the same cotangent and takes its own slice."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, reduce_grads: bool):
        ctx.mesh, ctx.reduce_grads, ctx.rows = mesh, reduce_grads, x.shape[0]
        return gather_rows(x.detach(), mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grads:
            g = _sum(g.contiguous().clone())
        lo = ctx.mesh.rank * ctx.rows
        return g[lo:lo + ctx.rows], None, None


@dataclass(frozen=True)
class StripGeometry:
    """Each rank's strip of tile rows: rows [rank rows_per, (rank+1) rows_per)
    of the tile grid, strip_h = rows_per tile_h pixel rows (the last strip
    may run past the image, whose rows there are cropped)."""

    grid_x: int
    grid_y: int
    rows_per: int
    strip_h: int

    @classmethod
    def of(cls, width: int, height: int, tile_w: int, tile_h: int, n: int):
        grid_x, grid_y = -(-width // tile_w), -(-height // tile_h)
        rows_per = -(-grid_y // n)
        return cls(grid_x, grid_y, rows_per, rows_per * tile_h)


def strip_rects(rect_min, rect_max, visible, row_lo: int, rows_per: int):
    """Tile rects clipped to the strip of tile rows [row_lo, row_lo +
    rows_per), in the strip's own tile rows, and the tiles each touches
    there (0 for an invisible Gaussian)."""
    rmin_y = torch.clamp(rect_min[:, 1] - row_lo, 0, rows_per)
    rmax_y = torch.clamp(rect_max[:, 1] - row_lo, 0, rows_per)
    rect_min_l = torch.stack([rect_min[:, 0], rmin_y], dim=-1)
    rect_max_l = torch.stack([rect_max[:, 0], rmax_y], dim=-1)
    tiles = torch.where(visible, (rect_max_l[:, 0] - rect_min_l[:, 0]) * (rmax_y - rmin_y), 0)
    return rect_min_l, rect_max_l, tiles.to(torch.int32)


def strip_capacity(raster_cfg: RasterizerConfig, num_points: int, n: int) -> int:
    """Entry capacity of one strip: the frame's share, at least 256."""
    return max(raster_cfg.capacity(num_points) // n, 256)


def step_collectives(num_points: int, width: int, height: int, tile_w: int, tile_h: int,
                     n: int) -> list:
    """The collectives of one sharded step over all `num_points` rows, in
    order: (what, tensor bytes) of each all_reduce. The wire bytes of an
    all_reduce of B bytes are 2 (n - 1) / n B per rank on a ring."""
    strip_h = StripGeometry.of(width, height, tile_w, tile_h, n).strip_h
    return [
        ("records, float32", 4 * RECORD_FLOATS * num_points),
        ("records, int32", 4 * RECORD_INTS * num_points),
        ("strip images", 4 * 3 * n * strip_h * width),
        ("record cotangents (backward)", 4 * RECORD_FLOATS * num_points),
        ("entry and visible counts", 8 * 2 * n),
    ]


def _row_tensors(state: TrainState) -> dict:
    """Every row tensor of a state by name, statistics and `alive` (as
    float32) as (rows, 1) columns."""
    p = state.params
    out = {f"p.{k}": getattr(p, k).detach() for k in PARAM_NAMES}
    out.update({f"m.{k}": state.adam.m[k] for k in PARAM_NAMES})
    out.update({f"v.{k}": state.adam.v[k] for k in PARAM_NAMES})
    out.update({k: getattr(state, k)[:, None] for k in STAT_NAMES})
    out["alive"] = p.alive.to(torch.float32)[:, None]
    return out


def _state_from_rows(t: dict, step: int) -> TrainState:
    """The inverse of `_row_tensors`."""
    params = GaussianParams(**{k: t[f"p.{k}"] for k in PARAM_NAMES}, alive=t["alive"][:, 0] > 0.5)
    adam = AdamState(m={k: t[f"m.{k}"] for k in PARAM_NAMES},
                     v={k: t[f"v.{k}"] for k in PARAM_NAMES}, step=step)
    return TrainState(params=params, adam=adam, **{k: t[k][:, 0] for k in STAT_NAMES})


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's contiguous rows [r cap/n, (r+1) cap/n) of every row
    tensor of `state`, copied; the Adam step count is replicated. Raises
    unless n divides the capacity."""
    cap = state.params.num_points
    if cap % mesh.size:
        raise ValueError(f"capacity {cap} does not divide over {mesh.size} ranks")
    rows = cap // mesh.size
    lo = mesh.rank * rows
    return _state_from_rows({k: t[lo:lo + rows].clone() for k, t in _row_tensors(state).items()},
                            state.adam.step)


def gather_train_state(shard: TrainState, mesh: Mesh) -> TrainState:
    """The whole state from every rank's shard, on every rank: one
    all_reduce of every row tensor packed side by side."""
    tensors = _row_tensors(shard)
    rows = shard.params.num_points
    full = gather_rows(torch.cat([t.reshape(rows, -1) for t in tensors.values()], dim=1), mesh)
    out, col = {}, 0
    for k, t in tensors.items():
        w = t[0].numel()
        out[k] = full[:, col:col + w].reshape((-1,) + tuple(t.shape[1:])).contiguous()
        col += w
    return _state_from_rows(out, shard.adam.step)


def make_sharded_train_step(mesh: Mesh, active_sh_degree: int, width: int, height: int,
                            raster_cfg: RasterizerConfig, opt: OptimizationConfig,
                            spatial_lr_scale: float, update_densify_stats: bool = True):
    """The multi-device train step for this rank, closed over its
    configuration: fn(state, cam, gt_image, bg, iteration) -> metrics.

    `state` is this rank's shard (`shard_train_state`); the step updates it
    IN PLACE, as the port's `train_step` does, and returns that step's
    metrics (loss, l1, psnr, num_entries, num_visible, all global) plus
    `max_strip_entries`, the largest strip's entry count: a strip that
    overflows its capacity drops whole Gaussians while the summed count may
    still fit the frame's, so the caller grows the budget from it. `cam`,
    `gt_image` (H, W, 3), `bg` and `iteration` are the same on every rank.
    As in the port's `train_step`, `sh_degree` is not an argument.
    """
    n = mesh.size
    tw, th = raster_cfg.tile_w, raster_cfg.tile_h
    geo = StripGeometry.of(width, height, tw, th, n)
    row_lo = mesh.rank * geo.rows_per  # the first tile row of this rank's strip

    def step(state: TrainState, cam, gt_image: torch.Tensor, bg, iteration: int) -> dict:
        params = state.params
        dev = params.xyz.device
        bg = torch.as_tensor(bg, dtype=torch.float32, device=dev).reshape(3)
        bias = torch.zeros((params.num_points, 2), dtype=torch.float32, device=dev,
                           requires_grad=True)
        acts = activate(params)
        prep = preprocess(acts.xyz, acts.scales, acts.quats, acts.opacities, acts.shs,
                          active_sh_degree, cam, width, height, tw, th,
                          mean2d_bias=bias, alive=params.alive)
        # The compact records of every Gaussian, on every rank.
        floats = torch.cat([prep.means2d, prep.depths[:, None], prep.conic, prep.rgb,
                            prep.opacity[:, None]], dim=1)
        ints = torch.cat([prep.rect_min, prep.rect_max, prep.visible[:, None],
                          prep.radii[:, None]], dim=1).to(torch.int32)
        floats = _GatherRows.apply(floats, mesh, True)
        ints = gather_rows(ints, mesh)
        P_full = floats.shape[0]
        # the kernels take contiguous fields
        means2d, depths, conic, rgb, opacity = (
            floats[:, a:b].contiguous() for a, b in ((0, 2), (2, 3), (3, 6), (6, 9), (9, 10)))
        depths, opacity = depths[:, 0], opacity[:, 0]
        rect_min_l, rect_max_l, tiles = strip_rects(ints[:, 0:2], ints[:, 2:4], ints[:, 4] > 0,
                                                    row_lo, geo.rows_per)
        lists = binning.build_tile_lists(rect_min_l, rect_max_l, depths.detach(), tiles,
                                         geo.grid_x, geo.rows_per,
                                         strip_capacity(raster_cfg, P_full, n))
        out = composite_fwd(lists, means2d, conic, rgb, opacity, bg, width, geo.strip_h, tw, th,
                            origin_y=row_lo * th)
        full = _GatherRows.apply(out.image, mesh, False)[:height]
        l1 = losses.l1_loss(full, gt_image)
        ssim = losses.ssim(full, gt_image)
        loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (1.0 - ssim)
        *grads, bias_grad = torch.autograd.grad(
            loss, [getattr(params, k) for k in PARAM_NAMES] + [bias])

        lrs = {
            "xyz": expon_lr(iteration, opt.position_lr_init * spatial_lr_scale,
                            opt.position_lr_final * spatial_lr_scale,
                            lr_delay_mult=opt.position_lr_delay_mult,
                            max_steps=opt.position_lr_max_steps),
            "features_dc": opt.feature_lr,
            "features_rest": opt.feature_lr / 20.0,
            "scaling": opt.scaling_lr,
            "rotation": opt.rotation_lr,
            "opacity": opt.opacity_lr,
        }
        adam_update(params, dict(zip(PARAM_NAMES, grads)), state.adam, lrs, params.alive)

        visible = prep.visible
        with torch.no_grad():
            if update_densify_stats:
                radii = prep.radii.to(torch.float32)
                state.max_radii2d.copy_(torch.where(
                    visible, torch.maximum(state.max_radii2d, radii), state.max_radii2d))
                grad_norm = torch.linalg.vector_norm(bias_grad, dim=-1)
                state.xyz_grad_accum.add_(torch.where(visible, grad_norm, 0.0))
                state.denom.add_(visible.to(torch.float32))
            counts = gather_rows(torch.stack([lists.total, visible.sum()]).to(torch.int64)[None],
                                 mesh)
            return {
                "loss": loss.detach(),
                "l1": l1.detach(),
                "psnr": losses.psnr(torch.clamp(full.detach(), 0.0, 1.0), gt_image),
                "num_entries": counts[:, 0].sum(),
                "num_visible": counts[:, 1].sum(),
                "max_strip_entries": counts[:, 0].max(),
            }

    return step


def ring_wire_bytes(nbytes: int, n: int) -> int:
    """Bytes each rank sends in a ring all_reduce of `nbytes` over n ranks."""
    return math.ceil(2 * (n - 1) * nbytes / n)
