"""The host training loop: the counterpart of `gaussian_splatting_tpu/trainer.py`
(itself the analog of the reference's train.py:31-180).

`Trainer` owns what stays on the host: camera sampling (a random pop from
a reshuffled stack), the SH-degree warm-up every 1000 iterations, the
densify / prune / opacity-reset cadence, the tile-list entry capacity and
its growth, checkpoints, and the snapshot dump on a non-finite loss. Each
step is the port's in-place `train_step` on the trainer's device.

As in the JAX package, the densification runs on the device at fixed
capacity (`densify.densify_and_prune_device`) and falls back to the numpy
form, which grows the capacity, when the children do not fit. Every host
round trip (the host densify, the opacity reset, `load_checkpoint`)
rebuilds the state from its live rows in index order, so it compacts the
rows as the JAX package does. A rebuild replaces the `GaussianParams`
module, the Adam moments and the statistics together.

Checkpoints are the JAX package's pickle (live rows as numpy arrays), so a
run moves between the two packages in either direction. Load only
checkpoints this program or the JAX package wrote: unpickling runs code.

With `mesh` (`parallel/sharding.py`), every rank of the process group runs
this loop from the same seed on the same cameras, so the camera, background
and SH schedules agree; `state` holds the rank's rows and each step is the
sharded step. Maintenance (densify on the device or the host, the opacity
reset) and checkpoints work on the state gathered from every rank, which is
then sharded again, so each rank's rows are the single-device loop's (the
device densify's generator is seeded alike on every rank). The entry probe
sums every rank's count. Only rank 0 writes a checkpoint, in the
single-device format.
"""

from __future__ import annotations

import math
import pickle
import time
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Callable, List, Optional

import numpy as np
import torch

from gaussian_splatting_torch.ops.projection import preprocess
from gaussian_splatting_torch.parallel import sharding
from gaussian_splatting_torch.ops.rasterize import RasterizerConfig, entry_bucket_capacity
from gaussian_splatting_torch.scene import densify as densify_mod
from gaussian_splatting_torch.scene.cameras import Camera
from gaussian_splatting_torch.scene.gaussians import (
    PAD_FILLS, PARAM_NAMES, activate, capacity_bucket, create_from_pcd,
)
from gaussian_splatting_torch.training import (
    OptimizationConfig, TrainState, init_train_state, train_state_from_numpy, train_step,
)
from gaussian_splatting_torch.utils.device import require_device

STAT_NAMES = ("max_radii2d", "xyz_grad_accum", "denom")
METRIC_NAMES = ("loss", "l1", "psnr", "num_entries", "num_visible")


def _state_to_host(state: TrainState):
    """Live rows, in index order, as host numpy dicts: (params, adam m,
    adam v, statistics, adam step)."""
    idx = torch.nonzero(state.params.alive).squeeze(1)

    def host(t):
        return t.detach()[idx].cpu().numpy()

    params = {k: host(getattr(state.params, k)) for k in PARAM_NAMES}
    m = {k: host(state.adam.m[k]) for k in PARAM_NAMES}
    v = {k: host(state.adam.v[k]) for k in PARAM_NAMES}
    stats = {k: host(getattr(state, k)) for k in STAT_NAMES}
    return params, m, v, stats, int(state.adam.step)


def _state_from_host(params, m, v, step, capacity: int, min_capacity: int, device,
                     stats=None) -> TrainState:
    """A state of max(capacity_bucket(n, min_capacity), capacity) rows on
    `device` from n live host rows; the statistics zero unless `stats`
    gives the live rows' values."""
    n = params["xyz"].shape[0]
    cap = max(capacity_bucket(n, min_capacity), capacity)

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    alive = np.arange(cap) < n
    stats = {k: pad(stats[k]) if stats is not None else np.zeros(cap, np.float32)
             for k in STAT_NAMES}
    return train_state_from_numpy(
        {k: pad(params[k], PAD_FILLS[k]) for k in PARAM_NAMES},
        {k: pad(m[k]) for k in PARAM_NAMES}, {k: pad(v[k]) for k in PARAM_NAMES},
        step, alive, device=device, **stats)


@dataclass
class Trainer:
    cameras: List[Camera]
    opt: OptimizationConfig = field(default_factory=OptimizationConfig)
    raster_cfg: RasterizerConfig = field(default_factory=RasterizerConfig)
    sh_degree: int = 3
    white_background: bool = False
    cameras_extent: float = 1.0
    spatial_lr_scale: float = 1.0
    min_capacity: int = 1024
    seed: int = 0
    # Size the tile-list capacity from the measured entry count: the first
    # step probes it (preprocess only), an overflowing step grows it at
    # once, and each densify re-fits it from the window's largest count
    # (`ops/rasterize.entry_bucket_capacity`, 2^entry_bucket_bits buckets).
    # False keeps raster_cfg's capacity, doubling capacity_mult on overflow.
    auto_capacity: bool = True
    entry_bucket_bits: int = 16
    # Densify in place on the device at fixed capacity, falling back to the
    # numpy form when the children do not fit; False always takes numpy.
    device_densify: bool = True
    log_every: int = 50
    log_fn: Callable[[int, dict], None] = lambda it, m: None
    # On a non-finite loss the step's inputs are pickled here for offline
    # repro (the reference's snapshot_fw.dump), and the step raises. With
    # debug=True any exception of the step dumps them too before re-raising.
    debug_dump_path: str = "snapshot_step.dump"
    debug: bool = False
    device: str = "cuda"
    # A `parallel.sharding.Mesh`: rows sharded over its ranks, the image's
    # tile rows in strips (see the module docstring). None: one device.
    mesh: Optional[sharding.Mesh] = None

    def __post_init__(self):
        self._dev = require_device(self.device)
        self.rng = np.random.default_rng(self.seed)
        self.py_rng_stack: List[int] = []
        self.iteration = 0
        self.active_sh_degree = 0
        self.state: Optional[TrainState] = None
        bg = [1.0, 1.0, 1.0] if self.white_background else [0.0, 0.0, 0.0]
        self.background = torch.tensor(bg, dtype=torch.float32, device=self._dev)
        self.history: List[dict] = []
        # one record per densify: iteration, path ("device" / "host"), the
        # counts, live rows before and after, rows before and after
        # (`capacity`), and its host-clock ms, which end in a device wait
        self.densify_history: List[dict] = []
        # largest entry count since the last capacity re-fit
        self._entry_window_max = 0
        # each camera's (CameraArrays, (H, W, 3) target) on the device, made
        # at its first use: the targets are uploaded once, not every step
        self._views = {}
        self._sharded_steps = {}
        self._state_is_shard = False

    def _place(self, state: TrainState) -> TrainState:
        """A (re)built whole state as this rank's shard, with a mesh."""
        if self.mesh is None:
            return state
        shard = sharding.shard_train_state(state, self.mesh)
        self._state_is_shard = True
        return shard

    @contextmanager
    def _whole_state(self):
        """With a mesh, `state` is the whole state gathered from every rank
        inside the block, and this rank's shard of it again after."""
        if not self._state_is_shard:
            yield
            return
        self.state = sharding.gather_train_state(self.state, self.mesh)
        self._state_is_shard = False
        try:
            yield
        finally:
            self.state = self._place(self.state)

    # ---- setup ----
    def init_from_pcd(self, points: np.ndarray, colors: np.ndarray):
        cap = capacity_bucket(points.shape[0], self.min_capacity)
        params = create_from_pcd(points, colors, self.sh_degree, capacity=cap, device=self._dev)
        self.state = self._place(init_train_state(params))

    def _pop_camera(self) -> int:
        """Index into `cameras` of the next training view: a random pop from
        a stack refilled with every camera when empty (train.py:105-108)."""
        if not self.py_rng_stack:
            self.py_rng_stack = list(range(len(self.cameras)))
        return self.py_rng_stack.pop(int(self.rng.integers(len(self.py_rng_stack))))

    def _view(self, i: int):
        if i not in self._views:
            cam = self.cameras[i]
            gt = torch.as_tensor(np.asarray(cam.image, np.float32), device=self._dev)
            self._views[i] = (cam.arrays(device=self._dev), gt.permute(1, 2, 0).contiguous())
        return self._views[i]

    def _global_sum(self, x: torch.Tensor) -> int:
        """x summed over the ranks while `state` is a shard."""
        return int(sharding.all_sum(x) if self._state_is_shard else x)

    @property
    def num_live(self) -> int:
        return self._global_sum(self.state.params.alive.sum())

    @property
    def num_rows(self) -> int:
        """Rows of the whole state (the capacity), on every rank."""
        n = self.state.params.num_points
        return n * self.mesh.size if self._state_is_shard else n

    # ---- entry-driven capacity (see auto_capacity above) ----
    def _entry_capacity(self, n_entries: int) -> int:
        return entry_bucket_capacity(n_entries, self.entry_bucket_bits)

    def _set_capacity(self, cap: int):
        if self.raster_cfg.capacity_exact != cap:
            self.raster_cfg = replace(self.raster_cfg, capacity_exact=cap)

    @torch.no_grad()
    def _probe_entries(self, cam_arrays, width: int, height: int) -> int:
        """The view's true tile-list entry count, from preprocess alone."""
        p = self.state.params
        acts = activate(p)
        prep = preprocess(acts.xyz, acts.scales, acts.quats, acts.opacities, acts.shs,
                          self.active_sh_degree, cam_arrays, width, height,
                          self.raster_cfg.tile_w, self.raster_cfg.tile_h, alive=p.alive)
        return self._global_sum(prep.tiles_touched.sum())

    def _sharded_step(self, width: int, height: int, densify_stats: bool):
        key = (self.active_sh_degree, width, height, self.raster_cfg, densify_stats)
        if key not in self._sharded_steps:
            self._sharded_steps[key] = sharding.make_sharded_train_step(
                self.mesh, self.active_sh_degree, width, height, self.raster_cfg, self.opt,
                self.spatial_lr_scale, update_densify_stats=densify_stats)
        return self._sharded_steps[key]

    # ---- the loop ----
    def train(self, iterations: Optional[int] = None, progress: bool = False):
        total = iterations if iterations is not None else self.opt.iterations
        end = self.iteration + total
        while self.iteration < end:
            self.step()
            if progress and self.iteration % self.log_every == 0:
                m = self.history[-1]
                print(
                    f"it {self.iteration}: loss {m['loss']:.4f} psnr {m['psnr']:.2f} "
                    f"P {self.num_live} entries {int(m['num_entries'])}"
                )

    def step(self, defer_maintenance: bool = False) -> dict:
        """One optimization step. With defer_maintenance=True the caller
        must call post_step() afterwards: evaluation and saving hooks run in
        between, BEFORE densification and the opacity reset, in the
        reference's order (train.py:146-169)."""
        self.iteration += 1
        it = self.iteration

        # SH warm-up every 1000 iterations (train.py:100-101)
        if it % 1000 == 0 and self.active_sh_degree < self.sh_degree:
            self.active_sh_degree += 1

        cam_index = self._pop_camera()
        camera = self.cameras[cam_index]
        if self.opt.random_background:
            bg = torch.tensor(self.rng.uniform(size=3), dtype=torch.float32, device=self._dev)
        else:
            bg = self.background
        cam_arrays, gt = self._view(cam_index)

        if self.auto_capacity and self.raster_cfg.capacity_exact is None:
            n0 = self._probe_entries(cam_arrays, camera.width, camera.height)
            self._set_capacity(self._entry_capacity(n0))
        in_densify_window = it < self.opt.densify_until_iter
        names = METRIC_NAMES
        try:
            if self.mesh is None:
                metrics = train_step(
                    self.state, cam_arrays, gt, bg, it,
                    active_sh_degree=self.active_sh_degree,
                    width=camera.width,
                    height=camera.height,
                    raster_cfg=self.raster_cfg,
                    opt=self.opt,
                    spatial_lr_scale=self.spatial_lr_scale,
                    update_densify_stats=in_densify_window,
                )
            else:
                names = METRIC_NAMES + ("max_strip_entries",)
                step_fn = self._sharded_step(camera.width, camera.height, in_densify_window)
                metrics = step_fn(self.state, cam_arrays, gt, bg, it)
            # one wait for the device: every metric in one copy
            values = torch.stack([metrics[k].to(torch.float64) for k in names]).tolist()
        except Exception:
            if self.debug:
                self._dump_snapshot(it, camera, {"error": "step exception"})
                print(f"step raised; snapshot written to {self.debug_dump_path}")
            raise
        m = dict(zip(names, values))
        m["iteration"] = it
        self.history.append(m)

        if not math.isfinite(m["loss"]):
            self._dump_snapshot(it, camera, {"metrics": m})
            raise FloatingPointError(
                f"non-finite loss {m['loss']} at iteration {it}; snapshot "
                f"written to {self.debug_dump_path}"
            )

        # Grow the entry budget at once if the tile list overflowed (the
        # reference reallocates its arena, rasterize_points.cu:28-36). With
        # a mesh the largest strip is held to its 1/n share as well: a
        # skewed strip can overflow while the summed count fits.
        n_ranks = 1 if self.mesh is None else self.mesh.size
        need = max(int(m["num_entries"]), int(m.get("max_strip_entries", 0)) * n_ranks)
        self._entry_window_max = max(self._entry_window_max, need)
        n_rows = self.num_rows
        if need > self.raster_cfg.capacity(n_rows):
            if self.auto_capacity or self.raster_cfg.capacity_exact is not None:
                self._set_capacity(self._entry_capacity(need))
            else:
                mult = self.raster_cfg.capacity_mult
                while mult * n_rows < need:
                    mult *= 2
                self.raster_cfg = replace(self.raster_cfg, capacity_mult=mult)

        if not defer_maintenance:
            self.post_step()
        return m

    def _dump_snapshot(self, it: int, camera, extra: dict):
        """Pickle the step's inputs for offline repro: the JAX package's
        snapshot (iteration, camera uid, `extra`, and the live rows'
        parameters, moments and statistics when the device can still be
        read; with a mesh, this rank's rows)."""
        payload = dict(iteration=it, camera_uid=camera.uid, **extra)
        try:
            params, am, av, stats, _step = _state_to_host(self.state)
            payload.update(params=params, adam_m=am, adam_v=av, stats=stats)
        except RuntimeError as e:  # the device faulted in the failing step
            payload["state_unavailable"] = repr(e)
        with open(self.debug_dump_path, "wb") as f:
            pickle.dump(payload, f)

    def post_step(self):
        """The densification cadence (train.py:151-169); see step()."""
        it = self.iteration
        if it >= self.opt.densify_until_iter:
            return
        densify = it > self.opt.densify_from_iter and it % self.opt.densification_interval == 0
        reset = it % self.opt.opacity_reset_interval == 0 or (
            self.white_background and it == self.opt.densify_from_iter)
        if not (densify or reset):
            return
        with self._whole_state():
            if densify:
                size_threshold = 20 if it > self.opt.opacity_reset_interval else None
                live_before = max(self.num_live, 1)
                self._densify_and_prune(size_threshold)
                if self.auto_capacity:
                    # Re-fit the entry budget: the window's largest count
                    # scaled by the live-count growth (clones and splits add
                    # entries roughly in proportion); it shrinks when pruning
                    # dropped the count a bucket or more.
                    target = self._entry_window_max * self.num_live / live_before
                    self._set_capacity(self._entry_capacity(int(target)))
                    self._entry_window_max = 0
            if reset:
                self._reset_opacity()

    # ---- density control ----
    def _densify_and_prune(self, size_threshold):
        t0 = time.perf_counter()
        live_before, rows_before = self.num_live, self.state.params.num_points
        counts = self._densify_device(size_threshold) if self.device_densify else None
        path = "device"
        if counts is None:
            counts = self._densify_host(size_threshold)
            path = "host"
        live_after = self.num_live  # waits for the device
        self.densify_history.append(dict(
            iteration=self.iteration, path=path, live_before=live_before,
            live_after=live_after, rows_before=rows_before, capacity=self.state.params.num_points,
            ms=(time.perf_counter() - t0) * 1e3,
            **{k: counts[k] for k in ("n_cloned", "n_split", "n_pruned")}))

    def _densify_device(self, size_threshold) -> Optional[dict]:
        """The in-place densify at fixed capacity; its counts, or None when
        the children did not fit (the state is then unchanged)."""
        gen = torch.Generator(device=self._dev).manual_seed(
            self.seed * 1_000_003 + self.iteration)
        counts = densify_mod.densify_and_prune_device(
            self.state, gen,
            max_grad=self.opt.densify_grad_threshold,
            min_opacity=0.005,
            extent=self.cameras_extent,
            use_size_prune=size_threshold is not None,
            percent_dense=self.opt.percent_dense,
        )
        if counts["overflow"]:
            return None
        for k in STAT_NAMES:
            getattr(self.state, k).zero_()
        return counts

    def _densify_host(self, size_threshold) -> dict:
        params, m, v, stats, step = _state_to_host(self.state)
        res = densify_mod.densify_and_prune(
            params, m, v, stats["xyz_grad_accum"], stats["denom"], stats["max_radii2d"],
            max_grad=self.opt.densify_grad_threshold,
            min_opacity=0.005,
            extent=self.cameras_extent,
            max_screen_size=size_threshold,
            percent_dense=self.opt.percent_dense,
            rng=self.rng,
        )
        old_cap = self.state.params.num_points
        self.state = None  # free the old rows before the new ones are made
        self.state = _state_from_host(res.params, res.adam_m, res.adam_v, step, old_cap,
                                      self.min_capacity, self._dev)
        return dict(n_cloned=res.n_cloned, n_split=res.n_split, n_pruned=res.n_pruned)

    def _reset_opacity(self):
        """Opacity to at most 0.01, its moments zeroed; the densification
        statistics are kept (only a densify resets them)."""
        params, m, v, stats, step = _state_to_host(self.state)
        params, m, v = densify_mod.reset_opacity(params, m, v)
        old_cap = self.state.params.num_points
        self.state = None
        self.state = _state_from_host(params, m, v, step, old_cap, self.min_capacity,
                                      self._dev, stats=stats)

    # ---- checkpoints (train.py:178-180, gaussian_model.py:80-112) ----
    def save_checkpoint(self, path: str):
        """Pickle the live rows and the loop's scalars; with a mesh every rank
        must call it, and rank 0 writes the whole state."""
        with self._whole_state():
            params, m, v, stats, step = _state_to_host(self.state)
        if self.mesh is not None and self.mesh.rank != 0:
            return
        payload = dict(
            iteration=self.iteration,
            active_sh_degree=self.active_sh_degree,
            sh_degree=self.sh_degree,
            spatial_lr_scale=self.spatial_lr_scale,
            cameras_extent=self.cameras_extent,
            params=params,
            adam_m=m,
            adam_v=v,
            adam_step=step,
            stats=stats,
        )
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    def load_checkpoint(self, path: str):
        with open(path, "rb") as f:
            payload = pickle.load(f)
        self.iteration = payload["iteration"]
        self.active_sh_degree = payload["active_sh_degree"]
        self.sh_degree = payload["sh_degree"]
        self.spatial_lr_scale = payload["spatial_lr_scale"]
        self.cameras_extent = payload["cameras_extent"]
        self.state = None
        self.state = self._place(_state_from_host(
            payload["params"], payload["adam_m"], payload["adam_v"], payload["adam_step"],
            0, self.min_capacity, self._dev, stats=payload["stats"]))
