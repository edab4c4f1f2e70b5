"""Adaptive density control: clone / split / prune / opacity reset.

The counterpart of `gaussian_splatting_tpu/scene/densify.py`, which
implements the reference's densification (gaussian_model.py:500-602) in
two forms, both here:
- the host form, `densify_and_prune` and `reset_opacity`: numpy on
  live-row dicts, a copy of the JAX package's functions (that package
  cannot be imported without JAX), so the same inputs and the same
  `np.random.Generator` give the same bits;
- the device form, `densify_and_prune_device`: an in-place edit of a
  `TrainState` at fixed capacity, on the state's device. Children go into
  dead slots, and the edit is skipped (the state left bit for bit as it
  was) when they do not fit, so the caller can grow the capacity through
  the host form.

Semantics:
- clone: avg grad >= threshold AND max scale <= percent_dense * extent;
  the new rows' Adam moments are zero.
- split: avg grad >= threshold AND max scale > percent_dense * extent;
  N = 2 samples drawn from the Gaussian itself, scale / (0.8 N) = 1.6,
  originals pruned.
- prune: opacity < min_opacity, or (with a size threshold) max world
  scale > 0.1 * extent. (The reference also tests max_radii2D, which its
  densification postfix has just reset to zero, so that test never fires.)
- reset_opacity: opacity <- min(opacity, 0.01), the opacity moments zeroed.

The device form draws its split samples from a `torch.Generator`, so it is
reproducible but not the JAX package's stream (nor the reference's). It
rotates them by the normalized parent quaternion, as the host form and the
reference do (the JAX device form skips the normalization).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gaussian_splatting_torch.ops import gsmath
from gaussian_splatting_torch.scene.gaussians import PARAM_NAMES


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _inverse_sigmoid(x):
    return np.log(x / (1.0 - x))


def _quat_rotmats(q):
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((q.shape[0], 3, 3), np.float32)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - r * z)
    R[:, 0, 2] = 2 * (x * z + r * y)
    R[:, 1, 0] = 2 * (x * y + r * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - r * x)
    R[:, 2, 0] = 2 * (x * z - r * y)
    R[:, 2, 1] = 2 * (y * z + r * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


@dataclass
class DensifyResult:
    params: dict  # name -> (P_new, ...) live rows only
    adam_m: dict
    adam_v: dict
    n_cloned: int
    n_split: int
    n_pruned: int


def densify_and_prune(
    params: dict,  # name -> np array, live rows only (P, ...)
    adam_m: dict,
    adam_v: dict,
    grad_accum: np.ndarray,  # (P,)
    denom: np.ndarray,  # (P,)
    max_radii2d: np.ndarray,  # (P,)
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size,  # int or None
    percent_dense: float,
    rng: np.random.Generator,
    n_split_samples: int = 2,
) -> DensifyResult:
    """The host form: clone, then split, then prune, on live rows. Rows come
    back in the JAX package's order: survivors, clones, split children."""
    P = params["xyz"].shape[0]
    grads = np.where(denom > 0, grad_accum / np.maximum(denom, 1), 0.0)
    grads = np.nan_to_num(grads)

    scales_act = np.exp(params["scaling"])
    max_scale = scales_act.max(axis=1)

    # ---- clone (gaussian_model.py:543-563) ----
    clone_mask = (grads >= max_grad) & (max_scale <= percent_dense * extent)

    new_params = {k: np.concatenate([v, v[clone_mask]], axis=0) for k, v in params.items()}
    zeros_like_clone = {k: np.zeros_like(v[clone_mask]) for k, v in params.items()}
    new_m = {k: np.concatenate([adam_m[k], zeros_like_clone[k]]) for k in adam_m}
    new_v = {k: np.concatenate([adam_v[k], zeros_like_clone[k]]) for k in adam_v}
    n_cloned = int(clone_mask.sum())

    # ---- split (gaussian_model.py:500-541) ----
    # padded grads: new (cloned) rows have zero grad, so they never split.
    P1 = new_params["xyz"].shape[0]
    padded_grad = np.zeros((P1,), np.float32)
    padded_grad[:P] = grads
    scales1 = np.exp(new_params["scaling"])
    split_mask = (padded_grad >= max_grad) & (scales1.max(axis=1) > percent_dense * extent)
    n_split = int(split_mask.sum())

    if n_split > 0:
        N = n_split_samples
        stds = np.repeat(scales1[split_mask], N, axis=0)  # (N*S, 3)
        samples = rng.normal(0.0, 1.0, stds.shape).astype(np.float32) * stds
        rots = np.repeat(_quat_rotmats(new_params["rotation"][split_mask]), N, axis=0)
        base_xyz = np.repeat(new_params["xyz"][split_mask], N, axis=0)
        split_new = {
            "xyz": np.einsum("bij,bj->bi", rots, samples) + base_xyz,
            "scaling": np.log(np.repeat(scales1[split_mask], N, axis=0) / (0.8 * N)),
            "rotation": np.repeat(new_params["rotation"][split_mask], N, axis=0),
            "features_dc": np.repeat(new_params["features_dc"][split_mask], N, axis=0),
            "features_rest": np.repeat(new_params["features_rest"][split_mask], N, axis=0),
            "opacity": np.repeat(new_params["opacity"][split_mask], N, axis=0),
        }
        new_params = {k: np.concatenate([new_params[k], split_new[k]]) for k in new_params}
        new_m = {k: np.concatenate([new_m[k], np.zeros_like(split_new[k])]) for k in new_m}
        new_v = {k: np.concatenate([new_v[k], np.zeros_like(split_new[k])]) for k in new_v}
        # prune the split originals
        keep = np.ones((new_params["xyz"].shape[0],), bool)
        keep[:P1] = ~split_mask
        new_params = {k: v[keep] for k, v in new_params.items()}
        new_m = {k: v[keep] for k, v in new_m.items()}
        new_v = {k: v[keep] for k, v in new_v.items()}

    # ---- prune (gaussian_model.py:565-594) ----
    opacity_act = _sigmoid(new_params["opacity"][:, 0])
    prune_mask = opacity_act < min_opacity
    if max_screen_size:
        # max_radii2D is zero for every surviving point at this spot in the
        # reference; world-size pruning still applies.
        big_ws = np.exp(new_params["scaling"]).max(axis=1) > 0.1 * extent
        prune_mask = prune_mask | big_ws
    n_pruned = int(prune_mask.sum())
    keep = ~prune_mask
    new_params = {k: v[keep] for k, v in new_params.items()}
    new_m = {k: v[keep] for k, v in new_m.items()}
    new_v = {k: v[keep] for k, v in new_v.items()}

    return DensifyResult(
        params=new_params,
        adam_m=new_m,
        adam_v=new_v,
        n_cloned=n_cloned,
        n_split=n_split,
        n_pruned=n_pruned,
    )


def reset_opacity(params: dict, adam_m: dict, adam_v: dict):
    """opacity <- inverse_sigmoid(min(sigmoid(opacity), 0.01)); zero the
    opacity Adam moments (gaussian_model.py:310-321)."""
    op = _sigmoid(params["opacity"])
    params = dict(params)
    params["opacity"] = _inverse_sigmoid(np.minimum(op, 0.01)).astype(np.float32)
    adam_m = dict(adam_m)
    adam_v = dict(adam_v)
    adam_m["opacity"] = np.zeros_like(adam_m["opacity"])
    adam_v["opacity"] = np.zeros_like(adam_v["opacity"])
    return params, adam_m, adam_v


@torch.no_grad()
def densify_and_prune_device(
    state,  # training.TrainState, edited in place
    generator: torch.Generator,  # on the state's device
    max_grad: float,
    min_opacity: float,
    extent: float,
    use_size_prune: bool,
    percent_dense: float,
    n_split: int = 2,
) -> dict:
    """The device form: clone, split and prune `state`'s rows in place at
    its capacity, on its device. Children take dead slots in index order
    (the r-th child the r-th slot that is dead after this pass's splits and
    prunes); their Adam moments are zeroed. The statistics are left to the
    caller.

    Returns the counts {n_cloned, n_split, n_pruned, overflow}: clone and
    split parents, pruned originals, and 1 when the children do not fit the
    dead slots, in which case nothing was written. It waits for the device
    a few times: for the dead slots, the counts and each batch of children.
    """
    p = state.params
    alive = p.alive
    grads = torch.where(state.denom > 0,
                        state.xyz_grad_accum / torch.clamp_min(state.denom, 1.0), 0.0)
    grads = torch.nan_to_num(grads)
    scales = torch.exp(p.scaling)
    max_scale = scales.amax(dim=1)
    op_act = torch.sigmoid(p.opacity[:, 0])

    hot = alive & (grads >= max_grad)
    clone = hot & (max_scale <= percent_dense * extent)
    split = hot & (max_scale > percent_dense * extent)

    # prune on the originals (max_radii2D is zero here, see the module docstring)
    prune = op_act < min_opacity
    if use_size_prune:
        prune = prune | (max_scale > 0.1 * extent)
    keep_orig = alive & ~split & ~prune

    # children that survive this pass's prune: clones share the parent's
    # values; split children have scales / (0.8 N)
    clone_child = clone & ~prune
    child_scales = scales / (0.8 * n_split)
    child_prune = op_act < min_opacity
    if use_size_prune:
        child_prune = child_prune | (child_scales.amax(dim=1) > 0.1 * extent)
    split_child = split & ~child_prune

    n_children = clone_child.to(torch.int64) + split_child.to(torch.int64) * n_split
    child_end = torch.cumsum(n_children, 0)
    free_slots = torch.nonzero(~keep_orig).squeeze(1)  # ascending: the r-th dead slot
    n_total, n_cloned, n_split_parents, n_pruned = torch.stack(
        [child_end[-1], clone.sum(), split.sum(), (alive & prune).sum()]).tolist()
    overflow = n_total > free_slots.numel()
    counts = {"n_cloned": n_cloned, "n_split": n_split_parents, "n_pruned": n_pruned,
              "overflow": int(overflow)}
    if overflow:
        return counts

    # Every child's values come from the rows as they are now, all of them
    # before the first write: a child's slot may be a split original's or a
    # pruned row's, which can be the parent of a later child.
    eps = torch.randn((n_split, alive.shape[0], 3), generator=generator,
                      device=alive.device, dtype=torch.float32)
    child_off = child_end - n_children
    slots, values = [], {k: [] for k in PARAM_NAMES}
    for j in range(n_split):
        src = torch.nonzero((clone_child | split_child) if j == 0 else split_child).squeeze(1)
        slots.append(free_slots[child_off[src] + j])
        is_split = split_child[src][:, None]
        rot = gsmath.quat_to_rotmat(gsmath.normalize_quat(p.rotation[src]))
        offset = torch.einsum("pij,pj->pi", rot, eps[j][src] * scales[src])
        values["xyz"].append(torch.where(is_split, p.xyz[src] + offset, p.xyz[src]))
        values["scaling"].append(torch.where(
            is_split, torch.log(torch.clamp_min(child_scales[src], 1e-30)), p.scaling[src]))
        for k in ("features_dc", "features_rest", "rotation", "opacity"):
            values[k].append(getattr(p, k)[src])
    slot = torch.cat(slots)
    for k in PARAM_NAMES:
        getattr(p, k)[slot] = torch.cat(values[k])
        state.adam.m[k][slot] = 0.0
        state.adam.v[k][slot] = 0.0
    alive.copy_(keep_orig)
    alive[slot] = True
    return counts
