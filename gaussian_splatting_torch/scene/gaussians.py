"""The learnable Gaussian scene state.

The counterpart of `gaussian_splatting_tpu/scene/gaussians.py`. There the
state is a padded pytree with an `alive` mask, because jit wants static
shapes; here it is an `nn.Module` of `nn.Parameter`s with `alive` as a
buffer, so checkpoints and parameters move between the two packages row
for row (`params_from_numpy`).

Parameter semantics match the reference (scene/gaussian_model.py):
- xyz: world positions (no activation)
- features_dc (N,1,3) / features_rest (N,K-1,3): SH coefficients
- scaling: log-scale (exp activation)
- rotation: unnormalized quaternion wxyz (normalized in build_cov3d)
- opacity: logit (sigmoid activation)
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from gaussian_splatting_torch.ops import gsmath, knn
from gaussian_splatting_torch.scene.ply import load_gaussians_ply
from gaussian_splatting_torch.utils.device import require_device

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


class GaussianParams(nn.Module):
    """Learnable parameters (raw, pre-activation). Leading dim = capacity.

    `alive` (N,) bool marks the real rows; padding rows render nothing.
    """

    def __init__(self, xyz, features_dc, features_rest, scaling, rotation, opacity,
                 alive: Optional[torch.Tensor] = None):
        super().__init__()
        self.xyz = nn.Parameter(xyz)  # (N, 3)
        self.features_dc = nn.Parameter(features_dc)  # (N, 1, 3)
        self.features_rest = nn.Parameter(features_rest)  # (N, K-1, 3)
        self.scaling = nn.Parameter(scaling)  # (N, 3) log-scale
        self.rotation = nn.Parameter(rotation)  # (N, 4) quaternion wxyz
        self.opacity = nn.Parameter(opacity)  # (N, 1) logit
        if alive is None:
            alive = torch.ones(xyz.shape[0], dtype=torch.bool, device=xyz.device)
        self.register_buffer("alive", alive)

    @property
    def num_points(self) -> int:
        return self.xyz.shape[0]


class GaussianActivations(NamedTuple):
    """Activated views handed to the rasterizer."""

    xyz: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor  # raw; the rasterizer normalizes (build_cov3d)
    opacities: torch.Tensor  # (N,)
    shs: torch.Tensor  # (N, K, 3)


def activate(params: GaussianParams) -> GaussianActivations:
    return GaussianActivations(
        xyz=params.xyz,
        scales=torch.exp(params.scaling),
        quats=params.rotation,
        opacities=torch.ravel(1.0 / (1.0 + torch.exp(-params.opacity))),
        shs=torch.cat([params.features_dc, params.features_rest], dim=1),
    )


def num_sh_coeffs(sh_degree: int) -> int:
    return (sh_degree + 1) ** 2


def capacity_bucket(n: int, minimum: int = 1024) -> int:
    """Capacity for n live Gaussians: next power of two."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


# Values of the rows past the live ones: log-scale and opacity logit -10
# make a dead row tiny and transparent.
PAD_FILLS = dict(xyz=0.0, features_dc=0.0, features_rest=0.0, scaling=-10.0, rotation=0.0,
                 opacity=-10.0)


@torch.no_grad()
def create_from_pcd(points: np.ndarray, colors: np.ndarray, sh_degree: int,
                    capacity: Optional[int] = None, device="cuda") -> GaussianParams:
    """Gaussians from a point cloud (the reference's gaussian_model.py:144-228),
    padded to `capacity` rows (default: `capacity_bucket(P)`) on `device`:
    - DC SH from the RGB colours in [0, 1], the other coefficients zero;
    - isotropic log-scale log(sqrt(d2)), d2 the mean squared distance to
      the 3 nearest neighbours clamped at 1e-7 (`ops/knn.py`);
    - identity rotation, opacity logit log(0.1 / 0.9).
    The returned module's `alive` marks the P point rows.
    """
    dev = require_device(device)
    P = points.shape[0]
    cap = capacity or capacity_bucket(P)
    K = num_sh_coeffs(sh_degree)
    dist2 = torch.clamp_min(knn.mean_knn_dist2(points, device=dev), 1e-7)
    live = {
        "xyz": torch.as_tensor(np.asarray(points, np.float32), device=dev),
        "features_dc": gsmath.rgb_to_sh(
            torch.as_tensor(np.asarray(colors, np.float32), device=dev))[:, None, :],
        "features_rest": torch.zeros((P, K - 1, 3), device=dev),
        "scaling": torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3),
        "rotation": torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(P, 1),
        "opacity": torch.full((P, 1), float(np.log(0.1 / 0.9)), device=dev),
    }
    rows = {}
    for k in PARAM_NAMES:
        rows[k] = torch.full((cap,) + live[k].shape[1:], PAD_FILLS[k], device=dev)
        rows[k][:P] = live[k]
    alive = torch.zeros((cap,), dtype=torch.bool, device=dev)
    alive[:P] = True
    return GaussianParams(**rows, alive=alive)


def repad(params_np: dict, alive_np: np.ndarray, capacity: int):
    """Re-pad a host-side numpy param dict to a (possibly larger) capacity."""
    n = alive_np.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < current rows {n}")

    def pad(x, fill):
        out = np.full((capacity,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    out = {k: pad(v, PAD_FILLS[k]) for k, v in params_np.items()}
    alive = np.zeros((capacity,), bool)
    alive[:n] = alive_np
    return out, alive


def params_from_numpy(params_np: Mapping[str, np.ndarray], alive=None,
                      device="cuda") -> GaussianParams:
    """Numpy parameters (the JAX package's `GaussianParams` fields, or the
    dict `load_gaussians_ply` returns) -> the port's `GaussianParams`."""
    dev = require_device(device)
    # Copies (torch.tensor), never views of the numpy input: training
    # updates the parameters in place.
    tensors = {
        k: torch.tensor(np.asarray(params_np[k], np.float32), device=dev)
        for k in PARAM_NAMES
    }
    if alive is not None:
        alive = torch.tensor(np.asarray(alive, bool), device=dev)
    return GaussianParams(**tensors, alive=alive)


def params_from_ply(path: str, sh_degree: int = 3, device="cuda") -> GaussianParams:
    """Load a reference-layout PLY model onto `device`."""
    dev = require_device(device)
    return params_from_numpy(load_gaussians_ply(path, sh_degree), device=dev)
