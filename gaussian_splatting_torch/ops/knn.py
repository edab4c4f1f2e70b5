"""Mean squared distance to the 3 nearest neighbours, for the initial scales.

The counterpart of `gaussian_splatting_tpu/ops/knn.py`, itself the
equivalent of the reference's simple-knn (`distCUDA2`): the mean of each
point's 3 smallest squared distances to the other points. Two forms, both
plain torch on the points' device:
- exact: chunked brute force over every pair, up to 20,000 points;
- Morton: 10-bit-per-axis Morton codes over the bounding box, a stable
  sort, and the 3 smallest among the +-16 neighbours in Morton order, an
  approximation in the reference's spirit (it only sets each Gaussian's
  initial log-scale).

The JAX dispatcher prefers a native host sweep (`native/gs_native.cc`)
above 20,000 points when that extension is built; the port keeps the
dispatch the JAX package takes without it, exact or Morton.
"""

from __future__ import annotations

import torch

from gaussian_splatting_torch.utils.device import require_device

EXACT_MAX_POINTS = 20_000


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of v over 30 bits (Morton interleave helper).

    int64 throughout: every product stays below 2^41, and each mask keeps
    the low 32 bits the JAX package's uint32 products wrap to.
    """
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """(P, 3) float32 -> (P,) int64 Morton codes (< 2^30) over the bounding box."""
    pmin = points.amin(dim=0)
    pmax = points.amax(dim=0)
    extent = torch.clamp_min(pmax - pmin, 1e-9)
    q = torch.clamp((points - pmin) / extent, 0.0, 1.0)
    grid = (q * 1023.0).to(torch.int64)  # truncates, as astype(uint32) does
    x = _expand_bits(grid[:, 0])
    y = _expand_bits(grid[:, 1])
    z = _expand_bits(grid[:, 2])
    return (x << 2) | (y << 1) | z


def _mean_finite(d2: torch.Tensor) -> torch.Tensor:
    """Mean of each row's finite entries (0 where none is finite)."""
    finite = torch.isfinite(d2)
    n = finite.sum(dim=-1).clamp_min(1)
    return torch.where(finite, d2, 0.0).sum(dim=-1) / n


def mean_knn_dist2_morton(points: torch.Tensor, window: int = 16, k: int = 3) -> torch.Tensor:
    """Mean squared distance to the (approximate) k nearest neighbours: the
    k smallest among the +-`window` neighbours in Morton order."""
    P = points.shape[0]
    # Stable, as jnp.argsort: points with tied codes keep their index order,
    # which decides the candidates each of them sees.
    order = torch.argsort(morton_codes(points), stable=True)
    sorted_pts = points[order]
    pos = torch.arange(P, device=points.device)
    d2s = []
    for off in range(1, window + 1):
        for sign in (-1, 1):
            nb = pos + sign * off
            diff = sorted_pts - sorted_pts[nb.clamp(0, P - 1)]
            d2 = torch.sum(diff * diff, dim=-1)
            d2s.append(torch.where((nb >= 0) & (nb < P), d2, torch.inf))
    cand = torch.stack(d2s, dim=-1)  # (P, 2 * window)
    nearest = torch.topk(cand, k, dim=-1, largest=False).values
    out = torch.empty_like(points[:, 0])
    out[order] = _mean_finite(nearest)
    return out


def mean_knn_dist2_exact(points: torch.Tensor, k: int = 3, chunk: int = 1024) -> torch.Tensor:
    """Exact mean of the k smallest squared distances to the other points,
    in chunks of `chunk` query points. The differences are formed and
    squared (not |a|^2 + |b|^2 - 2ab, which loses the small distances)."""
    P = points.shape[0]
    out = torch.empty_like(points[:, 0])
    cols = torch.arange(P, device=points.device)
    for base in range(0, P, chunk):
        q = points[base:base + chunk]
        d2 = torch.sum((q[:, None, :] - points[None, :, :]) ** 2, dim=-1)  # (C, P)
        rows = base + torch.arange(q.shape[0], device=points.device)
        d2 = torch.where(cols[None, :] == rows[:, None], torch.inf, d2)
        out[base:base + chunk] = torch.topk(d2, k, dim=-1, largest=False).values.mean(dim=-1)
    return out


def mean_knn_dist2(points, k: int = 3, device="cuda") -> torch.Tensor:
    """distCUDA2's equivalent: each point's mean squared distance to its k
    nearest neighbours, (P,) float32 on `device`. Exact up to 20,000
    points, the Morton window above."""
    pts = torch.as_tensor(points, dtype=torch.float32, device=require_device(device))
    if pts.shape[0] <= EXACT_MAX_POINTS:
        return mean_knn_dist2_exact(pts, k=k)
    return mean_knn_dist2_morton(pts, k=k)
