"""Gaussian rasterization: the public render op.

The counterpart of `gaussian_splatting_tpu/ops/rasterize.py`: preprocess
(`projection.py`) -> tile binning (`binning.py`) -> compositing.

`rasterize` is differentiable. Gradients reach means3d, scales, quats,
opacities, shs, mean2d_bias, colors_precomp, cov3d_precomp and bg: through
torch autograd of `preprocess`, and through the compositing op's
hand-written backward (`composite_cuda.composite_fwd`). Depths and tile
rects only order and bin the entries and take no gradient.

Backends:
  - "auto": the CUDA compositing kernels (forward, backward, gradient
    routing) for CUDA tensors, their plain torch versions for CPU tensors
    (`composite_cuda.composite_fwd`). On CUDA it launches the kernels or
    raises; it never falls back.
  - "reference": the brute-force oracle (`composite.render_bruteforce`;
    tests, small scenes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from gaussian_splatting_torch.ops import binning, composite
from gaussian_splatting_torch.ops.composite_cuda import composite_fwd
from gaussian_splatting_torch.ops.projection import preprocess
from gaussian_splatting_torch.scene.cameras import CameraArrays

BACKENDS = ("auto", "reference")


@dataclass(frozen=True)
class RasterizerConfig:
    """Static rasterizer configuration.

    tile_w/tile_h: screen tile size, 32x32 by default; the CUDA kernels take
      any tile of at most 4096 pixels (`composite.check_tile_geometry`).
    capacity_mult: tile-list capacity as a multiple of P. The true entry
      count comes back in aux["num_entries"]; past the capacity, whole
      trailing Gaussians are dropped from the image.
    capacity_exact: overrides capacity_mult when set.
    backend: see the module docstring.
    """

    tile_w: int = 32
    tile_h: int = 32
    capacity_mult: int = 8
    backend: str = "auto"
    capacity_exact: Optional[int] = None

    def capacity(self, num_points: int) -> int:
        cap = (
            self.capacity_exact
            if self.capacity_exact is not None
            else self.capacity_mult * num_points
        )
        return max(256, ((cap + 255) // 256) * 256)


def default_tile_geometry(converged: bool = True, training: bool = False) -> tuple:
    """The default tile geometry, 32x32, for every kind of render. Both
    arguments are ignored; the signature matches the JAX package's, whose
    32x32 choice was measured on a TPU. The port has not measured the
    alternatives on the card."""
    del converged, training
    return (32, 32)


def entry_bucket_capacity(n_entries: int, bits: int = 16, headroom: float = 1.2) -> int:
    """Bucketed tile-list capacity for a measured entry count: multiples of
    2^bits at scene scale, power-of-two buckets below that so tiny scenes
    don't pay a big floor."""
    want = max(256, int(n_entries * headroom))
    bucket = 1 << bits
    if want >= bucket:
        return -(-want // bucket) * bucket
    return 1 << (want - 1).bit_length()


def rasterize(
    means3d: torch.Tensor,  # (P, 3)
    scales: torch.Tensor,  # (P, 3) activated
    quats: torch.Tensor,  # (P, 4)
    opacities: torch.Tensor,  # (P,) or (P, 1) activated
    shs: Optional[torch.Tensor],  # (P, K, 3)
    sh_degree: int,
    cam: CameraArrays,
    width: int,
    height: int,
    bg,  # (3,)
    config: RasterizerConfig = RasterizerConfig(),
    scale_modifier: float = 1.0,
    mean2d_bias: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    return_aux: bool = True,
):
    """Render Gaussians to an (H, W, 3) image on the inputs' device.

    Returns (image, aux) where aux has radii (P,), visible (P,),
    final_t (H, W), num_entries (): the reference's
    {render, radii, visibility_filter} plus overflow accounting.
    """
    if config.backend not in BACKENDS:
        raise ValueError(f"backend {config.backend!r} not in {BACKENDS}")
    P = means3d.shape[0]
    opacities = opacities.reshape(P)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=means3d.device).reshape(3)

    prep = preprocess(
        means3d, scales, quats, opacities, shs, sh_degree, cam, width, height,
        config.tile_w, config.tile_h,
        scale_modifier=scale_modifier, mean2d_bias=mean2d_bias, alive=alive,
        colors_precomp=colors_precomp, cov3d_precomp=cov3d_precomp,
    )

    if config.backend == "reference":
        out = composite.render_bruteforce(prep, width, height, config.tile_w, config.tile_h, bg)
        num_entries = prep.tiles_touched.sum()
    else:
        grid_x = (width + config.tile_w - 1) // config.tile_w
        grid_y = (height + config.tile_h - 1) // config.tile_h
        lists = binning.build_tile_lists(
            prep.rect_min, prep.rect_max, prep.depths, prep.tiles_touched,
            grid_x, grid_y, config.capacity(P),
        )
        out = composite_fwd(
            lists, prep.means2d, prep.conic, prep.rgb, prep.opacity, bg,
            width, height, config.tile_w, config.tile_h,
        )
        num_entries = lists.total

    if not return_aux:
        return out.image
    aux = {
        "radii": prep.radii,
        "visible": prep.visible,
        "final_t": out.final_t,
        "num_entries": num_entries,
    }
    return out.image, aux


def mark_visible(positions: torch.Tensor, viewmatrix: torch.Tensor) -> torch.Tensor:
    """Frustum visibility mask (the reference's GaussianRasterizer.markVisible):
    camera-space z > 0.2, like the render-path cull."""
    p_view = positions @ viewmatrix[:3, :3].T + viewmatrix[:3, 3]
    return p_view[..., 2] > 0.2
