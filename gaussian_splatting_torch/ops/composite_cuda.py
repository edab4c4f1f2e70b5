"""The compositing kernels: bindings, launch counters, and the autograd op.

Three CUDA C++ kernels for Hopper, each built by `utils/cuda_build.py` at
first use and called through ctypes on PyTorch's current stream:
  - `csrc/composite_fwd.cu` replaces `gaussian_splatting_tpu/ops/
    composite_pallas.py::_fwd_kernel` (and the background epilogue of its
    `render_tiles_pallas`): the front-to-back blend.
  - `csrc/composite_bwd.cu` replaces `composite_pallas.py::_bwd_kernel`:
    the blend's VJP, one row of 9 gradients per entry.
  - `csrc/route_grads.cu` replaces `ops/relayout.py::_to_rows_kernel` at
    its one call site, the gradient routing: the per-Gaussian sums of
    those rows. The function of that kernel, the transpose, has its own
    counterpart: `csrc/relayout.cu` (`ops/relayout.py`).
Each source's header comment says what bounds it and how its design
answers that.

`composite_fwd` is the differentiable op the rasterizer calls; its
backward runs `composite_bwd` and then `route_grads`. Each of the three
wrappers runs its plain version (`ops/composite.py`) on CPU tensors, which
is the only reason it ever does: on CUDA tensors it launches its kernel or
raises. Each has a `launches` attribute that counts kernel launches, so a
run can show that it went through the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from gaussian_splatting_torch.ops.binning import TileLists
from gaussian_splatting_torch.ops.composite import (
    CompositeOut, composite_bwd_torch, composite_fwd_torch, route_grads_torch,
)
from gaussian_splatting_torch.utils import cuda_build

TILE_GEOMETRIES = ((32, 32), (32, 16), (16, 16))
_ptr, _int = cuda_build.PTR, cuda_build.INT
_ARGTYPES = {  # the C signature of each kernel's entry point `gs_<name>`
    "composite_fwd": (_ptr,) * 10 + (_int,) * 5 + (_ptr,),
    "composite_bwd": (_ptr,) * 14 + (_int,) * 5 + (_ptr,),
    "route_grads": (_ptr,) * 4 + (_int,) * 2 + (_ptr,),
}


def _launch(name: str, *args):
    cuda_build.launch(name, f"gs_{name}", _ARGTYPES[name], *args)


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_geometry(means2d, width, height, tile_w, tile_h):
    if (tile_w, tile_h) not in TILE_GEOMETRIES:
        raise ValueError(f"tile {tile_w}x{tile_h} unsupported; use one of {TILE_GEOMETRIES}")
    if width <= 0 or height <= 0:
        raise ValueError(f"image size {width}x{height} must be positive")
    if means2d.device.type != "cuda":
        raise ValueError(f"means2d: on {means2d.device}, expected a CUDA device")


def _check_scene(gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity,
                 width, height, tile_w, tile_h):
    """Checks the inputs both blend kernels share; returns their device."""
    _check_geometry(means2d, width, height, tile_w, tile_h)
    dev = means2d.device
    f32, i32 = torch.float32, torch.int32
    P = means2d.shape[0]
    num_tiles = ((width + tile_w - 1) // tile_w) * ((height + tile_h - 1) // tile_h)
    _check("gauss_id", gauss_id, i32, (gauss_id.shape[0],), dev)
    _check("tile_start", tile_start, i32, (num_tiles,), dev)
    _check("tile_stop", tile_stop, i32, (num_tiles,), dev)
    _check("means2d", means2d, f32, (P, 2), dev)
    _check("conic", conic, f32, (P, 3), dev)
    _check("rgb", rgb, f32, (P, 3), dev)
    _check("opacity", opacity, f32, (P,), dev)
    return dev


def composite_fwd_cuda(gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity,
                       bg, width: int, height: int, tile_w: int, tile_h: int) -> CompositeOut:
    """Launch the forward kernel on CUDA tensors; arguments as `composite_fwd_torch`."""
    dev = _check_scene(gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity,
                       width, height, tile_w, tile_h)
    _check("bg", bg, torch.float32, (3,), dev)
    image = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    final_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (gauss_id, tile_start, tile_stop, means2d, conic, rgb,
                                   opacity, bg, image, final_t)]
    _launch("composite_fwd", *ptrs, width, height, tile_w, tile_h, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    composite_fwd.launches += 1
    return CompositeOut(image=image, final_t=final_t)


def composite_bwd_cuda(gauss_id, tile_start, tile_stop, entry_src, means2d, conic, rgb,
                       opacity, image, final_t, g_image, g_final_t,
                       width: int, height: int, tile_w: int, tile_h: int,
                       replay_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the backward kernel on CUDA tensors; arguments and result as
    `composite_bwd_torch`. `replay_t`, if given, is an (H, W) float32 tensor
    the kernel fills with the final transmittance of its replay of the
    forward, which must equal the forward's `final_t` bit for bit."""
    dev = _check_scene(gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity,
                       width, height, tile_w, tile_h)
    f32 = torch.float32
    K = gauss_id.shape[0]
    _check("entry_src", entry_src, torch.int32, (K,), dev)
    for name, t, shape in (("image", image, (height, width, 3)),
                           ("final_t", final_t, (height, width)),
                           ("g_image", g_image, (height, width, 3)),
                           ("g_final_t", g_final_t, (height, width))):
        _check(name, t, f32, shape, dev)
    if replay_t is not None:
        _check("replay_t", replay_t, f32, (height, width), dev)
    rows = torch.empty((K, 9), dtype=f32, device=dev)
    ptrs = [t.data_ptr() for t in (gauss_id, tile_start, tile_stop, entry_src, means2d, conic,
                                   rgb, opacity, image, final_t, g_image, g_final_t, rows)]
    _launch("composite_bwd", *ptrs, None if replay_t is None else replay_t.data_ptr(),
            width, height, tile_w, tile_h, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    composite_bwd.launches += 1
    return rows


def route_grads_cuda(rows, gauss_offset, gauss_count, num_points: int) -> torch.Tensor:
    """Launch the routing kernel on CUDA tensors; arguments and result as
    `route_grads_torch`."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"rows: on {dev}, expected a CUDA device")
    _check("rows", rows, torch.float32, (rows.shape[0], 9), dev)
    _check("gauss_offset", gauss_offset, torch.int32, (num_points,), dev)
    _check("gauss_count", gauss_count, torch.int32, (num_points,), dev)
    out = torch.empty((num_points, 9), dtype=torch.float32, device=dev)
    if num_points == 0:
        return out
    _launch("route_grads", rows.data_ptr(), gauss_offset.data_ptr(), gauss_count.data_ptr(),
            out.data_ptr(), num_points, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    route_grads.launches += 1
    return out


def _on(dev: torch.device) -> str:
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"compositing runs on CUDA or CPU tensors, not {dev}")
    return dev.type


def composite_bwd(gauss_id, tile_start, tile_stop, entry_src, means2d, *rest) -> torch.Tensor:
    """Per-entry gradient rows: the kernel on CUDA tensors, the plain
    version on CPU tensors; arguments as `composite_bwd_torch`."""
    args = (gauss_id, tile_start, tile_stop, entry_src, means2d, *rest)
    if _on(means2d.device) == "cpu":
        return composite_bwd_torch(*args)
    return composite_bwd_cuda(*args)


def route_grads(rows, gauss_offset, gauss_count, num_points: int) -> torch.Tensor:
    """Per-Gaussian sums of the entry rows: the kernel on CUDA tensors, the
    plain version (`route_grads_torch`) on CPU tensors."""
    if _on(rows.device) == "cpu":
        return route_grads_torch(rows, gauss_offset, gauss_count, num_points)
    return route_grads_cuda(rows, gauss_offset, gauss_count, num_points)


class _Composite(torch.autograd.Function):
    """The blend with its hand-written VJP. Gradients reach means2d, conic,
    rgb, opacity and bg; the tile lists are integers and take none (the
    blend order is piecewise constant in depth, as in the JAX package)."""

    @staticmethod
    def forward(ctx, means2d, conic, rgb, opacity, bg, lists: TileLists,
                width, height, tile_w, tile_h):
        args = (lists.gauss_id, lists.tile_start, lists.tile_stop, means2d, conic, rgb,
                opacity, bg, width, height, tile_w, tile_h)
        if _on(means2d.device) == "cpu":
            out = composite_fwd_torch(*args)
        else:
            out = composite_fwd_cuda(*args)
        ctx.save_for_backward(means2d, conic, rgb, opacity, out.image, out.final_t,
                              lists.gauss_id, lists.tile_start, lists.tile_stop,
                              lists.entry_src, lists.gauss_offset, lists.gauss_count)
        ctx.geometry = (width, height, tile_w, tile_h)
        return out.image, out.final_t

    @staticmethod
    def backward(ctx, g_image, g_final_t):
        # Autograd hands zeros for an output that took no gradient (final_t,
        # in training).
        (means2d, conic, rgb, opacity, image, final_t, gauss_id, tile_start, tile_stop,
         entry_src, gauss_offset, gauss_count) = ctx.saved_tensors
        g_image, g_final_t = g_image.contiguous(), g_final_t.contiguous()
        rows = composite_bwd(gauss_id, tile_start, tile_stop, entry_src, means2d, conic, rgb,
                             opacity, image, final_t, g_image, g_final_t, *ctx.geometry)
        sums = route_grads(rows, gauss_offset, gauss_count, means2d.shape[0])
        d_bg = (g_image * final_t[..., None]).sum(dim=(0, 1))
        return (sums[:, 0:2], sums[:, 2:5], sums[:, 5:8], sums[:, 8], d_bg,
                None, None, None, None, None)


def composite_fwd(lists: TileLists, means2d, conic, rgb, opacity, bg,
                  width: int, height: int, tile_w: int, tile_h: int) -> CompositeOut:
    """Composite sorted tile entries into (image (H,W,3), final_t (H,W)),
    differentiably. CUDA tensors go through the kernels, CPU tensors
    through their plain versions; anything else raises."""
    image, final_t = _Composite.apply(means2d, conic, rgb, opacity, bg, lists,
                                      width, height, tile_w, tile_h)
    return CompositeOut(image=image, final_t=final_t)


composite_fwd.launches = 0
composite_bwd.launches = 0
route_grads.launches = 0
