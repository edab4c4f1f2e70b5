"""The (R, K) -> (K, R) transpose: a CUDA kernel and its plain version.

The counterpart of `gaussian_splatting_tpu/ops/relayout.py::relayout_to_rows`
(whose Pallas kernel `_to_rows_kernel` pinned an XLA layout around the
backward's routing gathers) and of the JAX profiler's `pallas_transpose`
(`tools/profile_stages.py::tkern`). Both TPU kernels compute this function;
`csrc/relayout.cu` computes it on the card. The port's gradient routing
does not need it (`csrc/route_grads.cu` sums the rows directly); the
profiler (`tools/profile_stages.py`) times it at the routing's and the
micro-benchmarks' shapes.

`relayout_to_rows` runs the plain version (`relayout_to_rows_torch`) on CPU
tensors, which is the only reason it ever does: on CUDA tensors it launches
the kernel or raises. `relayout_to_rows.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from gaussian_splatting_torch.utils import cuda_build

MAX_ROWS = 32  # the kernel's shared tile holds up to 32 rows of each column
_ARGTYPES = (cuda_build.PTR, cuda_build.PTR, cuda_build.LONG, cuda_build.INT, cuda_build.INT,
             cuda_build.PTR)


def _check(x):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a tensor, got {type(x).__name__}")
    if x.dtype != torch.float32 or x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"expected (R, K) float32 with 1 <= R <= {MAX_ROWS}, "
                         f"got {tuple(x.shape)} {x.dtype}")


def relayout_to_rows_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the transpose kernel: (R, K) -> (K, R), contiguous."""
    return x.t().contiguous()


def relayout_to_rows_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the transpose kernel on a contiguous (R, K) float32 CUDA tensor."""
    _check(x)
    if x.device.type != "cuda":
        raise ValueError(f"x: on {x.device}, expected a CUDA device")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    r, k = x.shape
    out = torch.empty((k, r), dtype=torch.float32, device=x.device)
    if k == 0:
        return out
    dev = x.device
    cuda_build.launch("relayout", "gs_relayout_to_rows", _ARGTYPES, x.data_ptr(), out.data_ptr(),
                      k, r, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    relayout_to_rows.launches += 1
    return out


def relayout_to_rows(x: torch.Tensor) -> torch.Tensor:
    """(R, K) float32, 1 <= R <= 32, any K -> its (K, R) transpose, rows
    contiguous: the kernel on CUDA tensors, the plain version on CPU tensors.

    Unlike the JAX function, which pads its output to a multiple of its
    2048-wide block, this returns exactly K rows; the JAX callers read rows
    < K only (gaussian_splatting_tpu/ops/relayout.py:78-79)."""
    _check(x)
    if x.device.type == "cpu":
        return relayout_to_rows_torch(x)
    if x.device.type != "cuda":
        raise ValueError(f"relayout_to_rows runs on CUDA or CPU tensors, not {x.device}")
    return relayout_to_rows_cuda(x)


relayout_to_rows.launches = 0
