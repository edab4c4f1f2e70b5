"""Column sums of a row-major (K, R) table: two CUDA kernels and their plain versions.

The counterparts of the consumer kernels of the JAX profiler's `gforms`
stage, which asked what a gathered (K, 16) table costs its consumer in each
memory form (`tools/profile_stages.py:396-491`):
  - `consume_rows` (`_sum_rows_kernel`): the column sums, (K, R) -> (1, R),
    reading row-major blocks;
  - `consume_t` (`_sum_t_kernel`): the same sums, (K, R) -> (R, 1), each
    block staged through shared memory as (R, rows) first.
Both are `csrc/consume.cu`: two launches per call (per-block partials, then
each column's partials summed in a fixed order), no atomics, so two runs
give the same bits; any K, 1 <= R <= 32.

Each wrapper runs its plain version on CPU tensors, which is the only
reason it ever does: on CUDA tensors it launches the kernels or raises.
Each has a `launches` attribute that counts its calls on the card.
"""

from __future__ import annotations

import torch

from gaussian_splatting_torch.utils import cuda_build

MAX_COLS = 32
ROWS_PER_BLOCK = 2048  # the kernels' first pass: one partial row per 2048 input rows
_ARGTYPES = (cuda_build.PTR, cuda_build.PTR, cuda_build.LONG, cuda_build.PTR, cuda_build.LONG,
             cuda_build.INT, cuda_build.INT, cuda_build.PTR)


def _check(x):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a tensor, got {type(x).__name__}")
    if x.dtype != torch.float32 or x.dim() != 2 or not 1 <= x.shape[1] <= MAX_COLS:
        raise ValueError(f"expected (K, R) float32 with 1 <= R <= {MAX_COLS}, "
                         f"got {tuple(x.shape)} {x.dtype}")


def consume_rows_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `consume_rows`: (K, R) -> (1, R) column sums."""
    return x.sum(0, keepdim=True)


def consume_t_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `consume_t`: (K, R) -> (R, 1) column sums."""
    return x.t().sum(1, keepdim=True)


def _launch(function: str, x: torch.Tensor, out_shape) -> torch.Tensor:
    _check(x)
    if x.device.type != "cuda":
        raise ValueError(f"x: on {x.device}, expected a CUDA device")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    k, r = x.shape
    dev = x.device
    partial_rows = -(-k // ROWS_PER_BLOCK)
    partials = torch.empty((max(partial_rows, 1), r), dtype=torch.float32, device=dev)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    cuda_build.launch("consume", function, _ARGTYPES, x.data_ptr(), partials.data_ptr(),
                      partials.shape[0], out.data_ptr(), k, r, dev.index,
                      torch.cuda.current_stream(dev).cuda_stream)
    return out


def consume_rows_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the row-major column-sum kernels on a contiguous (K, R) CUDA tensor."""
    out = _launch("gs_consume_rows", x, (1, x.shape[1]))
    consume_rows.launches += 1
    return out


def consume_t_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the transposed column-sum kernels on a contiguous (K, R) CUDA tensor."""
    out = _launch("gs_consume_t", x, (x.shape[1], 1))
    consume_t.launches += 1
    return out


def _on(x: torch.Tensor) -> str:
    _check(x)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the consumers run on CUDA or CPU tensors, not {x.device}")
    return x.device.type


def consume_rows(x: torch.Tensor) -> torch.Tensor:
    """(K, R) float32 -> (1, R) column sums: the kernels on CUDA tensors,
    the plain version on CPU tensors."""
    return consume_rows_torch(x) if _on(x) == "cpu" else consume_rows_cuda(x)


def consume_t(x: torch.Tensor) -> torch.Tensor:
    """(K, R) float32 -> (R, 1) column sums: the kernels on CUDA tensors,
    the plain version on CPU tensors."""
    return consume_t_torch(x) if _on(x) == "cpu" else consume_t_cuda(x)


consume_rows.launches = 0
consume_t.launches = 0
