"""The transpose and the column sums of the port against the JAX package.

Each kernel's plain version (the CPU twin of `csrc/relayout.cu` and
`csrc/consume.cu`) on the same numpy inputs as the TPU kernel, which runs
here in Pallas interpret mode:
  - `relayout_to_rows` against `gaussian_splatting_tpu/ops/relayout.py::
    relayout_to_rows` (whose output is padded to its block): the first K
    rows are equal, bit for bit (a transpose is a copy).
  - `consume_rows` / `consume_t` against the JAX profiler's
    `_sum_rows_kernel` / `_sum_t_kernel` (tools/profile_stages.py:427-467).
    Those kernels are closures inside a stage function, so they are
    restated here verbatim. Both sides sum float32 in their own order:
    each column within 1e-5 x the sum of |x| of a float64 sum.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gaussian_splatting_tpu.ops.relayout import relayout_to_rows as relayout_to_rows_jax
from gaussian_splatting_torch.ops.relayout import relayout_to_rows, relayout_to_rows_torch
from gaussian_splatting_torch.tools.consumers import (
    consume_rows, consume_rows_torch, consume_t, consume_t_torch,
)

BLK = 16384  # the tools kernels' block of rows
R = 16


# --- tools/profile_stages.py:427-467, verbatim but for interpret=True ---
def _sum_rows_kernel(x_ref, o_ref):
    @pl.when(pl.program_id(0) == 0)
    def _():
        o_ref[...] = jnp.zeros_like(o_ref)

    o_ref[...] += jnp.sum(x_ref[...], axis=0, keepdims=True)


def _consume_rows(x):  # (K, R) row-major Pallas consumer
    return pl.pallas_call(
        _sum_rows_kernel,
        grid=(x.shape[0] // BLK,),
        in_specs=[pl.BlockSpec((BLK, R), lambda b: (b, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, R), lambda b: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, R), jnp.float32),
        interpret=True,
    )(x)


def _sum_t_kernel(x_ref, o_ref):
    @pl.when(pl.program_id(0) == 0)
    def _():
        o_ref[...] = jnp.zeros_like(o_ref)

    o_ref[...] += jnp.sum(x_ref[...].T, axis=1, keepdims=True)


def _consume_t(x):  # (K, R) blocks transposed in-kernel to (R, BLK)
    return pl.pallas_call(
        _sum_t_kernel,
        grid=(x.shape[0] // BLK,),
        in_specs=[pl.BlockSpec((BLK, R), lambda b: (b, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((R, 1), lambda b: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R, 1), jnp.float32),
        interpret=True,
    )(x)
# --- end of the restated kernels ---


@pytest.mark.parametrize("rows", [9, 16])
@pytest.mark.parametrize("k", [256, 3000, 4096])
def test_relayout_matches_jax_bit_for_bit(rows, k):
    x = np.random.default_rng(k + rows).normal(size=(rows, k)).astype(np.float32)
    want = np.asarray(relayout_to_rows_jax(jnp.asarray(x)))[:k]
    before = relayout_to_rows.launches
    for got in (relayout_to_rows_torch(torch.from_numpy(x)), relayout_to_rows(torch.from_numpy(x))):
        assert got.shape == (k, rows) and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    assert relayout_to_rows.launches == before  # CPU tensors: the plain version, no launch


@pytest.mark.parametrize("form", ["rows", "t"])
def test_column_sums_match_the_tools_kernels(form):
    x = np.random.default_rng(7).normal(1.0, 2.0, size=(2 * BLK, R)).astype(np.float32)
    exact = x.astype(np.float64).sum(0)
    tol = 1e-5 * np.abs(x.astype(np.float64)).sum(0)
    jax_fn, plain, wrapper, shape = {
        "rows": (_consume_rows, consume_rows_torch, consume_rows, (1, R)),
        "t": (_consume_t, consume_t_torch, consume_t, (R, 1)),
    }[form]
    want = np.asarray(jax_fn(jnp.asarray(x)))
    assert want.shape == shape
    np.testing.assert_array_less(np.abs(want.reshape(R) - exact), tol)
    for got in (plain(torch.from_numpy(x)), wrapper(torch.from_numpy(x))):
        assert tuple(got.shape) == shape
        np.testing.assert_array_less(np.abs(got.numpy().astype(np.float64).reshape(R) - exact), tol)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="1 <= R <= 32"):
        relayout_to_rows(torch.zeros((33, 4)))
    with pytest.raises(ValueError, match="float32"):
        relayout_to_rows(torch.zeros((9, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="1 <= R <= 32"):
        consume_rows(torch.zeros((4, 40)))
    with pytest.raises(ValueError, match="float32"):
        consume_t(torch.zeros(16))
