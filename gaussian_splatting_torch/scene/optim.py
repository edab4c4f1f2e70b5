"""Masked Adam with per-group learning rates, and the LR schedule.

The counterpart of `gaussian_splatting_tpu/scene/optim.py`, which copies
the reference's optimizer (gaussian_model.py:243-257): Adam with eps 1e-15,
betas 0.9 / 0.999, one learning rate per parameter group, bias correction,
and the Plenoxels-style log-lerp schedule (utils/general_utils.py:29-76).

Two differences from `torch.optim.Adam`, both the JAX package's: one
scalar step count for every group, and a row mask. Rows whose `alive` is
false (padding, pruned Gaussians) keep their parameters AND their moments;
torch's Adam would decay the moments of a row whose gradient is zero.

`adam_update` works in place on the module's parameters and on the moment
tensors, under `torch.no_grad()`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from gaussian_splatting_torch.scene.gaussians import PARAM_NAMES, GaussianParams


@dataclass
class AdamState:
    m: dict  # parameter name -> first moment, shaped like the parameter
    v: dict  # parameter name -> second moment
    step: int  # updates taken so far


def init_adam(params: GaussianParams) -> AdamState:
    return AdamState(
        m={k: torch.zeros_like(getattr(params, k)) for k in PARAM_NAMES},
        v={k: torch.zeros_like(getattr(params, k)) for k in PARAM_NAMES},
        step=0,
    )


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1000000) -> float:
    """Log-lerp LR schedule (general_utils.py:29-76), on the host."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    step = float(step)
    if step < 0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay_rate = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay_rate * math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


@torch.no_grad()
def adam_update(params: GaussianParams, grads: Mapping[str, torch.Tensor], state: AdamState,
                lrs: Mapping[str, float], alive: torch.Tensor, beta1: float = 0.9,
                beta2: float = 0.999, eps: float = 1e-15) -> None:
    """One masked Adam step, in place: `params`' parameters and `state`'s
    moments and step change. `grads` and `lrs` map parameter names to
    gradients and learning rates; rows with `alive` false stay as they are."""
    state.step += 1
    # The bias corrections in float32, as the JAX package computes them.
    t = np.float32(state.step)
    bc1 = float(np.float32(1.0) - np.float32(beta1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(beta2) ** t)
    for name in PARAM_NAMES:
        p, m, v = getattr(params, name), state.m[name], state.v[name]
        mask = alive.reshape((-1,) + (1,) * (p.ndim - 1))
        g = torch.where(mask, grads[name], 0.0)
        m_new = beta1 * m + (1 - beta1) * g
        v_new = beta2 * v + (1 - beta2) * g * g
        step = lrs[name] * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        p.copy_(torch.where(mask, p - step, p))
        m.copy_(torch.where(mask, m_new, m))
        v.copy_(torch.where(mask, v_new, v))
