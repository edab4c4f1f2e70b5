"""The train step, its state, and rendering from raw parameters.

The counterpart of `gaussian_splatting_tpu/training.py`: `train_step`
renders, computes (1 - lambda) L1 + lambda (1 - SSIM), backpropagates
through the rasterizer (whose compositing backward and gradient routing
are CUDA kernels on the card), applies the masked Adam update and
accumulates the densification statistics. The reference's
screenspace-points `retain_grad` trick is an explicit zero `mean2d_bias`
whose gradient (dL / d NDC mean) feeds the statistics, as in the JAX
package.

Unlike the JAX step, which is a pure function of its state, `train_step`
updates the state in place (parameters, moments, statistics), PyTorch's
idiom. The host loop around it is `trainer.Trainer`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, NamedTuple

import numpy as np
import torch

from gaussian_splatting_torch.ops import gsmath, losses
from gaussian_splatting_torch.ops.rasterize import RasterizerConfig, rasterize
from gaussian_splatting_torch.scene.cameras import CameraArrays
from gaussian_splatting_torch.scene.gaussians import (
    PARAM_NAMES, GaussianParams, activate, params_from_numpy,
)
from gaussian_splatting_torch.scene.optim import AdamState, adam_update, expon_lr, init_adam


@dataclass(frozen=True)
class OptimizationConfig:
    """Defaults mirror the reference's arguments/__init__.py:89-108 verbatim."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False


@dataclass
class TrainState:
    """Parameters (with their `alive` mask), Adam state and the per-row
    densification statistics, all on one device."""

    params: GaussianParams
    adam: AdamState
    max_radii2d: torch.Tensor  # (N,) f32
    xyz_grad_accum: torch.Tensor  # (N,) f32
    denom: torch.Tensor  # (N,) f32


class StepGrads(NamedTuple):
    loss: torch.Tensor  # ()
    l1: torch.Tensor  # ()
    image: torch.Tensor  # (H, W, 3), detached
    aux: dict  # rasterize's aux
    grads: dict  # parameter name -> gradient
    bias_grad: torch.Tensor  # (N, 2): dL / d NDC mean


def init_train_state(params: GaussianParams) -> TrainState:
    N, dev = params.num_points, params.xyz.device
    zeros = lambda: torch.zeros((N,), dtype=torch.float32, device=dev)  # noqa: E731
    return TrainState(params=params, adam=init_adam(params), max_radii2d=zeros(),
                      xyz_grad_accum=zeros(), denom=zeros())


def train_state_from_numpy(params: Mapping[str, np.ndarray], m: Mapping[str, np.ndarray],
                           v: Mapping[str, np.ndarray], step: int, alive,
                           max_radii2d, xyz_grad_accum, denom, device="cuda") -> TrainState:
    """A training state from numpy arrays: the JAX package's `TrainState`
    fields (parameters, Adam m / v / step, alive and the three statistics),
    so a run can continue on the port from a JAX checkpoint. The arrays are
    copied: the train step updates the state in place."""
    p = params_from_numpy(params, alive=alive, device=device)
    dev = p.xyz.device
    as_t = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    adam = AdamState(m={k: as_t(m[k]) for k in PARAM_NAMES},
                     v={k: as_t(v[k]) for k in PARAM_NAMES}, step=int(step))
    return TrainState(params=p, adam=adam, max_radii2d=as_t(max_radii2d),
                      xyz_grad_accum=as_t(xyz_grad_accum), denom=as_t(denom))


def loss_and_grads(params: GaussianParams, cam: CameraArrays, gt_image: torch.Tensor, bg,
                   active_sh_degree: int, width: int, height: int,
                   raster_cfg: RasterizerConfig, lambda_dssim: float) -> StepGrads:
    """Render, the photometric loss, and its gradients with respect to every
    parameter and to a zero `mean2d_bias` (the densification signal)."""
    bias = torch.zeros((params.num_points, 2), dtype=torch.float32, device=params.xyz.device,
                       requires_grad=True)
    acts = activate(params)
    img, aux = rasterize(
        acts.xyz, acts.scales, acts.quats, acts.opacities, acts.shs, active_sh_degree,
        cam, width, height, bg, raster_cfg, mean2d_bias=bias, alive=params.alive,
    )
    l1 = losses.l1_loss(img, gt_image)
    loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - losses.ssim(img, gt_image))
    *grads, bias_grad = torch.autograd.grad(
        loss, [getattr(params, k) for k in PARAM_NAMES] + [bias])
    return StepGrads(loss=loss.detach(), l1=l1.detach(), image=img.detach(), aux=aux,
                     grads=dict(zip(PARAM_NAMES, grads)), bias_grad=bias_grad)


def train_step(
    state: TrainState,
    cam: CameraArrays,
    gt_image: torch.Tensor,  # (H, W, 3)
    bg,  # (3,)
    iteration: int,  # 1-based, like the reference
    active_sh_degree: int,
    width: int,
    height: int,
    raster_cfg: RasterizerConfig,
    opt: OptimizationConfig,
    spatial_lr_scale: float,
    update_densify_stats: bool = True,
) -> dict:
    """One optimization step, IN PLACE: `state`'s parameters, Adam moments
    and step, and (if `update_densify_stats`) its statistics are updated.
    Returns the metrics dict of the JAX step (loss, l1, psnr of the clamped
    image, num_entries, num_visible) as device tensors, so the step does not
    wait for the card."""
    out = loss_and_grads(state.params, cam, gt_image, bg, active_sh_degree, width, height,
                         raster_cfg, opt.lambda_dssim)

    # --- per-group learning rates (gaussian_model.py:243-257) ---
    lrs = {
        "xyz": expon_lr(iteration, opt.position_lr_init * spatial_lr_scale,
                        opt.position_lr_final * spatial_lr_scale,
                        lr_delay_mult=opt.position_lr_delay_mult,
                        max_steps=opt.position_lr_max_steps),
        "features_dc": opt.feature_lr,
        "features_rest": opt.feature_lr / 20.0,
        "scaling": opt.scaling_lr,
        "rotation": opt.rotation_lr,
        "opacity": opt.opacity_lr,
    }
    adam_update(state.params, out.grads, state.adam, lrs, state.params.alive)

    visible = out.aux["visible"]
    # --- densification statistics (train.py:153-159) ---
    if update_densify_stats:
        with torch.no_grad():
            radii = out.aux["radii"].to(torch.float32)
            state.max_radii2d.copy_(torch.where(
                visible, torch.maximum(state.max_radii2d, radii), state.max_radii2d))
            grad_norm = torch.linalg.vector_norm(out.bias_grad, dim=-1)
            state.xyz_grad_accum.add_(torch.where(visible, grad_norm, 0.0))
            state.denom.add_(visible.to(torch.float32))

    return {
        "loss": out.loss,
        "l1": out.l1,
        "psnr": losses.psnr(torch.clamp(out.image, 0.0, 1.0), gt_image),
        "num_entries": out.aux["num_entries"],
        "num_visible": visible.sum(),
    }


@torch.no_grad()
def eval_render(
    params: GaussianParams,
    cam: CameraArrays,
    bg,
    active_sh_degree: int,
    width: int,
    height: int,
    raster_cfg: RasterizerConfig = RasterizerConfig(),
    scale_modifier: float = 1.0,
    shs_python: bool = False,
    rot_scale_python: bool = False,
):
    """Render from raw params (viewer and eval path); returns (image, aux)
    as `rasterize` does. Rows with `params.alive` false render nothing.

    `scale_modifier` is the SIBR slider the reference threads through
    render(). `shs_python` / `rot_scale_python` are the SIBR debug toggles
    (the reference's convert_SHs_python / compute_cov3D_python): colors /
    3D covariances are computed here in plain torch and fed through the
    rasterizer's precomp inputs instead of its own preprocess; the images
    match the default path.

    Unlike the JAX function, `alive` is the module's buffer rather than an
    argument, and the unused `sh_degree` argument is gone.
    """
    acts = activate(params)
    colors_precomp = None
    cov3d_precomp = None
    shs = acts.shs
    if shs_python:
        colors_precomp = gsmath.sh_to_rgb(active_sh_degree, acts.shs, acts.xyz, cam.campos)
        shs = None
    if rot_scale_python:
        # scale_modifier folds into the covariance, as the reference's
        # build_covariance_from_scaling_rotation does.
        cov3d_precomp = gsmath.build_cov3d(acts.scales, acts.quats, scale_modifier)
    return rasterize(
        acts.xyz, acts.scales, acts.quats, acts.opacities, shs,
        active_sh_degree, cam, width, height, bg, raster_cfg, alive=params.alive,
        scale_modifier=scale_modifier,
        colors_precomp=colors_precomp, cov3d_precomp=cov3d_precomp,
    )
