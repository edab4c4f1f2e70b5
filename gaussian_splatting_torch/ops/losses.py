"""Training losses: L1, L2, SSIM, and the PSNR / MSE metrics.

The counterpart of `gaussian_splatting_tpu/ops/losses.py`, with the
reference's parameters (utils/loss_utils.py:17-63): SSIM over an 11x11
Gaussian window, sigma 1.5, zero ('same') padding, C1 = 0.01^2,
C2 = 0.03^2. Images are (..., H, W, C) float32, channel-last as in the JAX
package.

The window is the outer product of a 1-D Gaussian, so each windowed mean is
two depthwise 1-D convolutions (`conv2d` with one group per channel). On
the card, cuDNN runs a float32 convolution in TF32 unless
`torch.backends.cudnn.allow_tf32` is False; set it so for float32 SSIM.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred, gt):
    return (pred - gt).abs().mean()


def l2_loss(pred, gt):
    return ((pred - gt) ** 2).mean()


def mse(pred, gt):
    """Per-image MSE of a batch (N, H, W, C), or of one image (H, W, C)."""
    sq = (pred - gt) ** 2
    return sq.reshape(pred.shape[0], -1).mean(dim=1) if pred.ndim == 4 else sq.mean()


def psnr(pred, gt):
    return 20.0 * torch.log10(1.0 / torch.sqrt(((pred - gt) ** 2).mean()))


@functools.lru_cache(maxsize=None)
def _gaussian_1d(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Zero-padded 'same' 2-D Gaussian blur of (N, C, H, W), per channel."""
    C, r = x.shape[1], window.shape[0] // 2
    x = F.conv2d(x, window.view(1, 1, 1, -1).expand(C, 1, 1, -1), padding=(0, r), groups=C)
    return F.conv2d(x, window.view(1, 1, -1, 1).expand(C, 1, -1, 1), padding=(r, 0), groups=C)


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM over all pixels and channels (utils/loss_utils.py:33-63)."""
    H, W, C = img1.shape[-3:]
    window = torch.from_numpy(_gaussian_1d(window_size, sigma)).to(img1.device)
    x1 = img1.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    x2 = img2.reshape(-1, H, W, C).permute(0, 3, 1, 2)

    mu1 = _blur(x1, window)
    mu2 = _blur(x2, window)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur(x1 * x1, window) - mu1_sq
    sigma2_sq = _blur(x2 * x2, window) - mu2_sq
    sigma12 = _blur(x1 * x2, window) - mu1_mu2

    c1 = 0.01**2
    c2 = 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return ssim_map.mean()


def photometric_loss(pred, gt, lambda_dssim: float = 0.2):
    """(1 - lambda) L1 + lambda (1 - SSIM) (the reference's train.py:126-127)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (1.0 - ssim(pred, gt))
