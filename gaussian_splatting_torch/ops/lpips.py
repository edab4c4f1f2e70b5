"""LPIPS perceptual metric (vgg / alex / squeeze backbones).

The counterpart of `gaussian_splatting_tpu/ops/lpips.py`, a reimplementation
of the reference's vendored lpipsPyTorch/ (modules/lpips.py, networks.py):
backbone features at the reference's capture points, unit-normalized
channel-wise, squared differences projected by the LPIPS v0.1 linear heads,
averaged over H and W and summed over stages. VGG16 (5 stages, what the
metrics CLI uses by default), AlexNet (5) and SqueezeNet1.1 (7, Fire
modules, ceil-mode pooling), as networks.py:66-98.

The convolutions and pools are PyTorch's (`F.conv2d`, `F.max_pool2d`): the
JAX package computes them with `lax.conv` outside any Pallas kernel. They
run in the inputs' dtype and device; callers that compare with float64
turn TF32 off, as the metrics CLI does.

Weights: the same `.npz` as the JAX package's, named by
$GS_TPU_LPIPS_WEIGHTS, with the same keys: vgg `conv{i}_w/b` (13 convs) +
`lin{j}_w` (5 heads); alex `alex_conv{i}_w/b` (5) + `alex_lin{j}_w` (5);
squeeze `sq_conv0_w/b`, `sq{f}_s_w/b` / `sq{f}_e1_w/b` / `sq{f}_e3_w/b`
(8 Fires) + `sq_lin{j}_w` (7). The repository ships none (the reference
downloads torchvision's and the LPIPS heads at run time). The JAX package's
`export_weights_from_torch`, which writes that file from torchvision, is
not ported: it needs torchvision and a download. `lpips_available(net)`
says whether a backbone can run. The loaded weights are cached per device
and dtype; `_load_weights.cache_clear()` drops them (after the variable
changes).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv layout: (out_channels, num convs) per stage before each pool.
_VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
# The z-score constants of the reference's BaseNet (lpipsPyTorch/modules/
# networks.py:41-44), the LPIPS v0.1 scaling layer, applied to [0, 1] inputs.
_NORM_MEAN = (-0.030, -0.088, -0.188)
_NORM_STD = (0.458, 0.448, 0.450)
# AlexNet.features convs (out_ch, kernel, stride, pad); captures after every
# ReLU, 3x3/2 pools after captures 0 and 1 (networks.py:77-85).
_ALEX_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
_NET_KEY0 = {"vgg": "conv0_w", "alex": "alex_conv0_w", "squeeze": "sq_conv0_w"}


@functools.lru_cache(maxsize=4)
def _load_weights(device: str = "cpu", dtype: torch.dtype = torch.float32) -> Optional[dict]:
    """The .npz named by $GS_TPU_LPIPS_WEIGHTS as tensors on `device` in
    `dtype`; None when the variable is unset or names no file."""
    path = os.environ.get("GS_TPU_LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as data:
        return {k: torch.tensor(data[k], dtype=dtype, device=device) for k in data.files}


def lpips_available(net_type: str = "vgg") -> bool:
    w = _load_weights()
    return w is not None and _NET_KEY0[net_type] in w


def _conv(x, w, prefix: str, stride: int = 1, pad: int = 1):
    return F.conv2d(x, w[f"{prefix}_w"], w[f"{prefix}_b"], stride=stride, padding=pad)


def _vgg_features(x, w):
    """5 stage activations (torchvision vgg16.features indices 3/8/15/22/29)."""
    feats, ci = [], 0
    for stage, (_, n_convs) in enumerate(_VGG_STAGES):
        for _ in range(n_convs):
            x = torch.relu(_conv(x, w, f"conv{ci}"))
            ci += 1
        feats.append(x)
        if stage < len(_VGG_STAGES) - 1:
            x = F.max_pool2d(x, 2, 2)
    return feats


def _alex_features(x, w):
    feats = []
    for i, (_, _, s, p) in enumerate(_ALEX_CONVS):
        x = torch.relu(_conv(x, w, f"alex_conv{i}", stride=s, pad=p))
        feats.append(x)
        if i < 2:
            x = F.max_pool2d(x, 3, 2)
    return feats


def _fire(x, w, f: int):
    """SqueezeNet Fire module: 1x1 squeeze -> relu -> (1x1 | 3x3 pad 1)
    expand -> relu -> channel concat (torchvision squeezenet1_1)."""
    s = torch.relu(_conv(x, w, f"sq{f}_s", pad=0))
    e1 = torch.relu(_conv(s, w, f"sq{f}_e1", pad=0))
    e3 = torch.relu(_conv(s, w, f"sq{f}_e3", pad=1))
    return torch.cat([e1, e3], dim=1)


def _squeeze_features(x, w):
    """SqueezeNet1.1 captures at target_layers [2, 5, 8, 10, 11, 12, 13]
    (networks.py:66-74): after the stem ReLU, then after Fires 1, 3, 4, 5,
    6, 7; 3x3/2 ceil-mode pools after captures 0, 1, 2."""
    x = torch.relu(_conv(x, w, "sq_conv0", stride=2, pad=0))
    feats = [x]
    x = F.max_pool2d(x, 3, 2, ceil_mode=True)
    x = _fire(_fire(x, w, 0), w, 1)
    feats.append(x)
    x = F.max_pool2d(x, 3, 2, ceil_mode=True)
    x = _fire(_fire(x, w, 2), w, 3)
    feats.append(x)
    x = F.max_pool2d(x, 3, 2, ceil_mode=True)
    for f in (4, 5, 6, 7):
        x = _fire(x, w, f)
        feats.append(x)
    return feats


_NETS = {
    "vgg": (_vgg_features, "lin{}_w", 5),
    "alex": (_alex_features, "alex_lin{}_w", 5),
    "squeeze": (_squeeze_features, "sq_lin{}_w", 7),
}


@torch.no_grad()
def lpips(img1: torch.Tensor, img2: torch.Tensor, net_type: str = "vgg") -> torch.Tensor:
    """img (H, W, 3) in [0, 1], both on one device in one floating dtype.
    The scalar LPIPS v0.1 distance under the backbone ('vgg' | 'alex' |
    'squeeze'), as lpipsPyTorch/modules/lpips.py:30-36, computed on the
    images' device in their dtype."""
    dev, dtype = img1.device, img1.dtype
    w = _load_weights(str(dev), dtype)
    if w is None or _NET_KEY0[net_type] not in w:
        raise RuntimeError(f"LPIPS '{net_type}' weights not available; set GS_TPU_LPIPS_WEIGHTS "
                           "to an .npz with that backbone's keys")
    features, lin_fmt, n_stages = _NETS[net_type]
    mean = torch.tensor(_NORM_MEAN, dtype=dtype, device=dev)
    std = torch.tensor(_NORM_STD, dtype=dtype, device=dev)

    def prep(img):
        return ((img - mean) / std).permute(2, 0, 1)[None]

    f1, f2 = features(prep(img1), w), features(prep(img2), w)
    if len(f1) != n_stages:
        raise RuntimeError(f"{net_type}: {len(f1)} stages, expected {n_stages}")
    total = torch.zeros((), dtype=dtype, device=dev)
    for j, (a, b) in enumerate(zip(f1, f2)):
        # normalize_activation (modules/utils.py:6-8): eps OUTSIDE the sqrt
        a = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)) + 1e-10)
        b = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True)) + 1e-10)
        d = (a - b) ** 2
        total = total + torch.mean(torch.sum(d * w[lin_fmt.format(j)].reshape(1, -1, 1, 1), dim=1))
    return total


def lpips_vgg(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """LPIPS with the VGG16 backbone (the reference's metrics.py:74)."""
    return lpips(img1, img2, "vgg")
