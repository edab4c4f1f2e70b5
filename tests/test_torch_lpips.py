"""The port's LPIPS (`gaussian_splatting_torch/ops/lpips.py`) and its
metrics CLI against the JAX package's, on seeded random weights.

No pretrained weights are in the repository, so, as tests/test_lpips.py
does, each backbone gets random weights of its real shapes, written to one
.npz that both packages read through $GS_TPU_LPIPS_WEIGHTS.

Tolerances: the distance within rel 1e-4 / abs 1e-6 of JAX's (both in
float32, convolutions summed in other orders); self-distance within 1e-6 of
0; the metrics CLIs' LPIPS within rel 1e-4 of each other on the same PNGs.
"""

import json

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import lpips as jlpips
from gaussian_splatting_torch.cli import metrics as metrics_cli
from gaussian_splatting_torch.ops import lpips as tlpips
from gaussian_splatting_torch.utils.image_io import write_png

from test_lpips import (
    make_random_alex_weights, make_random_squeeze_weights, make_random_weights,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

MAKERS = {"vgg": make_random_weights, "alex": make_random_alex_weights,
          "squeeze": make_random_squeeze_weights}


def _clear():
    jlpips._load_weights.cache_clear()
    tlpips._load_weights.cache_clear()


@pytest.fixture()
def all_weights(tmp_path, monkeypatch):
    """One .npz with all three backbones' random weights."""
    rng = np.random.default_rng(11)
    weights = {}
    for make in MAKERS.values():
        weights.update(make(rng))
    path = str(tmp_path / "lpips_rand.npz")
    np.savez(path, **weights)
    monkeypatch.setenv("GS_TPU_LPIPS_WEIGHTS", path)
    _clear()
    yield weights
    _clear()


@pytest.mark.parametrize("net", ["vgg", "alex", "squeeze"])
def test_lpips_matches_jax(all_weights, net):
    rng = np.random.default_rng(5)
    img1 = rng.uniform(size=(64, 96, 3)).astype(np.float32)
    img2 = np.clip(img1 + rng.normal(0, 0.1, img1.shape), 0, 1).astype(np.float32)
    assert tlpips.lpips_available(net)
    got = float(tlpips.lpips(torch.from_numpy(img1), torch.from_numpy(img2), net))
    want = float(jlpips.lpips(img1, img2, net))
    assert got == pytest.approx(want, rel=1e-4, abs=1e-6)
    assert got > 1e-5
    assert float(tlpips.lpips(torch.from_numpy(img1), torch.from_numpy(img1), net)) == \
        pytest.approx(0.0, abs=1e-6)
    if net == "vgg":
        assert float(tlpips.lpips_vgg(torch.from_numpy(img1), torch.from_numpy(img2))) == got


def test_lpips_float64_matches_float32(all_weights):
    """The same weights in float64 (the card's check in chip_smoke.py)."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.uniform(size=(40, 56, 3)))
    b = torch.clamp(a + 0.05 * torch.from_numpy(rng.normal(size=a.shape)), 0, 1)
    d64 = float(tlpips.lpips(a, b, "alex"))
    d32 = float(tlpips.lpips(a.float(), b.float(), "alex"))
    assert d32 == pytest.approx(d64, rel=1e-4)


def test_lpips_unavailable_without_weights(monkeypatch, tmp_path):
    monkeypatch.delenv("GS_TPU_LPIPS_WEIGHTS", raising=False)
    _clear()
    assert not any(tlpips.lpips_available(n) for n in MAKERS)
    x = torch.zeros((8, 8, 3))
    with pytest.raises(RuntimeError, match="not available"):
        tlpips.lpips(x, x)
    # per backbone: alex-only weights leave vgg unavailable
    path = str(tmp_path / "alex.npz")
    np.savez(path, **make_random_alex_weights(np.random.default_rng(1)))
    monkeypatch.setenv("GS_TPU_LPIPS_WEIGHTS", path)
    _clear()
    assert tlpips.lpips_available("alex") and not tlpips.lpips_available("vgg")
    _clear()


@pytest.mark.parametrize("net", ["vgg", "squeeze"])
def test_metrics_cli_matches_jax(all_weights, tmp_path, monkeypatch, net):
    """Both metrics CLIs on the same PNGs (written by the port's
    image_io): the same LPIPS, mean and per view, within rel 1e-4."""
    import sys

    from gaussian_splatting_tpu.cli import metrics as jmetrics_cli

    monkeypatch.setattr(sys, "stdout", sys.stdout)
    rng = np.random.default_rng(9)
    models = []
    for who in ("port", "jax"):
        model = tmp_path / who
        for kind in ("renders", "gt"):
            (model / "test" / "ours_7000" / kind).mkdir(parents=True)
        models.append(model)
    for i in range(2):
        a = (rng.uniform(size=(48, 64, 3)) * 255).astype(np.uint8)
        b = np.clip(a + rng.normal(0, 12, a.shape), 0, 255).astype(np.uint8)
        for model in models:
            write_png(str(model / "test" / "ours_7000" / "renders" / f"{i:05d}.png"), a)
            write_png(str(model / "test" / "ours_7000" / "gt" / f"{i:05d}.png"), b)

    metrics_cli.main(["-m", str(models[0]), "--lpips_net", net], device="cpu")
    jmetrics_cli.main(["-m", str(models[1]), "--lpips_net", net])
    ours = json.load(open(models[0] / "results.json"))["ours_7000"]
    theirs = json.load(open(models[1] / "results.json"))["ours_7000"]
    assert ours["LPIPS"] is not None and np.isfinite(ours["LPIPS"]) and ours["LPIPS"] > 0
    assert ours["LPIPS"] == pytest.approx(theirs["LPIPS"], rel=1e-4)
    pv = json.load(open(models[0] / "per_view.json"))["ours_7000"]["LPIPS"]
    jpv = json.load(open(models[1] / "per_view.json"))["ours_7000"]["LPIPS"]
    assert sorted(pv) == sorted(jpv) and len(pv) == 2
    for name in pv:
        assert pv[name] == pytest.approx(jpv[name], rel=1e-4)
