"""The port's bench (`gaussian_splatting_torch/cli/bench.py`, run as the
repo root's `bench_torch.py`) against `bench.py` and the JAX package, on the
CPU at a small size (GS_BENCH_W=64, _H=48, P=300 for cloud and shell).

Tolerances:
  - the scenes (`bench_scene`): bit-equal to bench.py:168-221's draws from
    np.random.default_rng(0) (transcribed below with bench.py's jnp casts),
    and for `ply` to the JAX package's `load_gaussians_ply` with bench.py's
    activations;
  - the capacity (`bench_capacity`): equal to bench.py's formula on the JAX
    package's `preprocess(...).tiles_touched.sum()`;
  - one render at the bench's camera: image and final T within atol 2e-5
    of the JAX `rasterize(backend="xla")` (test_torch_render.py's rule: the
    JAX package blends in log-space transmittance);
  - one train step at the bench's train inputs (the camera at T = (0, 0,
    4), the rng(1) uniform target, every row alive, OptimizationConfig(),
    iteration 2): the loss, L1 and PSNR within rtol 1e-5 of the JAX
    `train_step`, the entry and visible counts equal; the gradients within
    2e-3 x the group's max |g| (the rasterizer bound of
    test_torch_train.py); the new parameters within 1e-2 x the group's
    learning rate where |g| > 1e-3 x max |g| (Adam's first step moves every
    coordinate by about lr x sign(g), so a coordinate whose gradient is
    rounding noise may move either way: test_torch_train.py's rule).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu import training as jtraining
from gaussian_splatting_tpu.ops import losses as jlosses
from gaussian_splatting_tpu.ops.projection import preprocess as jax_preprocess
from gaussian_splatting_tpu.ops.rasterize import RasterizerConfig as JaxConfig
from gaussian_splatting_tpu.ops.rasterize import rasterize as jax_rasterize
from gaussian_splatting_tpu.scene.cameras import Camera as JaxCamera
from gaussian_splatting_tpu.scene.gaussians import GaussianParams as JaxParams
from gaussian_splatting_tpu.scene.gaussians import activate as jax_activate
from gaussian_splatting_tpu.scene.ply import load_gaussians_ply as jax_load_ply
from gaussian_splatting_torch import RasterizerConfig, rasterize
from gaussian_splatting_torch.cli import bench
from gaussian_splatting_torch.scene.gaussians import PARAM_NAMES
from gaussian_splatting_torch.scene.optim import expon_lr
from gaussian_splatting_torch.training import (
    OptimizationConfig, init_train_state, loss_and_grads, train_step,
)

from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

W, H, P = 64, 48, 300
TRAINED_PLY = os.path.join(os.path.dirname(__file__), "..", "assets", "trained_r5.ply")
SMALL_PLY = os.path.join(os.path.dirname(__file__), "fixtures", "golden_gaussians.ply")


def bench_py_scene(scene, P, ply=TRAINED_PLY):
    """bench.py:168-221, transcribed: its draws from default_rng(0) in its
    order, its activations and its jnp float32 casts; (means, scales,
    quats, opacities, shs) as numpy, and the camera distance."""
    rng = np.random.default_rng(0)
    shs = None
    if scene == "ply":
        raw = jax_load_ply(ply)
        means_np = raw["xyz"]
        center = means_np.mean(axis=0)
        radius = float(np.quantile(np.linalg.norm(means_np - center, axis=1), 0.95))
        means = jnp.asarray(means_np - center, jnp.float32)
        scales = jnp.asarray(np.exp(raw["scaling"]), jnp.float32)
        quats = jnp.asarray(raw["rotation"], jnp.float32)
        opacities = jnp.asarray(1.0 / (1.0 + np.exp(-raw["opacity"][:, 0])), jnp.float32)
        shs = jnp.asarray(np.concatenate([raw["features_dc"], raw["features_rest"]], axis=1),
                          jnp.float32)
        cam_dist = 2.5 * radius
    elif scene == "shell":
        d = rng.normal(size=(P, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        means = jnp.asarray((1.5 * d + rng.normal(0, 0.01, (P, 3))).astype(np.float32))
        scales = jnp.asarray(np.exp(rng.normal(-4.8, 0.3, (P, 3))), jnp.float32)
        quats = jnp.asarray(rng.normal(0, 1, (P, 4)), jnp.float32)
        opacities = jnp.asarray(1 / (1 + np.exp(-rng.normal(2.5, 0.8, (P,)))), jnp.float32)
    else:
        means = jnp.asarray(rng.normal(0, 1.0, (P, 3)), jnp.float32)
        scales = jnp.asarray(np.exp(rng.normal(-4.2, 0.5, (P, 3))), jnp.float32)
        quats = jnp.asarray(rng.normal(0, 1, (P, 4)), jnp.float32)
        opacities = jnp.asarray(1 / (1 + np.exp(-rng.normal(0.0, 1.0, (P,)))), jnp.float32)
    if shs is None:
        shs_np = rng.normal(0, 0.2, (P, 16, 3)).astype(np.float32)
        shs_np[:, 0, :] += 1.0
        shs = jnp.asarray(shs_np)
        cam_dist = 4.0
    return tuple(np.asarray(x) for x in (means, scales, quats, opacities, shs)), cam_dist


def jax_camera(width, height, cam_dist):
    """bench.py:223-227's camera."""
    return JaxCamera(uid=0, colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, cam_dist]),
                     fovx=math.radians(70), fovy=math.radians(70 * height / width), image=None,
                     image_name="bench", width=width, height=height).arrays()


def port_scene(scene, ply=TRAINED_PLY):
    sc = bench.bench_scene(scene, P, np.random.default_rng(0), ply=ply)
    return sc, tuple(torch.from_numpy(x) for x in sc[:5])


@pytest.mark.parametrize("scene", ["cloud", "shell", "ply"])
def test_scenes_are_bench_py_draws(scene):
    got = bench.bench_scene(scene, P, np.random.default_rng(0))
    want, cam_dist = bench_py_scene(scene, P)
    for name, a, b in zip(("means", "scales", "quats", "opacities", "shs"), got[:5], want):
        assert a.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.cam_dist == cam_dist
    if scene == "ply":
        assert got.means.shape[0] == 122_535
    assert bench.bench_scene("ply", P, None, cam_dist=3.5).cam_dist == 3.5
    with pytest.raises(ValueError, match="ply, cloud and shell"):
        bench.bench_scene("sphere", P, np.random.default_rng(0))


def bench_py_capacity(n_entries, bits):
    """bench.py:256-257."""
    bucket = 1 << bits
    return max(bucket, -(int(n_entries * 1.02) // -bucket) * bucket)


@pytest.mark.parametrize("scene,tile,bits", [("cloud", (32, 32), 16), ("cloud", (8, 8), 4),
                                             ("shell", (16, 8), 5)])
def test_capacity_is_bench_py_rule(scene, tile, bits):
    sc, acts = port_scene(scene)
    cam = bench.bench_camera(W, H, sc.cam_dist, device="cpu")
    capacity, n_entries = bench.bench_capacity(acts, cam, W, H, *tile, bucket_bits=bits)
    want, cam_dist = bench_py_scene(scene, P)
    jprep = jax_preprocess(*map(jnp.asarray, want), 3, jax_camera(W, H, cam_dist), W, H, *tile)
    j_entries = int(jnp.sum(jprep.tiles_touched))
    assert n_entries == j_entries > 0
    assert capacity == bench_py_capacity(j_entries, bits)
    assert bench.bench_capacity(acts, cam, W, H, *tile, cap_mult=2) == (2 * P, n_entries)


@pytest.mark.parametrize("scene,tile", [("cloud", (32, 32)), ("shell", (8, 8))])
def test_render_at_the_bench_camera_matches_jax(scene, tile):
    sc, acts = port_scene(scene)
    cam = bench.bench_camera(W, H, sc.cam_dist, device="cpu")
    capacity, _ = bench.bench_capacity(acts, cam, W, H, *tile, bucket_bits=8)
    img, aux = rasterize(*acts, 3, cam, W, H, torch.zeros(3),
                         RasterizerConfig(tile_w=tile[0], tile_h=tile[1], capacity_exact=capacity))
    want, cam_dist = bench_py_scene(scene, P)
    jimg, jaux = jax_rasterize(*map(jnp.asarray, want), 3, jax_camera(W, H, cam_dist), W, H,
                               jnp.zeros(3, jnp.float32),
                               JaxConfig(backend="xla", capacity_exact=capacity, tile_w=tile[0],
                                         tile_h=tile[1]))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=2e-5, rtol=0)
    np.testing.assert_allclose(aux["final_t"].numpy(), np.asarray(jaux["final_t"]), atol=2e-5,
                               rtol=0)
    assert int(aux["num_entries"]) == int(jaux["num_entries"]) > 0
    assert float(img.max()) > 0.05  # the splats are in view


def test_train_step_at_the_bench_inputs_matches_jax():
    sc, acts = port_scene("cloud")
    capacity, _ = bench.bench_capacity(acts, bench.bench_camera(W, H, sc.cam_dist, device="cpu"),
                                       W, H, 32, 32, bucket_bits=8)
    opt = OptimizationConfig()
    cam = bench.bench_camera(W, H, 4.0, device="cpu")
    gt_np = np.random.default_rng(1).uniform(size=(H, W, 3)).astype(np.float32)
    state = init_train_state(bench.bench_train_params(sc, device="cpu"))
    cfg = RasterizerConfig(capacity_exact=capacity)
    out = loss_and_grads(state.params, cam, torch.from_numpy(gt_np), torch.zeros(3), 3, W, H,
                         cfg, opt.lambda_dssim)
    metrics = train_step(state, cam, torch.from_numpy(gt_np), torch.zeros(3), 2, 3, W, H, cfg,
                         opt, spatial_lr_scale=1.0)

    # bench.py:322-347's inputs and step, on the JAX package
    (means, scales, quats, opacities, shs), _ = bench_py_scene("cloud", P)
    means, scales, quats, opacities, shs = map(jnp.asarray, (means, scales, quats, opacities, shs))
    jparams = JaxParams(xyz=means, features_dc=shs[:, :1], features_rest=shs[:, 1:],
                        scaling=jnp.log(scales), rotation=quats,
                        opacity=jnp.log(opacities / (1.0 - opacities))[:, None])
    jstate = jtraining.init_train_state(jparams, np.ones((P,), bool))
    jcfg = JaxConfig(backend="xla", capacity_exact=capacity)
    kw = dict(cam=jax.tree.map(jnp.asarray, jax_camera(W, H, 4.0)), gt_image=jnp.asarray(gt_np),
              bg=jnp.zeros(3, jnp.float32), sh_degree=3, active_sh_degree=3, width=W, height=H,
              raster_cfg=jcfg, opt=jtraining.OptimizationConfig(), spatial_lr_scale=1.0)
    gt = jnp.asarray(gt_np)

    def jloss(p):
        a = jax_activate(p)
        img, _ = jax_rasterize(a.xyz, a.scales, a.quats, a.opacities, a.shs, 3, kw["cam"], W, H,
                               kw["bg"], jcfg, alive=jnp.asarray(jstate.alive))
        return ((1 - opt.lambda_dssim) * jlosses.l1_loss(img, gt)
                + opt.lambda_dssim * (1 - jlosses.ssim(img, gt)))

    jgrads = jax.tree.map(np.asarray, jax.grad(jloss)(jparams))  # before the step donates them
    new, jmetrics = jtraining.train_step(jstate, iteration=jnp.int32(2), **kw)

    for k in ("loss", "l1", "psnr"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    for k in ("num_entries", "num_visible"):
        assert int(metrics[k]) == int(jmetrics[k]) > 0, k
    lr = {"xyz": expon_lr(2, opt.position_lr_init, opt.position_lr_final,
                          lr_delay_mult=opt.position_lr_delay_mult,
                          max_steps=opt.position_lr_max_steps),
          "features_dc": opt.feature_lr, "features_rest": opt.feature_lr / 20,
          "scaling": opt.scaling_lr, "rotation": opt.rotation_lr, "opacity": opt.opacity_lr}
    moved = 0
    for k in PARAM_NAMES:
        g = out.grads[k].numpy()
        jg = getattr(jgrads, k)
        np.testing.assert_allclose(g, jg, atol=2e-3 * np.abs(jg).max(), rtol=0, err_msg=k)
        big = np.abs(g) > 1e-3 * np.abs(g).max()
        p_t = getattr(state.params, k).detach().numpy()
        p_j = np.asarray(getattr(new.params, k))
        np.testing.assert_allclose(p_t[big], p_j[big], atol=1e-2 * lr[k], rtol=0, err_msg=k)
        moved += int(big.sum())
    assert moved > 0


def run_main(monkeypatch, capsys, **env):
    for k in bench.NOT_PORTED:
        monkeypatch.delenv(k, raising=False)
    base = {"GS_BENCH_W": "64", "GS_BENCH_H": "48", "GS_BENCH_P": str(P), "GS_BENCH_ITERS": "2",
            "GS_BENCH_BUCKET_BITS": "8"}
    for k, v in {**base, **env}.items():
        monkeypatch.setenv(k, v)
    result = bench.main([], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == result
    return result


@pytest.mark.parametrize("env,metric", [
    (dict(GS_BENCH_SCENE="cloud"), f"render_fps_64x48_P{P}_cpu"),
    (dict(GS_BENCH_SCENE="shell", GS_BENCH_TILE_W="8", GS_BENCH_TILE_H="8"),
     f"render_fps_64x48_P{P}_cpu_shell"),
    (dict(GS_BENCH_SCENE="ply", GS_BENCH_PLY=SMALL_PLY), "render_fps_64x48_P8_cpu_ply"),
    (dict(GS_BENCH_MODE="train", GS_BENCH_SCENE="cloud"), f"train_its_64x48_P{P}_cpu"),
])
def test_main_prints_bench_py_line(monkeypatch, capsys, env, metric):
    result = run_main(monkeypatch, capsys, **env)
    assert set(result) == {"metric", "value", "unit", "vs_baseline", "frame_ms_median",
                           "frame_ms_p80"}
    assert result["metric"] == metric
    baseline = 20.0 if metric.startswith("train") else 30.0
    assert result["unit"] == ("iters/s" if baseline == 20.0 else "frames/s")
    assert result["value"] > 0 and math.isfinite(result["value"])
    # the program rounds value (to 3 places) and value / baseline (to 4)
    # from the one unrounded rate, as bench.py does: the two agree within
    # the two roundings' half steps
    assert abs(result["vs_baseline"] - result["value"] / baseline) <= 0.5e-3 / baseline + 0.5e-4
    assert 0 < result["frame_ms_median"] <= result["frame_ms_p80"]


@pytest.mark.parametrize("var,value", [("GS_BENCH_CHUNK", "1024"), ("GS_BENCH_BACKEND", "pallas"),
                                       ("GS_BENCH_BACKEND", "xla"), ("GS_BENCH_PLATFORM", "cpu")])
def test_tpu_variables_are_refused(monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(SystemExit, match=f"refuses {var}='{value}'"):
        bench.main([], device="cpu")


def test_bench_refuses_what_it_does_not_take(monkeypatch):
    for k in bench.NOT_PORTED:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="no arguments"):
        bench.main(["--iters", "3"], device="cpu")
    monkeypatch.setenv("GS_BENCH_MODE", "serve")
    with pytest.raises(SystemExit, match="render and train"):
        bench.main([], device="cpu")
    monkeypatch.setenv("GS_BENCH_MODE", "render")
    monkeypatch.setenv("GS_BENCH_TILE_W", "129")  # 129 x 32 pixels: more than 4096
    with pytest.raises(ValueError, match="tile 129x32 unsupported"):
        bench.main([], device="cpu")


def test_bench_needs_the_card_unless_told(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    for k in bench.NOT_PORTED:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
