"""The port's host training loop (`gaussian_splatting_torch/trainer.py`),
`create_from_pcd` and the point-cloud PLY functions, against the JAX
package on the CPU, and the analogs of tests/test_training.py.

Tolerances:
  - `create_from_pcd`: every array and `alive` equal, the scales within
    rtol 1e-6: the KNN's mean squared distances agree to rtol 1e-6
    (test_torch_knn.py; XLA's CPU code rounds the sum of three squares as
    two FMAs), so their square roots to 5e-7 relative, and the log-scales
    to 1e-6 absolute (a log's error is absolute: near log 0 no relative
    bound holds);
  - point clouds, checkpoints, the camera and background sequence, the
    SH warm-up, the entry-capacity decisions and the maintenance of
    `post_step` (host densify and opacity reset from one checkpoint, one
    Generator seed): bit-equal;
  - 5 real steps from the same cloud: losses within 1e-4 relative (each
    step's gradients agree with JAX's to the rasterizer's bound, and Adam
    carries the differences on), and the same probed capacity.
Where only the loop's decisions are compared, both packages' `train_step`
is replaced by a stub that returns set metrics (no render, no compile).
"""

import math
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu import trainer as jtrainer
from gaussian_splatting_tpu.ops.rasterize import RasterizerConfig as JaxConfig
from gaussian_splatting_tpu.scene import gaussians as jgaussians
from gaussian_splatting_tpu.scene import ply as jply
from gaussian_splatting_tpu.training import OptimizationConfig as JaxOpt
from gaussian_splatting_tpu.utils import native as jnative
from gaussian_splatting_torch import (
    OptimizationConfig, RasterizerConfig, Trainer, create_from_pcd, rasterize,
)
from gaussian_splatting_torch import trainer as ttrainer
from gaussian_splatting_torch.scene import ply
from gaussian_splatting_torch.scene.cameras import Camera
from gaussian_splatting_torch.scene.gaussians import PARAM_NAMES

from helpers import make_camera, make_gaussians
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

W, H = 64, 48
CAM_FIELDS = ("uid", "colmap_id", "R", "T", "fovx", "fovy", "image", "image_name", "width", "height")
NO_MAINTENANCE = dict(densify_from_iter=10_000, opacity_reset_interval=10_000)


def make_scene(n_cams=4):
    """JAX and port cameras around a fixed random Gaussian set, each with
    the set's render (the port's rasterizer) as its target; and the set's
    means."""
    gauss = make_gaussians(P=48, seed=3, spread=0.8)
    jcams, pcams = [], []
    for i in range(n_cams):
        jcam = make_camera(W, H, dist=4.0, angle=i * 2 * math.pi / n_cams)
        pcam = Camera(**{k: getattr(jcam, k) for k in CAM_FIELDS})
        with torch.no_grad():
            img = rasterize(*[torch.from_numpy(x) for x in gauss], 3, pcam.arrays(device="cpu"),
                            W, H, torch.zeros(3), RasterizerConfig(capacity_mult=32))[0]
        jcam.image = pcam.image = np.clip(img.numpy(), 0, 1).transpose(2, 0, 1)
        jcams.append(jcam)
        pcams.append(pcam)
    return jcams, pcams, gauss[0]


def noisy_cloud(means, seed):
    rng = np.random.default_rng(seed)
    pts = means + rng.normal(0, 0.15, means.shape).astype(np.float32)
    return pts, rng.uniform(0.3, 0.7, (pts.shape[0], 3)).astype(np.float32)


def port_trainer(cams, opt=None, **kw):
    kw = dict(dict(sh_degree=3, min_capacity=128, device="cpu"), **kw)
    return Trainer(cameras=cams, opt=opt or OptimizationConfig(**NO_MAINTENANCE), **kw)


def jax_trainer(cams, opt=None, **kw):
    kw = dict(dict(sh_degree=3, min_capacity=128,
                   raster_cfg=JaxConfig(backend="xla", chunk=128)), **kw)
    return jtrainer.Trainer(cameras=cams, opt=opt or JaxOpt(**NO_MAINTENANCE), **kw)


def host_rows(tr):
    """Every row of a trainer's state (padding included) as numpy."""
    st = tr.state
    if isinstance(tr, Trainer):
        p = {k: getattr(st.params, k).detach().numpy() for k in PARAM_NAMES}
        m = {k: st.adam.m[k].numpy() for k in PARAM_NAMES}
        v = {k: st.adam.v[k].numpy() for k in PARAM_NAMES}
        rest = dict(alive=st.params.alive.numpy(), step=st.adam.step,
                    **{k: getattr(st, k).numpy() for k in ttrainer.STAT_NAMES})
    else:
        p = {k: np.asarray(getattr(st.params, k)) for k in PARAM_NAMES}
        m = {k: np.asarray(getattr(st.adam.m, k)) for k in PARAM_NAMES}
        v = {k: np.asarray(getattr(st.adam.v, k)) for k in PARAM_NAMES}
        rest = dict(alive=np.asarray(st.alive), step=int(st.adam.step),
                    **{k: np.asarray(getattr(st, k)) for k in ttrainer.STAT_NAMES})
    return p, m, v, rest


def assert_same_state(a, b):
    for da, db in zip(host_rows(a), host_rows(b)):
        assert da.keys() == db.keys()
        for k in da:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)


# ---------------------------------------------------------------------------
# create_from_pcd and the point-cloud PLY
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [300, 20_500])
def test_create_from_pcd_matches_jax(monkeypatch, P):
    # JAX's dispatcher would take the native sweep above 20,000 points if
    # it were built; the port takes the Morton form there.
    monkeypatch.setattr(jnative, "get_native", lambda: None)
    rng = np.random.default_rng(P)
    pts = rng.normal(size=(P, 3)).astype(np.float32)
    colors = rng.uniform(size=(P, 3)).astype(np.float32)
    jp, jalive = jgaussians.create_from_pcd(pts, colors, 3)
    gp = create_from_pcd(pts, colors, 3, device="cpu")
    np.testing.assert_array_equal(gp.alive.numpy(), jalive)
    assert gp.num_points == jalive.shape[0] == jgaussians.capacity_bucket(P)
    for k in PARAM_NAMES:
        got, want = getattr(gp, k).detach().numpy(), np.asarray(getattr(jp, k))
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if k == "scaling":
            np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=1e-6, atol=0)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_point_cloud_ply_crosses_packages(tmp_path, writer):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    colors = rng.uniform(size=(10, 3)).astype(np.float32)
    normals = rng.normal(size=(10, 3)).astype(np.float32)
    paths = {name: str(tmp_path / f"{name}.ply") for name in ("jax", "port")}
    jply.save_point_cloud_ply(paths["jax"], pts, colors, normals)
    ply.save_point_cloud_ply(paths["port"], pts, colors, normals)
    assert open(paths["jax"], "rb").read() == open(paths["port"], "rb").read()
    reader = ply if writer == "jax" else jply
    got = reader.load_point_cloud_ply(paths[writer])
    want = (jply if writer == "jax" else ply).load_point_cloud_ply(paths[writer])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], pts)
    np.testing.assert_allclose(got[1], colors, atol=1 / 255.0)


# ---------------------------------------------------------------------------
# the loop's decisions, with both packages' step replaced by a stub
# ---------------------------------------------------------------------------


class StubSteps:
    """Replaces both packages' train_step with a recorder that returns set
    entry counts."""

    def __init__(self, monkeypatch, entries=lambda it: 100):
        self.entries = entries
        self.calls = {"jax": [], "port": []}
        monkeypatch.setattr(jtrainer, "train_step", self.jax_step)
        monkeypatch.setattr(ttrainer, "train_step", self.port_step)

    def metrics(self, it):
        return dict(loss=0.5, l1=0.25, psnr=20.0, num_entries=self.entries(it), num_visible=1)

    def jax_step(self, state, cam, gt, bg, it, **kw):
        it = int(it)
        self.calls["jax"].append((it, np.asarray(cam.viewmatrix), np.asarray(bg),
                                  kw["active_sh_degree"], kw["raster_cfg"].capacity_exact,
                                  kw["raster_cfg"].capacity_mult))
        return state, {k: jnp.asarray(x) for k, x in self.metrics(it).items()}

    def port_step(self, state, cam, gt, bg, it, **kw):
        self.calls["port"].append((it, cam.viewmatrix.numpy(), bg.numpy(), kw["active_sh_degree"],
                                   kw["raster_cfg"].capacity_exact, kw["raster_cfg"].capacity_mult))
        return {k: torch.tensor(x) for k, x in self.metrics(it).items()}

    def assert_same(self):
        assert len(self.calls["jax"]) == len(self.calls["port"]) > 0
        for cj, cp in zip(self.calls["jax"], self.calls["port"]):
            for a, b in zip(cj, cp):
                np.testing.assert_array_equal(a, b)


def test_camera_and_background_sequence_matches_jax(monkeypatch):
    stub = StubSteps(monkeypatch)
    jcams, pcams, means = make_scene()
    pts, colors = noisy_cloud(means, 0)
    kw = dict(seed=5, auto_capacity=False)
    jtr = jax_trainer(jcams, JaxOpt(random_background=True, **NO_MAINTENANCE), **kw)
    tr = port_trainer(pcams, OptimizationConfig(random_background=True, **NO_MAINTENANCE), **kw)
    jtr.init_from_pcd(pts, colors)
    tr.init_from_pcd(pts, colors)
    jtr.train(3 * len(jcams))
    tr.train(3 * len(pcams))
    stub.assert_same()
    views = [c[1].tobytes() for c in stub.calls["port"]]
    for epoch in range(3):  # each epoch visits every camera once
        assert len(set(views[4 * epoch:4 * epoch + 4])) == 4


def test_sh_warm_up_every_1000_iterations_matches_jax(monkeypatch):
    stub = StubSteps(monkeypatch)
    jcams, pcams, means = make_scene(n_cams=2)
    pts, colors = noisy_cloud(means, 0)
    jtr, tr = jax_trainer(jcams, auto_capacity=False), port_trainer(pcams, auto_capacity=False)
    for t in (jtr, tr):
        t.init_from_pcd(pts, colors)
        for start in (998, 1998, 2998, 3998):
            t.iteration = start
            t.train(3)
    stub.assert_same()
    degrees = [c[3] for c in stub.calls["port"]]
    assert degrees == [0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3]


@pytest.mark.parametrize("auto_capacity", [True, False])
def test_entry_capacity_decisions_match_jax(monkeypatch, auto_capacity):
    """Overflowing steps grow the entry capacity at once, and each densify
    re-fits it from the window's largest count (auto_capacity); without
    auto_capacity, capacity_mult doubles until the count fits."""
    counts = {1: 300, 2: 280, 3: 700, 5: 1500, 6: 3000, 9: 200, 10: 5000}
    stub = StubSteps(monkeypatch, entries=lambda it: counts.get(it, 250))
    for cls in (jtrainer.Trainer, Trainer):
        monkeypatch.setattr(cls, "_probe_entries", lambda self, cam, w, h: 300)
    jcams, pcams, means = make_scene(n_cams=2)
    pts, colors = noisy_cloud(means, 0)
    cadence = dict(densify_from_iter=3, densification_interval=4, densify_until_iter=100,
                   opacity_reset_interval=10_000)
    jtr = jax_trainer(jcams, JaxOpt(**cadence), auto_capacity=auto_capacity)
    tr = port_trainer(pcams, OptimizationConfig(**cadence), auto_capacity=auto_capacity)
    for t in (jtr, tr):
        t.init_from_pcd(pts, colors)
        t.train(11)
    stub.assert_same()
    assert tr.raster_cfg == RasterizerConfig(**{
        k: getattr(jtr.raster_cfg, k) for k in ("tile_w", "tile_h", "capacity_mult", "capacity_exact")})
    caps = [c[4] if auto_capacity else c[5] for c in stub.calls["port"]]
    assert len(set(caps)) > 2  # grew more than once
    assert [d["path"] for d in tr.densify_history] == ["device", "device"]


# ---------------------------------------------------------------------------
# real steps against the JAX trainer
# ---------------------------------------------------------------------------


def test_five_steps_match_jax_trainer():
    jcams, pcams, means = make_scene()
    pts, colors = noisy_cloud(means, 0)
    kw = dict(cameras_extent=4.0, spatial_lr_scale=4.0, seed=2)
    jtr, tr = jax_trainer(jcams, **kw), port_trainer(pcams, **kw)
    jtr.init_from_pcd(pts, colors)
    tr.init_from_pcd(pts, colors)
    jtr.train(5)
    tr.train(5)
    assert tr.raster_cfg.capacity_exact == jtr.raster_cfg.capacity_exact is not None
    got = np.array([h["loss"] for h in tr.history])
    want = np.array([h["loss"] for h in jtr.history])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert [h["num_entries"] for h in tr.history] == [h["num_entries"] for h in jtr.history]


def random_checkpoint(path, P=200, seed=3, iteration=400):
    """A JAX-format checkpoint of P live rows on which the default
    densification (threshold 2e-4, extent 1, percent_dense 0.01) clones,
    splits and prunes by opacity and by size."""
    rng = np.random.default_rng(seed)
    params = {
        "xyz": rng.normal(size=(P, 3)).astype(np.float32),
        "features_dc": rng.normal(size=(P, 1, 3)).astype(np.float32),
        "features_rest": rng.normal(size=(P, 15, 3)).astype(np.float32),
        "scaling": rng.normal(np.log(0.01), 1.0, (P, 3)).astype(np.float32),
        "rotation": rng.normal(size=(P, 4)).astype(np.float32),
        "opacity": rng.normal(0.0, 3.0, (P, 1)).astype(np.float32),
    }
    params["scaling"][:8] = 0.5
    denom = rng.integers(0, 4, P).astype(np.float32)
    payload = dict(
        iteration=iteration, active_sh_degree=1, sh_degree=3, spatial_lr_scale=2.0,
        cameras_extent=1.0, params=params,
        adam_m={k: rng.normal(size=x.shape).astype(np.float32) for k, x in params.items()},
        adam_v={k: rng.uniform(size=x.shape).astype(np.float32) for k, x in params.items()},
        adam_step=iteration - 1,
        stats={"max_radii2d": rng.uniform(0, 30, P).astype(np.float32),
               "xyz_grad_accum": (rng.uniform(0, 4e-4, P) * denom).astype(np.float32),
               "denom": denom},
    )
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return payload


def test_maintenance_from_a_jax_checkpoint_is_bit_equal(tmp_path):
    """The host densify (with capacity growth) and the opacity reset at
    iteration 400 of a densify-every-100, reset-every-200 cadence, from one
    checkpoint loaded into both trainers."""
    path = str(tmp_path / "ckpt.pkl")
    random_checkpoint(path, P=240)  # 312 rows after the densify: 256 -> 512
    cadence = dict(densify_from_iter=100, densification_interval=100, densify_until_iter=1000,
                   opacity_reset_interval=200)
    jtr = jax_trainer([], JaxOpt(**cadence), device_densify=False)
    tr = port_trainer([], OptimizationConfig(**cadence), device_densify=False)
    for t in (jtr, tr):
        t.load_checkpoint(path)
        t.rng = np.random.default_rng(5)
        t._entry_window_max = 5000
    assert_same_state(tr, jtr)
    live_before = tr.num_live
    jtr.post_step()
    tr.post_step()
    record = tr.densify_history[0]
    assert record["path"] == "host" and record["ms"] > 0
    assert (record["rows_before"], record["capacity"]) == (256, 512)
    assert tr.state.params.num_points == jtr.state.params.xyz.shape[0] == 512 > live_before
    assert tr.raster_cfg.capacity_exact == jtr.raster_cfg.capacity_exact
    assert_same_state(tr, jtr)
    opac = tr.state.params.opacity.detach()[tr.state.params.alive]
    assert bool((torch.sigmoid(opac) <= 0.01 + 1e-7).all())


def test_checkpoint_moves_from_jax_to_port(tmp_path):
    random_checkpoint(str(tmp_path / "a.pkl"))
    jtr = jax_trainer([])
    jtr.load_checkpoint(str(tmp_path / "a.pkl"))
    jtr.save_checkpoint(str(tmp_path / "jax.pkl"))
    tr = port_trainer([])
    tr.load_checkpoint(str(tmp_path / "jax.pkl"))
    assert_same_state(tr, jtr)
    for k in ("iteration", "active_sh_degree", "sh_degree", "spatial_lr_scale", "cameras_extent"):
        assert getattr(tr, k) == getattr(jtr, k), k


def test_checkpoint_moves_from_port_to_jax(tmp_path):
    payload = random_checkpoint(str(tmp_path / "a.pkl"))
    tr = port_trainer([])
    tr.load_checkpoint(str(tmp_path / "a.pkl"))
    tr.save_checkpoint(str(tmp_path / "port.pkl"))
    jtr = jax_trainer([])
    jtr.load_checkpoint(str(tmp_path / "port.pkl"))
    assert_same_state(tr, jtr)
    jtr.save_checkpoint(str(tmp_path / "jax.pkl"))
    with open(tmp_path / "port.pkl", "rb") as f:
        ours = pickle.load(f)
    with open(tmp_path / "jax.pkl", "rb") as f:
        theirs = pickle.load(f)
    assert ours.keys() == theirs.keys() == payload.keys()
    for k in ("params", "adam_m", "adam_v", "stats"):
        assert ours[k].keys() == theirs[k].keys()
        for name in ours[k]:
            assert ours[k][name].dtype == theirs[k][name].dtype
            np.testing.assert_array_equal(ours[k][name], theirs[k][name])
    assert type(ours["adam_step"]) is type(theirs["adam_step"]) is int


# ---------------------------------------------------------------------------
# analogs of tests/test_training.py, on the port alone
# ---------------------------------------------------------------------------


def test_training_fits_synthetic_scene():
    """test_training.py:40: fit 4 views at 64x48 in 150 steps, densifying at
    iterations 50 and 100."""
    _, cams, gt_means = make_scene()
    pts, colors = noisy_cloud(gt_means, 0)
    opt = OptimizationConfig(
        iterations=150, feature_lr=0.02, opacity_lr=0.1, scaling_lr=0.02,
        position_lr_init=0.0016, position_lr_final=0.00016, densify_from_iter=40,
        densification_interval=50, densify_until_iter=120, opacity_reset_interval=10_000,
        position_lr_max_steps=150,
    )
    tr = port_trainer(cams, opt, cameras_extent=4.0, spatial_lr_scale=4.0)
    tr.init_from_pcd(pts, colors)
    tr.train(150)
    early = np.mean([h["loss"] for h in tr.history[:10]])
    late = np.mean([h["loss"] for h in tr.history[-10:]])
    assert late < 0.6 * early, f"loss did not drop: {early} -> {late}"
    assert tr.history[-1]["psnr"] > tr.history[0]["psnr"] + 2.0
    assert [d["iteration"] for d in tr.densify_history] == [50, 100]
    assert tr.num_live > 10


def test_deferred_maintenance_order():
    """test_training.py:82: step(defer_maintenance=True) leaves the opacity
    reset to post_step()."""
    _, cams, gt_means = make_scene(n_cams=2)
    pts, colors = noisy_cloud(gt_means, 2)
    tr = port_trainer(cams, OptimizationConfig(densify_from_iter=10_000, opacity_reset_interval=3))
    tr.init_from_pcd(pts, colors)
    tr.train(2)
    tr.step(defer_maintenance=True)  # iteration 3: the reset is due
    alive = tr.state.params.alive
    before = torch.sigmoid(tr.state.params.opacity.detach()[alive])
    assert bool((before > 0.02).any()), "reset ran too early"
    tr.post_step()
    after = torch.sigmoid(tr.state.params.opacity.detach()[tr.state.params.alive])
    assert bool((after <= 0.0101).all()), "reset did not run"


def test_checkpoint_roundtrip(tmp_path):
    """test_training.py:111: save after 5 steps, load into a fresh trainer,
    the same state; training resumes."""
    _, cams, gt_means = make_scene(n_cams=2)
    pts, colors = noisy_cloud(gt_means, 1)
    tr = port_trainer(cams)
    tr.init_from_pcd(pts, colors)
    tr.train(5)
    path = str(tmp_path / "ckpt.pkl")
    tr.save_checkpoint(path)
    tr2 = port_trainer(cams)
    tr2.load_checkpoint(path)
    assert tr2.iteration == tr.iteration
    assert_same_state(tr2, tr)
    tr2.train(2)
    assert tr2.iteration == 7 and tr2.state.adam.step == 7


# ---------------------------------------------------------------------------
# snapshots and devices
# ---------------------------------------------------------------------------


def test_non_finite_loss_dumps_the_jax_snapshot(tmp_path):
    _, cams, gt_means = make_scene(n_cams=1)
    cams[0].image = np.full_like(cams[0].image, np.nan)
    pts, colors = noisy_cloud(gt_means, 0)
    path = tmp_path / "snap.dump"
    tr = port_trainer(cams, debug_dump_path=str(path))
    tr.init_from_pcd(pts, colors)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        tr.step()
    with open(path, "rb") as f:
        ours = pickle.load(f)

    random_checkpoint(str(tmp_path / "ckpt.pkl"))
    jtr = jax_trainer([], debug_dump_path=str(tmp_path / "jax.dump"))
    jtr.load_checkpoint(str(tmp_path / "ckpt.pkl"))
    jtr._dump_snapshot(1, make_camera(W, H), {"metrics": dict(tr.history[-1])})
    with open(tmp_path / "jax.dump", "rb") as f:
        theirs = pickle.load(f)
    assert ours.keys() == theirs.keys()
    assert ours["metrics"].keys() == theirs["metrics"].keys()
    assert ours["stats"].keys() == theirs["stats"].keys()
    assert ours["iteration"] == 1 and ours["params"]["xyz"].shape == (48, 3)


def test_debug_dumps_a_snapshot_when_the_step_raises(tmp_path, monkeypatch):
    def broken_step(*args, **kw):
        raise RuntimeError("injected")

    monkeypatch.setattr(ttrainer, "train_step", broken_step)
    _, cams, gt_means = make_scene(n_cams=1)
    pts, colors = noisy_cloud(gt_means, 0)
    path = tmp_path / "snap.dump"
    tr = port_trainer(cams, debug=True, debug_dump_path=str(path), auto_capacity=False)
    tr.init_from_pcd(pts, colors)
    with pytest.raises(RuntimeError, match="injected"):
        tr.step()
    with open(path, "rb") as f:
        assert pickle.load(f)["error"] == "step exception"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cameras=[])
    with pytest.raises(RuntimeError, match="CUDA"):
        create_from_pcd(pts, pts, 3)
