"""The train slice: the compositing backward, the rasterizer's gradients,
the losses, masked Adam and one train step, against autograd, finite
differences and the JAX package.

Tolerances, per check:
  - hand-written backward (`composite_bwd_torch` + `route_grads_torch`,
    through the autograd op) vs torch autograd of the plain forward:
    1e-5 x max |grad| per field (both are float32 sums of the same terms in
    other orders; the suffix term TOTAL - prefix loses a few bits to
    cancellation);
  - the port's `rasterize` gradients vs JAX's `backend="xla"`: 2e-3 x
    max |grad|, the bound test_rasterize.py:188-192 holds the JAX Pallas
    path to (linear vs log-space transmittance can flip a threshold
    decision on a borderline pixel);
  - losses: values to 1e-6, the SSIM gradient to 1e-5 x max |grad|;
  - masked Adam fed the SAME gradients as JAX's `adam_update`: 1e-6
    relative (only the learning rate's last bits differ);
  - the full train step vs JAX's: loss and metrics to 1e-5 relative,
    gradients as above, statistics and moments to bounds derived from the
    gradient bound (see `test_train_step_matches_jax`).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import losses as jlosses
from gaussian_splatting_tpu.ops.rasterize import RasterizerConfig as JaxConfig
from gaussian_splatting_tpu.ops.rasterize import rasterize as jax_rasterize
from gaussian_splatting_tpu.scene import optim as joptim
from gaussian_splatting_tpu.scene.gaussians import GaussianParams as JaxParams
from gaussian_splatting_tpu.scene.gaussians import activate as jax_activate
from gaussian_splatting_tpu import training as jtraining
from gaussian_splatting_torch import (
    OptimizationConfig, RasterizerConfig, init_train_state, rasterize, train_step,
)
from gaussian_splatting_torch.ops import binning, composite, losses
from gaussian_splatting_torch.ops.composite_cuda import (
    composite_bwd, composite_bwd_cuda, composite_fwd, route_grads, route_grads_cuda,
)
from gaussian_splatting_torch.ops.projection import preprocess
from gaussian_splatting_torch.scene.cameras import Camera
from gaussian_splatting_torch.scene.gaussians import PARAM_NAMES, params_from_numpy
from gaussian_splatting_torch.scene.optim import adam_update, expon_lr
from gaussian_splatting_torch.training import loss_and_grads, train_state_from_numpy

from helpers import make_camera, make_gaussians
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

CAM_FIELDS = ("uid", "colmap_id", "R", "T", "fovx", "fovy", "image", "image_name", "width", "height")
BG = np.array([0.1, 0.2, 0.3], np.float32)


def port_camera(jcam):
    return Camera(**{k: getattr(jcam, k) for k in CAM_FIELDS}).arrays(device="cpu")


def sorted_scene(W, H, tile, P=200, seed=0, spread=1.0, scale_mu=-2.5):
    """The port's preprocess + binning of a helpers scene (no gradients)."""
    scene = [torch.from_numpy(x) for x in make_gaussians(P=P, seed=seed, spread=spread,
                                                         scale_mu=scale_mu)]
    with torch.no_grad():
        prep = preprocess(*scene, 3, port_camera(make_camera(W, H)), W, H, *tile)
    lists = binning.build_tile_lists(prep.rect_min, prep.rect_max, prep.depths,
                                     prep.tiles_touched, -(-W // tile[0]), -(-H // tile[1]),
                                     max(256, int(prep.tiles_touched.sum())))
    return prep, lists


def cotangents(W, H, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(H, W, 3)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(H, W)).astype(np.float32)))


# ---------------------------------------------------------------------------
# (a) the hand-written backward against autograd of the plain forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W,H,tile,scene", [
    (64, 48, (32, 32), {}),
    (64, 48, (32, 16), {}),
    (64, 48, (16, 16), {}),
    (61, 47, (32, 32), {}),
    (64, 48, (16, 16), dict(P=300, seed=9, spread=0.3, scale_mu=-1.8)),  # saturated
])
def test_backward_matches_autograd_of_plain_forward(W, H, tile, scene):
    prep, lists = sorted_scene(W, H, tile, **scene)
    g_img, g_ft = cotangents(W, H)
    fields = (prep.means2d, prep.conic, prep.rgb, prep.opacity, torch.from_numpy(BG))

    leaves = [f.clone().requires_grad_(True) for f in fields]
    out = composite.composite_fwd_torch(lists.gauss_id, lists.tile_start, lists.tile_stop,
                                        *leaves, W, H, *tile)
    ref = torch.autograd.grad((out.image * g_img).sum() + (out.final_t * g_ft).sum(), leaves)

    leaves = [f.clone().requires_grad_(True) for f in fields]
    before = (composite_fwd.launches, composite_bwd.launches, route_grads.launches)
    out2 = composite_fwd(lists, *leaves, W, H, *tile)
    got = torch.autograd.grad((out2.image * g_img).sum() + (out2.final_t * g_ft).sum(), leaves)
    assert (composite_fwd.launches, composite_bwd.launches, route_grads.launches) == before

    np.testing.assert_array_equal(out2.image.detach().numpy(), out.image.detach().numpy())
    for name, a, b in zip(("means2d", "conic", "rgb", "opacity", "bg"), got, ref):
        scale = float(b.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5 * scale, rtol=0, err_msg=name)
    if scene:
        assert float((out.final_t < 1e-3).float().mean()) > 0.05  # pixels did stop


def test_entry_rows_are_routed_by_emission_run():
    W, H, tile = 64, 48, (16, 16)
    prep, lists = sorted_scene(W, H, tile, P=120, seed=3)
    P, n = prep.means2d.shape[0], int(lists.total)
    src = lists.entry_src.numpy()
    assert sorted(src[:n]) == list(range(n))  # a permutation of the emission rows
    # sorted entry s belongs to Gaussian gauss_id[s], whose run holds src[s]
    off, cnt = lists.gauss_offset.numpy(), lists.gauss_count.numpy()
    g = lists.gauss_id.numpy()[:n]
    assert ((src[:n] >= off[g]) & (src[:n] < off[g] + cnt[g])).all()

    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.normal(size=(lists.gauss_id.shape[0], 9)).astype(np.float32))
    sums = composite.route_grads_torch(rows, lists.gauss_offset, lists.gauss_count, P)
    want = np.zeros((P, 9), np.float64)
    np.add.at(want, g, rows.numpy()[src[:n]].astype(np.float64))
    np.testing.assert_allclose(sums.numpy(), want, atol=1e-5)


def test_backward_wrappers_use_plain_versions_on_cpu():
    W, H, tile = 61, 47, (32, 16)
    prep, lists = sorted_scene(W, H, tile)
    out = composite.composite_fwd_torch(lists.gauss_id, lists.tile_start, lists.tile_stop,
                                        prep.means2d, prep.conic, prep.rgb, prep.opacity,
                                        torch.from_numpy(BG), W, H, *tile)
    g_img, g_ft = cotangents(W, H)
    args = (lists.gauss_id, lists.tile_start, lists.tile_stop, lists.entry_src, prep.means2d,
            prep.conic, prep.rgb, prep.opacity, out.image, out.final_t, g_img, g_ft, W, H, *tile)
    before = (composite_bwd.launches, route_grads.launches)
    rows = composite_bwd(*args)
    np.testing.assert_array_equal(rows.numpy(), composite.composite_bwd_torch(*args).numpy())
    P = prep.means2d.shape[0]
    sums = route_grads(rows, lists.gauss_offset, lists.gauss_count, P)
    np.testing.assert_array_equal(
        sums.numpy(),
        composite.route_grads_torch(rows, lists.gauss_offset, lists.gauss_count, P).numpy())
    assert (composite_bwd.launches, route_grads.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        composite_bwd_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        route_grads_cuda(rows, lists.gauss_offset, lists.gauss_count, P)


# ---------------------------------------------------------------------------
# (b) the port's rasterize gradients against JAX's XLA backend
# ---------------------------------------------------------------------------

def grads_both(W, H, tile, P, seed, **scene_kw):
    scene = make_gaussians(P=P, seed=seed, **scene_kw)
    jcam = make_camera(W, H, angle=0.2)
    target = np.random.default_rng(7).uniform(size=(H, W, 3)).astype(np.float32)
    bias0 = np.zeros((P, 2), np.float32)

    def jloss(m, s, q, o, sh, bg, bias):
        img, _ = jax_rasterize(m, s, q, o, sh, 3, jcam.arrays(), W, H, bg,
                               JaxConfig(backend="xla", tile_w=tile[0], tile_h=tile[1],
                                         capacity_mult=16, chunk=128), mean2d_bias=bias)
        return jnp.mean((img - target) ** 2)

    ref = jax.grad(jloss, argnums=tuple(range(7)))(*map(jnp.asarray, scene), jnp.asarray(BG),
                                                   jnp.asarray(bias0))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (*scene, BG, bias0)]
    img, _ = rasterize(*leaves[:5], 3, port_camera(jcam), W, H, leaves[5],
                       RasterizerConfig(tile_w=tile[0], tile_h=tile[1], capacity_mult=16),
                       mean2d_bias=leaves[6])
    got = torch.autograd.grad(((img - torch.from_numpy(target)) ** 2).mean(), leaves)
    return got, ref


@pytest.mark.parametrize("W,H,tile,P,seed,kw", [
    (64, 48, (32, 32), 200, 0, {}),
    (61, 47, (16, 16), 200, 4, {}),
    (64, 48, (32, 16), 300, 9, dict(spread=0.3, scale_mu=-1.8)),  # saturated
    (61, 47, (8, 8), 200, 4, {}),  # a geometry the kernels run at runtime
    (64, 48, (24, 20), 300, 9, dict(spread=0.3, scale_mu=-1.8)),
])
def test_rasterize_gradients_match_jax(W, H, tile, P, seed, kw):
    got, ref = grads_both(W, H, tile, P, seed, **kw)
    names = ("means", "scales", "quats", "opacities", "shs", "bg", "mean2d_bias")
    for name, a, b in zip(names, got, ref):
        a, b = a.numpy(), np.asarray(b)
        assert np.isfinite(a).all(), name
        scale = max(float(np.abs(b).max()), 1e-8)
        np.testing.assert_allclose(a, b, atol=2e-3 * scale, rtol=0, err_msg=name)
    assert float(np.abs(got[0].numpy()).max()) > 0


# ---------------------------------------------------------------------------
# (c) finite differences on the port (the test_grads_fd.py scene)
# ---------------------------------------------------------------------------

def test_finite_differences():
    W, H = 32, 24
    means, scales, quats, opacities, shs = make_gaussians(P=12, seed=5, spread=0.6)
    opacities = np.clip(opacities, 0.2, 0.8)  # away from the alpha clamps
    cam = port_camera(make_camera(W, H, dist=3.0))
    cfg = RasterizerConfig(capacity_mult=32)
    target = torch.from_numpy(np.random.default_rng(0).uniform(size=(H, W, 3)).astype(np.float32))
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (means, scales, quats, opacities, shs)]

    def f(*a):
        img, _ = rasterize(*a, 3, cam, W, H, torch.zeros(3), cfg)
        return ((img - target) ** 2).mean()

    leaves = [a.clone().requires_grad_(True) for a in args]
    grads = torch.autograd.grad(f(*leaves), leaves)

    def fd_at(ai, idx, eps):
        vals = []
        for sign in (1.0, -1.0):
            a = [x.clone() for x in args]
            flat = a[ai].view(-1)
            flat[idx] = float(np.float64(args[ai].view(-1)[idx]) + sign * eps)
            with torch.no_grad():
                vals.append(float(f(*a)))
        return (vals[0] - vals[1]) / (2 * eps)

    checked = skipped = 0
    for ai, (name, eps) in enumerate(
        [("means", 2e-3), ("scales", 2e-4), ("quats", 2e-3), ("opacity", 2e-3), ("shs", 2e-3)]
    ):
        gflat = grads[ai].numpy().astype(np.float64).reshape(-1)
        for idx in np.argsort(-np.abs(gflat))[:3]:
            if abs(gflat[idx]) < 1e-7:
                continue
            fd1, fd2 = fd_at(ai, int(idx), eps), fd_at(ai, int(idx), eps / 2)
            # piecewise smooth (integer radii, tile rects, clamps): skip
            # coordinates where the finite difference itself is unstable
            if abs(fd1 - fd2) > 0.02 * max(abs(fd1), abs(fd2), 1e-6):
                skipped += 1
                continue
            ad = gflat[idx]
            assert abs(fd2 - ad) <= 0.05 * max(abs(ad), abs(fd2)) + 5e-4, (
                f"{name}[{idx}]: fd={fd2} ad={ad}")
            checked += 1
    assert checked >= 8, f"only {checked} smooth coordinates checked ({skipped} skipped)"


# ---------------------------------------------------------------------------
# (d) losses against gaussian_splatting_tpu/ops/losses.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W", [(48, 64), (37, 29)])
def test_losses_match_jax(H, W):
    rng = np.random.default_rng(H)
    a = rng.uniform(size=(H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for port_fn, jax_fn in ((losses.l1_loss, jlosses.l1_loss), (losses.l2_loss, jlosses.l2_loss),
                            (losses.mse, jlosses.mse), (losses.psnr, jlosses.psnr),
                            (losses.ssim, jlosses.ssim),
                            (losses.photometric_loss, jlosses.photometric_loss)):
        np.testing.assert_allclose(float(port_fn(ta, tb)), float(jax_fn(ja, jb)), rtol=1e-6,
                                   atol=1e-6, err_msg=port_fn.__name__)
    assert 0.5 < float(losses.ssim(ta, tb)) < 1.0
    np.testing.assert_allclose(float(losses.ssim(ta, ta)), 1.0, atol=1e-6)

    leaf = ta.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(losses.ssim(leaf, tb), [leaf])
    ref = np.asarray(jax.grad(jlosses.ssim)(ja, jb))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_batched_mse_matches_jax():
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(size=(2, 16, 20, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(losses.mse(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jlosses.mse(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


# ---------------------------------------------------------------------------
# (e) the optimizer and one train step against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [-1, 0, 1, 250, 29_999, 40_000])
def test_expon_lr_matches_jax(step):
    kw = dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01, max_steps=30_000)
    for delay in (0, 100):
        np.testing.assert_allclose(expon_lr(step, lr_delay_steps=delay, **kw),
                                   float(joptim.expon_lr(step, lr_delay_steps=delay, **kw)),
                                   rtol=1e-6)


def random_params(P=240, pad=16, seed=11):
    """Raw JAX-layout parameters as numpy, with `pad` dead rows at the end."""
    means, scales, quats, ops, shs = make_gaussians(P=P, seed=seed)
    raw = {
        "xyz": means,
        "features_dc": shs[:, :1],
        "features_rest": shs[:, 1:],
        "scaling": np.log(scales),
        "rotation": quats,
        "opacity": np.log(ops / (1.0 - ops))[:, None],
    }
    fills = dict(xyz=0.0, features_dc=0.0, features_rest=0.0, scaling=-10.0,
                 rotation=0.0, opacity=-10.0)
    raw = {k: np.concatenate([v, np.full((pad,) + v.shape[1:], fills[k])]).astype(np.float32)
           for k, v in raw.items()}
    return raw, np.arange(P + pad) < P


W_T, H_T = 64, 48
OPT = OptimizationConfig()
JAX_CFG = JaxConfig(backend="xla", capacity_mult=16, chunk=128)
PORT_CFG = RasterizerConfig(capacity_mult=16)


@pytest.fixture(scope="module")
def jax_mid_training():
    """A JAX state after two steps (non-zero moments, step 2), as numpy;
    the target, camera and JAX's own third step from it."""
    raw, alive = random_params()
    jcam = make_camera(W_T, H_T, angle=0.3)
    # the target: the same scene, moved, from another angle
    shifted = dict(raw, xyz=raw["xyz"] + 0.05)
    gt, _ = jtraining.eval_render(JaxParams(**{k: jnp.asarray(v) for k, v in shifted.items()}),
                                  jnp.asarray(alive), make_camera(W_T, H_T, angle=0.35).arrays(),
                                  jnp.zeros(3), 3, 3, W_T, H_T, JAX_CFG)
    gt = np.clip(np.asarray(gt), 0, 1)
    kw = dict(cam=jcam.arrays(), gt_image=jnp.asarray(gt), bg=jnp.asarray(BG), sh_degree=3,
              active_sh_degree=3, width=W_T, height=H_T, raster_cfg=JAX_CFG, opt=OPT,
              spatial_lr_scale=2.0)
    params = JaxParams(**{k: jnp.asarray(v) for k, v in raw.items()})
    state = jtraining.init_train_state(params, jnp.asarray(alive))
    for it in (1, 2):
        state, _ = jtraining.train_step(state, iteration=jnp.int32(it), **kw)
    snap = jax.tree.map(np.array, state)  # copies: the step donates its state
    new_state, metrics = jtraining.train_step(state, iteration=jnp.int32(3), **kw)

    def jloss(p, bias):
        acts = jax_activate(p)
        img, _ = jax_rasterize(acts.xyz, acts.scales, acts.quats, acts.opacities, acts.shs, 3,
                               jcam.arrays(), W_T, H_T, jnp.asarray(BG), JAX_CFG,
                               mean2d_bias=bias, alive=jnp.asarray(snap.alive))
        return ((1 - OPT.lambda_dssim) * jlosses.l1_loss(img, gt)
                + OPT.lambda_dssim * (1 - jlosses.ssim(img, gt)))

    jgrads, jbias = jax.grad(jloss, argnums=(0, 1))(
        JaxParams(*map(jnp.asarray, snap.params)), jnp.zeros((len(alive), 2), jnp.float32))
    return dict(snap=snap, gt=gt, jcam=jcam, new=jax.tree.map(np.array, new_state),
                metrics={k: float(v) for k, v in metrics.items()},
                grads={k: np.asarray(v) for k, v in jgrads._asdict().items()},
                bias_grad=np.asarray(jbias))


def port_state(snap):
    return train_state_from_numpy(snap.params._asdict(), snap.adam.m._asdict(),
                                  snap.adam.v._asdict(), int(snap.adam.step), snap.alive,
                                  snap.max_radii2d, snap.xyz_grad_accum, snap.denom, device="cpu")


def test_train_state_carries_across(jax_mid_training):
    snap = jax_mid_training["snap"]
    state = port_state(snap)
    assert state.adam.step == 2
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(state.params, k).detach().numpy(),
                                      getattr(snap.params, k))
        np.testing.assert_array_equal(state.adam.m[k].numpy(), getattr(snap.adam.m, k))
        np.testing.assert_array_equal(state.adam.v[k].numpy(), getattr(snap.adam.v, k))
    assert np.abs(snap.adam.m.xyz).max() > 0 and np.abs(snap.adam.v.opacity).max() > 0
    np.testing.assert_array_equal(state.params.alive.numpy(), snap.alive)
    for k in ("max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_array_equal(getattr(state, k).numpy(), getattr(snap, k))
    fresh = init_train_state(params_from_numpy(snap.params._asdict(), device="cpu"))
    assert fresh.adam.step == 0 and float(fresh.denom.abs().sum()) == 0


def test_adam_update_matches_jax_on_the_same_gradients(jax_mid_training):
    # Both optimizers get JAX's gradients, so only the update arithmetic is
    # compared: near-equality (1e-6 relative) is the bar.
    snap, grads = jax_mid_training["snap"], jax_mid_training["grads"]
    lrs = {"xyz": 1e-3, "features_dc": 2.5e-3, "features_rest": 1.25e-4, "scaling": 5e-3,
           "rotation": 1e-3, "opacity": 5e-2}
    jparams, jadam = joptim.adam_update(
        JaxParams(*map(jnp.asarray, snap.params)), JaxParams(**grads),
        joptim.AdamState(JaxParams(*map(jnp.asarray, snap.adam.m)),
                         JaxParams(*map(jnp.asarray, snap.adam.v)), jnp.asarray(snap.adam.step)),
        JaxParams(**{k: jnp.float32(v) for k, v in lrs.items()}), jnp.asarray(snap.alive))
    state = port_state(snap)
    adam_update(state.params, {k: torch.tensor(v) for k, v in grads.items()}, state.adam,
                lrs, state.params.alive)
    assert state.adam.step == int(jadam.step) == 3
    for k in PARAM_NAMES:
        p_old = getattr(snap.params, k)
        p_j, p_t = np.asarray(getattr(jparams, k)), getattr(state.params, k).detach().numpy()
        # the update itself, relative to its size
        np.testing.assert_allclose(p_t - p_old, p_j - p_old, rtol=1e-6,
                                   atol=1e-6 * np.abs(p_j - p_old).max(), err_msg=k)
        np.testing.assert_allclose(state.adam.m[k].numpy(), np.asarray(getattr(jadam.m, k)),
                                   rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_allclose(state.adam.v[k].numpy(), np.asarray(getattr(jadam.v, k)),
                                   rtol=1e-6, atol=0, err_msg=k)
        dead = ~snap.alive
        np.testing.assert_array_equal(p_t[dead], p_old[dead])
        np.testing.assert_array_equal(state.adam.m[k].numpy()[dead], getattr(snap.adam.m, k)[dead])


def test_train_step_matches_jax(jax_mid_training):
    """One full step from the carried-across state, against JAX's step.

    The two steps see gradients that agree to the rasterizer bound (2e-3 x
    max |g|; on this scene to about 2e-6 relative), not bit for bit, and
    Adam at step 3 moves a parameter by about lr x m_hat / sqrt(v_hat): a
    coordinate whose gradient is near zero can swing by up to ~lr on
    rounding alone. So the new parameters are compared where
    |g| > 1e-3 x max |g| of their group, to 1e-2 x lr (a coordinate that
    followed noise instead of its gradient is off by a sizeable share of
    lr); the moments everywhere, to what the gradient bound allows (m takes
    0.1 g, v takes 0.001 g^2).
    """
    d = jax_mid_training
    snap, new, jgrads = d["snap"], d["new"], d["grads"]
    state = port_state(snap)
    cam = port_camera(d["jcam"])
    gt = torch.from_numpy(d["gt"])

    out = loss_and_grads(state.params, cam, gt, torch.from_numpy(BG), 3, W_T, H_T, PORT_CFG,
                         OPT.lambda_dssim)
    for k in PARAM_NAMES:
        scale = np.abs(jgrads[k]).max()
        np.testing.assert_allclose(out.grads[k].numpy(), jgrads[k], atol=2e-3 * scale, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(out.bias_grad.numpy(), d["bias_grad"],
                               atol=2e-3 * np.abs(d["bias_grad"]).max(), rtol=0)

    metrics = train_step(state, cam, gt, torch.from_numpy(BG), 3, 3, W_T, H_T, PORT_CFG, OPT,
                         spatial_lr_scale=2.0)
    for k in ("loss", "l1", "psnr"):
        np.testing.assert_allclose(float(metrics[k]), d["metrics"][k], rtol=1e-5, err_msg=k)
    for k in ("num_entries", "num_visible"):
        assert int(metrics[k]) == int(d["metrics"][k]), k
    assert state.adam.step == int(new.adam.step) == 3

    lrs = {"xyz": expon_lr(3, OPT.position_lr_init * 2.0, OPT.position_lr_final * 2.0,
                           lr_delay_mult=OPT.position_lr_delay_mult,
                           max_steps=OPT.position_lr_max_steps),
           "features_dc": OPT.feature_lr, "features_rest": OPT.feature_lr / 20,
           "scaling": OPT.scaling_lr, "rotation": OPT.rotation_lr, "opacity": OPT.opacity_lr}
    moved = 0
    for k in PARAM_NAMES:
        g = np.abs(jgrads[k])
        big = g > 1e-3 * g.max()
        p_t = getattr(state.params, k).detach().numpy()
        p_j = getattr(new.params, k)
        np.testing.assert_allclose(p_t[big], p_j[big], atol=1e-2 * lrs[k], rtol=0, err_msg=k)
        moved += int((p_t != getattr(snap.params, k)).sum())
        gmax = g.max()
        np.testing.assert_allclose(state.adam.m[k].numpy(), getattr(new.adam.m, k),
                                   atol=0.1 * 2e-3 * gmax, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(state.adam.v[k].numpy(), getattr(new.adam.v, k),
                                   atol=1e-3 * 2 * gmax * 2e-3 * gmax, rtol=1e-5, err_msg=k)
    assert moved > 0
    np.testing.assert_array_equal(state.max_radii2d.numpy(), new.max_radii2d)
    np.testing.assert_array_equal(state.denom.numpy(), new.denom)
    np.testing.assert_allclose(state.xyz_grad_accum.numpy(), new.xyz_grad_accum,
                               atol=2 * 2e-3 * np.abs(d["bias_grad"]).max() * 3, rtol=0)
