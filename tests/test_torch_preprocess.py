"""The port's preprocess against the JAX package's, field by field.

Floats agree at rtol=1e-5, atol=1e-4 (the absolute part covers pixel
coordinates of a few hundred); the integer fields (radii, rects, tile
counts) and `visible` must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import gsmath as jgsmath
from gaussian_splatting_tpu.ops.projection import preprocess as jax_preprocess
from gaussian_splatting_torch.ops import gsmath
from gaussian_splatting_torch.ops.projection import PreprocessOut, preprocess
from gaussian_splatting_torch.scene.cameras import Camera

from helpers import make_camera, make_gaussians
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

INT_FIELDS = ("radii", "rect_min", "rect_max", "tiles_touched", "visible")
CAM_FIELDS = ("uid", "colmap_id", "R", "T", "fovx", "fovy", "image", "image_name", "width", "height")


def port_camera(jcam):
    return Camera(**{k: getattr(jcam, k) for k in CAM_FIELDS})


def run_both(scene, W, H, tile=(32, 32), angle=0.0, **kw):
    """Preprocess one numpy scene with both packages. `kw` holds numpy
    arrays (or scalars) passed to both as keyword arguments."""
    means, scales, quats, ops, shs = scene
    jcam = make_camera(W, H, angle=angle)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ref = jax_preprocess(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats), jnp.asarray(ops),
        None if shs is None else jnp.asarray(shs), 3, jcam.arrays(), W, H, *tile, **jkw,
    )
    port = preprocess(
        torch.from_numpy(means), torch.from_numpy(scales), torch.from_numpy(quats),
        torch.from_numpy(ops), None if shs is None else torch.from_numpy(shs), 3,
        port_camera(jcam).arrays(device="cpu"), W, H, *tile, **tkw,
    )
    return port, ref


def assert_prep_equal(port, ref):
    for name in PreprocessOut._fields:
        a = getattr(port, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        if name in INT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("W,H", [(64, 48), (128, 128)])
def test_preprocess_matches_jax(seed, W, H):
    scene = make_gaussians(P=200, seed=seed)
    port, ref = run_both(scene, W, H)
    assert_prep_equal(port, ref)
    assert int(port.visible.sum()) > 50


def test_preprocess_other_tiles_and_scale_modifier():
    scene = make_gaussians(P=150, seed=1)
    port, ref = run_both(scene, 61, 47, tile=(16, 16), angle=0.7, scale_modifier=0.6)
    assert_prep_equal(port, ref)


def test_all_behind_camera():
    means, scales, quats, ops, shs = make_gaussians(P=64, seed=2)
    means = means * 0.1 + np.array([0.0, 0.0, -6.0], np.float32)  # camera sits at z = -4
    port, ref = run_both((means, scales, quats, ops, shs), 64, 48)
    assert_prep_equal(port, ref)
    assert not port.visible.any()
    assert int(port.tiles_touched.sum()) == 0


def test_alive_mask():
    scene = make_gaussians(P=120, seed=4)
    alive = np.arange(120) % 3 != 0
    port, ref = run_both(scene, 64, 48, alive=alive)
    assert_prep_equal(port, ref)
    assert not port.visible.numpy()[~alive].any()


def test_mean2d_bias():
    scene = make_gaussians(P=100, seed=6)
    bias = np.random.default_rng(6).normal(0, 0.01, (100, 2)).astype(np.float32)
    port, ref = run_both(scene, 64, 48, mean2d_bias=bias)
    assert_prep_equal(port, ref)


def test_colors_precomp():
    means, scales, quats, ops, _ = make_gaussians(P=100, seed=7)
    colors = np.random.default_rng(7).uniform(0, 1, (100, 3)).astype(np.float32)
    port, ref = run_both((means, scales, quats, ops, None), 64, 48, colors_precomp=colors)
    assert_prep_equal(port, ref)
    np.testing.assert_array_equal(port.rgb.numpy(), colors)


def test_cov3d_precomp():
    means, scales, quats, ops, shs = make_gaussians(P=100, seed=8)
    cov = np.array(jgsmath.build_cov3d(jnp.asarray(scales), jnp.asarray(quats), 1.3))
    port, ref = run_both((means, scales, quats, ops, shs), 64, 48, cov3d_precomp=cov)
    assert_prep_equal(port, ref)
    # the precomputed covariance equals the port's own at that modifier
    cov_port = gsmath.build_cov3d(torch.from_numpy(scales), torch.from_numpy(quats), 1.3)
    np.testing.assert_allclose(cov_port.numpy(), cov, rtol=1e-6, atol=1e-6)
