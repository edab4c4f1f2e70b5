"""The render slice as a whole: the port's `rasterize` / `eval_render`
against the golden fixture and against the JAX package's functions.

Images and final transmittance agree at atol=2e-5 (linear vs log-space
transmittance, the bound of test_golden_render.py:53); radii, visibility
and entry counts are equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.rasterize import RasterizerConfig as JaxConfig
from gaussian_splatting_tpu.ops.rasterize import mark_visible as jax_mark_visible
from gaussian_splatting_tpu.scene.gaussians import GaussianParams as JaxParams
from gaussian_splatting_tpu.scene.ply import load_gaussians_ply as jax_load_ply
from gaussian_splatting_tpu.training import eval_render as jax_eval_render
from gaussian_splatting_torch import RasterizerConfig, eval_render, mark_visible, rasterize
from gaussian_splatting_torch.scene.cameras import Camera
from gaussian_splatting_torch.scene.gaussians import params_from_numpy, params_from_ply

from helpers import make_camera, make_gaussians
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
ATOL = 2e-5
CAM_FIELDS = ("uid", "colmap_id", "R", "T", "fovx", "fovy", "image", "image_name", "width", "height")


def port_camera(jcam):
    return Camera(**{k: getattr(jcam, k) for k in CAM_FIELDS})


def test_golden_render_128():
    # The scene of test_golden_render.py: seed 5, P = 300, 128x128, 32x32 tiles.
    W = H = 128
    scene = make_gaussians(P=300, seed=5, spread=0.9)
    cam = port_camera(make_camera(W, H)).arrays(device="cpu")
    img, aux = rasterize(*map(torch.from_numpy, scene), 3, cam, W, H, [0.1, 0.2, 0.3],
                         RasterizerConfig(capacity_mult=32))
    golden = np.load(os.path.join(FIXTURE_DIR, "golden_render_128.npy"))
    golden_ft = np.load(os.path.join(FIXTURE_DIR, "golden_final_t_128.npy"))
    assert img.shape == golden.shape and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), golden, atol=ATOL)
    np.testing.assert_allclose(aux["final_t"].numpy(), golden_ft, atol=ATOL)


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
    alive = np.arange(P + pad) < P
    return raw, alive


def assert_renders_match(port, ref):
    (img, aux), (jimg, jaux) = port, ref
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=ATOL)
    np.testing.assert_allclose(aux["final_t"].numpy(), np.asarray(jaux["final_t"]), atol=ATOL)
    for name in ("radii", "visible"):
        np.testing.assert_array_equal(aux[name].numpy(), np.asarray(jaux[name]), err_msg=name)
    assert int(aux["num_entries"]) == int(jaux["num_entries"])


@pytest.mark.parametrize("shs_python,rot_scale_python,scale_modifier", [
    (False, False, 1.0), (True, False, 1.0), (False, True, 0.8),
])
def test_eval_render_matches_jax(shs_python, rot_scale_python, scale_modifier):
    W, H = 96, 64
    raw, alive = random_params()
    jcam = make_camera(W, H, angle=0.3)
    bg = np.array([0.0, 0.5, 1.0], np.float32)
    ref = jax_eval_render(
        JaxParams(**{k: jnp.asarray(v) for k, v in raw.items()}), jnp.asarray(alive),
        jcam.arrays(), jnp.asarray(bg), 3, 3, W, H, JaxConfig(backend="xla", capacity_mult=16),
        scale_modifier=scale_modifier, shs_python=shs_python, rot_scale_python=rot_scale_python,
    )
    params = params_from_numpy(raw, alive=alive, device="cpu")
    port = eval_render(
        params, port_camera(jcam).arrays(device="cpu"), torch.from_numpy(bg), 3, W, H,
        RasterizerConfig(capacity_mult=16), scale_modifier=scale_modifier,
        shs_python=shs_python, rot_scale_python=rot_scale_python,
    )
    assert_renders_match(port, ref)
    assert not port[1]["visible"].numpy()[~alive].any()
    assert int(port[1]["visible"].sum()) > 100


def test_golden_ply_renders_like_jax():
    W, H = 64, 48
    path = os.path.join(FIXTURE_DIR, "golden_gaussians.ply")
    jcam = make_camera(W, H, angle=0.2)
    raw = jax_load_ply(path)
    ref = jax_eval_render(
        JaxParams(**{k: jnp.asarray(v) for k, v in raw.items()}), jnp.ones((8,), bool),
        jcam.arrays(), jnp.zeros(3), 3, 3, W, H, JaxConfig(backend="xla"),
    )
    params = params_from_ply(path, device="cpu")
    assert params.num_points == 8 and bool(params.alive.all())
    port = eval_render(params, port_camera(jcam).arrays(device="cpu"), [0.0, 0.0, 0.0], 3, W, H)
    assert_renders_match(port, ref)
    assert int(port[1]["visible"].sum()) == 8


def test_mark_visible_matches_jax():
    means = make_gaussians(P=100, seed=12, spread=3.0)[0]
    jcam = make_camera(64, 48)
    port = mark_visible(torch.from_numpy(means), port_camera(jcam).arrays(device="cpu").viewmatrix)
    ref = jax_mark_visible(jnp.asarray(means), jnp.asarray(jcam.arrays().viewmatrix))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert 0 < int(port.sum()) < 100


def test_unknown_backend_raises():
    scene = make_gaussians(P=10, seed=0)
    cam = port_camera(make_camera(32, 32)).arrays(device="cpu")
    with pytest.raises(ValueError, match="backend"):
        rasterize(*map(torch.from_numpy, scene), 3, cam, 32, 32, [0, 0, 0],
                  RasterizerConfig(backend="pallas"))


def test_loaders_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is usable")
    raw, alive = random_params(P=4, pad=0)
    path = os.path.join(FIXTURE_DIR, "golden_gaussians.ply")
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(raw)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_ply(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_camera(make_camera(32, 32)).arrays()
