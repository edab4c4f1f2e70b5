"""The port's live-viewer bridge (`gaussian_splatting_torch/viewer/network_gui.py`)
on loopback: test_viewer.py:46 on the port, with the JAX package's wire
format. The client sends the reference's length-prefixed JSON request
and reads raw RGB plus the source path back.

Tolerances: each served frame within one uint8 level of a direct
`eval_render` through the same camera (the served frame takes the
receive() matrix round trip), the toggled frame within one level of the
plain one, and the direct toggled render bit-equal to the direct plain
one. Against the JAX package's bridge (its XLA backend) on the same
weights: the reply's bytes within one uint8 level, its source path equal."""

import math
import threading
import time

import numpy as np
import pytest
import torch

from gaussian_splatting_torch import OptimizationConfig, Trainer, create_from_pcd, eval_render
from gaussian_splatting_torch.scene.cameras import Camera
from gaussian_splatting_torch.scene.gaussians import params_from_numpy
from gaussian_splatting_torch.training import init_train_state
from gaussian_splatting_torch.viewer.network_gui import NetworkGUI
from test_viewer import _client_request

W = H = 32


def serve(gui, trainer, port, view, viewproj, **kw):
    """One client request answered by gui.poll; returns (image, path)."""
    result = {}

    def client():
        result["img"], result["path"] = _client_request(port, W, H, view, viewproj, **kw)

    t = threading.Thread(target=client)
    t.start()
    for _ in range(200):  # the listener does not block: wait for the client
        gui.try_connect()
        if gui.conn is not None:
            break
        time.sleep(0.05)
    gui.poll(trainer)
    t.join(timeout=30)
    assert not t.is_alive()
    assert "img" in result, "the bridge dropped the request"
    return result["img"], result["path"]


def as_uint8(img):
    return (torch.clamp(img, 0, 1) * 255).to(torch.uint8).numpy()


def test_network_gui_roundtrip():
    rng = np.random.default_rng(0)
    params = create_from_pcd(rng.normal(0, 0.5, (32, 3)).astype(np.float32),
                             rng.uniform(0.3, 0.8, (32, 3)).astype(np.float32),
                             sh_degree=3, capacity=64, device="cpu")
    cam = Camera(uid=0, colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, 3.0]),
                 fovx=math.radians(60), fovy=math.radians(60), image=None, image_name="v",
                 width=W, height=H)
    trainer = Trainer(cameras=[cam], opt=OptimizationConfig(iterations=1), device="cpu")
    trainer.state = init_train_state(params)
    trainer.iteration = 1  # the loop's exit condition

    # Wire matrices in the reference's transposed layout with Y/Z flips
    # (network_gui.py:74-78): undo what receive() applies.
    ca = cam.arrays(device="cpu")
    wv = ca.viewmatrix.numpy().copy()
    wv[1] *= -1
    wv[2] *= -1
    fp = ca.projmatrix.numpy().copy()
    fp[1] *= -1
    view, viewproj = wv.T.reshape(-1).tolist(), fp.T.reshape(-1).tolist()

    gui = NetworkGUI(port=0)  # an ephemeral port
    port = gui.listener.getsockname()[1]
    gui.source_path = "/data/scene"

    def direct(**kw):
        return eval_render(trainer.state.params, ca, trainer.background, 0, W, H,
                           trainer.raster_cfg, **kw)

    img, path = serve(gui, trainer, port, view, viewproj)
    assert path == "/data/scene" and img.shape == (H, W, 3) and img.max() > 0
    img_direct, aux_full = direct()
    assert np.abs(as_uint8(img_direct).astype(int) - img.astype(int)).max() <= 1

    # the scaling slider reaches the rasterizer: smaller splats light fewer pixels
    half, _ = serve(gui, trainer, port, view, viewproj, scaling_modifier=0.5)
    assert not np.array_equal(half, img)
    assert (half.sum(-1) > 0).sum() < (img.sum(-1) > 0).sum()
    img_half, aux_half = direct(scale_modifier=0.5)
    assert np.abs(as_uint8(img_half).astype(int) - half.astype(int)).max() <= 1
    assert int(aux_half["num_entries"]) <= int(aux_full["num_entries"])

    # the SIBR debug toggles reach eval_render's precomp paths
    toggled, _ = serve(gui, trainer, port, view, viewproj, shs_python=True, rot_scale_python=True)
    assert np.abs(toggled.astype(int) - img.astype(int)).max() <= 1
    img_tog, _ = direct(shs_python=True, rot_scale_python=True)
    torch.testing.assert_close(img_tog, img_direct, rtol=0, atol=0)
    gui.listener.close()


def wire_matrices(cam_arrays):
    """The camera's matrices in the wire's transposed layout with the Y / Z
    flips that receive() undoes (network_gui.py:74-78)."""
    wv = cam_arrays.viewmatrix.numpy().copy()
    wv[1] *= -1
    wv[2] *= -1
    fp = cam_arrays.projmatrix.numpy().copy()
    fp[1] *= -1
    return wv.T.reshape(-1).tolist(), fp.T.reshape(-1).tolist()


def seeded_weights(P=48, live=40, seed=7):
    """Raw parameters of P rows, the first `live` anisotropic Gaussians
    with view-dependent colour, the rest padding (dead rows)."""
    from gaussian_splatting_torch.scene.gaussians import PAD_FILLS

    rng = np.random.default_rng(seed)
    w = {"xyz": rng.normal(0, 0.6, (P, 3)), "features_dc": rng.normal(0, 0.6, (P, 1, 3)),
         "features_rest": rng.normal(0, 0.15, (P, 15, 3)),
         "scaling": np.log(rng.uniform(0.04, 0.25, (P, 3))), "rotation": rng.normal(0, 1, (P, 4)),
         "opacity": rng.normal(0.5, 1.0, (P, 1))}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    for k, v in w.items():
        v[live:] = PAD_FILLS[k]
    return w, np.arange(P) < live


@pytest.mark.parametrize("setting", [{}, {"scaling_modifier": 0.5},
                                     {"shs_python": True, "rot_scale_python": True}],
                         ids=["plain", "scaling_modifier_0.5", "sibr_toggles"])
def test_network_gui_matches_jax(setting):
    """One wire request served by the JAX package's NetworkGUI and by the
    port's, on the same seeded weights (SH degree 3, dead rows included)."""
    import jax.numpy as jnp

    from gaussian_splatting_tpu.ops.rasterize import RasterizerConfig as JaxRasterizerConfig
    from gaussian_splatting_tpu.scene.cameras import Camera as JaxCamera
    from gaussian_splatting_tpu.scene.gaussians import GaussianParams as JaxParams
    from gaussian_splatting_tpu.trainer import Trainer as JaxTrainer
    from gaussian_splatting_tpu.training import OptimizationConfig as JaxOptimizationConfig
    from gaussian_splatting_tpu.training import init_train_state as jax_init_train_state
    from gaussian_splatting_tpu.viewer.network_gui import NetworkGUI as JaxNetworkGUI

    weights, alive = seeded_weights()
    pose = dict(uid=0, colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, 3.0]), fovx=math.radians(60),
                fovy=math.radians(60), image=None, image_name="v", width=W, height=H)
    jtrainer = JaxTrainer(cameras=[JaxCamera(**pose)], raster_cfg=JaxRasterizerConfig(backend="xla"),
                          opt=JaxOptimizationConfig(iterations=1))
    jtrainer.state = jax_init_train_state(JaxParams(**{k: jnp.asarray(v) for k, v in weights.items()}), alive)
    trainer = Trainer(cameras=[Camera(**pose)], opt=OptimizationConfig(iterations=1), device="cpu")
    trainer.state = init_train_state(params_from_numpy(weights, alive=alive, device="cpu"))
    replies = []
    for tr, gui_cls in ((jtrainer, JaxNetworkGUI), (trainer, NetworkGUI)):
        tr.iteration, tr.active_sh_degree = 1, 3
        gui = gui_cls(port=0)
        gui.source_path = "/data/scene"
        view, viewproj = wire_matrices(Camera(**pose).arrays(device="cpu"))
        replies.append(serve(gui, tr, gui.listener.getsockname()[1], view, viewproj, **setting))
        gui.listener.close()
    (jax_img, jax_path), (img, path) = replies
    assert path == jax_path == "/data/scene"
    assert img.shape == jax_img.shape == (H, W, 3) and img.max() > 0
    assert np.abs(img.astype(int) - jax_img.astype(int)).max() <= 1
