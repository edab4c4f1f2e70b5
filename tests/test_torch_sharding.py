"""The port's multi-device train step (`gaussian_splatting_torch/parallel/
sharding.py`) and `Trainer(mesh=...)` on the CPU, against the JAX
package's sharded step and the port's single-device step.

Each rank is a subprocess (this file run as a script, which imports no
JAX) joined to a gloo process group over a localhost TCP store, with a
timeout. The JAX references run here on conftest's 8 virtual CPU devices
with `backend="xla"`; the ranks start from JAX's own initial arrays.

Tolerances:
  - one sharded step on test_sharding.py's 40-point scene at 64x48 with
    n = 2 and 4 ranks against JAX's sharded step on make_mesh(n): loss and
    l1 within rtol 1e-5, parameters within atol 2e-5, xyz_grad_accum within
    atol 1e-6; denom, num_entries, max_strip_entries, num_visible equal;
  - against the port's single-device `train_step`: the same, and the strips
    stitch into that step's image (loss and psnr bit-equal).
  - the skewed scene of test_sharding.py:298: the same max_strip_entries
    as JAX under overflow, and after the budget grows from it, loss within
    rtol 1e-5 of the single-device step.
"""

import math
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaussian_splatting_torch import OptimizationConfig, RasterizerConfig, Trainer
from gaussian_splatting_torch.ops import composite as tcomposite
from gaussian_splatting_torch.parallel import sharding
from gaussian_splatting_torch.scene.cameras import Camera
from gaussian_splatting_torch.scene.gaussians import PARAM_NAMES, params_from_numpy
from gaussian_splatting_torch.training import init_train_state, train_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
W, H = 64, 48
CAM_FIELDS = ("R", "T", "fovx", "fovy")
RANK_TIMEOUT = 300  # seconds for one rank's subprocess


# ---------------------------------------------------------------- the ranks


def _camera(d, i=0, image=None):
    return Camera(uid=i, colmap_id=i, R=d["cam_R"][i], T=d["cam_T"][i], fovx=float(d["fov"]),
                  fovy=float(d["fov"]), image=image, image_name=f"v{i}",
                  width=int(d["width"]), height=int(d["height"]))


def _cfg(d) -> RasterizerConfig:
    exact = int(d["capacity_exact"])
    return RasterizerConfig(capacity_mult=int(d["capacity_mult"]),
                            capacity_exact=exact if exact > 0 else None)


def _rank_step(mesh, d) -> dict:
    """`steps` sharded steps from the given arrays; the metrics of each, the
    rank's rows after them, and the bytes of each all_reduce of the first."""
    import torch.distributed as dist

    params = params_from_numpy({k: d[k] for k in PARAM_NAMES}, alive=d["alive"], device="cpu")
    state = sharding.shard_train_state(init_train_state(params), mesh)
    width, height = int(d["width"]), int(d["height"])
    step = sharding.make_sharded_train_step(mesh, int(d["active_sh"]), width, height, _cfg(d),
                                            OptimizationConfig(), 1.0)
    cam = _camera(d).arrays(device="cpu")
    gt = torch.from_numpy(d["gt"])
    sizes, all_reduce = [], dist.all_reduce

    def counted(t, *a, **kw):
        sizes.append(t.numel() * t.element_size())
        return all_reduce(t, *a, **kw)

    out = {k: [] for k in ("loss", "l1", "psnr", "num_entries", "num_visible",
                           "max_strip_entries")}
    for it in range(1, int(d["steps"]) + 1):
        dist.all_reduce = counted if it == 1 else all_reduce
        try:
            m = step(state, cam, gt, torch.zeros(3), it)
        finally:
            dist.all_reduce = all_reduce
        for k in out:
            out[k].append(float(m[k]))
    out = {k: np.asarray(v) for k, v in out.items()}
    out["all_reduce_bytes"] = np.asarray(sizes)
    for k in PARAM_NAMES:
        out[k] = getattr(state.params, k).detach().numpy()
    for k in sharding.STAT_NAMES:
        out[k] = getattr(state, k).numpy()
    return out


def _rank_trainer(mesh, d) -> dict:
    """A sharded `Trainer` run; its history, maintenance, live count and
    the whole state's live rows at the end (rank 0 saves a checkpoint)."""
    cams = [_camera(d, i, d["images"][i]) for i in range(len(d["images"]))]
    opt = OptimizationConfig(**pickle.loads(d["opt"].tobytes()))
    tr = Trainer(cameras=cams, opt=opt, raster_cfg=_cfg(d), sh_degree=3, min_capacity=128,
                 cameras_extent=4.0, spatial_lr_scale=4.0, device="cpu", mesh=mesh)
    tr.init_from_pcd(d["pts"], d["cols"])
    tr.train(int(d["steps"]))
    tr.save_checkpoint(str(d["ckpt"]))
    return {"loss": np.asarray([h["loss"] for h in tr.history]),
            "max_strip_entries": np.asarray([h["max_strip_entries"] for h in tr.history]),
            "num_live": np.asarray(tr.num_live), "rows": np.asarray(tr.num_rows),
            "shard_rows": np.asarray(tr.state.params.num_points),
            "paths": np.asarray([h["path"] for h in tr.densify_history])}


def _rank_init(port) -> dict:
    assert sharding.initialize_distributed() is False
    assert sharding.initialize_distributed(f"127.0.0.1:{port}", 1, 0, backend="gloo") is True
    assert sharding.initialize_distributed(f"127.0.0.1:{port}", 1, 0) is True  # idempotent
    mesh = sharding.make_mesh()
    x = torch.arange(6.0).reshape(3, 2)
    return {"size": np.asarray(mesh.size), "gathered": sharding.gather_rows(x, mesh).numpy()}


def rank_main(mode, rank, n, port, inputs, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    if mode == "init":
        result = _rank_init(port)
    else:
        d = dict(np.load(inputs, allow_pickle=False))
        sharding.initialize_distributed(f"127.0.0.1:{port}", n, rank, backend="gloo")
        mesh = sharding.make_mesh(n)
        result = (_rank_step if mode == "step" else _rank_trainer)(mesh, d)
    dist.destroy_process_group()
    np.savez(out, **result)


# ---------------------------------------------------------------- the tests


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(mode, n, inputs, tmp_path):
    """Run `n` ranks of `mode` as subprocesses; their result dicts."""
    inp = str(tmp_path / f"{mode}_in.npz")
    np.savez(inp, **inputs)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = free_port()
    outs = [str(tmp_path / f"{mode}_{n}_{r}.npz") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r), str(n),
                               str(port), inp, outs[r]], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(n)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(o)) for o in outs]


def jax_scene(seed, P, capacity):
    """test_sharding.py's scene: JAX's create_from_pcd of a seeded cloud."""
    from gaussian_splatting_tpu.scene.gaussians import create_from_pcd

    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 0.8, (P, 3)).astype(np.float32)
    colors = rng.uniform(0.2, 0.8, (P, 3)).astype(np.float32)
    params, alive = create_from_pcd(pts, colors, 3, capacity=capacity)
    gt = rng.uniform(size=(H, W, 3)).astype(np.float32)
    return params, np.asarray(alive), gt


def camera_inputs(cams):
    return {"cam_R": np.stack([c.R for c in cams]), "cam_T": np.stack([c.T for c in cams]),
            "fov": np.asarray(cams[0].fovx), "width": np.asarray(W), "height": np.asarray(H)}


def step_inputs(params, alive, gt, cam, active_sh, capacity_mult=16, capacity_exact=0, steps=1):
    d = {k: np.asarray(getattr(params, k)) for k in PARAM_NAMES}
    d.update(alive=alive, gt=gt, active_sh=np.asarray(active_sh), steps=np.asarray(steps),
             capacity_mult=np.asarray(capacity_mult), capacity_exact=np.asarray(capacity_exact))
    d.update(camera_inputs([cam]))
    return d


def gathered(results, key):
    return np.concatenate([r[key] for r in results])


def single_device(d):
    """The port's single-device train_step from the same arrays."""
    params = params_from_numpy({k: d[k] for k in PARAM_NAMES}, alive=d["alive"], device="cpu")
    state = init_train_state(params)
    cam = _camera(d).arrays(device="cpu")
    m = train_step(state, cam, torch.from_numpy(d["gt"]), torch.zeros(3), 1, int(d["active_sh"]),
                   W, H, _cfg(d), OptimizationConfig(), 1.0)
    return state, {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_matches_jax_and_single_device(tmp_path, n):
    import jax
    import jax.numpy as jnp

    from gaussian_splatting_tpu.ops.rasterize import RasterizerConfig as JaxConfig
    from gaussian_splatting_tpu.parallel import sharding as jsharding
    from gaussian_splatting_tpu.training import OptimizationConfig as JaxOpt
    from gaussian_splatting_tpu.training import init_train_state as jinit

    from helpers import make_camera

    params, alive, gt = jax_scene(0, 40, 128)
    cam = make_camera(W, H)
    d = step_inputs(params, alive, gt, cam, active_sh=2)
    ranks = run_ranks("step", n, d, tmp_path)

    mesh = jsharding.make_mesh(n)
    jstate = jsharding.shard_train_state(jinit(params, jnp.asarray(alive)), mesh)
    jstep = jsharding.make_sharded_train_step(
        mesh, 3, 2, W, H, JaxConfig(backend="xla", capacity_mult=16, chunk=128), JaxOpt(), 1.0)
    jnew, jm = jstep(jstate, jax.tree.map(jnp.asarray, cam.arrays()), jnp.asarray(gt),
                     jnp.zeros(3), jnp.asarray(1, jnp.int32))
    jm = jax.device_get(jm)
    state1, m1 = single_device(d)

    for r in ranks:  # every rank reports the same global metrics
        for k in ("loss", "l1", "psnr", "num_entries", "num_visible", "max_strip_entries"):
            assert r[k][0] == ranks[0][k][0], k
    got = ranks[0]
    for k in ("loss", "l1"):
        np.testing.assert_allclose(got[k][0], float(jm[k]), rtol=1e-5, err_msg=k)
        assert got[k][0] == m1[k], k  # the strips stitch into the single-device image
    assert got["psnr"][0] == m1["psnr"]
    for k in ("num_entries", "num_visible", "max_strip_entries"):
        assert int(got[k][0]) == int(jm[k]), k
    assert int(got["num_entries"][0]) == int(m1["num_entries"])
    assert int(got["num_visible"][0]) == int(m1["num_visible"])
    for k in PARAM_NAMES:
        np.testing.assert_allclose(gathered(ranks, k), np.asarray(getattr(jnew.params, k)),
                                   atol=2e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(gathered(ranks, k), getattr(state1.params, k).detach().numpy(),
                                   atol=2e-5, rtol=0, err_msg=k)
    for ref in (np.asarray(jnew.xyz_grad_accum), state1.xyz_grad_accum.numpy()):
        np.testing.assert_allclose(gathered(ranks, "xyz_grad_accum"), ref, atol=1e-6, rtol=0)
    for ref in (np.asarray(jnew.denom), state1.denom.numpy()):
        np.testing.assert_array_equal(gathered(ranks, "denom"), ref)
    np.testing.assert_array_equal(gathered(ranks, "max_radii2d"), state1.max_radii2d.numpy())
    assert float(gathered(ranks, "denom").sum()) > 0


def test_skewed_strip_overflow_is_reported_and_recovers(tmp_path):
    """test_sharding.py:298 with 4 ranks: every splat in the bottom tile
    rows, so one strip holds nearly all entries while the frame's total fits
    its capacity. Both packages report the same max_strip_entries; after the
    budget grows to max_strip_entries x n, the loss is the single-device
    step's."""
    import jax
    import jax.numpy as jnp

    from gaussian_splatting_tpu.ops.rasterize import RasterizerConfig as JaxConfig
    from gaussian_splatting_tpu.parallel import sharding as jsharding
    from gaussian_splatting_tpu.scene.gaussians import create_from_pcd
    from gaussian_splatting_tpu.training import OptimizationConfig as JaxOpt
    from gaussian_splatting_tpu.training import init_train_state as jinit

    from helpers import make_camera

    n = 4
    rng = np.random.default_rng(3)
    P = 700
    pts = np.stack([rng.uniform(-1.8, 1.8, P), -1.7 + rng.uniform(-0.15, 0.15, P),
                    rng.uniform(-0.3, 0.3, P)], axis=1).astype(np.float32)
    colors = rng.uniform(0.4, 0.9, (P, 3)).astype(np.float32)
    params, alive = create_from_pcd(pts, colors, 3, capacity=768)
    alive = np.asarray(alive)
    cam = make_camera(W, H)
    gt = np.zeros((H, W, 3), np.float32)

    _, m_big = single_device(step_inputs(params, alive, gt, cam, 0, capacity_mult=64))
    entries = int(m_big["num_entries"])
    cap_small = -(-entries // 256) * 256
    assert max(cap_small // n, 256) < entries
    small = run_ranks("step", n, step_inputs(params, alive, gt, cam, 0,
                                             capacity_exact=cap_small), tmp_path)[0]

    mesh = jsharding.make_mesh(n)
    jstep = jsharding.make_sharded_train_step(
        mesh, 3, 0, W, H, JaxConfig(backend="xla", capacity_exact=cap_small, chunk=128), JaxOpt(),
        1.0)
    _, jm = jstep(jsharding.shard_train_state(jinit(params, jnp.asarray(alive)), mesh),
                  jax.tree.map(jnp.asarray, cam.arrays()), jnp.asarray(gt), jnp.zeros(3),
                  jnp.asarray(1, jnp.int32))
    jm = jax.device_get(jm)
    assert int(small["max_strip_entries"][0]) == int(jm["max_strip_entries"]) > cap_small // n
    assert int(small["num_entries"][0]) == int(jm["num_entries"]) == entries <= cap_small
    assert abs(float(small["loss"][0]) - m_big["loss"]) > 1e-6  # the full strip dropped splats

    cap_big = -(-int(small["max_strip_entries"][0]) * n // 256) * 256
    big = run_ranks("step", n, step_inputs(params, alive, gt, cam, 0, capacity_exact=cap_big),
                    tmp_path)[0]
    np.testing.assert_allclose(big["loss"][0], m_big["loss"], rtol=1e-5)
    assert int(big["max_strip_entries"][0]) * n >= int(big["num_entries"][0])


def test_sharded_trainer_with_densify_and_reset(tmp_path):
    """Trainer(mesh=...) on 2 ranks, with a device densify, a host densify
    that doubles the rows and an opacity reset on the gathered state,
    against the port's single-device Trainer from the same cloud: the same
    losses (rtol 1e-5), the same maintenance and live count; rank 0's
    checkpoint loads into a single-device Trainer."""
    from helpers import make_camera, make_gaussians

    means, scales, quats, opacities, shs = make_gaussians(P=48, seed=3, spread=0.8)
    rng = np.random.default_rng(3)
    cams = [make_camera(W, H, dist=4.0, angle=i * 3.14) for i in range(2)]
    images = []
    for c in cams:  # targets: the set's render by the port's rasterizer
        from gaussian_splatting_torch import rasterize

        pc = Camera(uid=0, colmap_id=0, R=c.R, T=c.T, fovx=c.fovx, fovy=c.fovy, image=None,
                    image_name="t", width=W, height=H)
        with torch.no_grad():
            img, _ = rasterize(*(torch.from_numpy(x) for x in (means, scales, quats, opacities,
                                                               shs)),
                               3, pc.arrays(device="cpu"), W, H, torch.zeros(3),
                               RasterizerConfig(capacity_mult=16))
        images.append(np.clip(img.numpy(), 0, 1).transpose(2, 0, 1))
    pts = means + rng.normal(0, 0.1, means.shape).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (pts.shape[0], 3)).astype(np.float32)
    opt = dict(iterations=30, densify_from_iter=5, densification_interval=10,
               densify_until_iter=25, opacity_reset_interval=20, feature_lr=0.02,
               opacity_lr=0.05)
    ckpt = tmp_path / "ckpt.pkl"
    d = dict(camera_inputs(cams), images=np.stack(images), pts=pts, cols=cols, steps=np.asarray(30),
             opt=np.frombuffer(pickle.dumps(opt), np.uint8), capacity_mult=np.asarray(16),
             capacity_exact=np.asarray(0), ckpt=np.asarray(str(ckpt)))
    ranks = run_ranks("trainer", 2, d, tmp_path)

    tcams = [_camera(d, i, images[i]) for i in range(2)]
    one = Trainer(cameras=tcams, opt=OptimizationConfig(**opt), raster_cfg=_cfg(d), sh_degree=3,
                  min_capacity=128, cameras_extent=4.0, spatial_lr_scale=4.0, device="cpu")
    one.init_from_pcd(pts, cols)
    one.train(30)

    for r in ranks:
        np.testing.assert_array_equal(r["loss"], ranks[0]["loss"])
        assert int(r["num_live"]) == int(ranks[0]["num_live"])
        assert int(r["shard_rows"]) * 2 == int(r["rows"])
    losses = np.asarray([h["loss"] for h in one.history])
    assert np.isfinite(ranks[0]["loss"]).all()
    np.testing.assert_allclose(ranks[0]["loss"], losses, rtol=1e-5)
    # one densify on the device, then a host densify that grows the rows
    assert list(ranks[0]["paths"]) == [h["path"] for h in one.densify_history] == ["device", "host"]
    assert int(ranks[0]["num_live"]) == one.num_live > 10
    assert int(ranks[0]["rows"]) == one.state.params.num_points

    # rank 0's checkpoint in a single-device Trainer: saved again it holds
    # the same bits, and it trains on
    back = Trainer(cameras=tcams, opt=OptimizationConfig(**opt), raster_cfg=_cfg(d),
                   min_capacity=128, device="cpu")
    back.load_checkpoint(str(ckpt))
    assert back.iteration == 30 and back.num_live == one.num_live
    back.save_checkpoint(str(tmp_path / "again.pkl"))
    with open(ckpt, "rb") as f:
        theirs = pickle.load(f)
    with open(tmp_path / "again.pkl", "rb") as f:
        again = pickle.load(f)
    for what in ("params", "adam_m", "adam_v", "stats"):
        for k in theirs[what]:
            np.testing.assert_array_equal(again[what][k], theirs[what][k], err_msg=f"{what} {k}")
    assert math.isfinite(back.step()["loss"])
    # and it is the single-device run's state, but for float rounding that
    # 30 Adam steps carry on (each step's loss agrees to rtol 1e-5 above)
    for k in PARAM_NAMES:
        np.testing.assert_allclose(theirs["params"][k],
                                   getattr(one.state.params, k).detach().numpy()[:one.num_live],
                                   atol=1e-3, rtol=0, err_msg=k)


def test_initialize_distributed(tmp_path):
    """False without a coordinator; True with a one-process TCP store, and
    again on a second call; a mesh of one rank gathers its own rows."""
    assert sharding.initialize_distributed() is False
    out = str(tmp_path / "init.npz")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("GS_COORDINATOR", "GS_NUM_PROCESSES", "GS_PROCESS_ID"):
        env.pop(k, None)
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "init", "0", "1",
                          str(free_port()), "-", out], env=env, capture_output=True, text=True,
                         timeout=RANK_TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    got = np.load(out)
    assert int(got["size"]) == 1
    np.testing.assert_array_equal(got["gathered"], np.arange(6.0).reshape(3, 2))


@pytest.mark.parametrize("tile", [(16, 16), (32, 16)])
def test_plain_versions_at_an_origin_match_jax_and_stitch(tile):
    """`composite_fwd_torch` on each strip's clipped lists at its origin
    against JAX's `composite_tiles(..., origin_y=...)`, and the strips
    stitched into the full frame's image and final T, bit for bit; the
    backward's rows of every strip, routed and summed over the strips,
    against the full frame's."""
    import jax.numpy as jnp

    from gaussian_splatting_tpu.ops import binning as jbinning
    from gaussian_splatting_tpu.ops import composite as jcomposite
    from gaussian_splatting_tpu.ops.projection import PreprocessOut as JaxPrep
    from gaussian_splatting_torch.ops import binning
    from gaussian_splatting_torch.ops.projection import preprocess

    from helpers import make_camera, make_gaussians

    Wo, Ho = 72, 80  # odd tile counts: the last strip runs past the image
    tw, th = tile
    scene = [torch.from_numpy(x) for x in make_gaussians(P=150, seed=4, spread=0.9)]
    pc = Camera(**{k: getattr(make_camera(Wo, Ho), k) for k in CAM_FIELDS}, uid=0, colmap_id=0,
                image=None, image_name="t", width=Wo, height=Ho)
    with torch.no_grad():
        prep = preprocess(*scene, 3, pc.arrays(device="cpu"), Wo, Ho, tw, th)
    gx, gy = -(-Wo // tw), -(-Ho // th)
    bg = torch.tensor([0.1, 0.2, 0.3])
    cap = 4 * int(prep.tiles_touched.sum()) + 256
    full = binning.build_tile_lists(prep.rect_min, prep.rect_max, prep.depths,
                                    prep.tiles_touched, gx, gy, cap)
    fargs = (full.gauss_id, full.tile_start, full.tile_stop, prep.means2d, prep.conic, prep.rgb,
             prep.opacity)
    ref = tcomposite.composite_fwd_torch(*fargs, bg, Wo, Ho, tw, th)
    gen = torch.Generator().manual_seed(5)
    g_img, g_ft = torch.randn((Ho, Wo, 3), generator=gen), torch.randn((Ho, Wo), generator=gen)
    rows_full = tcomposite.composite_bwd_torch(*fargs[:3], full.entry_src, *fargs[3:], ref.image,
                                               ref.final_t, g_img, g_ft, Wo, Ho, tw, th)
    P = prep.means2d.shape[0]
    sums_full = tcomposite.route_grads_torch(rows_full, full.gauss_offset, full.gauss_count, P)

    for n in (2, 3):
        geo = sharding.StripGeometry.of(Wo, Ho, tw, th, n)
        images, ts, sums = [], [], torch.zeros_like(sums_full)
        for r in range(n):
            lo = r * geo.rows_per
            rmin, rmax, tiles = sharding.strip_rects(prep.rect_min, prep.rect_max, prep.visible,
                                                     lo, geo.rows_per)
            lists = binning.build_tile_lists(rmin, rmax, prep.depths, tiles, gx, geo.rows_per, cap)
            args = (lists.gauss_id, lists.tile_start, lists.tile_stop, *fargs[3:])
            out = tcomposite.composite_fwd_torch(*args, bg, Wo, geo.strip_h, tw, th,
                                                 origin_y=lo * th)
            # JAX's XLA compositing of the same strip at the same origin
            jprep = JaxPrep(**{k: jnp.asarray(getattr(prep, k).numpy()) for k in JaxPrep._fields})
            jprep = jprep._replace(rect_min=jnp.asarray(rmin.numpy()),
                                   rect_max=jnp.asarray(rmax.numpy()),
                                   tiles_touched=jnp.asarray(tiles.numpy()))
            jl = jbinning.build_tile_lists(jprep.rect_min, jprep.rect_max, jprep.depths,
                                           jprep.tiles_touched, gx, geo.rows_per, cap)
            jout = jcomposite.composite_tiles(jprep, jl, Wo, geo.strip_h, tw, th,
                                              jnp.asarray(bg.numpy()), chunk=64, origin_y=lo * th)
            np.testing.assert_allclose(out.image.numpy(), np.asarray(jout.image), atol=5e-5)
            np.testing.assert_allclose(out.final_t.numpy(), np.asarray(jout.final_t), atol=5e-5)
            images.append(out.image)
            ts.append(out.final_t)
            # the backward of the strip at its origin, on the full frame's cotangents
            pad = geo.rows_per * n * th - Ho
            rows_of = slice(lo * th, lo * th + geo.strip_h)
            g_s = torch.nn.functional.pad(g_img, (0, 0, 0, 0, 0, pad))[rows_of]
            g_t = torch.nn.functional.pad(g_ft, (0, 0, 0, pad))[rows_of]
            rows = tcomposite.composite_bwd_torch(*args[:3], lists.entry_src, *args[3:],
                                                  out.image, out.final_t, g_s.contiguous(),
                                                  g_t.contiguous(), Wo, geo.strip_h, tw, th,
                                                  origin_y=lo * th)
            sums += tcomposite.route_grads_torch(rows, lists.gauss_offset, lists.gauss_count, P)
        assert torch.equal(torch.cat(images)[:Ho], ref.image)
        assert torch.equal(torch.cat(ts)[:Ho], ref.final_t)
        scale = sums_full.abs().amax(dim=0)
        np.testing.assert_allclose(sums.numpy(), sums_full.numpy(), rtol=0,
                                   atol=1e-5 * float(scale.max()))


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
              sys.argv[6])
