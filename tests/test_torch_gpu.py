"""The CUDA kernels against their plain versions, on the card, and one
train step through them.

Marked `gpu`; each test skips itself where there is no CUDA. Imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Forward: the kernels round three steps as FMAs (csrc/blend.cuh), which
can flip an alpha >= 1/255 or T >= 1e-4 decision on a few pixels; so at
least 99.9% of pixels agree within 1e-5 and every pixel within 1e-2.
Backward and routing (per gradient field): relative L2 error <= 1e-4, and
at least 99.9% of rows within 1e-3 x the field's max |grad| (the same few
flipped pixels, and float32 sums in other orders). The backward's replay
of the forward is exact: its final transmittance equals the forward's bit
for bit, and two runs give the same bits.
The transpose is a copy: bit-equal to its plain version. The column sums
take float32 partials in another order than a float64 sum: per column
within 1e-5 x the sum of |x|, and two runs give the same bits.
"""

import math

import numpy as np
import pytest
import torch

from gaussian_splatting_torch import OptimizationConfig, init_train_state, train_step
from gaussian_splatting_torch.ops import binning
from gaussian_splatting_torch.ops.composite import (
    composite_bwd_torch, composite_fwd_torch, route_grads_torch,
)
from gaussian_splatting_torch.ops.composite_cuda import (
    TILE_GEOMETRIES, composite_bwd, composite_bwd_cuda, composite_fwd, composite_fwd_cuda,
    route_grads, route_grads_cuda,
)
from gaussian_splatting_torch.ops.projection import preprocess
from gaussian_splatting_torch.ops.rasterize import RasterizerConfig
from gaussian_splatting_torch.ops.relayout import (
    relayout_to_rows, relayout_to_rows_cuda, relayout_to_rows_torch,
)
from gaussian_splatting_torch.scene.cameras import Camera
from gaussian_splatting_torch.scene.gaussians import params_from_numpy
from gaussian_splatting_torch.tools.consumers import (
    consume_rows, consume_rows_cuda, consume_rows_torch, consume_t, consume_t_cuda,
    consume_t_torch,
)
from gaussian_splatting_torch.training import eval_render

pytestmark = pytest.mark.gpu


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def random_scene(P, seed):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 1, (P, 3))
    scales = np.exp(rng.normal(-2.5, 0.3, (P, 3)))
    quats = rng.normal(0, 1, (P, 4))
    ops = 1 / (1 + np.exp(-rng.normal(0.5, 1, (P,))))
    shs = rng.normal(0, 0.2, (P, 16, 3))
    shs[:, 0, :] += 1.0
    return means, scales, quats, ops, shs


def camera(W, H, dev):
    return Camera(uid=0, colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]),
                  fovx=math.radians(60), fovy=math.radians(60), image=None,
                  image_name="gpu", width=W, height=H).arrays(device=dev)


def sorted_lists(dev, W, H, tile, P=1500, seed=0):
    scene = [torch.tensor(x, dtype=torch.float32, device=dev) for x in random_scene(P, seed)]
    prep = preprocess(*scene, 3, camera(W, H, dev), W, H, *tile)
    lists = binning.build_tile_lists(prep.rect_min, prep.rect_max, prep.depths,
                                     prep.tiles_touched, -(-W // tile[0]), -(-H // tile[1]),
                                     int(prep.tiles_touched.sum()) + 256)
    return prep, lists


def kernel_inputs(dev, W, H, tile, P=1500, seed=0):
    prep, lists = sorted_lists(dev, W, H, tile, P, seed)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    return [lists.gauss_id, lists.tile_start, lists.tile_stop, prep.means2d, prep.conic,
            prep.rgb, prep.opacity, bg, W, H, *tile]


def assert_close(out, ref):
    for a, b in ((out.image, ref.image), (out.final_t, ref.final_t)):
        d = (a - b).abs()
        assert bool(torch.isfinite(a).all())
        assert float(d.max()) <= 1e-2
        assert float((d > 1e-5).float().mean()) <= 1e-3


@pytest.mark.parametrize("tile", TILE_GEOMETRIES)
@pytest.mark.parametrize("W,H", [(128, 128), (333, 197)])
def test_kernel_matches_plain(W, H, tile):
    prep, lists = sorted_lists(cuda_device(), W, H, tile)
    args = [lists.gauss_id, lists.tile_start, lists.tile_stop, prep.means2d, prep.conic,
            prep.rgb, prep.opacity, torch.tensor([0.1, 0.2, 0.3], device=prep.means2d.device),
            W, H, *tile]
    before = composite_fwd.launches
    out = composite_fwd(lists, *args[3:])
    torch.cuda.synchronize()
    assert composite_fwd.launches == before + 1
    assert_close(out, composite_fwd_torch(*args))


def test_empty_tiles_are_background():
    args = kernel_inputs(cuda_device(), 64, 48, (32, 32))
    args[2] = args[1].clone()  # every tile empty
    out = composite_fwd_cuda(*args)
    torch.cuda.synchronize()
    assert bool((out.image == args[7]).all()) and bool((out.final_t == 1).all())


def test_bad_inputs_raise():
    args = kernel_inputs(cuda_device(), 64, 48, (32, 32))
    bad = list(args)
    bad[3] = args[3].double()
    with pytest.raises(ValueError, match="dtype"):
        composite_fwd_cuda(*bad)
    bad = list(args)
    bad[4] = args[4].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        composite_fwd_cuda(*bad)


def assert_grads_close(a, b):
    """Per field (column): relative L2 error <= 1e-4, and >= 99.9% of rows
    within 1e-3 x the field's max |grad|."""
    assert bool(torch.isfinite(a).all())
    for f in range(b.shape[1]):
        d = (a[:, f] - b[:, f]).double()
        ref = b[:, f].double()
        assert float(d.norm()) <= 1e-4 * max(float(ref.norm()), 1e-30), f
        assert float((d.abs() > 1e-3 * float(ref.abs().max())).double().mean()) <= 1e-3, f


@pytest.mark.parametrize("tile", TILE_GEOMETRIES)
@pytest.mark.parametrize("W,H", [(128, 128), (333, 197)])
def test_backward_kernels_match_plain(W, H, tile):
    dev = cuda_device()
    prep, lists = sorted_lists(dev, W, H, tile)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    fwd = composite_fwd_cuda(lists.gauss_id, lists.tile_start, lists.tile_stop, prep.means2d,
                             prep.conic, prep.rgb, prep.opacity, bg, W, H, *tile)
    gen = torch.Generator(device=dev).manual_seed(1)
    g_img = torch.randn((H, W, 3), generator=gen, device=dev)
    g_ft = torch.randn((H, W), generator=gen, device=dev)
    args = (lists.gauss_id, lists.tile_start, lists.tile_stop, lists.entry_src, prep.means2d,
            prep.conic, prep.rgb, prep.opacity, fwd.image, fwd.final_t, g_img, g_ft, W, H, *tile)
    replay_t = torch.full((H, W), -1.0, device=dev)
    before = (composite_bwd.launches, route_grads.launches)
    rows = composite_bwd_cuda(*args, replay_t=replay_t)
    rows_again = composite_bwd(*args)
    P = prep.means2d.shape[0]
    sums = route_grads(rows, lists.gauss_offset, lists.gauss_count, P)
    torch.cuda.synchronize()
    assert (composite_bwd.launches, route_grads.launches) == (before[0] + 2, before[1] + 1)
    assert torch.equal(replay_t, fwd.final_t)  # the forward's decisions, replayed
    n = int(lists.total)  # rows past the kept entries are padding, never written or read
    assert torch.equal(rows[:n], rows_again[:n])  # deterministic
    rows_ref = composite_bwd_torch(*args)
    assert_grads_close(rows[:n], rows_ref[:n])
    assert_grads_close(sums, route_grads_torch(rows_ref, lists.gauss_offset,
                                               lists.gauss_count, P))
    assert_grads_close(route_grads_cuda(rows, lists.gauss_offset, lists.gauss_count, P),
                       route_grads_torch(rows, lists.gauss_offset, lists.gauss_count, P))


def test_train_step_on_the_card():
    dev = cuda_device()
    W, H, P = 160, 120, 1500
    means, scales, quats, ops, shs = random_scene(P, seed=3)
    raw = {"xyz": means, "features_dc": shs[:, :1], "features_rest": shs[:, 1:],
           "scaling": np.log(scales), "rotation": quats, "opacity": np.log(ops / (1 - ops))[:, None]}
    cam = camera(W, H, dev)
    cfg = RasterizerConfig(capacity_mult=16)
    target = eval_render(params_from_numpy(dict(raw, xyz=raw["xyz"] + 0.05), device=dev),
                         cam, [0.0, 0.0, 0.0], 3, W, H, cfg)[0].clamp(0, 1)
    state = init_train_state(params_from_numpy(raw, device=dev))
    xyz0 = state.params.xyz.detach().clone()
    before = (composite_fwd.launches, composite_bwd.launches, route_grads.launches)
    losses = []
    for it in (1, 2):
        m = train_step(state, cam, target, torch.zeros(3, device=dev), it, 3, W, H, cfg,
                       OptimizationConfig(), spatial_lr_scale=1.0)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    after = (composite_fwd.launches, composite_bwd.launches, route_grads.launches)
    assert after == tuple(b + 2 for b in before)
    assert all(math.isfinite(x) for x in losses) and int(m["num_visible"]) > 100
    assert state.adam.step == 2 and not torch.equal(state.params.xyz, xyz0)
    assert float(state.denom.max()) == 2.0


@pytest.mark.parametrize("R", [1, 9, 16, 32])
@pytest.mark.parametrize("K", [0, 255, 4097, 1_339_001])
def test_transpose_is_bit_equal(R, K):
    dev = cuda_device()
    x = torch.randn((R, K), generator=torch.Generator(device=dev).manual_seed(K + R), device=dev)
    before = relayout_to_rows.launches
    out = relayout_to_rows(x)
    torch.cuda.synchronize()
    assert relayout_to_rows.launches == before + (K > 0)
    assert out.shape == (K, R) and torch.equal(out, relayout_to_rows_torch(x))


def test_transpose_rejects_what_the_kernel_does_not_take():
    dev = cuda_device()
    with pytest.raises(ValueError, match="1 <= R <= 32"):
        relayout_to_rows_cuda(torch.zeros((33, 8), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        relayout_to_rows_cuda(torch.zeros((8, 9), device=dev).t())


@pytest.mark.parametrize("R", [1, 9, 16, 32])
@pytest.mark.parametrize("K", [0, 1, 2047, 2 * 16384, 1_339_001])
def test_column_sums_match_and_repeat(R, K):
    dev = cuda_device()
    x = torch.randn((K, R), generator=torch.Generator(device=dev).manual_seed(K + R), device=dev)
    ref = x.double().sum(0)
    tol = 1e-5 * x.double().abs().sum(0)
    before = (consume_rows.launches, consume_t.launches)
    for fn, cuda_fn, plain, shape in ((consume_rows, consume_rows_cuda, consume_rows_torch, (1, R)),
                                      (consume_t, consume_t_cuda, consume_t_torch, (R, 1))):
        a, b = fn(x), cuda_fn(x)
        torch.cuda.synchronize()
        assert a.shape == shape and torch.equal(a, b)  # two runs, the same bits
        assert bool(((a.double().reshape(R) - ref).abs() <= tol).all())
        assert bool(((plain(x).double().reshape(R) - ref).abs() <= tol).all())
    assert (consume_rows.launches, consume_t.launches) == (before[0] + 2, before[1] + 2)
