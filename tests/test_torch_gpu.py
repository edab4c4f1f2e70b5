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
The KNN on the card: within rtol 1e-6 of the same function on the CPU.
The device densify on the card: the counts, `alive` and every value its
random draws do not reach equal to the same edit on the CPU; the split
children's scales within rtol 1e-6 (exp and log of two libraries), so
their log-scales within 1e-6 absolute.
"""

import math

import numpy as np
import pytest
import torch

from gaussian_splatting_torch import OptimizationConfig, init_train_state, train_step
from gaussian_splatting_torch.ops import binning, knn
from gaussian_splatting_torch.ops.composite import (
    composite_bwd_torch, composite_fwd_torch, route_grads_torch,
)
from gaussian_splatting_torch.ops.composite_cuda import (
    TILE_GEOMETRIES, composite_bwd, composite_bwd_cuda, composite_bwd_occupancy, composite_fwd,
    composite_fwd_cuda, composite_fwd_occupancy, composite_fwd_unculled_cuda, route_grads,
    route_grads_cuda,
)
from gaussian_splatting_torch.ops.projection import preprocess
from gaussian_splatting_torch.ops.rasterize import RasterizerConfig
from gaussian_splatting_torch.ops.relayout import (
    relayout_to_rows, relayout_to_rows_cuda, relayout_to_rows_torch,
)
from gaussian_splatting_torch.scene import densify
from gaussian_splatting_torch.scene.cameras import Camera
from gaussian_splatting_torch.scene.gaussians import PARAM_NAMES, params_from_numpy
from gaussian_splatting_torch.tools.consumers import (
    consume_rows, consume_rows_cuda, consume_rows_torch, consume_t, consume_t_cuda,
    consume_t_occupancy, consume_t_torch,
)
from gaussian_splatting_torch.training import eval_render, train_state_from_numpy

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


# Entries per tile, each with the Gaussians' opacity and size in pixels:
# counts that are not multiples of the kernel's 128-entry batch (whose
# partials are flushed at the next batch's barriers), of the reduction's 9
# fields or of 256, an empty tile, faint lists that never saturate (no
# block exit) and opaque ones that do.
RAGGED_TILES = ((0, 0.5, 4.0), (513, 0.95, 20.0), (1, 0.6, 6.0), (31, 0.3, 5.0),
                (257, 0.03, 6.0), (33, 0.2, 3.0), (300, 0.9, 12.0), (65, 0.5, 2.0))
DEEP = 384  # entries of a 513-entry list from here on come after every pixel stopped


def ragged_scene(dev, W, H, tile, seed=0):
    """Hand-made tile lists: tile t gets RAGGED_TILES[t % 8]'s count of
    entries, each its own Gaussian, centred near the tile with a random
    anisotropic footprint; emission order is a random permutation."""
    rng = np.random.default_rng(seed)
    gx, gy = -(-W // tile[0]), -(-H // tile[1])
    counts, ops, sizes = zip(*(RAGGED_TILES[t % len(RAGGED_TILES)] for t in range(gx * gy)))
    counts = np.array(counts)
    K = int(counts.sum())
    tile_of = np.repeat(np.arange(gx * gy), counts)
    corner = np.stack([tile_of % gx * tile[0], tile_of // gx * tile[1]], axis=1)
    means = corner + rng.uniform(-4, np.array(tile) + 4, (K, 2))
    sigma = np.repeat(np.array(sizes), counts)[:, None] * rng.uniform(0.5, 1.5, (K, 2))
    rho = rng.uniform(-0.6, 0.6, K)
    det = (sigma[:, 0] * sigma[:, 1]) ** 2 * (1 - rho ** 2)
    conic = np.stack([sigma[:, 1] ** 2, -rho * sigma[:, 0] * sigma[:, 1], sigma[:, 0] ** 2], 1)
    opacity = np.repeat(np.array(ops), counts) * rng.uniform(0.8, 1.0, K)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    stop = np.cumsum(counts)
    return (torch.arange(K, **i32), torch.tensor(stop - counts, **i32), torch.tensor(stop, **i32),
            torch.tensor(rng.permutation(K), **i32), torch.tensor(means, **f32),
            torch.tensor(conic / det[:, None], **f32), torch.tensor(rng.uniform(0, 1, (K, 3)), **f32),
            torch.tensor(opacity, **f32))


@pytest.mark.parametrize("tile", TILE_GEOMETRIES)
def test_backward_on_ragged_tiles(tile):
    dev = cuda_device()
    W, H = 75, 53  # a multiple of no tile side
    ids, start, stop, src, means2d, conic, rgb, opacity = ragged_scene(dev, W, H, tile)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    fwd = composite_fwd_cuda(ids, start, stop, means2d, conic, rgb, opacity, bg, W, H, *tile)
    gen = torch.Generator(device=dev).manual_seed(2)
    args = (ids, start, stop, src, means2d, conic, rgb, opacity, fwd.image, fwd.final_t,
            torch.randn((H, W, 3), generator=gen, device=dev),
            torch.randn((H, W), generator=gen, device=dev), W, H, *tile)
    replay_t = torch.full((H, W), -1.0, device=dev)
    rows = composite_bwd_cuda(*args, replay_t=replay_t)
    rows_again = composite_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(replay_t, fwd.final_t)
    assert float(fwd.final_t.min()) < 1e-3  # the opaque lists saturate: some blocks exit early
    assert torch.equal(rows, rows_again)
    ref = composite_bwd_torch(*args)
    assert_grads_close(rows, ref)
    counts = (stop - start).cpu()
    deep = torch.cat([torch.arange(int(a) + DEEP, int(b)) for a, b, n in
                      zip(start.cpu(), stop.cpu(), counts) if n == 513]).to(dev)
    deep_rows = src[deep].long()
    assert deep.numel() > 0 and bool((ref[deep_rows] == 0).all())  # past the block's exit
    assert bool((rows[deep_rows] == 0).all())


@pytest.mark.parametrize("tile", TILE_GEOMETRIES)
def test_backward_on_ragged_tiles_repeats_bit_for_bit(tile):
    # Each batch's flush shares the block with the staging of the next
    # batch; a race between them would show as rows that change from run
    # to run.
    dev = cuda_device()
    W, H = 75, 53
    ids, start, stop, src, means2d, conic, rgb, opacity = ragged_scene(dev, W, H, tile, seed=5)
    bg = torch.zeros(3, device=dev)
    fwd = composite_fwd_cuda(ids, start, stop, means2d, conic, rgb, opacity, bg, W, H, *tile)
    gen = torch.Generator(device=dev).manual_seed(6)
    args = (ids, start, stop, src, means2d, conic, rgb, opacity, fwd.image, fwd.final_t,
            torch.randn((H, W, 3), generator=gen, device=dev),
            torch.randn((H, W), generator=gen, device=dev), W, H, *tile)
    first = composite_bwd_cuda(*args)
    runs = [composite_bwd_cuda(*args) for _ in range(200)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, rows) for rows in runs)
    assert_grads_close(first, composite_bwd_torch(*args))


@pytest.mark.parametrize("tile", TILE_GEOMETRIES)
def test_forward_on_ragged_tiles_repeats_bit_for_bit(tile):
    # Units of 8x4 or 16x2 pixels, the box cull and the block exit on
    # ragged lists; edge pixels outside the 75x53 image start done and are
    # not written.
    dev = cuda_device()
    W, H = 75, 53
    ids, start, stop, _, means2d, conic, rgb, opacity = ragged_scene(dev, W, H, tile, seed=7)
    args = (ids, start, stop, means2d, conic, rgb, opacity,
            torch.tensor([0.1, 0.2, 0.3], device=dev), W, H, *tile)
    first = composite_fwd_cuda(*args)
    runs = [composite_fwd_cuda(*args) for _ in range(200)]
    torch.cuda.synchronize()
    assert float(first.final_t.min()) < 1e-3  # the opaque lists saturate: some blocks exit early
    assert all(torch.equal(first.image, r.image) and torch.equal(first.final_t, r.final_t)
               for r in runs)
    assert_close(first, composite_fwd_torch(*args))


def thin_splats_everywhere(dev, W, H, tile, seed):
    """Every tile lists the same N splats, thin as a line (correlation up to
    1 - 1e-7, where the float32 conic's determinant is all rounding), of
    every opacity from 1/255 up: the box cull at its edge cases."""
    rng = np.random.default_rng(seed)
    N = 160
    sigma = rng.uniform(0.5, 15.0, (N, 2))
    rho = rng.choice([0.0, 0.9, -0.999, 0.99999, -0.9999999], N)
    det = (sigma[:, 0] * sigma[:, 1]) ** 2 * (1 - rho ** 2)
    conic = np.stack([sigma[:, 1] ** 2, -rho * sigma[:, 0] * sigma[:, 1], sigma[:, 0] ** 2], 1)
    num_tiles = -(-W // tile[0]) * -(-H // tile[1])
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return (torch.arange(N, **i32).repeat(num_tiles), torch.arange(num_tiles, **i32) * N,
            torch.arange(1, num_tiles + 1, **i32) * N,
            torch.tensor(rng.uniform([-4, -4], [W + 4, H + 4], (N, 2)), **f32),
            torch.tensor(conic / det[:, None], **f32), torch.tensor(rng.uniform(0, 1, (N, 3)), **f32),
            torch.tensor(rng.uniform(1 / 255, 1.0, N), **f32))


@pytest.mark.parametrize("tile", TILE_GEOMETRIES)
@pytest.mark.parametrize("scene", ["ragged", "thin splats"])
def test_forward_box_cull_changes_no_bit(tile, scene):
    # The cull may leave out only pairs the blend skips, so the forward with
    # every box infinite gives the same bits.
    dev = cuda_device()
    W, H = 75, 53
    if scene == "ragged":
        ids, start, stop, _, *rest = ragged_scene(dev, W, H, tile, seed=5)
    else:
        ids, start, stop, *rest = thin_splats_everywhere(dev, W, H, tile, seed=6)
    args = (ids, start, stop, *rest, torch.tensor([0.1, 0.2, 0.3], device=dev), W, H, *tile)
    before = composite_fwd.launches
    out, full = composite_fwd_cuda(*args), composite_fwd_unculled_cuda(*args)
    torch.cuda.synchronize()
    assert composite_fwd.launches == before + 1  # the check's launch is not counted
    assert torch.equal(out.image, full.image) and torch.equal(out.final_t, full.final_t)
    assert float(out.final_t.min()) < 0.5  # the splats blend
    if scene == "ragged":
        # Not for the thin splats: the conic's condition number scales the
        # rounding gap between the kernel's FMAs and the plain version's
        # separate roundings, which then flips decisions past the tolerance.
        assert_close(out, composite_fwd_torch(*args))


def route_layout(dev, case):
    """Hostile run layouts for the routing kernel: (rows, offset, count).
    Rows outside every run are NaN, so a kernel that reads the capacity's
    padding or a neighbour's rows shows it."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "one long run":
        counts = rng.integers(0, 12, 64)
        counts[17] = 1_000_000
    elif case == "all counts zero":
        counts = np.zeros(300, np.int64)
    elif case == "runs across every chunk edge":
        counts = rng.integers(1, 3000, 80)  # crosses multiples of 32, 256, 1024, ...
    elif case.startswith("K % 4 == "):
        counts = rng.integers(0, 40, 501)
        counts[-1] += (int(case[-1]) - counts.sum()) % 4
    else:  # trailing Gaussians dropped at capacity
        counts = rng.integers(0, 40, 400)
        counts[-50:] = 0
    n = int(counts.sum())
    offset = np.cumsum(counts) - counts
    capacity = {"all counts zero": 64, "trailing dropped at capacity": n + 1000}.get(case, n)
    if case == "trailing dropped at capacity":
        offset[-50:] = capacity  # as build_tile_lists leaves them
    rows = torch.full((capacity, 9), float("nan"), device=dev)
    rows[:n] = torch.randn((n, 9), generator=torch.Generator(device=dev).manual_seed(n), device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return rows, torch.tensor(offset, **i32), torch.tensor(counts, **i32)


@pytest.mark.parametrize("case", ["one long run", "all counts zero", "runs across every chunk edge",
                                  "K % 4 == 1", "K % 4 == 2", "K % 4 == 3",
                                  "trailing dropped at capacity"])
def test_routing_on_hostile_layouts(case):
    dev = cuda_device()
    rows, offset, count = route_layout(dev, case)
    P = count.shape[0]
    if case.startswith("K % 4"):
        assert rows.shape[0] % 4 == int(case[-1])
    before = route_grads.launches
    sums = route_grads(rows, offset, count, P)
    again = route_grads_cuda(rows, offset, count, P)
    torch.cuda.synchronize()
    assert route_grads.launches == before + 2
    assert torch.equal(sums, again)  # two runs, the same bits
    assert bool(torch.isfinite(sums).all())  # no NaN row outside a run was read
    assert bool((sums[count == 0] == 0).all())
    assert_grads_close(sums, route_grads_torch(rows, offset, count, P))


def test_occupancy_queries():
    dev = cuda_device()
    for tile in TILE_GEOMETRIES:
        for query in (composite_fwd_occupancy, composite_bwd_occupancy):
            occ = query(*tile, dev.index)
            assert occ["registers"] > 0 and occ["threads"] % 32 == 0 and occ["blocks_per_sm"] >= 1
    for r in (1, 3, 16, 32):
        occ = consume_t_occupancy(r, dev.index)
        assert occ["registers"] > 0 and occ["threads"] == 256 and occ["blocks_per_sm"] >= 1


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


@pytest.mark.parametrize("R", [1, 3, 9, 12, 16, 32])
@pytest.mark.parametrize("K", [0, 1, 2047, 2049, 2 * 16384, 1_339_001])
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


@pytest.mark.parametrize("R", [4, 16])
def test_column_sums_of_an_unaligned_table(R):
    dev = cuda_device()
    K = 5001
    flat = torch.randn(K * R + 1, generator=torch.Generator(device=dev).manual_seed(R), device=dev)
    x = flat[1:].view(K, R)  # 4 bytes past a 16-byte boundary: the transposed form reads floats
    assert x.data_ptr() % 16 == 4
    ref = x.double().sum(0)
    tol = 1e-5 * x.double().abs().sum(0)
    a, b = consume_t_cuda(x), consume_t_cuda(x)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert bool(((a.double().reshape(R) - ref).abs() <= tol).all())


def test_knn_on_the_card_matches_the_cpu():
    dev = cuda_device()
    pts = np.random.default_rng(7).normal(size=(30_000, 3)).astype(np.float32)
    got = knn.mean_knn_dist2(pts, device=dev)  # the Morton form above 20,000 points
    want = knn.mean_knn_dist2(pts, device="cpu")
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-6, atol=0)


def densify_state(dev, cap=8192, live=3000, seed=2):
    """Live rows on which clone, split, the opacity prune and the size prune
    all fire (threshold 0.5, extent 1, percent_dense 0.01), on `dev`."""
    rng = np.random.default_rng(seed)
    shapes = {"xyz": (3,), "features_dc": (1, 3), "features_rest": (15, 3), "scaling": (3,),
              "rotation": (4,), "opacity": (1,)}
    pad = lambda a: np.concatenate([a, np.zeros((cap - live,) + a.shape[1:], a.dtype)])  # noqa: E731
    params = {k: rng.normal(size=(live,) + sh).astype(np.float32) for k, sh in shapes.items()}
    params["scaling"] = rng.normal(np.log(0.01), 1.0, (live, 3)).astype(np.float32)
    params["scaling"][:50] = 0.5
    params["opacity"] *= 3.0
    m = {k: rng.normal(size=x.shape).astype(np.float32) for k, x in params.items()}
    v = {k: rng.uniform(size=x.shape).astype(np.float32) for k, x in params.items()}
    accum = rng.uniform(0, 2, live).astype(np.float32)
    denom = rng.integers(0, 3, live).astype(np.float32)
    return train_state_from_numpy(
        {k: pad(x) for k, x in params.items()}, {k: pad(x) for k, x in m.items()},
        {k: pad(x) for k, x in v.items()}, 5, np.arange(cap) < live,
        pad(np.zeros(live, np.float32)), pad(accum), pad(denom), device=dev)


@pytest.mark.parametrize("use_size_prune", [False, True])
def test_device_densify_on_the_card_matches_the_cpu(use_size_prune):
    dev = cuda_device()
    kw = dict(max_grad=0.5, min_opacity=0.005, extent=1.0, percent_dense=0.01,
              use_size_prune=use_size_prune)
    edited = []
    for d in (dev, torch.device("cpu")):
        state = densify_state(d)
        before = state.params.scaling.detach().clone()
        counts = densify.densify_and_prune_device(
            state, torch.Generator(device=d).manual_seed(3), **kw)
        edited.append((counts, state, before))
    (got_counts, got, _), (want_counts, want, before) = edited
    assert got_counts == want_counts and want_counts["overflow"] == 0
    assert want_counts["n_cloned"] > 0 and want_counts["n_split"] > 0
    alive = want.params.alive
    assert torch.equal(got.params.alive.cpu(), alive)
    # slots that took a split child: alive, with a new log-scale
    child = alive & (want.params.scaling.detach() != before).any(dim=1)
    assert int(child.sum()) > 0
    for k in PARAM_NAMES:
        a, b = getattr(got.params, k).detach().cpu(), getattr(want.params, k).detach()
        if k in ("xyz", "scaling"):
            assert torch.equal(a[~child], b[~child]), k
        else:
            assert torch.equal(a, b), k
        assert torch.equal(got.adam.m[k].cpu(), want.adam.m[k]), k
        assert torch.equal(got.adam.v[k].cpu(), want.adam.v[k]), k
    # the children's scales within rtol 1e-6, so their logs within 1e-6
    # absolute (a log has no relative bound near 0)
    got_log = got.params.scaling.detach().cpu()[child].numpy()
    want_log = want.params.scaling.detach()[child].numpy()
    np.testing.assert_allclose(np.exp(got_log), np.exp(want_log), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_log, want_log, rtol=0, atol=1e-6)


def test_cli_round_trip_on_the_card(tmp_path, monkeypatch):
    """The train, render and metrics CLIs on the card at 128x72 on a COLMAP
    dataset written by the port: the files, a falling loss, the ground
    truths bit-equal to the dataset's PNGs, each render within the
    forward's rule (every pixel within one level, at most 0.1 % off) of
    the plain version's render of the saved PLY on the CPU, and finite
    metrics."""
    import json
    import os
    import sys

    from gaussian_splatting_torch.cli import metrics, render, train
    from gaussian_splatting_torch.scene.dataset_readers import write_colmap_scene
    from gaussian_splatting_torch.scene.gaussians import params_from_ply
    from gaussian_splatting_torch.utils.image_io import read_png

    dev = cuda_device()
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # safe_state replaces it
    W, H, n_views = 128, 72, 9
    rng = np.random.default_rng(0)
    means, scales, quats, ops, shs = random_scene(400, seed=4)
    cams, images = [], []
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        pos = np.array([4 * math.sin(a), 0.0, -4 * math.cos(a)])
        fwd = -pos / 4
        right = np.cross([0.0, 1.0, 0.0], fwd)
        R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        cam = Camera(uid=0, colmap_id=0, R=R, T=-R.T @ pos, fovx=math.radians(60),
                     fovy=math.radians(60) * H / W, image=None, image_name=f"v{i}", width=W, height=H)
        with torch.no_grad():
            img = eval_render(params_from_numpy({
                "xyz": means, "features_dc": shs[:, :1], "features_rest": shs[:, 1:],
                "scaling": np.log(scales), "rotation": quats,
                "opacity": np.log(ops / (1 - ops))[:, None]}, device=dev),
                cam.arrays(device=dev), torch.zeros(3, device=dev), 3, W, H)[0]
        cams.append(cam)
        images.append(render.quantize(img.cpu().numpy()))
    data, model = str(tmp_path / "data"), str(tmp_path / "model")
    colors = rng.integers(0, 256, (400, 3)).astype(np.uint8)
    write_colmap_scene(data, cams, images, means + rng.normal(0, 0.1, means.shape), colors)

    _, tr = train.main(["-s", data, "-m", model, "--eval", "--iterations", "30",
                        "--test_iterations", "30", "--densify_from_iter", "10",
                        "--densification_interval", "10", "--disable_viewer", "--quiet"])
    assert tr.iteration == 30 and tr.densify_history
    assert np.mean([h["loss"] for h in tr.history[-5:]]) < np.mean([h["loss"] for h in tr.history[:5]])
    render.main(["-m", model, "--quiet"])
    metrics.main(["-m", model])
    with open(os.path.join(model, "results.json")) as f:
        m = json.load(f)["ours_30"]
    assert math.isfinite(m["SSIM"]) and math.isfinite(m["PSNR"]) and m["LPIPS"] is None

    saved = params_from_ply(os.path.join(model, "point_cloud/iteration_30/point_cloud.ply"),
                            device="cpu")
    names = sorted(c.image_name for c in cams)
    for split, split_names in (("test", names[::8]), ("train", [n for i, n in enumerate(names) if i % 8])):
        out = os.path.join(model, split, "ours_30")
        for i, name in enumerate(split_names):
            gt = read_png(os.path.join(out, "gt", f"{i:05d}.png"))
            np.testing.assert_array_equal(gt, images[int(name[1:])])
            cam = cams[int(name[1:])]
            with torch.no_grad():
                cpu = eval_render(saved, cam.arrays(device="cpu"), torch.zeros(3), 3, W, H)[0]
            diff = np.abs(read_png(os.path.join(out, "renders", f"{i:05d}.png")).astype(int)
                          - render.quantize(cpu.numpy()).astype(int)).max(-1)
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (split, name)
