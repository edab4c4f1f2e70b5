"""The plain compositing version against the JAX package and the oracle.

`composite_fwd_torch` (the CUDA kernel's plain version) blends in linear
transmittance; the JAX `composite_tiles` in log space. On the same prep and
the same sorted lists they agree at atol=2e-5, the bound the JAX package
holds its own accelerator path to (test_golden_render.py:53). The port's
`render_bruteforce` takes the entries in the same order with the same
operations, so it agrees with the plain version to the same bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import binning as jbinning
from gaussian_splatting_tpu.ops import composite as jcomposite
from gaussian_splatting_tpu.ops.projection import preprocess as jax_preprocess
from gaussian_splatting_torch.ops import binning, composite
from gaussian_splatting_torch.ops.composite_cuda import composite_fwd, composite_fwd_cuda
from gaussian_splatting_torch.ops.projection import PreprocessOut

from helpers import make_camera, make_gaussians
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ATOL = 2e-5
BG = np.array([0.1, 0.2, 0.3], np.float32)


def setup(W, H, tile, P=200, seed=0, opacity_scale=1.0, spread=1.0, scale_mu=-2.5):
    means, scales, quats, ops, shs = make_gaussians(P=P, seed=seed, spread=spread,
                                                    scale_mu=scale_mu)
    ops = (ops * opacity_scale).astype(np.float32)
    jprep = jax_preprocess(*map(jnp.asarray, (means, scales, quats, ops, shs)), 3,
                           make_camera(W, H).arrays(), W, H, *tile)
    prep = PreprocessOut(*(torch.from_numpy(np.array(f)) for f in jprep))
    gx, gy = -(-W // tile[0]), -(-H // tile[1])
    capacity = max(256, int(prep.tiles_touched.sum()))
    lists = binning.build_tile_lists(prep.rect_min, prep.rect_max, prep.depths,
                                     prep.tiles_touched, gx, gy, capacity)
    return jprep, prep, lists, capacity


def plain(prep, lists, W, H, tile, bg=BG):
    return composite.composite_fwd_torch(
        lists.gauss_id, lists.tile_start, lists.tile_stop, prep.means2d, prep.conic,
        prep.rgb, prep.opacity, torch.from_numpy(bg), W, H, *tile)


def jax_composite(jprep, capacity, W, H, tile, bg=BG):
    gx, gy = -(-W // tile[0]), -(-H // tile[1])
    jl = jbinning.build_tile_lists(jprep.rect_min, jprep.rect_max, jprep.depths,
                                   jprep.tiles_touched, gx, gy, capacity)
    return jcomposite.composite_tiles(jprep, jl, W, H, *tile, jnp.asarray(bg), chunk=128)


@pytest.mark.parametrize("W,H,tile", [
    (128, 128, (32, 32)), (64, 48, (16, 16)), (64, 48, (32, 16)), (61, 47, (32, 32)),
])
def test_plain_matches_jax_and_bruteforce(W, H, tile):
    jprep, prep, lists, capacity = setup(W, H, tile)
    out = plain(prep, lists, W, H, tile)
    ref = jax_composite(jprep, capacity, W, H, tile)
    assert out.image.shape == (H, W, 3) and out.final_t.shape == (H, W)
    np.testing.assert_allclose(out.image.numpy(), np.asarray(ref.image), atol=ATOL)
    np.testing.assert_allclose(out.final_t.numpy(), np.asarray(ref.final_t), atol=ATOL)
    brute = composite.render_bruteforce(prep, W, H, *tile, torch.from_numpy(BG))
    np.testing.assert_allclose(out.image.numpy(), brute.image.numpy(), atol=ATOL)
    np.testing.assert_allclose(out.final_t.numpy(), brute.final_t.numpy(), atol=ATOL)
    assert float(out.final_t.min()) < 0.5  # the scene covers part of the image


def test_dense_scene_saturates_like_jax():
    # Opaque, dense splats: many pixels reach the T < 1e-4 stop.
    W, H, tile = 64, 48, (16, 16)
    jprep, prep, lists, capacity = setup(W, H, tile, P=300, seed=9, spread=0.3, scale_mu=-1.8)
    out = plain(prep, lists, W, H, tile)
    ref = jax_composite(jprep, capacity, W, H, tile)
    assert float((out.final_t < 1e-3).float().mean()) > 0.05
    np.testing.assert_allclose(out.image.numpy(), np.asarray(ref.image), atol=ATOL)
    np.testing.assert_allclose(out.final_t.numpy(), np.asarray(ref.final_t), atol=ATOL)


def test_empty_scene_is_background():
    W, H, tile = 64, 48, (32, 32)
    _, prep, lists, _ = setup(W, H, tile)
    empty = lists._replace(tile_stop=lists.tile_start.clone())
    out = plain(prep, empty, W, H, tile)
    np.testing.assert_array_equal(out.image.numpy(), np.broadcast_to(BG, (H, W, 3)))
    np.testing.assert_array_equal(out.final_t.numpy(), 1.0)


def test_zero_opacity_is_background():
    W, H, tile = 64, 48, (32, 32)
    _, prep, lists, _ = setup(W, H, tile, opacity_scale=0.0)
    out = plain(prep, lists, W, H, tile)
    np.testing.assert_array_equal(out.image.numpy(), np.broadcast_to(BG, (H, W, 3)))
    np.testing.assert_array_equal(out.final_t.numpy(), 1.0)


def test_pair_count_stops_at_saturation():
    W, H, tile = 64, 48, (16, 16)
    _, prep, lists, _ = setup(W, H, tile, P=300, seed=9, spread=0.3, scale_mu=-1.8)
    args = (lists.gauss_id, lists.tile_start, lists.tile_stop, prep.means2d, prep.conic,
            prep.rgb, prep.opacity, W, H, *tile)
    pairs = composite.blend_pair_counts(*args).pairs
    counts = (lists.tile_stop - lists.tile_start).numpy()
    upper = int((counts * tile[0] * tile[1]).sum())  # every pixel x every entry
    assert 0 < pairs < upper  # saturated pixels stop early


def test_band_counts_grow_with_the_bands():
    W, H, tile = 64, 48, (16, 16)
    _, prep, lists, _ = setup(W, H, tile, P=300, seed=9, spread=0.3, scale_mu=-1.8)
    args = (lists.gauss_id, lists.tile_start, lists.tile_stop, prep.means2d, prep.conic,
            prep.rgb, prep.opacity, W, H, *tile)
    by_warps = {w: composite.blend_pair_counts(*args, warps=w) for w in (1, 4, 8)}
    c = by_warps[8]
    assert all(x[:3] == c[:3] for x in by_warps.values())  # the bands change no decision
    # one band is the whole tile: each entry counts once if any pixel blended it
    assert 0 < by_warps[1].band_entries <= by_warps[4].band_entries <= c.band_entries
    assert by_warps[1].band_entries <= int(lists.total) and c.band_entries <= c.blended


@pytest.mark.parametrize("opaque", [False, True])
def test_taken_pairs_are_the_blended_ones_and_the_stops(opaque):
    W, H, tile = 64, 48, (16, 16)
    scene = dict(P=300, seed=9, spread=0.3, scale_mu=-1.8) if opaque else dict(P=12, seed=3)
    _, prep, lists, _ = setup(W, H, tile, **scene)
    c = composite.blend_pair_counts(lists.gauss_id, lists.tile_start, lists.tile_stop,
                                    prep.means2d, prep.conic, prep.rgb, prep.opacity, W, H, *tile)
    assert 0 < c.blended <= c.taken < c.pairs
    stopped = c.taken - c.blended  # each pixel stops at one taken entry at most
    assert (0 < stopped <= W * H) if opaque else stopped == 0


def test_wrapper_uses_plain_version_on_cpu():
    W, H, tile = 61, 47, (32, 16)
    _, prep, lists, _ = setup(W, H, tile)
    args = (lists.gauss_id, lists.tile_start, lists.tile_stop, prep.means2d, prep.conic,
            prep.rgb, prep.opacity, torch.from_numpy(BG), W, H, *tile)
    before = composite_fwd.launches
    out = composite_fwd(lists, *args[3:])
    ref = composite.composite_fwd_torch(*args)
    np.testing.assert_array_equal(out.image.numpy(), ref.image.numpy())
    assert composite_fwd.launches == before  # no kernel launch on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        composite_fwd_cuda(*args)
    for tile in ((128, 64), (0, 8)):  # more than 4096 pixels; a side below 1
        with pytest.raises(ValueError, match=f"tile {tile[0]}x{tile[1]} unsupported"):
            composite_fwd_cuda(*args[:-2], *tile)


def assert_taken_inside_box(gid, means2d, conic, opacity, px, py):
    """Every pair the blend takes lies inside its Gaussian's `reach_box`:
    the kernels' cull leaves out only pairs the blend would skip."""
    box = composite.reach_box(conic, opacity)
    dx, dy, _, _, _, taken, _ = composite._pair(gid, means2d, conic, opacity, px, py,
                                                torch.ones(()))
    inside = (dx.abs() <= box[gid, 0][:, None]) & (dy.abs() <= box[gid, 1][:, None])
    assert bool((inside | ~taken).all())
    return int(taken.sum())


@pytest.mark.parametrize("tile", [(32, 32), (32, 16), (16, 16)])
def test_taken_pairs_lie_inside_their_box(tile):
    W, H = 64, 48
    _, prep, lists, _ = setup(W, H, tile, P=300, seed=9, spread=0.3, scale_mu=-1.8)
    px, py, _ = composite._tile_pixels(W, H, *tile, "cpu")
    n_taken = 0
    for _, has, _, gid in composite._entry_positions(lists.gauss_id, lists.tile_start,
                                                    lists.tile_stop):
        n_taken += assert_taken_inside_box(gid[has], prep.means2d, prep.conic, prep.opacity,
                                           px[has], py[has])
    assert n_taken > 10_000


def test_taken_pairs_of_near_singular_conics_lie_inside_their_box():
    # Splats thin as a line (correlation up to 1 - 1e-7, where the float32
    # conic's determinant is all rounding), against every pixel of the image.
    rng = np.random.default_rng(4)
    N, W, H = 240, 64, 48
    sigma = rng.uniform(0.5, 15.0, (N, 2))
    rho = rng.choice([0.9, -0.999, 0.99999, -0.9999999], N)
    det = (sigma[:, 0] * sigma[:, 1]) ** 2 * (1 - rho ** 2)
    conic = np.stack([sigma[:, 1] ** 2, -rho * sigma[:, 0] * sigma[:, 1], sigma[:, 0] ** 2], 1)
    means2d = torch.tensor(rng.uniform([-4, -4], [W + 4, H + 4], (N, 2)), dtype=torch.float32)
    conic = torch.tensor(conic / det[:, None], dtype=torch.float32)
    opacity = torch.tensor(rng.uniform(0.02, 1.0, N), dtype=torch.float32)
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                          torch.arange(W, dtype=torch.float32), indexing="ij")
    gid = torch.arange(N)
    assert assert_taken_inside_box(gid, means2d, conic, opacity, x.reshape(1, -1),
                                   y.reshape(1, -1)) > 1_000
    box = composite.reach_box(conic, opacity)
    assert bool(torch.isfinite(box).any()) and bool((box[:, 0] < W / 2).any())  # some cull


@pytest.mark.parametrize("tile", [(32, 32), (32, 16), (16, 16)])
def test_units_are_compact_blocks_of_32(tile):
    unit = composite.unit_of_pixel(*tile)
    k_pix = tile[0] * tile[1] // 256
    assert sorted(torch.bincount(unit).tolist()) == [32] * (8 * k_pix)
    p = torch.arange(tile[0] * tile[1])
    x, y = p % tile[0], p // tile[0]
    for u in range(8 * k_pix):
        xs, ys = x[unit == u], y[unit == u]
        w, h = int(xs.max() - xs.min()) + 1, int(ys.max() - ys.min()) + 1
        assert w * h == 32 and w == tile[0] // k_pix  # a full kUnitW x R block


@pytest.mark.parametrize("tile", [(8, 8), (16, 8), (8, 16), (24, 20), (64, 64), (7, 7), (1, 1)])
def test_other_geometries_cut_into_runs_of_32(tile):
    """A geometry with no compiled instantiation: unit u is the 32 pixels
    32 u .. 32 u + 31 in row-major order, and the block gives each thread
    kPix (a power of two up to 16) pixels in whole warps of at most 256
    threads, with fewer than one warp's kPix slots to spare."""
    tpx = tile[0] * tile[1]
    unit = composite.unit_of_pixel(*tile)
    np.testing.assert_array_equal(unit.numpy(), np.arange(tpx) // 32)
    pix, threads = composite.block_shape(*tile)
    assert pix in (1, 2, 4, 8, 16) and threads % 32 == 0 and threads <= 256
    assert threads * pix >= tpx > threads * pix - 32 * pix
    assert (pix == 1) or tpx > 256 * pix // 2  # the least kPix that fits


@pytest.mark.parametrize("tile", [(4097, 1), (65, 64), (0, 16), (16, -1)])
def test_geometries_the_kernels_do_not_take_raise(tile):
    with pytest.raises(ValueError, match=f"tile {tile[0]}x{tile[1]} unsupported"):
        composite.check_tile_geometry(*tile)
    with pytest.raises(ValueError, match="unsupported"):
        composite.unit_of_pixel(*tile)


def brute_force_units(prep, lists, W, H, tile):
    """(entry, unit) pairs with an open pixel inside the entry's box, and
    those with any open pixel, tile by tile and entry by entry, with the
    units taken from the kernels' unit_pixel formula lane by lane."""
    px, py, outside = composite._tile_pixels(W, H, *tile, "cpu")
    box = composite.reach_box(prep.conic, prep.opacity)
    tpx = tile[0] * tile[1]
    if tile in composite.COMPILED_TILE_GEOMETRIES:
        k_pix = tpx // 256
        unit_w = tile[0] // k_pix
        units = [[(w * (32 // unit_w) + lane // unit_w) * tile[0] + k * unit_w + lane % unit_w
                  for lane in range(32)] for w in range(8) for k in range(k_pix)]
    else:  # lane of unit k of warp w: pixel (w kPix + k) 32 + lane, if inside the tile
        k_pix, threads = composite.block_shape(*tile)
        units = [[p for p in ((w * k_pix + k) * 32 + lane for lane in range(32)) if p < tpx]
                 for w in range(threads // 32) for k in range(k_pix)]
        units = [u for u in units if u]
    in_box = any_open = 0
    for t in range(px.shape[0]):
        done, trans = outside[t].clone(), torch.ones(px.shape[1])
        for s in range(int(lists.tile_start[t]), int(lists.tile_stop[t])):
            g = lists.gauss_id[s:s + 1].long()
            dx, dy, _, _, _, taken, test = composite._pair(
                g, prep.means2d, prep.conic, prep.opacity, px[t:t + 1], py[t:t + 1], trans[None])
            inside = (dx[0].abs() <= box[g, 0]) & (dy[0].abs() <= box[g, 1])
            for u in units:
                in_box += bool((~done[u] & inside[u]).any())
                any_open += bool((~done[u]).any())
            live = ~done & taken[0]
            stop = live & (test[0] < composite.T_EPS)
            done = done | stop
            trans = torch.where(live & ~stop, test[0], trans)
    return in_box, any_open


@pytest.mark.parametrize("W,H,tile,scene", [
    (64, 48, (16, 16), dict(P=300, seed=9, spread=0.3, scale_mu=-1.8)),
    (61, 47, (32, 32), dict(P=200, seed=0)),
    (64, 48, (32, 16), dict(P=300, seed=9, spread=0.3, scale_mu=-1.8)),
    (61, 47, (8, 8), dict(P=200, seed=0)),
    (64, 48, (24, 20), dict(P=300, seed=9, spread=0.3, scale_mu=-1.8)),
])
def test_unit_counts_match_a_brute_force(W, H, tile, scene):
    _, prep, lists, _ = setup(W, H, tile, **scene)
    c = composite.blend_pair_counts(lists.gauss_id, lists.tile_start, lists.tile_stop,
                                    prep.means2d, prep.conic, prep.rgb, prep.opacity, W, H, *tile)
    in_box, any_open = brute_force_units(prep, lists, W, H, tile)
    assert c.units == in_box
    assert 0 < c.units < any_open  # the box culls some units that have open pixels


def _round_to_float32(v):
    """The float32 nearest the rational v, ties to even (v normal-ranged)."""
    from fractions import Fraction

    if v == 0:
        return 0.0
    sign, v = (-1 if v < 0 else 1), abs(v)
    e = v.numerator.bit_length() - v.denominator.bit_length()
    while Fraction(2) ** e > v:
        e -= 1
    while Fraction(2) ** (e + 1) <= v:
        e += 1
    scale = Fraction(2) ** (e - 23)  # 24 significant bits
    m = v / scale
    q, r = divmod(m.numerator, m.denominator)
    if 2 * r > m.denominator or (2 * r == m.denominator and q % 2):
        q += 1
    return float(sign * q * scale)


def test_fma_rn_rounds_once():
    """`fma_rn` (the plain version's fmaf on the card) is x y + z rounded
    once to float32: equal to the exact rational sum's nearest float32 on
    random triples, near-cancelling ones among them, where the two-step
    rounding of the CPU path differs."""
    from fractions import Fraction

    rng = np.random.default_rng(11)
    x = rng.normal(0, 10, 4000).astype(np.float32)
    y = rng.normal(0, 10, 4000).astype(np.float32)
    z = rng.normal(0, 100, 4000).astype(np.float32)
    z[:2000] = -(x[:2000] * y[:2000])  # near cancellation: x y rounded, negated
    got = composite.fma_rn(*(torch.from_numpy(a) for a in (x, y, z))).numpy()
    want = np.array([_round_to_float32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
                     for a, b, c in zip(x, y, z)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert (got != x * y + z).any()  # the two roundings of the CPU path differ

