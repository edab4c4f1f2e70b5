"""Front-to-back alpha compositing of depth-sorted tile entries, in plain torch.

The counterpart of `gaussian_splatting_tpu/ops/composite.py` and of the
reference's `forward.cu::renderCUDA` (forward.cu:331-485). Blending rules
(forward.cu:437-463), per pixel, entries front to back:

    power = -0.5(a dx^2 + c dy^2) - b dx dy, d = mean2d - pixel ; skip if power > 0
    alpha = min(0.99, opacity * exp(power))  ; skip unless alpha >= 1/255
    stop (sticky) if T*(1-alpha) < 1e-4, BEFORE compositing that entry
    C += rgb * alpha * T ; T = T*(1-alpha)
    image = C + T * bg, final_t = T

Functions:
  - `composite_fwd_torch`: the plain version of the compositing kernel in
    `ops/composite_cuda.py`, with the same signature. It walks every
    tile's sorted list one entry position at a time, vectorised over all
    tiles and their pixels, in linear transmittance with the kernel's order
    of operations, so kernel and plain version agree to rounding. The
    CPU path and the tests use it; on the card only the kernel check calls it.
  - `composite_bwd_torch`: the plain version of the backward kernel, the
    VJP of the blend; one row of 9 gradients per entry. It walks the same
    entry positions with the same arithmetic (`_pair`), so it takes the
    forward's decisions.
  - `route_grads_torch`: the plain version of the routing kernel, the sum
    of each Gaussian's entry rows.
  - `reach_box`, `unit_of_pixel`, `block_shape`: the plain twins of the
    kernels' entry box, pixel units and block size (csrc/blend.cuh);
    `check_tile_geometry`, the tiles the kernels take (any tile_w x tile_h
    of at most 4096 pixels); and `blend_pair_counts`, the work the kernels
    do on given inputs.
  - `render_bruteforce`: the oracle ("reference" backend). It composites
    every visible Gaussian against every pixel in global depth order, with
    the same rect-overlap rule as the tiled path. Small scenes only.

The JAX package blends in log-space transmittance (segmented prefix sums);
the two agree to ~2e-5 on a [0, 1.2] image.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


class CompositeOut(NamedTuple):
    image: torch.Tensor  # (H, W, 3)
    final_t: torch.Tensor  # (H, W) final transmittance


def _tile_pixels(width: int, height: int, tile_w: int, tile_h: int, dev, origin_y: int = 0):
    """Global pixel coordinates of every tile's pixels, (T, TPX) float32
    each, and the mask of those outside the image. The image is a strip
    whose first row is global pixel row `origin_y` (0 for a whole frame):
    the y coordinate is global, the mask is the strip's own."""
    grid_x = (width + tile_w - 1) // tile_w
    grid_y = (height + tile_h - 1) // tile_h
    tiles = torch.arange(grid_x * grid_y, device=dev)
    pix = torch.arange(tile_w * tile_h, device=dev)
    x = ((tiles % grid_x) * tile_w)[:, None] + (pix % tile_w)[None, :]
    y = ((tiles // grid_x) * tile_h)[:, None] + (pix // tile_w)[None, :]
    return (x.to(torch.float32), (y + origin_y).to(torch.float32),
            (x >= width) | (y >= height))


def fma_rn(x, y, z):
    """fmaf(x, y, z) of float32 tensors, x y + z rounded once to float32,
    through float64: the product is exact there, and the float64 sum,
    rounded again to float32, differs from one rounding only where it lands
    exactly on a float32 tie."""
    return (x.double() * y.double() + z.double()).float()


def _power(a, b, c, dx, dy):
    """power = -0.5 (a dx^2 + c dy^2) - b dx dy. On CUDA tensors, where
    the plain version is the kernels' reference, rounded as csrc/blend.cuh's
    pair_alpha: the quadratic form is one FMA, and its second FMA, -0.5 quad
    - b dx dy, equals the float32 subtraction (the product by -0.5 is
    exact). On the CPU every step rounds on its own, the arithmetic the CPU
    tests hold to the JAX package's."""
    if dx.is_cuda:
        return -0.5 * fma_rn(a * dx, dx, c * dy * dy) - b * dx * dy
    return -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy


def _transmit(trans, alpha):
    """T (1 - alpha): on CUDA tensors rounded as csrc/blend.cuh's transmit,
    fmaf(-T, alpha, T); on the CPU as two steps."""
    if trans.is_cuda:
        return fma_rn(-trans, alpha, trans)
    return trans * (1.0 - alpha)


def _pair(gid, means2d, conic, opacity, px, py, trans):
    """The per-(entry, pixel) blend arithmetic in the kernels' order of
    operations (csrc/blend.cuh; on CUDA tensors also with their FMAs'
    rounding, `_power`, `_transmit`): d, G = exp(power), the unclamped
    alpha `raw`, alpha, whether the entry is taken (not skipped) and the
    transmittance test."""
    dx = means2d[gid, 0][:, None] - px
    dy = means2d[gid, 1][:, None] - py
    a = conic[gid, 0][:, None]
    b = conic[gid, 1][:, None]
    c = conic[gid, 2][:, None]
    power = _power(a, b, c, dx, dy)
    g = torch.exp(power)
    raw = opacity[gid][:, None] * g
    alpha = torch.clamp_max(raw, ALPHA_MAX)
    # `alpha >= ALPHA_MIN` is false for NaN, so a NaN alpha is skipped.
    taken = ~(power > 0.0) & (alpha >= ALPHA_MIN)
    test = _transmit(trans, alpha)
    return dx, dy, g, raw, alpha, taken, test


def reach_box(conic: torch.Tensor, opacity: torch.Tensor) -> torch.Tensor:
    """The plain twin of the kernels' `reach` (csrc/blend.cuh), in float64:
    per Gaussian, (N, 2) float32 half-width and half-height in pixels of the
    box outside which the blend cannot take it (op exp(-Q/2) >= 1/255 needs
    Q <= t = 2 ln(255 op); the ellipse Q <= t spans |dx| <= sqrt(t c / det),
    |dy| <= sqrt(t a / det)). Widened for the float32 rounding of the pair
    arithmetic by 16 u kappa + 1e-3 on t (kappa = (a + c)^2 / det), 1e-3
    and 0.01 pixel. +inf where the conic is not positive definite or not
    finite (no cull); -1 where op < 1/255 (every pixel culled)."""
    a32 = conic[:, 0]
    a, b, c = (conic[:, i].double() for i in range(3))
    det = a * c - b * b
    t = 2.0 * torch.log(255.0 * opacity.double())
    kappa = (a + c) * (a + c) / det
    tq = torch.clamp_min(t, 0.0) * (1.0 + 1e-3 + 16.0 * 5.9604645e-8 * kappa) + 1e-3
    box = torch.stack([torch.sqrt(tq * c / det), torch.sqrt(tq * a / det)], 1).float() + 0.01
    box = torch.where(~(t > -1e-3)[:, None], torch.full_like(box, -1.0), box)
    no_cull = ~(a32 > 0.0) | ~(det > 0.0) | ~(det < float("inf"))
    return torch.where(no_cull[:, None], torch.full_like(box, float("inf")), box)


# Tile geometries with compile-time instantiations of the kernels (256
# threads, units of whole rows); every other one up to MAX_TILE_PIXELS runs
# their runtime-geometry instantiation (csrc/blend.cuh).
COMPILED_TILE_GEOMETRIES = ((32, 32), (32, 16), (16, 16))
MAX_TILE_PIXELS = 4096
_MAX_THREADS = 256


def check_tile_geometry(tile_w: int, tile_h: int) -> None:
    """Raise a ValueError naming the geometry unless the compositing
    kernels take it: tile_w, tile_h >= 1 and tile_w * tile_h <= 4096."""
    if not (tile_w >= 1 and tile_h >= 1 and tile_w * tile_h <= MAX_TILE_PIXELS):
        raise ValueError(f"tile {tile_w}x{tile_h} unsupported: the compositing kernels take "
                         f"tile_w, tile_h >= 1 with at most {MAX_TILE_PIXELS} pixels a tile")


def block_shape(tile_w: int, tile_h: int) -> tuple:
    """The plain twin of the kernels' `block_shape` (csrc/blend.cuh):
    (pixels per thread, threads per block) for a tile geometry. kPix is
    the least of 1, 2, 4, 8, 16 with tile_w tile_h <= 256 kPix; the block
    has tile_w tile_h / kPix threads rounded up to whole warps."""
    check_tile_geometry(tile_w, tile_h)
    tpx = tile_w * tile_h
    pix = 1
    while tpx > _MAX_THREADS * pix:
        pix *= 2
    threads = -(-tpx // pix)
    return pix, -(-threads // 32) * 32


def unit_of_pixel(tile_w: int, tile_h: int) -> torch.Tensor:
    """The plain twin of the kernels' `unit_pixel` (csrc/blend.cuh): for
    each pixel of a tile in row-major order, (tile_w * tile_h,) int64, the
    32-pixel unit it belongs to, numbered warp * kPix + k. At a compiled
    geometry (`COMPILED_TILE_GEOMETRIES`) a block of 256 threads gives each
    kPix pixels; warp w owns rows w R .. w R + R - 1 (R = 32 / kUnitW,
    kUnitW = tile_w / kPix), and its unit k is the kUnitW x R block at
    column k kUnitW. At any other geometry unit u is the 32 pixels 32 u ..
    32 u + 31 in row-major order (the last one short where the tile's
    pixels are not a multiple of 32)."""
    if (tile_w, tile_h) not in COMPILED_TILE_GEOMETRIES:
        check_tile_geometry(tile_w, tile_h)
        return torch.arange(tile_w * tile_h) // 32
    p = torch.arange(tile_w * tile_h)
    k_pix = tile_w * tile_h // _MAX_THREADS
    unit_w = tile_w // k_pix
    x, y = p % tile_w, p // tile_w
    return (y // (32 // unit_w)) * k_pix + x // unit_w


def _slots(n: int, size: int, dev) -> torch.Tensor:
    """(ceil(n / size), size) indices that cut 0 .. n - 1 into runs of
    `size`, the last one short: n marks a slot past the end."""
    idx = torch.arange(-(-n // size) * size, device=dev)
    return torch.where(idx < n, idx, n).reshape(-1, size)


def _entry_positions(gauss_id, tile_start, tile_stop):
    """Yields, for each entry position j of the longest tile list, the
    tiles that have an entry there (T,) bool, that entry's sorted index
    (T,) int64 and its Gaussian id (T,) int64 (0 where the tile has none)."""
    start = tile_start.to(torch.int64)
    count = (tile_stop - tile_start).to(torch.int64)
    longest = int(count.max()) if count.numel() else 0
    last = max(gauss_id.shape[0] - 1, 0)
    for j in range(longest):
        has = count > j
        s = torch.clamp(start + j, max=last)
        gid = torch.where(has, gauss_id[s].to(torch.int64), 0)
        yield j, has, s, gid


def _blend_tiles(gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity,
                 width: int, height: int, tile_w: int, tile_h: int,
                 warps: Optional[int] = None, origin_y: int = 0):
    """Per-tile blend. Returns acc (T, TPX, 3) before background, final
    transmittance (T, TPX), and (5,) int64 counts of the work, zero unless
    the backward kernel's `warps` is given: the (pixel, entry) pairs
    evaluated (for each pixel, those up to and including the one it
    stopped at), of those the pairs taken (alpha >= 1/255) and the pairs
    blended; the (entry, warp
    band) pairs in which some pixel of the band (a tile's pixels in
    row-major order cut into `warps` runs of ceil(TPX / warps)) blended the
    entry; and the
    (entry, unit) pairs in which some pixel of the 32-pixel unit
    (`unit_of_pixel`) was open: not done and inside the entry's box
    (`reach_box`), the units the kernels evaluate."""
    dev = means2d.device
    px, py, done = _tile_pixels(width, height, tile_w, tile_h, dev, origin_y)
    trans = torch.ones(px.shape, dtype=torch.float32, device=dev)
    acc = torch.zeros(px.shape + (3,), dtype=torch.float32, device=dev)
    counts = torch.zeros(5, dtype=torch.int64, device=dev)
    T = px.shape[0]
    if warps is not None:
        box = reach_box(conic, opacity)
        # (unit, lane) -> the unit's pixels in order, the pad column where it is short
        unit = unit_of_pixel(tile_w, tile_h)
        order = torch.argsort(unit, stable=True)
        lane = torch.arange(unit.numel()) - torch.searchsorted(unit[order], unit[order])
        by_unit = torch.full((int(unit.max()) + 1, 32), unit.numel(), dtype=torch.int64)
        by_unit[unit[order], lane] = order
        by_unit = by_unit.to(dev)
        by_band = _slots(px.shape[1], -(-px.shape[1] // warps), dev)
        pad = torch.zeros((T, 1), dtype=torch.bool, device=dev)

    for j, has, _, gid in _entry_positions(gauss_id, tile_start, tile_stop):
        # Leave once no pixel of any tile with entries left is still open.
        if j % 32 == 0 and not bool((has[:, None] & ~done).any()):
            break
        live = has[:, None] & ~done
        dx, dy, _, _, alpha, taken, test = _pair(gid, means2d, conic, opacity, px, py, trans)
        if warps is not None:
            inside = (dx.abs() <= box[gid, 0][:, None]) & (dy.abs() <= box[gid, 1][:, None])
            counts[0] += live.sum()
            counts[1] += (live & taken).sum()
            counts[4] += torch.cat([live & inside, pad], 1)[:, by_unit].any(dim=-1).sum()
        live = live & taken
        stop = live & (test < T_EPS)
        done = done | stop
        live = live & ~stop
        if warps is not None:
            counts[2] += live.sum()
            counts[3] += torch.cat([live, pad], 1)[:, by_band].any(dim=-1).sum()
        w = torch.where(live, alpha * trans, torch.zeros_like(trans))
        acc = acc + rgb[gid][:, None, :] * w[..., None]
        trans = torch.where(live, test, trans)
    return acc, trans, counts


def _untile(x: torch.Tensor, width: int, height: int, tile_w: int, tile_h: int):
    """(num_tiles, TPX, ...) tile-major pixels -> (H, W, ...) image."""
    grid_x = (width + tile_w - 1) // tile_w
    grid_y = (height + tile_h - 1) // tile_h
    rest = x.shape[2:]
    x = x.reshape((grid_y, grid_x, tile_h, tile_w) + rest).transpose(1, 2)
    x = x.reshape((grid_y * tile_h, grid_x * tile_w) + rest)
    return x[:height, :width]


def _to_tiles(x: torch.Tensor, width: int, height: int, tile_w: int, tile_h: int):
    """(H, W, ...) image -> (num_tiles, TPX, ...) tile-major pixels, zero
    outside the image; the inverse of `_untile`."""
    grid_x = (width + tile_w - 1) // tile_w
    grid_y = (height + tile_h - 1) // tile_h
    rest = x.shape[2:]
    padded = x.new_zeros((grid_y * tile_h, grid_x * tile_w) + rest)
    padded[:height, :width] = x
    padded = padded.reshape((grid_y, tile_h, grid_x, tile_w) + rest).transpose(1, 2)
    return padded.reshape((grid_x * grid_y, tile_w * tile_h) + rest)


def composite_fwd_torch(gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity,
                        bg, width: int, height: int, tile_w: int, tile_h: int,
                        origin_y: int = 0) -> CompositeOut:
    """Plain version of the compositing kernel (`composite_cuda.composite_fwd`).

    gauss_id (K,) int32 sorted entries; tile_start/tile_stop (T,) int32;
    means2d (P,2), conic (P,3), rgb (P,3), opacity (P,), bg (3,) float32.
    Returns image (H, W, 3) and final_t (H, W). With `origin_y`, the image
    is a strip of H rows whose first row is global pixel row origin_y: the
    tiles' pixels sit there (the multi-device step's strips).
    """
    acc, trans, _ = _blend_tiles(gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity,
                                 width, height, tile_w, tile_h, origin_y=origin_y)
    out = acc + trans[..., None] * bg
    return CompositeOut(
        image=_untile(out, width, height, tile_w, tile_h),
        final_t=_untile(trans, width, height, tile_w, tile_h),
    )


class PairCounts(NamedTuple):
    pairs: int  # (pixel, entry) pairs evaluated
    taken: int  # of those, the pairs with alpha >= 1/255 (blended, or the one a pixel stops at)
    blended: int  # of those, the pairs blended
    band_entries: int  # (entry, warp band) pairs in which some pixel blended the entry
    units: int  # (entry, 32-pixel unit) pairs with an open pixel inside the entry's box


def blend_pair_counts(gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity,
                      width: int, height: int, tile_w: int, tile_h: int,
                      warps: int = 8) -> PairCounts:
    """The work that bounds the compositing kernels, on these inputs: the
    (pixel, entry) pairs the blend evaluates (for every pixel, its tile's
    entries up to and including the one it stopped at), the pairs it takes
    and the pairs it blends; the (entry, warp band) pairs in which at least
    one pixel blended the entry, where a tile's pixels in row-major order
    are cut into `warps` runs of ceil(TPX / warps), as the backward kernel
    splits them over its 8 warps at a compiled geometry (each is one
    per-entry reduction over a warp in that kernel); and the
    (entry, unit) pairs that both kernels evaluate: the 32-pixel units of
    `unit_of_pixel` with a pixel that is not done and lies inside the
    entry's `reach_box` (a unit without one is skipped by a warp vote)."""
    counts = _blend_tiles(gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity,
                          width, height, tile_w, tile_h, warps=warps)[2]
    return PairCounts(*(int(c) for c in counts))


def composite_bwd_torch(gauss_id, tile_start, tile_stop, entry_src, means2d, conic, rgb,
                        opacity, image, final_t, g_image, g_final_t,
                        width: int, height: int, tile_w: int, tile_h: int,
                        origin_y: int = 0) -> torch.Tensor:
    """Plain version of the compositing backward kernel
    (`composite_cuda.composite_bwd`): the VJP of `composite_fwd_torch`.

    image (H, W, 3) and final_t (H, W) are the forward's outputs (the image
    with background); g_image / g_final_t their cotangents. Returns one row
    of 9 gradients per entry, (K, 9) float32, at row `entry_src[s]` for
    sorted entry s: d mean2d (2), d conic a, b, c (3), d rgb (3),
    d opacity (1). Rows of entries that blend nowhere are zero. `origin_y`
    as in `composite_fwd_torch`.

    It replays the forward entry by entry in forward order, with its
    decisions, and writes the suffix colour term as TOTAL - prefix:
      TOTAL    = sum_c g_c image_c + g_ft T_final        (per pixel)
      prefix_i = sum_{j <= i} cg_j alpha_j T_j,  cg_i = sum_c g_c rgb_ic
      dL/dalpha_i = T_i cg_i - (TOTAL - prefix_i) / (1 - alpha_i)
    The alpha clamp's gradient is gated: no alpha-path gradient where the
    unclamped op * G >= 0.99, while d rgb still flows.
    """
    dev = means2d.device
    f32 = torch.float32
    px, py, done = _tile_pixels(width, height, tile_w, tile_h, dev, origin_y)
    g = _to_tiles(g_image, width, height, tile_w, tile_h)  # (T, TPX, 3)
    img = _to_tiles(image, width, height, tile_w, tile_h)
    total = ((g[..., 0] * img[..., 0] + g[..., 1] * img[..., 1] + g[..., 2] * img[..., 2])
             + _to_tiles(g_final_t, width, height, tile_w, tile_h)
             * _to_tiles(final_t, width, height, tile_w, tile_h))
    trans = torch.ones(px.shape, dtype=f32, device=dev)
    pfx = torch.zeros(px.shape, dtype=f32, device=dev)
    rows = torch.zeros((gauss_id.shape[0], 9), dtype=f32, device=dev)
    zero = torch.zeros_like(trans)

    for j, has, s, gid in _entry_positions(gauss_id, tile_start, tile_stop):
        if j % 32 == 0 and not bool((has[:, None] & ~done).any()):
            break
        live = has[:, None] & ~done
        dx, dy, gs, raw, alpha, taken, test = _pair(gid, means2d, conic, opacity, px, py, trans)
        live = live & taken
        stop = live & (test < T_EPS)
        done = done | stop
        live = live & ~stop

        e_rgb = rgb[gid][:, None, :]
        cg = g[..., 0] * e_rgb[..., 0] + g[..., 1] * e_rgb[..., 1] + g[..., 2] * e_rgb[..., 2]
        w = torch.where(live, alpha * trans, zero)
        pfx = pfx + cg * w
        dalpha = trans * cg - (total - pfx) / (1.0 - alpha)
        gate = live & (raw < ALPHA_MAX)
        dpower = torch.where(gate, dalpha * raw, zero)
        a = conic[gid, 0][:, None]
        b = conic[gid, 1][:, None]
        c = conic[gid, 2][:, None]
        terms = torch.stack([
            -(a * dx + b * dy) * dpower,
            -(c * dy + b * dx) * dpower,
            -0.5 * dx * dx * dpower,
            -dx * dy * dpower,
            -0.5 * dy * dy * dpower,
            g[..., 0] * w,
            g[..., 1] * w,
            g[..., 2] * w,
            torch.where(gate, dalpha * gs, zero),
        ], dim=-1)  # (T, TPX, 9)
        rows[entry_src[s[has]].to(torch.int64)] = terms.sum(dim=1)[has]
        trans = torch.where(live, test, trans)
    return rows


def route_grads_torch(rows, gauss_offset, gauss_count, num_points: int) -> torch.Tensor:
    """Plain version of the gradient-routing kernel (`composite_cuda.route_grads`):
    the sum of each Gaussian's entry rows, (P, 9) float32. Gaussian g owns
    rows [gauss_offset[g], gauss_offset[g] + gauss_count[g]) of `rows`."""
    dev = rows.device
    count = gauss_count.to(torch.int64)
    n = int(count.sum())
    seg = torch.repeat_interleave(torch.arange(num_points, device=dev), count, output_size=n)
    first = torch.cumsum(count, 0) - count
    src = gauss_offset.to(torch.int64)[seg] + (torch.arange(n, device=dev) - first[seg])
    out = torch.zeros((num_points, rows.shape[1]), dtype=rows.dtype, device=dev)
    return out.index_add_(0, seg, rows[src])


def render_bruteforce(prep, width: int, height: int, tile_w: int, tile_h: int,
                      bg: torch.Tensor) -> CompositeOut:
    """Oracle: global depth sort, every visible Gaussian against every pixel.

    A pixel only sees Gaussians whose tile rect covers the pixel's tile,
    the same rule as the tiled path, so the outputs match it.
    """
    dev = prep.means2d.device
    f32 = torch.float32
    inf = torch.full_like(prep.depths, float("inf"))
    order = torch.argsort(torch.where(prep.visible, prep.depths, inf), stable=True)
    order = order[: int(prep.visible.sum())]

    ix = torch.arange(width, dtype=f32, device=dev)[None, :]
    iy = torch.arange(height, dtype=f32, device=dev)[:, None]
    tile_x = (torch.arange(width, device=dev) // tile_w)[None, :]
    tile_y = (torch.arange(height, device=dev) // tile_h)[:, None]

    trans = torch.ones((height, width), dtype=f32, device=dev)
    acc = torch.zeros((height, width, 3), dtype=f32, device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for g in order.tolist():
        (r0x, r0y), (r1x, r1y) = prep.rect_min[g].tolist(), prep.rect_max[g].tolist()
        in_rect = (tile_x >= r0x) & (tile_x < r1x) & (tile_y >= r0y) & (tile_y < r1y)
        dx = prep.means2d[g, 0] - ix
        dy = prep.means2d[g, 1] - iy
        a, b, c = prep.conic[g]
        power = _power(a, b, c, dx, dy)
        alpha = torch.clamp_max(prep.opacity[g] * torch.exp(power), ALPHA_MAX)
        live = in_rect & ~done & ~(power > 0.0) & (alpha >= ALPHA_MIN)
        test = _transmit(trans, alpha)
        stop = live & (test < T_EPS)
        done = done | stop
        live = live & ~stop
        w = torch.where(live, alpha * trans, torch.zeros_like(trans))
        acc = acc + prep.rgb[g] * w[..., None]
        trans = torch.where(live, test, trans)
    return CompositeOut(image=acc + trans[..., None] * bg, final_t=trans)
