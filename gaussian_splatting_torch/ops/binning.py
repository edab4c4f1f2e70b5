"""Tile binning: one entry per (Gaussian, covered tile), sorted by (tile, depth).

The counterpart of `gaussian_splatting_tpu/ops/binning.py::build_tile_lists`
and of the reference's device pipeline (rasterizer_impl.cu:286-410):

    cub::DeviceScan::InclusiveSum(tiles_touched)   -> torch.cumsum
    duplicateWithKeys (tileID<<32 | depth bits)    -> repeat_interleave + rect
                                                      arithmetic, int64 key
    cub::DeviceRadixSort::SortPairs                -> torch.sort(stable=True)
    identifyTileRanges                             -> searchsorted

Depths of emitted entries are > 0.2 (the near cull), so their float32 bit
patterns order like the floats, and a stable sort on the int64 key gives
exactly the order of the JAX package's stable (tile, depth) sort, ties
included.

Besides the sorted lists, `TileLists` carries what the backward needs to
route per-entry gradients to Gaussians without a second sort: the emission
index of each sorted entry (`entry_src`, the sort's permutation) and each
Gaussian's run of emission indices (`gauss_offset`, `gauss_count`).
Emission runs are contiguous by Gaussian id, so the entries of Gaussian g
are emission rows [gauss_offset[g], gauss_offset[g] + gauss_count[g]).

The entry list has a static capacity K (`RasterizerConfig.capacity`). On
overflow, whole trailing Gaussians are dropped (a rect that does not fit in
the remaining capacity emits nothing) and `total` still reports the true
count, as the JAX package's accelerator path does (binning.py:298-311).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TileLists(NamedTuple):
    gauss_id: torch.Tensor  # (K,) int32: Gaussian index per sorted entry (0 for padding)
    entry_tile: torch.Tensor  # (K,) int32: tile per sorted entry (num_tiles for padding)
    entry_valid: torch.Tensor  # (K,) bool
    tile_start: torch.Tensor  # (num_tiles,) int32 range start in the sorted list
    tile_stop: torch.Tensor  # (num_tiles,) int32 range end (exclusive)
    total: torch.Tensor  # () int64: true number of entries (> K means overflow)
    entry_src: torch.Tensor  # (K,) int32: emission index of each sorted entry
    gauss_offset: torch.Tensor  # (P,) int32: first emission index of each Gaussian's run
    gauss_count: torch.Tensor  # (P,) int32: entries kept for each Gaussian (0 if dropped)


def _tile_ranges(s_tile: torch.Tensor, num_tiles: int):
    """Per-tile [start, stop) ranges in the tile-sorted entry list:
    start[t] = #entries < t = stop[t-1]."""
    tile_ids = torch.arange(num_tiles, dtype=s_tile.dtype, device=s_tile.device)
    tile_stop = torch.searchsorted(s_tile, tile_ids, right=True).to(torch.int32)
    tile_start = torch.cat([tile_stop.new_zeros(1), tile_stop[:-1]])
    return tile_start, tile_stop


def build_tile_lists(
    rect_min: torch.Tensor,  # (P, 2) int32
    rect_max: torch.Tensor,  # (P, 2) int32
    depths: torch.Tensor,  # (P,) f32
    tiles_touched: torch.Tensor,  # (P,) int32 (0 for invisible)
    grid_x: int,
    grid_y: int,
    capacity: int,
) -> TileLists:
    dev = depths.device
    P = depths.shape[0]
    num_tiles = grid_x * grid_y
    i64 = torch.int64

    counts_raw = tiles_touched.to(i64)
    ends_raw = torch.cumsum(counts_raw, 0)
    total = ends_raw[-1] if P else counts_raw.sum()
    # Drop whole trailing Gaussians on overflow: ends_raw is monotone, so
    # `fits` is a prefix mask and the kept entries keep their offsets.
    counts = torch.where(ends_raw <= capacity, counts_raw, torch.zeros_like(counts_raw))
    offsets = ends_raw - counts_raw

    # The one host sync of the render: the kept entry count sizes the
    # expansion below.
    n = int(counts.sum())
    gid = torch.repeat_interleave(torch.arange(P, device=dev), counts, output_size=n)
    local = torch.arange(n, device=dev) - offsets[gid]
    rmin = rect_min.to(i64)[gid]
    rw = torch.clamp_min(rect_max[gid, 0].to(i64) - rmin[:, 0], 1)
    tile = (rmin[:, 1] + local // rw) * grid_x + rmin[:, 0] + local % rw

    depth_bits = depths.contiguous().view(torch.int32).to(i64)[gid] & 0xFFFFFFFF
    key = torch.full((capacity,), num_tiles << 32, dtype=i64, device=dev)
    key[:n] = (tile << 32) | depth_bits
    gid_k = torch.zeros((capacity,), dtype=i64, device=dev)
    gid_k[:n] = gid

    s_key, order = torch.sort(key, stable=True)
    s_tile = (s_key >> 32).to(torch.int32)
    tile_start, tile_stop = _tile_ranges(s_tile, num_tiles)
    valid = torch.arange(capacity, device=dev) < n
    return TileLists(
        gauss_id=gid_k[order].to(torch.int32),
        entry_tile=s_tile,
        entry_valid=valid,
        tile_start=tile_start,
        tile_stop=tile_stop,
        total=total,
        entry_src=order.to(torch.int32),
        gauss_offset=torch.clamp_max(offsets, capacity).to(torch.int32),
        gauss_count=counts.to(torch.int32),
    )
