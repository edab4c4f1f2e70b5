"""The port's tile binning against the JAX package's `build_tile_lists`.

Both see the same preprocess output (the JAX one, as numpy). Within
capacity the sorted ids, tile ranges and total must be equal. On overflow
the port drops whole trailing Gaussians, the rule of the JAX package's
accelerator path (binning.py:298-311); its XLA `build_tile_lists` cuts the
last rect short instead, so the overflow case is held to its own rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import binning as jbinning
from gaussian_splatting_tpu.ops.projection import preprocess as jax_preprocess
from gaussian_splatting_torch.ops import binning
from gaussian_splatting_torch.ops.rasterize import RasterizerConfig, rasterize
from gaussian_splatting_torch.scene.cameras import Camera

from helpers import make_camera, make_gaussians
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

CAM_FIELDS = ("uid", "colmap_id", "R", "T", "fovx", "fovy", "image", "image_name", "width", "height")


def jax_prep(W, H, tile, P=160, seed=0):
    scene = make_gaussians(P=P, seed=seed)
    jcam = make_camera(W, H)
    prep = jax_preprocess(*map(jnp.asarray, scene), 3, jcam.arrays(), W, H, *tile)
    return scene, jcam, prep


def both_lists(prep, W, H, tile, capacity):
    gx, gy = -(-W // tile[0]), -(-H // tile[1])
    args = (prep.rect_min, prep.rect_max, prep.depths, prep.tiles_touched)
    ref = jbinning.build_tile_lists(*args, gx, gy, capacity)
    port = binning.build_tile_lists(
        *(torch.from_numpy(np.array(a)) for a in args), gx, gy, capacity
    )
    return port, ref


@pytest.mark.parametrize("W,H,tile", [(64, 48, (32, 32)), (64, 48, (16, 16)), (61, 47, (32, 16))])
def test_tile_lists_match_jax(W, H, tile):
    _, _, prep = jax_prep(W, H, tile)
    capacity = 4096
    port, ref = both_lists(prep, W, H, tile, capacity)
    total = int(ref.total)
    assert 0 < total <= capacity
    assert int(port.total) == total
    for name in ("gauss_id", "entry_tile", "entry_valid", "tile_start", "tile_stop"):
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )
    assert port.gauss_id.dtype == torch.int32 and port.tile_start.dtype == torch.int32


def test_overflow_drops_whole_trailing_gaussians():
    W, H, tile = 128, 128, (16, 16)
    (means, scales, quats, ops, shs), jcam, prep = jax_prep(W, H, tile, P=300)
    counts = np.asarray(prep.tiles_touched).astype(np.int64)
    total = int(counts.sum())
    capacity = 256
    assert total > 2 * capacity  # well over capacity
    port, _ = both_lists(prep, W, H, tile, capacity)
    assert int(port.total) == total  # the true count, not the kept one

    kept = np.cumsum(counts) <= capacity  # a prefix of the Gaussians
    n_kept = int(counts[kept].sum())
    assert int(port.entry_valid.sum()) == n_kept
    ids = port.gauss_id.numpy()[:n_kept]
    # every kept Gaussian keeps all of its entries, no dropped one has any
    np.testing.assert_array_equal(np.bincount(ids, minlength=len(counts)), np.where(kept, counts, 0))

    # the image equals a render with the dropped Gaussians masked off
    cam = Camera(**{k: getattr(jcam, k) for k in CAM_FIELDS}).arrays(device="cpu")
    t = [torch.from_numpy(x) for x in (means, scales, quats, ops, shs)]
    cfg = RasterizerConfig(tile_w=16, tile_h=16, capacity_exact=capacity)
    img, aux = rasterize(*t, 3, cam, W, H, torch.zeros(3), cfg)
    img_masked, _ = rasterize(*t, 3, cam, W, H, torch.zeros(3),
                              RasterizerConfig(tile_w=16, tile_h=16, capacity_mult=64),
                              alive=torch.from_numpy(kept))
    assert int(aux["num_entries"]) == total
    np.testing.assert_array_equal(img.numpy(), img_masked.numpy())


def test_sorted_by_tile_then_depth():
    W, H, tile = 128, 128, (32, 32)
    _, _, prep = jax_prep(W, H, tile, P=300, seed=5)
    port, _ = both_lists(prep, W, H, tile, 8192)
    depths = np.asarray(prep.depths)[port.gauss_id.numpy()]
    start, stop = port.tile_start.numpy(), port.tile_stop.numpy()
    tiles = port.entry_tile.numpy()
    for t in range(len(start)):
        assert (tiles[start[t]:stop[t]] == t).all()
        assert (np.diff(depths[start[t]:stop[t]]) >= 0).all()
    assert stop[-1] == int(port.total)
