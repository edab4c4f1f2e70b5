"""The port's stage profiler on the CPU, held to the JAX tool's formulas.

`gaussian_splatting_torch.tools.profile_stages.run` drives every ported
stage at a tiny size (P = 300 at 128x96, 32x16 tiles, one call per line)
through the kernels' plain versions. Its header counts (entries, capacity,
tiles) and its `sat` statistics must equal what the JAX tool computes
(tools/profile_stages.py:61-72 and :167-203) with the JAX package's
`preprocess`, `emit_sorted_records` and `rasterize` on the same seeded
scene, at the run's tile geometry. Counts and percentiles are integers
and must be equal; the final-transmittance statistics may differ by the
linear vs log-space transmittance of the two packages (2e-5 per pixel,
test_golden_render.py:53).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import binning as jax_binning
from gaussian_splatting_tpu.ops.projection import preprocess as jax_preprocess
from gaussian_splatting_tpu.ops.rasterize import RasterizerConfig as JaxConfig
from gaussian_splatting_tpu.ops.rasterize import rasterize as jax_rasterize
from gaussian_splatting_tpu.scene.cameras import Camera as JaxCamera
from gaussian_splatting_torch.tools import profile_stages as ps
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

P, W, H, TILE = 300, 128, 96, (32, 16)


@pytest.fixture(scope="module")
def result():
    return ps.run(ps.STAGES, P=P, width=W, height=H, tile=TILE, iters=1, reps=1, device="cpu")


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX tool's scene (tools/profile_stages.py:38-51) and its numbers."""
    rng = np.random.default_rng(0)
    means = jnp.asarray(rng.normal(0, 1.0, (P, 3)), jnp.float32)
    scales = jnp.asarray(np.exp(rng.normal(-4.2, 0.5, (P, 3))), jnp.float32)
    quats = jnp.asarray(rng.normal(0, 1, (P, 4)), jnp.float32)
    opacities = jnp.asarray(1 / (1 + np.exp(-rng.normal(0.0, 1.0, (P,)))), jnp.float32)
    shs_np = rng.normal(0, 0.2, (P, 16, 3)).astype(np.float32)
    shs_np[:, 0, :] += 1.0
    shs = jnp.asarray(shs_np)
    cam = JaxCamera(uid=0, colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]),
                    fovx=math.radians(70), fovy=math.radians(70 * H / W), image=None,
                    image_name="bench", width=W, height=H).arrays()
    gx, gy = -(-W // TILE[0]), -(-H // TILE[1])
    prep = jax_preprocess(means, scales, quats, opacities, shs, 3, cam, W, H, *TILE)
    n_entries = int(jnp.sum(prep.tiles_touched))
    bucket = 1 << 16
    cap = max(bucket, -(int(n_entries * 1.02) // -bucket) * bucket)
    _, aux = jax_rasterize(means, scales, quats, opacities, shs, 3, cam, W, H,
                           jnp.zeros(3, jnp.float32),
                           JaxConfig(tile_w=TILE[0], tile_h=TILE[1], backend="xla",
                                     capacity_exact=cap))
    sr = jax_binning.emit_sorted_records(prep.means2d, prep.conic, prep.rgb, prep.opacity,
                                         prep.depths, prep.rect_min, prep.rect_max,
                                         prep.tiles_touched, gx, gy, cap)
    return {"entries": n_entries, "capacity": cap, "tiles": gx * gy,
            "final_t": np.asarray(aux["final_t"]),
            "tiles_touched": np.asarray(prep.tiles_touched),
            "entries_per_tile": np.asarray(sr.tile_stop - sr.tile_start)}


def test_every_stage_gives_a_finite_time(result):
    assert result["device"] == "cpu"
    for stage in ps.STAGES:
        if stage not in ("sat", "comm"):  # sat reports statistics, comm a model
            assert any(k.startswith(f"{stage}: ") for k in result["ms"]), stage
    assert all(math.isfinite(ms) and ms > 0 for ms in result["ms"].values()), result["ms"]
    assert all(math.isfinite(r["bound_ms"]) for r in result["roofline"]["rows"])


def test_kernel_calls_are_counted_per_line(result):
    # 2 calls a line (one warm-up, iters * reps = 1 timed), and sat's one render
    assert result["calls"] == {
        "composite_fwd": 2 * 5 + 1,  # render, grad, train, roofline's kernel and render lines
        "composite_bwd": 2 * 2,  # grad, train
        "route_grads": 2 * 3,  # grad, train, routing
        "relayout_to_rows": 2 * 7,  # micro 2, emitparts 2, gforms 1, routing 2
        "consume_rows": 2 * 3,
        "consume_t": 2 * 3,
    }


def test_header_counts_match_the_jax_tool(result, jax_tool):
    assert result["P"] == P
    for key in ("entries", "capacity", "tiles"):
        assert result[key] == jax_tool[key], key
    assert result["capacity"] == 65536 and result["tiles"] == 4 * 6


def _stats(x):
    return {"mean": float(x.mean()), "p50": float(np.percentile(x, 50)),
            "p95": float(np.percentile(x, 95)), "max": float(x.max())}


def test_sat_statistics_match_the_jax_tool(result, jax_tool):
    sat = result["sat"]
    ft = jax_tool["final_t"]
    assert abs(sat["final_t_mean"] - float(ft.mean())) <= 2e-5
    assert sat["final_t_share_below_1e-4"] == float(np.mean(ft < 1e-4))
    tw, th = TILE
    hh, ww = H // th * th, W // tw * tw
    tiles = ft[:hh, :ww].reshape(hh // th, th, ww // tw, tw).transpose(0, 2, 1, 3)
    assert sat["tiles_all_saturated"] == float(np.mean(tiles.reshape(-1, tw * th).max(1) < 1e-4))
    assert sat["tiles_touched"] == _stats(jax_tool["tiles_touched"])
    assert sat["entries_per_tile"] == _stats(jax_tool["entries_per_tile"])


def test_cpu_lines_say_they_are_host_clock(capsys):
    ps.run(["pre"], P=P, width=W, height=H, tile=TILE, iters=1, reps=1, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.endswith("]")]
    assert lines and all("host clock on the CPU" in ln for ln in lines)


@pytest.mark.parametrize("stage", ["gather", "visits"])
def test_unported_stages_are_refused_with_the_reason(stage, capsys):
    with pytest.raises(ValueError, match=f"{stage!r} is not ported"):
        ps.run([stage], device="cpu")
    assert ps.main([stage]) != 0
    assert ps.NOT_PORTED[stage] in capsys.readouterr().err


def test_unknown_stage_is_refused():
    with pytest.raises(ValueError, match="unknown stage"):
        ps.check_stages(["pre", "nope"])


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        ps.run(["pre"], P=P, width=W, height=H)


def test_comm_counts_the_sharded_steps_collectives(tmp_path, monkeypatch):
    """The bytes `comm` counts per step are the sizes of the tensors that a
    2-rank sharded step all-reduces (recorded in the ranks, on the scene of
    tests/test_torch_sharding.py: 128 rows at 64x48, 32x32 tiles); with a
    link rate and GS_STEP_MS, the ring's wire time and the efficiency."""
    from test_torch_sharding import H as SH
    from test_torch_sharding import W as SW
    from test_torch_sharding import jax_scene, run_ranks, step_inputs

    from helpers import make_camera

    params, alive, gt = jax_scene(0, 40, 128)
    rank = run_ranks("step", 2, step_inputs(params, alive, gt, make_camera(SW, SH), 2), tmp_path)[0]
    monkeypatch.setenv("GS_LINK_GBPS", "100")
    monkeypatch.setenv("GS_STEP_MS", "10")
    out = ps.run(["comm"], P=128, width=SW, height=SH, tile=(32, 32), iters=1, reps=1,
                 device="cpu")["comm"]
    row = next(r for r in out["rows"] if r["P"] == 128 and r["n"] == 2)
    assert [b for _, b in row["collectives"]] == rank["all_reduce_bytes"].tolist()
    assert row["tensor_bytes"] == int(rank["all_reduce_bytes"].sum())
    assert row["wire_bytes"] == row["tensor_bytes"]  # 2 (n - 1) / n = 1 at n = 2
    assert row["comm_ms"] == pytest.approx(row["wire_bytes"] / 100e9 * 1e3)
    assert row["comp_ms"] == 5.0 and 0 < row["efficiency"] < 1
    assert [(r["P"], r["n"]) for r in out["rows"]] == [
        (128 * s, n) for s in ps.COMM_P_SCALES for n in ps.COMM_RANKS]


def test_comm_without_a_link_rate_counts_bytes_only(monkeypatch):
    monkeypatch.delenv("GS_LINK_GBPS", raising=False)
    monkeypatch.delenv("GS_STEP_MS", raising=False)
    out = ps.run(["comm"], P=P, width=W, height=H, tile=TILE, iters=1, reps=1, device="cpu")
    assert all(r["comm_ms"] is None and r["efficiency"] is None for r in out["comm"]["rows"])
    assert all(r["wire_bytes"] > 0 for r in out["comm"]["rows"])
