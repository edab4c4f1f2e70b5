"""The port's CLIs (`gaussian_splatting_torch/cli/*`) on the CPU
(`main(argv, device="cpu")`), against the JAX package's CLIs on one
synthetic Blender scene.

Tolerances:
  - parity, both train CLIs for 5 iterations: every PLY attribute within
    rtol 1e-4 (the bound of test_torch_trainer.py:270 on the losses), but
    the rotations; the 3D covariances that scaling and rotation make
    within 1e-4 of each Gaussian's largest entry. The init is isotropic,
    so a rotation's imaginary parts have no gradient but rounding noise,
    which Adam turns into +-lr steps in either package: those components
    are not compared one by one;
  - the port's render CLI on a JAX-trained model: its PNGs equal to the
    JAX render CLI's but at most 0.1 % of pixels, each at most one level
    off (the forward's rule, test_torch_render.py);
  - the port's metrics CLI on the JAX CLI's renders: results within 1e-5
    relative of the JAX CLI's.
The init cloud is 300 points (GS_TPU_BLENDER_INIT_POINTS, read by both
packages) to keep the plain compositing versions quick.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.cli import full_eval as jfull_eval
from gaussian_splatting_tpu.cli import metrics as jmetrics
from gaussian_splatting_tpu.cli import render as jrender
from gaussian_splatting_tpu.cli import train as jtrain
from gaussian_splatting_torch.cli import convert, full_eval, metrics, render, train
from gaussian_splatting_torch.scene import ply
from gaussian_splatting_torch.utils.image_io import read_png

sys.path.insert(0, os.path.dirname(__file__))

TRAIN_FLAGS = ["--iterations", "5", "--test_iterations", "5", "--save_iterations", "5",
               "--checkpoint_iterations", "5", "--densify_from_iter", "1000", "--eval",
               "--disable_viewer", "--quiet"]


@pytest.fixture(scope="module")
def env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GS_TPU_BLENDER_INIT_POINTS", "300")
        mp.setattr(sys, "stdout", sys.stdout)  # safe_state replaces it
        yield mp


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory, env):
    from make_synthetic_scene import make_blender_scene

    d = str(tmp_path_factory.mktemp("cli") / "scene")
    make_blender_scene(d, n_train=3, n_test=1)
    return d


def copy_of(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory, scene_dir):
    """A model directory trained, rendered and scored by the JAX CLIs."""
    base = tmp_path_factory.mktemp("jax")
    src = copy_of(scene_dir, base / "scene")
    model = str(base / "model")
    jtrain.main(["-s", src, "-m", model] + TRAIN_FLAGS)
    jrender.main(["-m", model, "--quiet"])
    jmetrics.main(["-m", model])
    return model


def test_train_render_metrics(scene_dir, tmp_path, env):
    """test_cli.py:26 on the port: train -> render -> metrics, with a
    torch.profiler trace of steps 2-7."""
    src = copy_of(scene_dir, tmp_path / "scene")
    model_dir = str(tmp_path / "model")
    scene, trainer = train.main(
        ["-s", src, "-m", model_dir, "--iterations", "8", "--test_iterations", "8",
         "--save_iterations", "8", "--checkpoint_iterations", "8", "--densify_from_iter", "1000",
         "--eval", "--disable_viewer", "--capacity_mult", "2", "--profile_iteration", "2"],
        device="cpu")
    assert trainer.iteration == 8 and len(trainer.history) == 8
    assert all(h["iter_time_ms"] > 0 for h in trainer.history)  # the CLI's own step times
    for f in ("point_cloud/iteration_8/point_cloud.ply", "cfg_args", "chkpnt8.pth",
              "input.ply", "cameras.json"):
        assert os.path.exists(os.path.join(model_dir, f)), f
    assert [f for f in os.listdir(os.path.join(model_dir, "profile")) if f.endswith(".json")]

    render.main(["-m", model_dir, "--skip_train"], device="cpu")
    out = os.path.join(model_dir, "test/ours_8")
    assert os.listdir(os.path.join(out, "renders")) == ["00000.png"]
    assert os.listdir(os.path.join(out, "gt")) == ["00000.png"]
    assert read_png(os.path.join(out, "renders/00000.png")).shape == (64, 64, 3)

    metrics.main(["-m", model_dir], device="cpu")
    with open(os.path.join(model_dir, "results.json")) as f:
        m = json.load(f)["ours_8"]
    assert 0.0 < m["SSIM"] <= 1.0 and m["PSNR"] > 5.0 and m["LPIPS"] is None


def covariances(p):
    q = p["rotation"].astype(np.float64)
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1)
    M = R.reshape(-1, 3, 3) * np.exp(p["scaling"].astype(np.float64))[:, None, :]
    return M @ M.transpose(0, 2, 1)


def test_train_cli_matches_jax(scene_dir, jax_model, tmp_path, env):
    src = copy_of(scene_dir, tmp_path / "scene")
    model = str(tmp_path / "model")
    train.main(["-s", src, "-m", model] + TRAIN_FLAGS, device="cpu")
    rel = "point_cloud/iteration_5/point_cloud.ply"
    got = ply.load_gaussians_ply(os.path.join(model, rel))
    want = ply.load_gaussians_ply(os.path.join(jax_model, rel))
    assert got["xyz"].shape == want["xyz"].shape == (300, 3)
    for k in want:
        if k != "rotation":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0, err_msg=k)
    cg, cw = covariances(got), covariances(want)
    err = np.abs(cg - cw).max(axis=(1, 2)) / np.abs(cw).max(axis=(1, 2))
    assert err.max() <= 1e-4, err.max()
    for f in ("input.ply", "cameras.json"):
        assert open(os.path.join(model, f), "rb").read() == open(os.path.join(jax_model, f), "rb").read()


def test_render_cli_on_a_jax_model(jax_model, tmp_path, env):
    model = copy_of(jax_model, tmp_path / "model")
    shutil.rmtree(os.path.join(model, "train"))
    shutil.rmtree(os.path.join(model, "test"))
    render.main(["-m", model, "--quiet"], device="cpu")
    n_pngs = 0
    for split in ("train", "test"):
        for kind in ("renders", "gt"):
            d = os.path.join(split, "ours_5", kind)
            names = sorted(os.listdir(os.path.join(jax_model, d)))
            assert sorted(os.listdir(os.path.join(model, d))) == names and names
            for name in names:
                got = read_png(os.path.join(model, d, name)).astype(int)
                want = read_png(os.path.join(jax_model, d, name)).astype(int)
                diff = np.abs(got - want).max(axis=-1)
                if kind == "gt":
                    np.testing.assert_array_equal(diff, 0)
                else:
                    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (d, name)
                n_pngs += 1
    assert n_pngs == 2 * (3 + 1)


def test_metrics_cli_matches_jax(jax_model, tmp_path, env):
    model = copy_of(jax_model, tmp_path / "model")
    os.remove(os.path.join(model, "results.json"))
    metrics.main(["-m", model], device="cpu")
    for f in ("results.json", "per_view.json"):
        with open(os.path.join(model, f)) as fp:
            got = json.load(fp)
        with open(os.path.join(jax_model, f)) as fp:
            want = json.load(fp)
        assert got.keys() == want.keys() == {"ours_5"}
        for metric in ("SSIM", "PSNR"):
            g, w = got["ours_5"][metric], want["ours_5"][metric]
            if isinstance(w, dict):
                assert g.keys() == w.keys()
                g, w = list(g.values()), list(w.values())
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=f"{f} {metric}")
        assert got["ours_5"]["LPIPS"] in (None, {})


def test_start_checkpoint_from_the_jax_cli(scene_dir, jax_model, tmp_path, env):
    """--start_checkpoint with the JAX CLI's checkpoint at 5: the port
    resumes there and takes steps 6 and 7 only."""
    src = copy_of(scene_dir, tmp_path / "scene")
    _, trainer = train.main(
        ["-s", src, "-m", str(tmp_path / "model"), "--iterations", "7", "--test_iterations", "7",
         "--save_iterations", "7", "--densify_from_iter", "1000", "--eval", "--disable_viewer",
         "--quiet", "--start_checkpoint", os.path.join(jax_model, "chkpnt5.pth")], device="cpu")
    assert [h["iteration"] for h in trainer.history] == [6, 7]
    assert trainer.state.adam.step == 7
    assert os.path.exists(tmp_path / "model/point_cloud/iteration_7/point_cloud.ply")


def test_full_eval_arg_validation(monkeypatch):
    """test_cli.py:65 on the port: dataset paths are required unless every
    stage that needs them is skipped, and the all-skipped call is a no-op;
    the commands it would run name the port's CLIs."""
    full_eval.main(["--skip_training", "--skip_rendering", "--skip_metrics",
                    "--output_path", "/nonexistent_eval"])
    with pytest.raises(SystemExit):
        full_eval.main(["--output_path", "/nonexistent_eval"])
    with pytest.raises(SystemExit):
        jfull_eval.main(["--output_path", "/nonexistent_eval"])
    commands = []
    monkeypatch.setattr(os, "system", lambda cmd: commands.append(cmd) or 0)
    full_eval.main(["-m360", "/m", "-tat", "/t", "-db", "/d", "--skip_rendering",
                    "--output_path", "/o"])
    assert len(commands) == 13 + 1
    assert all("-m gaussian_splatting_torch.cli." in c for c in commands)
    assert "-m gaussian_splatting_torch.cli.metrics -m /o/bicycle" in commands[-1]


def test_convert_arg_handling(tmp_path, monkeypatch):
    """Neither colmap nor magick is here: the source path is required, and
    a failing colmap command stops the run with exit code 1."""
    with pytest.raises(SystemExit):
        convert.main([])
    commands = []
    monkeypatch.setattr(os, "system", lambda cmd: commands.append(cmd) or 1)
    with pytest.raises(SystemExit) as e:
        convert.main(["-s", str(tmp_path), "--colmap_executable", "colmap-3.9", "--no_gpu"])
    assert e.value.code == 1
    assert commands == [
        f'"colmap-3.9" feature_extractor --database_path {tmp_path}/distorted/database.db '
        f"--image_path {tmp_path}/input --ImageReader.single_camera 1 "
        f"--ImageReader.camera_model OPENCV --SiftExtraction.use_gpu 0"]


@pytest.mark.parametrize("argv,explicit,tiles", [
    ([], False, None),
    (["--tile_size", "16"], True, (16, 0)),
    (["--tile_size_", "16"], True, (32, 16)),  # an abbreviation of --tile_size_y
    (["--tile_size=16", "--tile_size_y", "32"], True, (16, 32)),
    (["--tile_size_y", "16"], True, (32, 16)),
])
def test_render_cli_tile_policy(tmp_path, monkeypatch, argv, explicit, tiles):
    """test_cli.py:81 on the port, and the two render-CLI faults the port
    does not copy: an explicit --tile_size against a cfg_args that sets no
    tile_size_y gives square tiles (tile_size_y backfills 0, "the same"),
    and explicit tiles are found by argparse, abbreviations included.
    cfg_args' training-time tiles never reach the render."""
    captured = {}

    def fake_render_sets(dataset, iteration, pipe, skip_train=False, skip_test=False,
                         explicit_tiles=False, device="cuda"):
        captured.update(explicit=explicit_tiles, tiles=(pipe.tile_size, pipe.tile_size_y),
                        device=device, filled=(pipe.backend, pipe.capacity_mult))

    monkeypatch.setattr(render, "render_sets", fake_render_sets)
    monkeypatch.setattr(render, "safe_state", lambda q: None)
    (tmp_path / "cfg_args").write_text(
        "Namespace(sh_degree=3, source_path='/s', model_path='/m', images='images', "
        "resolution=-1, white_background=False, data_device='tpu', eval=True, "
        "tile_size=8, tile_size_y=8)")
    render.main(["-m", str(tmp_path)] + argv, device="cpu")
    assert captured["explicit"] is explicit and captured["device"] == torch.device("cpu")
    assert captured["filled"] == ("auto", 8)  # unset in both: PipelineParams' defaults
    if explicit:
        assert captured["tiles"] == tiles
        w, h = captured["tiles"]
        assert (w, h or w) == (tiles[0], tiles[1] or tiles[0])


def test_clis_need_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["-s", "/nonexistent", "-m", "/nonexistent"])
    with pytest.raises(RuntimeError, match="CUDA"):
        render.main(["-m", "/nonexistent"])
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.main(["-m", "/nonexistent"])
