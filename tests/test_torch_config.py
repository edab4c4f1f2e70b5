"""The port's flag groups (`gaussian_splatting_torch/config.py`) against the
JAX package's `config.py`: the same flags parse to the same values (but
the two defaults the packages choose differently: `data_device` and the
JAX-only rasterizer backends), a cfg_args the JAX train CLI wrote merges
through the port's `get_combined_args`, and `resolve_backend` maps the
JAX backend names and refuses the rest. Tolerance: equal."""

import sys
from argparse import ArgumentParser, Namespace
from dataclasses import fields

import pytest

from gaussian_splatting_tpu import config as jconfig
from gaussian_splatting_torch import config

GROUPS = ("ModelParams", "PipelineParams", "OptimizationParams")
ARGV = ["-s", "data", "-m", "out", "-r", "2", "-w", "--eval", "--sh_degree", "2",
        "--iterations", "123", "--position_lr_init", "0.001", "--densify_grad_threshold", "3e-4",
        "--random_background", "--tile_size", "16", "--tile_size_y", "0", "--capacity_mult", "4",
        "--debug", "--images", "images_2", "--lambda_dssim", "0.3"]


def parser_of(pkg, fill_none=False):
    p = ArgumentParser()
    for name in GROUPS:
        getattr(pkg, name).add_to_parser(p, name, fill_none=fill_none)
    return p


def test_groups_have_the_jax_fields_and_defaults():
    for name in GROUPS:
        ours, theirs = getattr(config, name), getattr(jconfig, name)
        assert [f.name for f in fields(ours)] == [f.name for f in fields(theirs)], name
        assert ours.SHORTHAND == theirs.SHORTHAND
        for f, jf in zip(fields(ours), fields(theirs)):
            if (name, f.name) == ("ModelParams", "data_device"):
                assert (f.default, jf.default) == ("cuda", "tpu")  # the reference's "cuda"
            else:
                assert f.default == jf.default, (name, f.name)


@pytest.mark.parametrize("fill_none", [False, True])
@pytest.mark.parametrize("argv", [ARGV, ["-s", "x"]])
def test_same_flags_parse_to_the_same_values(fill_none, argv):
    ours = vars(parser_of(config, fill_none).parse_args(argv))
    theirs = vars(parser_of(jconfig, fill_none).parse_args(argv))
    assert ours.keys() == theirs.keys()
    for k in theirs:
        if k == "data_device" and not fill_none:
            continue
        assert ours[k] == theirs[k], k
    args = parser_of(config, fill_none).parse_args(argv)
    jargs = parser_of(jconfig, fill_none).parse_args(argv)
    for name in GROUPS:
        got, want = vars(getattr(config, name).extract(args)), vars(getattr(jconfig, name).extract(jargs))
        assert {k: v for k, v in got.items() if k != "data_device"} == \
            {k: v for k, v in want.items() if k != "data_device"}


def test_jax_cfg_args_merge_through_the_port(tmp_path, monkeypatch):
    """cfg_args as the JAX train CLI writes it (write_cfg_args of its
    ModelParams), read by the port with a command-line override."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    jargs = parser_of(jconfig).parse_args(["-s", "/data/scene", "-m", str(tmp_path), "-r", "4",
                                           "--eval", "--white_background"])
    jconfig.write_cfg_args(str(tmp_path), Namespace(**vars(jconfig.ModelParams.extract(jargs))))
    p = ArgumentParser()
    config.ModelParams.add_to_parser(p, "model", fill_none=True)
    config.PipelineParams.add_to_parser(p, "pipe", fill_none=True)
    p.add_argument("--iteration", default=-1, type=int)
    merged = config.get_combined_args(p, ["-m", str(tmp_path), "--sh_degree", "1"])
    want = jconfig.get_combined_args(p, ["-m", str(tmp_path), "--sh_degree", "1"])
    assert vars(merged) == vars(want)
    assert merged.resolution == 4 and merged.eval and merged.white_background
    assert merged.sh_degree == 1 and merged.data_device == "tpu" and merged.iteration == -1
    assert merged.source_path == "/data/scene"
    # and the other way round: the port's cfg_args read by the JAX package
    config.write_cfg_args(str(tmp_path), Namespace(**vars(config.ModelParams.extract(jargs))))
    assert (tmp_path / "cfg_args").read_text() == str(Namespace(**vars(
        jconfig.ModelParams.extract(jargs))))
    assert vars(jconfig.get_combined_args(p, ["-m", str(tmp_path)])) == \
        vars(config.get_combined_args(p, ["-m", str(tmp_path)]))


def test_parse_namespace_repr_matches_jax():
    for s in ["Namespace(a=1, b='x', c=[1, 2], d=None, e=True, f=-0.5)", "garbage", "Namespace()"]:
        assert vars(config.parse_namespace_repr(s)) == vars(jconfig.parse_namespace_repr(s))
    with pytest.raises(ValueError):
        config.parse_namespace_repr("Namespace(a=__import__('os'))")


@pytest.mark.parametrize("name,want", [("auto", "auto"), ("reference", "reference"),
                                       ("xla", "auto"), ("pallas", "auto")])
def test_resolve_backend_maps_the_jax_names(name, want):
    assert config.resolve_backend(name) == want


@pytest.mark.parametrize("name", ["cuda", "triton", "Auto", ""])
def test_resolve_backend_refuses_other_names(name):
    with pytest.raises(ValueError, match="unknown backend"):
        config.resolve_backend(name)
