"""Reflection-based CLI flag groups — the arguments/ system.

The counterpart of `gaussian_splatting_tpu/config.py` (the reference's
arguments/__init__.py:19-130): dataclass fields become argparse flags,
names listed in `SHORTHAND` also get a one-letter short flag, bools become
store_true. `get_combined_args` merges the persisted cfg_args of a trained
model dir with command-line overrides, parsing the repr'd Namespace
without executing it (the reference `eval()`s the file).

The flags are the JAX package's, so a cfg_args either package wrote merges
in the other. `data_device` defaults to the reference's "cuda" and, as in
the JAX package, nothing reads it: the CLIs' `main(..., device=...)` places
the tensors. `backend` takes the port's rasterizer backends; the JAX
package's "xla" and "pallas" map to "auto" (`resolve_backend`).
"""

from __future__ import annotations

import ast
import os
import sys
from argparse import ArgumentParser, Namespace
from dataclasses import dataclass, fields

from gaussian_splatting_torch.ops.rasterize import BACKENDS

# the JAX package's rasterizer backends; a cfg_args it wrote renders here
JAX_BACKENDS = ("xla", "pallas")


class ParamGroup:
    SHORTHAND: tuple = ()

    @classmethod
    def add_to_parser(cls, parser: ArgumentParser, name: str, fill_none: bool = False):
        group = parser.add_argument_group(name)
        for f in fields(cls):
            default = None if fill_none else f.default
            flag = "--" + f.name
            args = (flag, "-" + f.name[0]) if f.name in cls.SHORTHAND else (flag,)
            if f.type in (bool, "bool"):
                group.add_argument(*args, default=default, action="store_true")
            else:
                t = {"int": int, "float": float, "str": str}.get(f.type, f.type)
                group.add_argument(*args, default=default, type=t)

    @classmethod
    def extract(cls, args: Namespace):
        kwargs = {f.name: getattr(args, f.name) for f in fields(cls) if hasattr(args, f.name)}
        return cls(**kwargs)


@dataclass
class ModelParams(ParamGroup):
    """arguments/__init__.py:62-80."""

    SHORTHAND = ("source_path", "model_path", "images", "resolution", "white_background")

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False

    @classmethod
    def extract(cls, args: Namespace):
        g = super().extract(args)
        g.source_path = os.path.abspath(g.source_path)
        return g


@dataclass
class PipelineParams(ParamGroup):
    """arguments/__init__.py:82-87 and the rasterizer's knobs."""

    SHORTHAND = ()

    # Accepted for reference CLI compatibility: the escape hatches they
    # switch on are `eval_render`'s shs_python / rot_scale_python.
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    backend: str = "auto"  # "auto" | "reference"; the JAX names map to "auto"
    # Tile shape; tile_size_y = 0 means "same as tile_size". The CUDA
    # kernels take 32x32, 32x16 and 16x16.
    tile_size: int = 32
    tile_size_y: int = 32
    capacity_mult: int = 8


@dataclass
class OptimizationParams(ParamGroup):
    """arguments/__init__.py:89-108 — defaults preserved verbatim."""

    SHORTHAND = ()

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False


def parse_namespace_repr(s: str) -> Namespace:
    """Safely parse `repr(Namespace(...))` without eval."""
    s = s.strip()
    prefix, suffix = "Namespace(", ")"
    if not (s.startswith(prefix) and s.endswith(suffix)):
        return Namespace()
    body = s[len(prefix) : -1]
    # Parse as a call expression's keyword list via ast.
    tree = ast.parse(f"f({body})", mode="eval")
    kwargs = {}
    for kw in tree.body.keywords:  # type: ignore[attr-defined]
        kwargs[kw.arg] = ast.literal_eval(kw.value)
    return Namespace(**kwargs)


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """arguments/__init__.py:110-130 behavior with safe parsing: the
    model dir's cfg_args, with every flag of this command line that is not
    None on top."""
    cmdline = parser.parse_args(sys.argv[1:] if argv is None else argv)
    cfg_ns = Namespace()
    try:
        cfgfilepath = os.path.join(cmdline.model_path, "cfg_args")
        print("Looking for config file in", cfgfilepath)
        with open(cfgfilepath) as f:
            print(f"Config file found: {cfgfilepath}")
            cfg_ns = parse_namespace_repr(f.read())
    except (TypeError, FileNotFoundError):
        print("Config file not found")
    merged = vars(cfg_ns).copy()
    for k, v in vars(cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)


def write_cfg_args(model_path: str, args: Namespace):
    """train.py:194-197: persist the run config."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(Namespace(**vars(args))))


def resolve_backend(backend: str) -> str:
    """The port's rasterizer backend for a `--backend` value: "auto" and
    "reference" as they are, the JAX package's "xla" and "pallas" as
    "auto" (the CUDA kernels on the card); anything else raises."""
    if backend in JAX_BACKENDS:
        return "auto"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: the port takes {BACKENDS}, and maps the "
                         f"JAX package's {JAX_BACKENDS} to 'auto'")
    return backend
