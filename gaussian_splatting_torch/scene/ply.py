"""PLY serialization of Gaussian models and point clouds.

The attribute layout matches gaussian_model.py:277-308 byte-for-byte
(x,y,z, nx,ny,nz, f_dc_*, f_rest_*, opacity, scale_*, rot_* — all float32,
raw pre-activation values, f_rest flattened channel-major), so models saved
here load in SIBR / web viewers and reference checkpoints load here.
Point clouds (the datasets' input.ply: xyz, normals, uint8 colours) have
their own pair of functions. Self-contained binary_little_endian
reader/writer (no plyfile dependency).

Numpy only: the port keeps its own copy of the JAX package's module,
because importing anything from that package imports JAX.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

_PLY_DTYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
}


def write_ply_vertex_table(path: str, columns: Dict[str, np.ndarray]):
    """Write a single 'vertex' element with float32 scalar properties."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    names = list(columns.keys())
    n = next(iter(columns.values())).shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header"]
    table = np.column_stack([np.asarray(columns[k], np.float32).reshape(n) for k in names])
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(table, dtype="<f4").tobytes())


def read_ply_vertex_table(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY 'vertex' element into {property: (N,) float array}."""
    with open(path, "rb") as f:
        # ---- header ----
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        n = None
        props = []
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("element"):
                raise ValueError(f"unsupported extra element: {line}")
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list properties unsupported")
                props.append((parts[2], _PLY_DTYPES[parts[1]]))
            elif line == "end_header":
                break
        if n is None:
            raise ValueError(f"PLY file has no vertex element: {path}")
        if fmt == "binary_little_endian":
            dtype = np.dtype([(name, "<" + dt) for name, dt in props])
            data = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
            return {name: np.asarray(data[name]) for name, _ in props}
        elif fmt == "ascii":
            rows = np.loadtxt(f, max_rows=n).reshape(n, len(props))
            return {name: rows[:, i] for i, (name, _) in enumerate(props)}
        elif fmt == "binary_big_endian":
            dtype = np.dtype([(name, ">" + dt) for name, dt in props])
            data = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
            return {name: np.asarray(data[name]) for name, _ in props}
        raise ValueError(f"unknown PLY format {fmt}")


def save_gaussians_ply(path: str, params: Dict[str, np.ndarray]):
    """params: live-row host dict (xyz, features_dc (P,1,3),
    features_rest (P,M,3), opacity (P,1), scaling (P,3), rotation (P,4))."""
    xyz = np.asarray(params["xyz"], np.float32)
    P = xyz.shape[0]
    cols: Dict[str, np.ndarray] = {}
    for i, ax in enumerate("xyz"):
        cols[ax] = xyz[:, i]
    for ax in ("nx", "ny", "nz"):
        cols[ax] = np.zeros(P, np.float32)
    # (P, 1, 3) -> transpose(0,2,1) -> (P, 3, 1) -> flatten: channel-major
    f_dc = np.asarray(params["features_dc"], np.float32).transpose(0, 2, 1).reshape(P, -1)
    for i in range(f_dc.shape[1]):
        cols[f"f_dc_{i}"] = f_dc[:, i]
    f_rest = np.asarray(params["features_rest"], np.float32).transpose(0, 2, 1).reshape(P, -1)
    for i in range(f_rest.shape[1]):
        cols[f"f_rest_{i}"] = f_rest[:, i]
    cols["opacity"] = np.asarray(params["opacity"], np.float32).reshape(P)
    scaling = np.asarray(params["scaling"], np.float32)
    for i in range(scaling.shape[1]):
        cols[f"scale_{i}"] = scaling[:, i]
    rotation = np.asarray(params["rotation"], np.float32)
    for i in range(rotation.shape[1]):
        cols[f"rot_{i}"] = rotation[:, i]
    write_ply_vertex_table(path, cols)


def load_gaussians_ply(path: str, sh_degree: int = 3) -> Dict[str, np.ndarray]:
    """Inverse of save_gaussians_ply (gaussian_model.py:323-364)."""
    cols = read_ply_vertex_table(path)
    P = cols["x"].shape[0]
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float32)
    f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], axis=1).astype(np.float32)
    n_rest = 3 * ((sh_degree + 1) ** 2 - 1)
    rest_names = sorted(
        [k for k in cols if k.startswith("f_rest_")], key=lambda s: int(s.split("_")[-1])
    )
    if len(rest_names) != n_rest:
        raise ValueError(f"expected {n_rest} f_rest, got {len(rest_names)}")
    f_rest = np.stack([cols[k] for k in rest_names], axis=1).astype(np.float32)
    scale_names = sorted(
        [k for k in cols if k.startswith("scale_")], key=lambda s: int(s.split("_")[-1])
    )
    rot_names = sorted(
        [k for k in cols if k.startswith("rot_")], key=lambda s: int(s.split("_")[-1])
    )
    return {
        "xyz": xyz,
        # channel-major (P, 3, M) -> (P, M, 3)
        "features_dc": f_dc.reshape(P, 3, 1).transpose(0, 2, 1),
        "features_rest": f_rest.reshape(P, 3, -1).transpose(0, 2, 1),
        "opacity": cols["opacity"].astype(np.float32).reshape(P, 1),
        "scaling": np.stack([cols[k] for k in scale_names], axis=1).astype(np.float32),
        "rotation": np.stack([cols[k] for k in rot_names], axis=1).astype(np.float32),
    }


def save_point_cloud_ply(path: str, points: np.ndarray, colors: np.ndarray, normals=None):
    """input.ply-style point cloud: float32 xyz and normals, uint8 colours
    (float colours in [0, 1] are scaled by 255 and truncated)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = points.shape[0]
    normals = np.zeros_like(points) if normals is None else normals
    header = [
        "ply", "format binary_little_endian 1.0", f"element vertex {n}",
        "property float x", "property float y", "property float z",
        "property float nx", "property float ny", "property float nz",
        "property uchar red", "property uchar green", "property uchar blue",
        "end_header",
    ]
    dtype = np.dtype(
        [(k, "<f4") for k in ("x", "y", "z", "nx", "ny", "nz")]
        + [(k, "u1") for k in ("red", "green", "blue")]
    )
    rec = np.empty(n, dtype)
    for i, k in enumerate(("x", "y", "z")):
        rec[k] = points[:, i]
        rec["n" + k] = normals[:, i]
    rgb = colors
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    for i, k in enumerate(("red", "green", "blue")):
        rec[k] = rgb[:, i]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def load_point_cloud_ply(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(points, colors in [0, 1], normals), each (P, 3) float32; grey
    colours and zero normals where the file has none."""
    cols = read_ply_vertex_table(path)
    points = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float32)
    if "red" in cols:
        colors = np.stack([cols["red"], cols["green"], cols["blue"]], axis=1)
        colors = colors.astype(np.float32) / 255.0 if colors.max() > 1 else colors.astype(np.float32)
    else:
        colors = np.full_like(points, 0.5)
    if "nx" in cols:
        normals = np.stack([cols["nx"], cols["ny"], cols["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(points)
    return points, colors, normals
