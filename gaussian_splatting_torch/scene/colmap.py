"""COLMAP binary and text parsers and writers (cameras, images, points3D).

The counterpart of `gaussian_splatting_tpu/scene/colmap.py` (itself the
reference's scene/colmap_loader.py), kept as code here because importing
that package imports JAX. The binary layout is COLMAP's, byte for byte:
the writers give the JAX package's bytes, and each package reads the
other's files. Records of fixed size are read and written as numpy
structured arrays rather than one `struct` call each.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# COLMAP camera model ids -> (name, num_params) (colmap_loader.py:69-83)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}

# an image's 2D point (x, y, point3D id) and a point3D record up to its track
_XY_ID = np.dtype([("xy", "<f8", 2), ("id", "<i8")])
_POINT = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("error", "<f8")])
_POINT_NO_TRACK = np.dtype(_POINT.descr + [("track_length", "<u8")])


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) wxyz, world -> camera
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


def qvec2rotmat(qvec):
    """Quaternion (w,x,y,z) -> rotation matrix (colmap_loader.py:43-53)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R):
    """Rotation matrix -> quaternion (w,x,y,z) with w >= 0."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


# ---------------- binary readers ----------------

def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, nparams = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * nparams, "d" * nparams))
            out[cid] = ColmapCamera(id=cid, model=name, width=w, height=h, params=params)
    return out


def read_images_binary(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        data = f.read()
    (num,), pos = struct.unpack_from("<Q", data), 8
    for _ in range(num):
        iid, qw, qx, qy, qz, tx, ty, tz, camera_id = struct.unpack_from("<i7di", data, pos)
        end = data.index(b"\x00", pos + 64)
        name = data[pos + 64:end].decode("utf-8")
        (npts,) = struct.unpack_from("<Q", data, end + 1)
        pos = end + 9
        rec = np.frombuffer(data, _XY_ID, count=npts, offset=pos)
        pos += _XY_ID.itemsize * npts
        out[iid] = ColmapImage(
            id=iid, qvec=np.array([qw, qx, qy, qz]), tvec=np.array([tx, ty, tz]),
            camera_id=camera_id, name=name, xys=rec["xy"].copy(), point3d_ids=rec["id"].copy(),
        )
    return out


def read_points3d_binary(path):
    """Returns (xyz (N,3) f64, rgb (N,3) u8, errors (N,)). The records have
    variable-length tracks: one pass finds where each starts, then the
    fixed 43-byte heads are gathered at once."""
    with open(path, "rb") as f:
        data = f.read()
    (num,) = struct.unpack_from("<Q", data)
    starts = np.empty(num, np.int64)
    pos, head = 8, _POINT.itemsize
    for i in range(num):
        starts[i] = pos
        (tlen,) = struct.unpack_from("<Q", data, pos + head)
        pos += head + 8 + 8 * tlen  # the head, the track length, the track
    if pos > len(data):
        raise ValueError(f"{path}: truncated points3D file")
    raw = np.frombuffer(data, np.uint8)
    rec = raw[starts[:, None] + np.arange(head)].view(_POINT).reshape(num)
    return rec["xyz"].copy(), rec["rgb"].copy(), rec["error"].copy()


# ---------------- text readers ----------------

def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            out[int(e[0])] = ColmapCamera(
                id=int(e[0]),
                model=e[1],
                width=int(e[2]),
                height=int(e[3]),
                params=np.array(tuple(map(float, e[4:]))),
            )
    return out


def read_images_text(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    for head, pts in zip(lines[0::2], lines[1::2]):
        e = head.split()
        pe = pts.split()
        xys = np.array(pe, dtype=np.float64).reshape(-1, 3)[:, :2] if pe else np.zeros((0, 2))
        ids = (
            np.array(pe[2::3], dtype=np.int64) if pe else np.zeros((0,), np.int64)
        )
        out[int(e[0])] = ColmapImage(
            id=int(e[0]),
            qvec=np.array(e[1:5], dtype=np.float64),
            tvec=np.array(e[5:8], dtype=np.float64),
            camera_id=int(e[8]),
            name=e[9],
            xys=xys,
            point3d_ids=ids,
        )
    return out


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            xyz.append(tuple(map(float, e[1:4])))
            rgb.append(tuple(map(int, e[4:7])))
            err.append(float(e[7]))
    return (
        np.array(xyz).reshape(-1, 3),
        np.array(rgb, np.uint8).reshape(-1, 3),
        np.array(err),
    )


# ---------------- binary writers ----------------

def write_cameras_binary(cams: Dict[int, ColmapCamera], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            mid = CAMERA_MODEL_IDS[c.model]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))


def write_images_binary(images: Dict[int, ColmapImage], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i4d3di", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode() + b"\x00")
            n = im.xys.shape[0]
            rec = np.empty(n, _XY_ID)
            rec["xy"] = im.xys
            rec["id"] = im.point3d_ids
            f.write(struct.pack("<Q", n) + rec.tobytes())


def write_points3d_binary(xyz, rgb, err, path):
    """Points with ids 0..N-1 and empty tracks."""
    n = xyz.shape[0]
    rec = np.zeros(n, _POINT_NO_TRACK)
    rec["id"] = np.arange(n)
    rec["xyz"] = xyz
    rec["rgb"] = rgb
    rec["error"] = err
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n) + rec.tobytes())
