"""Camera model and projective matrices.

Numpy on the host (cheap, done once per camera); `CameraArrays` is the
tensor view handed to the rasterizer, made by `arrays(device=...)`.

Parity notes (cited against the INRIA reference):
- world->view matrix built exactly like utils/graphics_utils.py:38-51
  (R stored as C2W rotation; re-centering translate/scale applied in
  camera space of the inverse).
- projection matrix like utils/graphics_utils.py:53-75 (OpenGL-style
  frustum with z mapped to [~0, zfar/(zfar-znear)] and w = z).
- znear=0.01, zfar=100 (scene/cameras.py:49-50).
- Matrices are row-major (apply as M @ [p;1]). The reference stores them
  transposed for glm column-major consumption; that is storage, not math.

The numpy part is a copy of `gaussian_splatting_tpu/scene/cameras.py`,
kept here because importing that package imports JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussian_splatting_torch.utils.device import require_device


def get_world2view(R: np.ndarray, t: np.ndarray, translate=None, scale: float = 1.0) -> np.ndarray:
    """World->camera 4x4. R is the C2W rotation (as read from COLMAP),
    t the W2C translation — same convention as graphics_utils.py:38-51."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        cam_center = (C2W[:3, 3] + translate) * scale
        C2W[:3, 3] = cam_center
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def get_projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection, graphics_utils.py:53-75 layout (w' = z)."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


class CameraArrays(NamedTuple):
    """The tensor view of a camera: everything the rasterizer needs.

    All float32 on one device. Width and height are not here; the
    rasterizer takes them as plain ints.
    """

    viewmatrix: torch.Tensor  # (4,4) W2C, row-major (apply as V @ [p;1])
    projmatrix: torch.Tensor  # (4,4) full = proj @ view, row-major
    campos: torch.Tensor  # (3,) camera center in world
    tanfovx: torch.Tensor  # () scalar
    tanfovy: torch.Tensor  # () scalar


def _camera_arrays(cam, device) -> CameraArrays:
    dev = require_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return CameraArrays(
        viewmatrix=t(cam.world_view_transform),
        projmatrix=t(cam.full_proj_transform),
        campos=t(cam.camera_center),
        tanfovx=t(cam.tanfovx),
        tanfovy=t(cam.tanfovy),
    )


@dataclass
class Camera:
    """A training/eval camera. Mirrors scene/cameras.py:17-61 behavior."""

    uid: int
    colmap_id: int
    R: np.ndarray  # (3,3) C2W rotation
    T: np.ndarray  # (3,) W2C translation
    fovx: float
    fovy: float
    image: Optional[np.ndarray]  # (3,H,W) float32 in [0,1], premultiplied by alpha mask
    image_name: str
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    def __post_init__(self):
        self.world_view_transform = get_world2view(self.R, self.T, self.trans, self.scale)
        self.projection_matrix = get_projection_matrix(self.znear, self.zfar, self.fovx, self.fovy)
        self.full_proj_transform = (self.projection_matrix @ self.world_view_transform).astype(
            np.float32
        )
        self.camera_center = np.linalg.inv(self.world_view_transform)[:3, 3].astype(np.float32)

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy * 0.5)

    def arrays(self, device="cuda") -> CameraArrays:
        return _camera_arrays(self, device)


@dataclass
class MiniCam:
    """Viewer-supplied camera (scene/cameras.py:63-75): matrices given directly."""

    width: int
    height: int
    fovy: float
    fovx: float
    znear: float
    zfar: float
    world_view_transform: np.ndarray  # (4,4) row-major W2C
    full_proj_transform: np.ndarray  # (4,4) row-major full projection

    def __post_init__(self):
        self.camera_center = np.linalg.inv(self.world_view_transform)[:3, 3].astype(np.float32)

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy * 0.5)

    def arrays(self, device="cuda") -> CameraArrays:
        return _camera_arrays(self, device)


def orbit_camera(center, dist: float, angle: float, width: int, height: int,
                 fovx_deg: float, fovy_deg: float) -> Camera:
    """A camera on a circle of radius `dist` around `center` in the xz
    plane, at `angle` radians, looking at `center`."""
    c, s = math.cos(angle), math.sin(angle)
    cam_pos = np.asarray(center, np.float64) + np.array([dist * s, 0.0, -dist * c])
    forward = (np.asarray(center) - cam_pos) / dist
    right = np.cross([0.0, 1.0, 0.0], forward)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(forward, right), forward], axis=1)  # C2W
    return Camera(uid=0, colmap_id=0, R=R, T=-R.T @ cam_pos, fovx=math.radians(fovx_deg),
                  fovy=math.radians(fovy_deg), image=None, image_name="orbit", width=width,
                  height=height)
