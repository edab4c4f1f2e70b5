"""Dataset readers: COLMAP scenes and Blender/NeRF-synthetic scenes.

The counterpart of `gaussian_splatting_tpu/scene/dataset_readers.py`
(itself the reference's scene/dataset_readers.py:45-286), with the same
behaviour:
- scene normalization radius = 1.1 x max camera-to-centroid distance
  (getNerfppNorm)
- COLMAP reader: PINHOLE / SIMPLE_PINHOLE only, every-8th-image test split
  when eval (llffhold=8), points3D.bin/.txt -> points3D.ply cache written
  into the dataset
- Blender reader: OpenGL->COLMAP axis flip, alpha compositing over a white
  or black background, a random init of GS_TPU_BLENDER_INIT_POINTS
  (default 100k) points from the global `np.random` that `safe_state`
  seeds, cached as points3d.ply
- resolution policy: -r in {1,2,4,8} divisors, else a width cap at 1600 px
  (utils/camera_utils.py:22-39)

Images are read with the port's PNG reader and resized with its copy of
PIL's default resize (`utils/image_io.py`), so `CameraInfo.image` holds
uint8 pixels rather than a PIL image. Only PNG files are read.
`write_colmap_scene` writes a COLMAP dataset from cameras and pixels, the
inverse of `read_colmap_scene`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from gaussian_splatting_torch.scene import colmap, ply
from gaussian_splatting_torch.scene.cameras import Camera, focal2fov, fov2focal, get_world2view
from gaussian_splatting_torch.utils import image_io


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int
    image: Optional[np.ndarray] = None  # (H, W, C) uint8; read from image_path when None


@dataclass
class SceneInfo:
    points: Optional[np.ndarray]
    colors: Optional[np.ndarray]
    normals: Optional[np.ndarray]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    centers = []
    for cam in cam_infos:
        w2c = get_world2view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers, axis=0)
    avg = centers.mean(axis=0)
    diagonal = float(np.linalg.norm(centers - avg, axis=1).max())
    return {"translate": -avg, "radius": diagonal * 1.1}


def read_colmap_scene(path: str, images_dir: Optional[str], eval_split: bool, llffhold: int = 8) -> SceneInfo:
    sparse = os.path.join(path, "sparse/0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    try:
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    reading_dir = images_dir if images_dir else "images"
    cam_infos = []
    for key in extr:
        e = extr[key]
        c = intr[e.camera_id]
        R = colmap.qvec2rotmat(e.qvec).T  # stored as C2W rotation
        T = np.array(e.tvec)
        if c.model == "SIMPLE_PINHOLE":
            fovx = focal2fov(c.params[0], c.width)
            fovy = focal2fov(c.params[0], c.height)
        elif c.model == "PINHOLE":
            fovx = focal2fov(c.params[0], c.width)
            fovy = focal2fov(c.params[1], c.height)
        else:
            raise AssertionError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE cameras) supported!"
            )
        image_path = os.path.join(path, reading_dir, os.path.basename(e.name))
        cam_infos.append(
            CameraInfo(
                uid=c.id, R=R, T=T, fovx=fovx, fovy=fovy, image_path=image_path,
                image_name=os.path.basename(image_path).split(".")[0],
                width=c.width, height=c.height,
            )
        )
    cam_infos.sort(key=lambda x: x.image_name)

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        ply.save_point_cloud_ply(ply_path, xyz.astype(np.float32), rgb)
    points, colors, normals = ply.load_point_cloud_ply(ply_path)

    return SceneInfo(
        points=points, colors=colors, normals=normals,
        train_cameras=train, test_cameras=test,
        nerf_normalization=norm, ply_path=ply_path,
    )


def _to_rgba(pixels: np.ndarray) -> np.ndarray:
    """PIL's convert("RGBA") of (H, W, C) uint8 pixels (L, LA, RGB, RGBA)."""
    C = pixels.shape[2]
    rgb = pixels[..., :1].repeat(3, axis=2) if C in (1, 2) else pixels[..., :3]
    alpha = pixels[..., -1:] if C in (2, 4) else np.full_like(pixels[..., :1], 255)
    return np.concatenate([rgb, alpha], axis=2)


def _read_transforms(path: str, fname: str, white_background: bool, extension=".png") -> List[CameraInfo]:
    with open(os.path.join(path, fname)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    cam_infos = []
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        cam_name = os.path.join(path, file_path + (extension if not file_path.endswith(extension) else ""))
        c2w = np.array(frame["transform_matrix"])
        # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]

        im_data = np.array(_to_rgba(image_io.read_png(cam_name)), dtype=np.float32) / 255.0
        bg = np.ones(3) if white_background else np.zeros(3)
        # float32 products, then float64 with bg, truncated as the reference does
        rgb = im_data[..., :3] * im_data[..., 3:4] + bg * (1 - im_data[..., 3:4])
        image = (rgb * 255).astype(np.uint8)
        height, width = image.shape[:2]

        fovy = focal2fov(fov2focal(fovx, width), height)
        cam_infos.append(
            CameraInfo(
                uid=idx, R=R, T=T, fovx=fovx, fovy=fovy, image=image,
                image_path=cam_name, image_name=Path(cam_name).stem,
                width=width, height=height,
            )
        )
    return cam_infos


def read_blender_scene(path: str, white_background: bool, eval_split: bool, extension=".png") -> SceneInfo:
    train = _read_transforms(path, "transforms_train.json", white_background, extension)
    test = (
        _read_transforms(path, "transforms_test.json", white_background, extension)
        if os.path.exists(os.path.join(path, "transforms_test.json"))
        else []
    )
    if not eval_split:
        train = train + test
        test = []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        # random points like the reference (:263-267); the JAX package's
        # variable sets the count, so one setting drives both packages
        num_pts = int(os.environ.get("GS_TPU_BLENDER_INIT_POINTS", 100_000))
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        colors = shs * 0.28209479177387814 + 0.5  # SH2RGB
        ply.save_point_cloud_ply(ply_path, xyz.astype(np.float32), colors)
    points, colors, normals = ply.load_point_cloud_ply(ply_path)

    return SceneInfo(
        points=points, colors=colors, normals=normals,
        train_cameras=train, test_cameras=test,
        nerf_normalization=norm, ply_path=ply_path,
    )


def load_camera(cam_info: CameraInfo, resolution: int, resolution_scale: float = 1.0) -> Camera:
    """Resolution policy + GT image loading (camera_utils.py:19-52).

    (The reference checks the alpha channel with `shape[1] == 4`, an
    H-vs-channels bug; as the JAX package, we check the channel count.)
    """
    pixels = cam_info.image
    if pixels is None:
        pixels = image_io.read_png(cam_info.image_path)
    orig_h, orig_w = pixels.shape[:2]
    if resolution in (1, 2, 4, 8):
        target = (
            round(orig_w / (resolution_scale * resolution)),
            round(orig_h / (resolution_scale * resolution)),
        )
    else:
        if resolution == -1:
            global_down = orig_w / 1600 if orig_w > 1600 else 1
        else:
            global_down = orig_w / resolution
        scale = float(global_down) * float(resolution_scale)
        target = (int(orig_w / scale), int(orig_h / scale))

    arr = np.asarray(image_io.resize(pixels, target), dtype=np.float32) / 255.0
    if arr.shape[2] == 1:
        arr = arr.repeat(3, axis=-1)
    chw = arr.transpose(2, 0, 1)
    gt = np.clip(chw[:3], 0.0, 1.0)
    if chw.shape[0] == 4:
        gt = gt * chw[3:4]  # premultiply by alpha mask (cameras.py:43-44)

    return Camera(
        uid=cam_info.uid, colmap_id=cam_info.uid, R=cam_info.R, T=cam_info.T,
        fovx=cam_info.fovx, fovy=cam_info.fovy, image=gt,
        image_name=cam_info.image_name, width=target[0], height=target[1],
    )


def camera_to_json(cid: int, camera) -> dict:
    rt = np.zeros((4, 4))
    rt[:3, :3] = camera.R.T
    rt[:3, 3] = camera.T
    rt[3, 3] = 1.0
    c2w = np.linalg.inv(rt)
    return {
        "id": cid,
        "img_name": camera.image_name,
        "width": camera.width,
        "height": camera.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fy": fov2focal(camera.fovy, camera.height),
        "fx": fov2focal(camera.fovx, camera.width),
    }


def write_colmap_scene(path: str, cameras: Sequence, images: Sequence[np.ndarray],
                       points: np.ndarray, colors: np.ndarray):
    """A COLMAP dataset that `read_colmap_scene` reads back: `cameras`
    (each with R (C2W), T, fovx, fovy, width, height, image_name) as
    PINHOLE cameras centred on the image, one per distinct intrinsics, in
    sparse/0/{cameras,images}.bin; their uint8 `images` as
    images/<image_name>.png; `points` (N, 3) with uint8 `colors` in
    sparse/0/points3D.bin."""
    sparse = os.path.join(path, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(path, "images"), exist_ok=True)
    intrinsics, records = {}, {}
    for i, (cam, pixels) in enumerate(zip(cameras, images)):
        fx, fy = fov2focal(cam.fovx, cam.width), fov2focal(cam.fovy, cam.height)
        key = (cam.width, cam.height, fx, fy)
        if key not in intrinsics:
            intrinsics[key] = colmap.ColmapCamera(
                id=len(intrinsics) + 1, model="PINHOLE", width=cam.width, height=cam.height,
                params=np.array([fx, fy, cam.width / 2, cam.height / 2]))
        name = f"{cam.image_name}.png"
        records[i + 1] = colmap.ColmapImage(
            id=i + 1, qvec=colmap.rotmat2qvec(np.asarray(cam.R).T), tvec=np.asarray(cam.T, np.float64),
            camera_id=intrinsics[key].id, name=name, xys=np.zeros((0, 2)),
            point3d_ids=np.zeros((0,), np.int64))
        image_io.write_png(os.path.join(path, "images", name), pixels)
    colmap.write_cameras_binary({c.id: c for c in intrinsics.values()},
                                os.path.join(sparse, "cameras.bin"))
    colmap.write_images_binary(records, os.path.join(sparse, "images.bin"))
    colmap.write_points3d_binary(np.asarray(points, np.float64), colors,
                                 np.zeros(len(points)), os.path.join(sparse, "points3D.bin"))
