"""Scene: dataset detection, camera lists, model-directory persistence.

The counterpart of `gaussian_splatting_tpu/scene/scene.py` (the
reference's scene/__init__.py:21-126):
- detects COLMAP (`sparse/`) vs Blender (`transforms_train.json`) layouts
- copies input.ply and writes cameras.json into the model dir on fresh runs
- shuffles both camera lists once at load with Python's `random`, which
  `utils.general.safe_state` seeds, so the order is the JAX package's
- per-resolution-scale camera lists
- saves and loads point_cloud/iteration_N/point_cloud.ply
"""

from __future__ import annotations

import json
import os
import random
import shutil
from typing import Dict, List, Optional

from gaussian_splatting_torch.scene import dataset_readers, ply
from gaussian_splatting_torch.scene.cameras import Camera
from gaussian_splatting_torch.utils.general import search_for_max_iteration


class Scene:
    def __init__(
        self,
        source_path: str,
        model_path: str,
        images: str = "images",
        eval_split: bool = False,
        white_background: bool = False,
        resolution: int = -1,
        load_iteration: Optional[int] = None,
        shuffle: bool = True,
        resolution_scales=(1.0,),
        sh_degree: int = 3,
    ):
        self.model_path = model_path
        self.loaded_iter = None
        self.sh_degree = sh_degree
        self.white_background = white_background

        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_for_max_iteration(
                    os.path.join(model_path, "point_cloud")
                )
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        # dataset type detection (scene/__init__.py:56-63)
        if os.path.exists(os.path.join(source_path, "sparse")):
            info = dataset_readers.read_colmap_scene(source_path, images, eval_split)
        elif os.path.exists(os.path.join(source_path, "transforms_train.json")):
            print("Found transforms_train.json file, assuming Blender data set!")
            info = dataset_readers.read_blender_scene(source_path, white_background, eval_split)
        else:
            raise AssertionError(f"Could not recognize scene type: {source_path}")
        self.info = info

        if not self.loaded_iter:
            os.makedirs(model_path, exist_ok=True)
            shutil.copyfile(info.ply_path, os.path.join(model_path, "input.ply"))
            cam_json = []
            for cid, cam in enumerate(info.test_cameras + info.train_cameras):
                cam_json.append(dataset_readers.camera_to_json(cid, cam))
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        if shuffle:
            random.shuffle(info.train_cameras)
            random.shuffle(info.test_cameras)

        self.cameras_extent = info.nerf_normalization["radius"]

        self.train_cameras: Dict[float, List[Camera]] = {}
        self.test_cameras: Dict[float, List[Camera]] = {}
        for scale in resolution_scales:
            self.train_cameras[scale] = [
                dataset_readers.load_camera(c, resolution, scale) for c in info.train_cameras
            ]
            self.test_cameras[scale] = [
                dataset_readers.load_camera(c, resolution, scale) for c in info.test_cameras
            ]

    # -- model snapshots (PLY) --
    def save(self, iteration: int, params_live: dict):
        """Write the live rows (host numpy dict) as iteration N's PLY."""
        out = os.path.join(self.model_path, f"point_cloud/iteration_{iteration}")
        ply.save_gaussians_ply(os.path.join(out, "point_cloud.ply"), params_live)

    def load_gaussians(self) -> dict:
        path = os.path.join(
            self.model_path,
            f"point_cloud/iteration_{self.loaded_iter}/point_cloud.ply",
        )
        return ply.load_gaussians_ply(path, self.sh_degree)

    def get_train_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.test_cameras[scale]
