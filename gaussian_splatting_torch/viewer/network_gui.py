"""TCP live-viewer bridge, SIBR-remote compatible.

The counterpart of `gaussian_splatting_tpu/viewer/network_gui.py`.
Implements the exact wire protocol of the reference
(gaussian_renderer/network_gui.py:26-86 + train.py:77-90): a non-blocking
listener on port 6009; requests are 4-byte little-endian length-prefixed
JSON with resolution, FoV, z range, flags, and view / view-projection
matrices; responses are raw HxWx3 RGB bytes followed by a length-prefixed
source-path string.

The incoming matrices arrive in the reference's transposed (glm) layout
with Y/Z column flips (network_gui.py:74-78); we convert to our row-major
convention here at the boundary.
"""

from __future__ import annotations

import json
import socket
import traceback
from typing import Optional

import numpy as np
import torch

from gaussian_splatting_torch.scene.cameras import MiniCam
from gaussian_splatting_torch.training import eval_render


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None
        self.source_path = ""

    def try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nConnected by {addr}")
            self.conn.settimeout(None)
        except Exception:
            pass

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def read(self) -> dict:
        n = int.from_bytes(self._read_exact(4), "little")
        return json.loads(self._read_exact(n).decode("utf-8"))

    def send(self, image_bytes: Optional[bytes], verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self):
        """Returns (MiniCam|None, do_training, shs_python, rot_scale_python,
        keep_alive, scaling_modifier) — network_gui.py:57-86."""
        msg = self.read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None, None, None
        try:
            do_training = bool(msg["train"])
            fovy, fovx = msg["fov_y"], msg["fov_x"]
            znear, zfar = msg["z_near"], msg["z_far"]
            do_shs_python = bool(msg["shs_python"])
            do_rot_scale_python = bool(msg["rot_scale_python"])
            keep_alive = bool(msg["keep_alive"])
            scaling_modifier = msg["scaling_modifier"]
            # wire layout = transposed (glm); column flips there are row
            # flips in our row-major convention.
            wv_t = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
            wv = wv_t.T.copy()
            wv[1] *= -1
            wv[2] *= -1
            fp_t = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
            fp = fp_t.T.copy()
            fp[1] *= -1
            cam = MiniCam(width, height, fovy, fovx, znear, zfar, wv, fp)
        except Exception as e:
            print("")
            traceback.print_exc()
            raise e
        return cam, do_training, do_shs_python, do_rot_scale_python, keep_alive, scaling_modifier

    def poll(self, trainer) -> None:
        """train.py:77-90: serve render requests between training steps."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                net_image_bytes = None
                (cam, do_training, shs_python, rot_scale_python,
                 keep_alive, scaling_modifier) = self.receive()
                if cam is not None:
                    with torch.no_grad():
                        img, _ = eval_render(
                            trainer.state.params,
                            cam.arrays(device=trainer.background.device),
                            trainer.background,
                            trainer.active_sh_degree,
                            cam.width,
                            cam.height,
                            trainer.raster_cfg,
                            scale_modifier=float(scaling_modifier),
                            shs_python=bool(shs_python),
                            rot_scale_python=bool(rot_scale_python),
                        )
                    arr = (torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy()
                    net_image_bytes = memoryview(np.ascontiguousarray(arr))
                self.send(net_image_bytes, self.source_path)
                if do_training and (
                    trainer.iteration < trainer.opt.iterations or not keep_alive
                ):
                    break
            except Exception:  # a viewer that fails or leaves ends its connection only
                self.conn = None
