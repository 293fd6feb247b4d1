"""The SIBR remote viewer's socket server (port of moss_tpu/train/network_gui.py).

The wire protocol of the reference's viewer hook
(gaussian_renderer/network_gui.py:26-86), so the standard SIBR 3DGS remote
viewer can watch a training run:

  receive: a 4-byte little-endian length, then a JSON header
           {resolution_x/y, train, fov_y, fov_x, z_near, z_far, shs_python,
            rot_scale_python, keep_alive, scale_modifier, view_matrix,
            view_projection_matrix}; the view matrices are 16 floats, row-major.
  send:    the H*W*3 uint8 RGB bytes, then the training source path
           (a 4-byte little-endian length and its ASCII bytes).

The server never blocks on accept: the train loop polls it
(train_ZJU.py:67-80). render_fn is any callable (camera spec) -> (H, W, 3)
float image in [0, 1], a numpy array or a tensor on any device. A viewer
that fails is dropped, its traceback printed.
"""
from __future__ import annotations

import json
import socket
import traceback
from typing import Callable, Optional, Tuple

import numpy as np


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.host = host
        self.port = port
        self.listener: Optional[socket.socket] = None
        self.conn: Optional[socket.socket] = None
        self.addr = None

    def init(self):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((self.host, self.port))
        self.listener.listen()
        self.listener.settimeout(0)

    def try_connect(self):
        if self.listener is None:
            return
        try:
            self.conn, self.addr = self.listener.accept()
            self.conn.settimeout(None)
        except Exception:
            pass

    def _read(self) -> bytes:
        assert self.conn is not None
        n = int.from_bytes(self.conn.recv(4), "little")
        data = b""
        while len(data) < n:
            chunk = self.conn.recv(n - len(data))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            data += chunk
        return data

    def receive(self) -> Tuple[Optional[dict], bool, bool, float]:
        """(camera spec or None, do_training, keep_alive, scale_modifier)."""
        msg = json.loads(self._read().decode("utf-8"))
        W = msg["resolution_x"]
        H = msg["resolution_y"]
        cam = None
        if W != 0 and H != 0:
            view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
            proj = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
            cam = {
                "width": W, "height": H,
                "fovy": msg["fov_y"], "fovx": msg["fov_x"],
                "znear": msg["z_near"], "zfar": msg["z_far"],
                "world_view_transform": view,
                "full_proj_transform": proj,
                "shs_python": bool(msg["shs_python"]),
                "rot_scale_python": bool(msg["rot_scale_python"]),
            }
        return (
            cam,
            bool(msg["train"]),
            bool(msg["keep_alive"]),
            float(msg["scale_modifier"]),
        )

    def send(self, image_u8: Optional[np.ndarray], source_path: str):
        assert self.conn is not None
        if image_u8 is not None:
            self.conn.sendall(np.ascontiguousarray(image_u8).tobytes())
        self.conn.sendall(len(source_path).to_bytes(4, "little"))
        self.conn.sendall(source_path.encode("ascii"))

    def poll(self, render_fn: Callable, source_path: str, training_done: bool) -> bool:
        """One train-loop poll (the body of the reference's while loop,
        train_ZJU.py:67-80). Returns True: training goes on."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                cam, do_training, keep_alive, scale_mod = self.receive()
                img_bytes = None
                if cam is not None:
                    cam["scale_modifier"] = scale_mod
                    img_bytes = quantize(render_fn(cam))
                self.send(img_bytes, source_path)
                if do_training and (not training_done or not keep_alive):
                    break
            except Exception:
                # drop the viewer, and say why
                traceback.print_exc()
                try:
                    self.conn.close()
                except OSError:
                    pass
                self.conn = None
        return True

    def close(self):
        for s in (self.conn, self.listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self.conn = self.listener = None


def quantize(img) -> np.ndarray:
    """The (H, W, 3) uint8 bytes the viewer gets for a [0, 1] float image."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
