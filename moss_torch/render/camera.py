"""Pinhole camera (port of moss_tpu/render/camera.py:22-109, 119-153).

Host math in float64 numpy, stored as f32 tensors, exactly as the JAX camera
does. Row-vector convention:

    x_view_h = [x, 1] @ world_view          (world_view = W2V^T)
    x_clip_h = [x, 1] @ full_proj           (full_proj  = world_view @ proj^T)
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .. import resolve_device


def projection_matrix_from_K(K, H, W, znear=0.001, zfar=1000.0):
    """Intrinsics K -> OpenGL-style projection (math convention, not transposed)."""
    K = np.asarray(K, np.float64)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    s = K[0, 1]
    P = np.zeros((4, 4), np.float64)
    P[0, 0] = 2 * fx / W
    P[0, 1] = 2 * s / W
    P[0, 2] = -1 + 2 * (cx / W)
    P[1, 1] = 2 * fy / H
    P[1, 2] = -1 + 2 * (cy / H)
    P[2, 2] = (zfar + znear) / (zfar - znear)
    P[2, 3] = -2 * zfar * znear / (zfar - znear)
    P[3, 2] = 1.0
    return P


def world_to_view(R, T):
    """R (3,3, stored transposed as the dataset readers do) and T (3,) -> 4x4 W2V."""
    Rt = np.zeros((4, 4), np.float64)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = np.asarray(T)
    Rt[3, 3] = 1.0
    return Rt


@dataclasses.dataclass(frozen=True)
class Camera:
    world_view: torch.Tensor  # (4,4) = W2V^T   (row-vector convention)
    full_proj: torch.Tensor   # (4,4) = world_view @ proj^T
    cam_center: torch.Tensor  # (3,)
    tan_fovx: torch.Tensor    # () f32
    tan_fovy: torch.Tensor    # () f32
    height: int
    width: int

    @staticmethod
    def from_KRT(K, R, T, H: int, W: int, znear=0.001, zfar=1000.0,
                 device=None) -> "Camera":
        device = resolve_device(device)
        K = np.asarray(K, np.float64)
        W2V = world_to_view(R, T)
        proj = projection_matrix_from_K(K, H, W, znear, zfar)
        world_view = W2V.T
        full_proj = world_view @ proj.T
        cam_center = np.linalg.inv(world_view)[3, :3]

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        return Camera(
            world_view=f32(world_view),
            full_proj=f32(full_proj),
            cam_center=f32(cam_center),
            tan_fovx=f32(W / (2.0 * K[0, 0])),
            tan_fovy=f32(H / (2.0 * K[1, 1])),
            height=int(H),
            width=int(W),
        )

    @staticmethod
    def from_viewer_spec(spec: dict, device=None) -> "Camera":
        """A Camera from a SIBR remote-viewer message (train/network_gui.py
        NetworkGUI.receive): the viewer sends the row-vector world_view and
        full_proj matrices themselves (the reference's MiniCam, its
        network_gui.py:70-84); the centre comes from world_view's inverse."""
        device = resolve_device(device)
        wv = np.asarray(spec["world_view_transform"], np.float64).reshape(4, 4)
        fp = np.asarray(spec["full_proj_transform"], np.float64).reshape(4, 4)
        cam_center = np.linalg.inv(wv)[3, :3]

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        return Camera(
            world_view=f32(wv),
            full_proj=f32(fp),
            cam_center=f32(cam_center),
            tan_fovx=f32(np.tan(spec["fovx"] * 0.5)),
            tan_fovy=f32(np.tan(spec["fovy"] * 0.5)),
            height=int(spec["height"]),
            width=int(spec["width"]),
        )

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tan_fovy)


def camera_to_json(cam_id: int, cam: Camera, img_name: str = "") -> dict:
    """The SIBR viewer's cameras.json entry (the reference's
    utils/camera_utils.py:77-99): camera-to-world position and rotation rows
    and the focal lengths in pixels, as moss_tpu writes it."""
    w2v = cam.world_view.detach().cpu().numpy().astype(np.float64).T
    c2w = np.linalg.inv(w2v)
    return {
        "id": int(cam_id),
        "img_name": str(img_name),
        "width": int(cam.width),
        "height": int(cam.height),
        "position": c2w[:3, 3].tolist(),
        "rotation": [row.tolist() for row in c2w[:3, :3]],
        "fy": float(cam.focal_y),
        "fx": float(cam.focal_x),
    }


def dump_cameras_json(path: str, cameras, img_names=None) -> None:
    """The cameras.json a fresh run writes for external viewers."""
    names = img_names if img_names is not None else ["" for _ in cameras]
    entries = [camera_to_json(i, c, n) for i, (c, n) in enumerate(zip(cameras, names))]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(entries, f)
