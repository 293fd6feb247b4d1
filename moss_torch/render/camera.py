"""Pinhole camera (port of moss_tpu/render/camera.py:22-89).

Host math in float64 numpy, stored as f32 tensors, exactly as the JAX camera
does. Row-vector convention:

    x_view_h = [x, 1] @ world_view          (world_view = W2V^T)
    x_clip_h = [x, 1] @ full_proj           (full_proj  = world_view @ proj^T)
"""
from __future__ import annotations

import dataclasses

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

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tan_fovy)
