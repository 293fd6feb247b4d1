"""Synthetic scene and camera (port of moss_tpu/data/synthetic.py:28-56).

Only what serving needs: the synthetic SMPL scene with its big pose, an
orbit camera and a random pose. make_frames (ground truth for training)
comes with the training slice.
"""
from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..models import smpl as S
from ..render.camera import Camera
from ..render.render import SceneContext


def make_scene(n_verts: int = 800, seed: int = 3407, device=None) -> SceneContext:
    device = resolve_device(device)
    model = S.synthetic_smpl(n_verts=n_verts, seed=seed, device=device)
    big = S.big_pose_params(device=device)
    v_big, _ = S.lbs_vertices(model, big["poses"][0], big["shapes"][0])
    return SceneContext(smpl=model, big_pose_params=big, big_pose_vertices=v_big)


def make_camera(H: int = 128, W: int = 128, dist: float = 2.5, angle: float = 0.0,
                device=None) -> Camera:
    """Camera on a circle around the origin, looking at it."""
    fx = 0.9 * max(H, W)
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]])
    c, s = np.cos(angle), np.sin(angle)
    eye = np.array([dist * s, 0.0, -dist * c])
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R_w2c = np.stack([right, up2, fwd], axis=0)  # rows
    T = -R_w2c @ eye
    # reference convention: CameraInfo stores R transposed
    return Camera.from_KRT(K, R_w2c.T, T, H, W, device=device)


def random_pose(rng, magnitude: float = 0.25):
    poses = np.zeros(72, np.float32)
    poses[3:] = rng.normal(0, magnitude, 69)
    return poses
