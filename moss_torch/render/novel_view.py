"""Free-viewpoint (novel-view) orbit cameras (port of moss_tpu/render/novel_view.py).

The reference's `novel_view_vis` path (scene/dataset_readers.py:509-538
ZJU, :268-297 MonoCap): cameras on a fixed-radius circle about the subject,
built by an OpenGL look-at and flipped to COLMAP axes (Y down, Z forward)
with diag(1, -1, -1, 1). Each frame keeps its SMPL pose; only the camera
moves, so a trained avatar renders as an orbit from viewpoints never
captured.

Host camera math in numpy float32, step for step moss_tpu's, so the
matrices are bit for bit the same. `novel_view_specs` grafts the orbit onto
a split's FrameSpecs: one spec per pose supplies the SMPL params, world
bound, K and the image paths (the ground truth is not from the orbit
viewpoint; rendering is the point).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


def _lookat_w2c(eye: np.ndarray, at: np.ndarray, up: np.ndarray) -> np.ndarray:
    """OpenGL look-at view matrix (dataset_readers.py:513-524)."""

    def norm(v):
        return v / np.linalg.norm(v)

    z = norm(at - eye)
    x = norm(np.cross(z, up))
    y = np.cross(x, z)
    return np.array([
        [x[0], x[1], x[2], -np.dot(x, eye)],
        [y[0], y[1], y[2], -np.dot(y, eye)],
        [-z[0], -z[1], -z[2], np.dot(z, eye)],
        [0.0, 0.0, 0.0, 1.0],
    ])


_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])  # OpenGL -> COLMAP axes


def _fix_eye(phi: float, theta: float, camera_distance: float) -> np.ndarray:
    return np.array([
        camera_distance * np.sin(theta) * np.cos(phi),
        camera_distance * np.sin(theta) * np.sin(phi),
        camera_distance * np.cos(theta),
    ])


def orbit_w2c_zju(view_index: int, camera_view_num: int = 36) -> np.ndarray:
    """(4, 4) world-to-camera of ZJU orbit view `view_index`: a radius-2
    circle about (0, 0, -0.8), up -z (dataset_readers.py:509-538, :628)."""
    at = np.array([0.0, 0.0, -0.8], np.float32)
    eye = _fix_eye(
        np.pi + 2 * np.pi * view_index / camera_view_num + 1e-6,
        np.pi / 2 + np.pi / 12 + 1e-6,
        camera_distance=2.0,
    ).astype(np.float32) + at
    ext = _lookat_w2c(eye, at, np.array([0.0, 0.0, -1.0])).astype(np.float32)
    return (_FLIP @ ext).astype(np.float32)


def orbit_w2c_monocap(view_index: int, camera_view_num: int = 36) -> np.ndarray:
    """(4, 4) world-to-camera of MonoCap orbit view `view_index`: a radius-3
    circle about (0, 0.8, 0), up +y, the sweep on theta
    (dataset_readers.py:268-297, :375)."""
    at = np.array([0.0, 0.8, 0.0], np.float32)
    eye = _fix_eye(
        np.pi + np.pi / 12 + 1e-6,
        -np.pi / 2 + 2 * np.pi * view_index / camera_view_num + 1e-6,
        camera_distance=3.0,
    ).astype(np.float32) + at
    ext = _lookat_w2c(eye, at, np.array([0.0, 1.0, 0.0])).astype(np.float32)
    return (_FLIP @ ext).astype(np.float32)


ORBIT_CENTER = {"zju": (0.0, 0.0, -0.8), "monocap": (0.0, 0.8, 0.0)}


def novel_view_specs(specs: List, dataset: str = "zju", n_views: int = 36,
                     camera_view_num: int = 36) -> List:
    """For each distinct pose in `specs`, n_views specs on the dataset's
    orbit: the pose's first spec with R|T replaced by the orbit camera and
    no undistortion (D=None), as the reference reuses view 0
    (dataset_readers.py:604-616)."""
    orbit = orbit_w2c_zju if dataset == "zju" else orbit_w2c_monocap
    by_pose: dict = {}
    for s in specs:
        by_pose.setdefault(s.pose_id, s)
    out = []
    for pose_id in sorted(by_pose):
        base = by_pose[pose_id]
        for v in range(n_views):
            w2c = orbit(v, camera_view_num)
            out.append(dataclasses.replace(
                base,
                R_w2c=w2c[:3, :3].astype(np.float64),
                T_w2c=w2c[:3, 3:4].astype(np.float64),
                D=None,
            ))
    return out
