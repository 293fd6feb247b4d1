"""Synthetic dataset (port of moss_tpu/data/synthetic.py): the synthetic SMPL
scene with its big pose, an orbit camera, a random pose, and make_frames,
the ground-truth frames of a known cloud posed by skinning alone; and
bench_scene, bench.py's projected splat cloud.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import gaussians as G
from ..models import smpl as S
from ..models.deform import coarse_deform_c2source
from ..ops.projection import preprocess
from ..ops.rasterize_cuda import rasterize_cuda
from ..ops.sh import sh_to_color
from ..ops.transforms import build_covariance
from ..render.camera import Camera
from ..render.render import SceneContext
from .frames import Frame


def make_scene(n_verts: int = 800, seed: int = 3407, device=None) -> SceneContext:
    device = resolve_device(device)
    model = S.synthetic_smpl(n_verts=n_verts, seed=seed, device=device)
    big = S.big_pose_params(device=device)
    v_big, _ = S.lbs_vertices(model, big["poses"][0], big["shapes"][0])
    return SceneContext(smpl=model, big_pose_params=big, big_pose_vertices=v_big)


def orbit_krt(H: int = 128, W: int = 128, dist: float = 2.5, angle: float = 0.0):
    """(K, R_w2c, T_w2c) of a camera on a circle around the origin, looking at it."""
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
    return K, R_w2c, -R_w2c @ eye


def make_camera(H: int = 128, W: int = 128, dist: float = 2.5, angle: float = 0.0,
                device=None) -> Camera:
    """Camera on a circle around the origin, looking at it."""
    K, R_w2c, T = orbit_krt(H, W, dist, angle)
    # reference convention: CameraInfo stores R transposed
    return Camera.from_KRT(K, R_w2c.T, T, H, W, device=device)


def random_pose(rng, magnitude: float = 0.25):
    poses = np.zeros(72, np.float32)
    poses[3:] = rng.normal(0, magnitude, 69)
    return poses


def make_frames(
    scene: SceneContext,
    n_frames: int = 4,
    H: int = 128,
    W: int = 128,
    seed: int = 0,
    crop: int = 96,
    rasterize_fn: Optional[Callable] = None,
    opacity: Optional[float] = None,
) -> Tuple[List[Frame], dict]:
    """Render ground-truth frames of a target cloud deformed by LBS.

    The target cloud sits on the big-pose vertices with random colours; each
    frame poses it with coarse_deform_c2source (no learned corrections) and
    rasterizes it with `rasterize_fn` (default rasterize_cuda: the kernel on a
    GPU, the plain blend at 16x16 tiles on the CPU; moss_tpu renders with the
    plain blend at 32x32 tiles). `opacity` sets every target Gaussian's
    opacity (default create_from_points' 0.1, moss_tpu's target): a cloud
    seeded on the same vertices starts away from a denser target, so
    training has work to show. Runs where the scene lies. Returns
    (frames, {"xyz", "colors"}).
    """
    from scipy.spatial.transform import Rotation

    raster = rasterize_cuda if rasterize_fn is None else rasterize_fn
    device = scene.big_pose_vertices.device
    rng = np.random.default_rng(seed)
    verts = scene.big_pose_vertices.cpu().numpy()
    colors = rng.uniform(0.2, 0.9, (verts.shape[0], 3)).astype(np.float32)
    params, _ = G.create_from_points(verts, colors, capacity=verts.shape[0], device=device)
    if opacity is not None:
        params.opacity = torch.full_like(params.opacity, math.log(opacity / (1.0 - opacity)))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    frames = []
    with torch.no_grad():
        for i in range(n_frames):
            poses = random_pose(rng)
            smpl_params = {"poses": t(poses)[None], "shapes": t(np.zeros((1, 10))),
                           "R": t(np.eye(3)), "Th": t(np.zeros((1, 3)))}
            cam = make_camera(H, W, angle=2 * np.pi * i / max(n_frames, 1), device=device)
            out = coarse_deform_c2source(scene.smpl, params.xyz, smpl_params,
                                         scene.big_pose_params, scene.big_pose_vertices)
            cov3d = G.get_covariance(params, transform=out.transforms)
            color = sh_to_color(0, G.get_features(params), out.world_pts, cam.cam_center)
            proj = preprocess(out.world_pts, cov3d, color, G.get_opacity(params), cam)
            imgs = raster(proj, torch.zeros(3, device=device), H, W)
            alpha = imgs["alpha"]
            ys, xs = np.nonzero((alpha > 0.05).cpu().numpy())
            y0 = int(np.clip(ys.min(), 0, H - crop)) if len(ys) else 0
            x0 = int(np.clip(xs.min(), 0, W - crop)) if len(ys) else 0
            rotmats = Rotation.from_rotvec(poses.reshape(24, 3)[1:]).as_matrix()
            frames.append(Frame(
                camera=cam, image=imgs["color"], bkgd_mask=alpha,
                bound_mask=torch.ones((H, W), device=device), **smpl_params,
                pose_rotmats=t(rotmats), crop_y0=y0, crop_x0=x0, pose_id=i))
    return frames, {"xyz": params.xyz, "colors": colors}


def bench_scene(device=None, opacity=None, dense=False, H: int = 512, P: int = 46080):
    """bench.py:92-113's projected cloud (numpy default_rng(0), same draw
    order), also tools/bwd_kernel_floor.py:64-77's at 512x512: P splats with
    means in [-0.4, 0.4] x [-0.7, 0.7] x [1.5, 2.5], scales U(0.004, 0.012),
    random rotations and colours, opacity U(0.3, 0.95), seen by an H x H
    pinhole camera at the origin with f = 550 H / 512. opacity sets every
    opacity (the cloud after an opacity reset); dense packs the splats,
    enlarges them and makes them near-opaque (tests/test_rasterize_tpu.py:
    76-90). Returns (Projected, Camera)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    f = 550.0 * H / 512.0
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1.0]])
    cam = Camera.from_KRT(K, np.eye(3), np.zeros(3), H, H, device=device)
    means = np.stack(
        [rng.uniform(-0.4, 0.4, P), rng.uniform(-0.7, 0.7, P), rng.uniform(1.5, 2.5, P)], -1
    ).astype(np.float32)
    scales = rng.uniform(0.004, 0.012, (P, 3)).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    colors = rng.uniform(size=(P, 3)).astype(np.float32)
    op = rng.uniform(0.3, 0.95, P).astype(np.float32)
    if dense:
        means[:, :2] *= 0.5
        scales *= 1.5
        op[:] = 0.97
    if opacity is not None:
        op[:] = opacity

    def t(x):
        return torch.as_tensor(x, device=device)

    cov3d = build_covariance(t(scales), t(quats))
    return preprocess(t(means), cov3d, t(colors), t(op), cam), cam
