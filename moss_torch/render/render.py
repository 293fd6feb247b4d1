"""One frame: deform -> covariance fold -> SH colour -> preprocess -> rasterize.

Port of moss_tpu/render/render.py:35-154 with the same arguments and the same
return dict (images plus the training-contract extras). `mlps` holds the two
correction modules, {"pose": PoseRefine, "lbs": LBSField}. The rasterizer
defaults to ops.rasterize_cuda.rasterize_cuda: the CUDA kernel on a GPU, its
plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from .. import resolve_device
from ..models import gaussians as G
from ..models.deform import apply_cached_transform, coarse_deform_c2source
from ..models.smpl import SMPLModel
from ..ops.projection import preprocess
from ..ops.rasterize_cuda import rasterize_cuda
from ..ops.sh import degree_coeff_mask, sh_to_color
from .camera import Camera


@dataclasses.dataclass(frozen=True)
class SceneContext:
    """Per-sequence constants: body model + canonical big pose."""

    smpl: SMPLModel
    big_pose_params: Dict        # poses/shapes/R/Th tensors
    big_pose_vertices: torch.Tensor  # (V, 3) big-pose world vertices


def render_frame(
    params: G.GaussianParams,
    valid,
    mlps: Optional[Dict],
    scene: SceneContext,
    smpl_params: Dict,
    camera: Camera,
    bg_color,
    sh_degree: int,
    rasterize_fn: Optional[Callable] = None,
    mean2d_offset=None,
    cached_transforms=None,
    cached_translation=None,
    motion_offset: bool = True,
    static_scene: bool = False,
    active_sh=None,
    scaling_modifier: float = 1.0,
    override_color=None,
    device=None,
):
    """Render one frame on `device` (default: the GPU; the cloud must lie there).

    rasterize_fn(proj, bg, H, W) -> dict; defaults to rasterize_cuda.
    cached_transforms/translation: the MLP-free eval path.
    """
    device = resolve_device(device)
    if params.xyz.device != device:
        raise ValueError(f"the cloud lies on {params.xyz.device}, not on {device}")
    means_canonical = params.xyz
    pose_out = None
    bweights = None
    transforms = cached_transforms
    translation = cached_translation

    if static_scene:
        # vanilla-3DGS path: no body, no deformation
        means3d = means_canonical
        transforms = None
    elif not motion_offset:
        out = coarse_deform_c2source(
            scene.smpl, means_canonical, smpl_params,
            scene.big_pose_params, scene.big_pose_vertices,
        )
        means3d, transforms, translation = out.world_pts, out.transforms, out.translation
        bweights = out.bweights
    elif transforms is None:
        pose_out = mlps["pose"](smpl_params["poses"])
        correct_Rs = pose_out["Rs"]  # (23, 3, 3)
        lbs_delta = mlps["lbs"](means_canonical, correct_Rs)
        out = coarse_deform_c2source(
            scene.smpl, means_canonical, smpl_params,
            scene.big_pose_params, scene.big_pose_vertices,
            lbs_weight_delta=lbs_delta, correct_Rs=correct_Rs,
        )
        means3d, transforms, translation = out.world_pts, out.transforms, out.translation
        bweights = out.bweights
    else:
        means3d = apply_cached_transform(means_canonical, transforms, translation)

    cov3d = G.get_covariance(params, transform=transforms, scaling_modifier=scaling_modifier)
    if override_color is not None:
        color = override_color
    else:
        feats = G.get_features(params)
        if active_sh is not None:
            feats = feats * degree_coeff_mask(active_sh, feats.shape[1], device)
        color = sh_to_color(sh_degree, feats, means3d, camera.cam_center)
    opacity = G.get_opacity(params)

    proj = preprocess(means3d, cov3d, color, opacity, camera, valid_mask=valid)
    if mean2d_offset is not None:
        proj = proj._replace(mean2d=proj.mean2d + mean2d_offset)

    raster = rasterize_cuda if rasterize_fn is None else rasterize_fn
    images = raster(proj, bg_color, camera.height, camera.width)
    # rasterizer extras (the `overflow` count) pass through to the caller
    extra = {k: v for k, v in images.items()
             if k not in ("color", "depth", "alpha", "final_T")}
    return {
        "render": images["color"],  # (H, W, 3)
        "render_depth": images["depth"],
        "render_alpha": images["alpha"],
        "final_T": images.get("final_T"),
        "radii": proj.radius,
        "visibility_filter": proj.valid & (proj.radius > 0),
        "transforms": transforms,
        "translation": translation,
        "pose_out": pose_out,
        "lbs_weights": bweights,
        "means3D": means3d,
        **extra,
    }
