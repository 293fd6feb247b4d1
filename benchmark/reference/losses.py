"""The six-term training loss (port of moss_tpu/train/losses.py).

A frozen copy of moss_torch/train/losses.py for the benchmark's reference (its
plain path only, imports pointed into benchmark.reference).

loss = L1(bound) + 0.5 mask_L2 + 0.2 (1 - SSIM) + 0.5 LPIPS + 0.06 FisherNLL
       + 0.3 S3IM

SSIM, S3IM and LPIPS read a fixed-size crop window whose top-left each frame
carries, as in moss_tpu. LPIPS runs its towers in bf16 for the training loss
(the metric path stays f32), and is skipped when its weight is 0.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from . import lpips as lpips_mod
from .fisher import matrix_fisher_nll
from .ssim import s3im as s3im_fn
from .ssim import ssim as ssim_fn


class LossWeights(NamedTuple):
    l1: float = 1.0
    mask: float = 0.5
    ssim: float = 0.2
    lpips: float = 0.5
    nll: float = 0.06
    s3im: float = 0.3


def crop_window(img, y0, x0, crop_h: int, crop_w: int):
    """Fixed-size crop at (y0, x0); img (H, W, C) or (H, W). y0 and x0 are
    ints, or 0-d device ints (a step that reads no host value), gathered
    then; either way the crop is a contiguous copy with the same bits."""
    if isinstance(y0, torch.Tensor):
        rows = y0 + torch.arange(crop_h, device=img.device)
        cols = x0 + torch.arange(crop_w, device=img.device)
        return img.index_select(0, rows).index_select(1, cols)
    return img[y0:y0 + crop_h, x0:x0 + crop_w].contiguous()


def compute_losses(
    render_out: Dict,
    gt_image,             # (H, W, 3)
    bkgd_mask,            # (H, W) soft alpha target
    bound_mask,           # (H, W) 0/1 region of interest
    target_pose_rotmats,  # (23, 3, 3) dataset pose rotations
    crop_y0,              # int, or a 0-d device int
    crop_x0,
    crop_h: int,
    crop_w: int,
    lpips_params=None,
    weights: LossWeights = LossWeights(),
    gt_lpips_feats=None,
):
    """(total, logs) with the six terms. lpips_params is needed unless
    weights.lpips is 0; gt_lpips_feats is lpips.gt_features of the crop of
    the gt image (bf16), computed once per frame."""
    img = render_out["render"]
    alpha = render_out["render_alpha"]

    bound = bound_mask.to(img.dtype)
    n_bound = torch.sum(bound) + 1e-8

    l1 = torch.sum(torch.abs(img - gt_image) * bound[..., None]) / (3.0 * n_bound)
    mask_l2 = torch.sum(((alpha - bkgd_mask) ** 2) * bound) / n_bound

    img_c = crop_window(img, crop_y0, crop_x0, crop_h, crop_w)
    gt_c = crop_window(gt_image, crop_y0, crop_x0, crop_h, crop_w)
    ssim_val = ssim_fn(img_c, gt_c)
    s3im_loss = s3im_fn(img_c, gt_c)

    if weights.lpips != 0.0:
        if lpips_params is None:
            raise ValueError("the LPIPS term needs lpips_params (ops/lpips.init_random or load_params)")
        lpips_loss = lpips_mod.lpips(lpips_params, img_c, gt_c, dtype=torch.bfloat16,
                                     cached_f2=gt_lpips_feats)
    else:
        lpips_loss = img.new_zeros(())

    pose_out = render_out.get("pose_out")
    if pose_out is not None:
        nll = torch.mean(matrix_fisher_nll(pose_out["Rs"], target_pose_rotmats))
    else:
        nll = img.new_zeros(())

    total = (
        weights.l1 * l1
        + weights.mask * mask_l2
        + weights.ssim * (1.0 - ssim_val)
        + weights.lpips * lpips_loss
        + weights.nll * nll
        + weights.s3im * s3im_loss
    )
    return total, {
        "loss": total,
        "l1": l1,
        "mask": mask_l2,
        "ssim": ssim_val,
        "lpips": lpips_loss,
        "nll": nll,
        "s3im": s3im_loss,
    }
