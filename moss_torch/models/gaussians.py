"""Gaussian cloud parameters under a capacity with a validity mask.

Port of moss_tpu/models/gaussians.py:31-128: the same fields and activations
(exp / sigmoid / quat-normalize), capacity-padded with a `valid` mask so a
cloud moves between the two packages slot for slot, and the GaussianState
bookkeeping the training step keeps beside it. `compact` is the serving
counterpart of Trainer.compact_for_eval (train/trainer.py:1404): the port has
no static shapes, so it keeps exactly the live slots, in order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..ops.knn import mean_knn_dist2
from ..ops.sh import rgb_to_sh
from ..ops.transforms import build_covariance, inverse_sigmoid, quat_normalize

FIELDS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


@dataclasses.dataclass
class GaussianParams:
    """Per-Gaussian parameters (all capacity-padded)."""

    xyz: torch.Tensor        # (P, 3) canonical (big-pose world) positions
    f_dc: torch.Tensor       # (P, 1, 3) degree-0 SH
    f_rest: torch.Tensor     # (P, 15, 3) higher SH
    scaling: torch.Tensor    # (P, 3) log-scales
    rotation: torch.Tensor   # (P, 4) unnormalized quaternions (w,x,y,z)
    opacity: torch.Tensor    # (P, 1) logits

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


@dataclasses.dataclass
class GaussianState:
    """Non-learnable bookkeeping that rides along the cloud."""

    valid: torch.Tensor           # (P,) bool
    max_radii2d: torch.Tensor     # (P,) f32, densify pruning stat
    xyz_grad_accum: torch.Tensor  # (P,) f32, sum of screen-grad norms
    denom: torch.Tensor           # (P,) f32, frames accumulated
    joint_F: torch.Tensor         # (23, 3, 3) summed Fisher factors over the window
    lbs_weight_sum: torch.Tensor  # (P, 24) summed blend weights over the window

    @property
    def num_valid(self):
        return torch.sum(self.valid.to(torch.int32))


def initial_state(valid) -> GaussianState:
    """The state of a fresh cloud with live slots `valid` (zero statistics)."""
    P, device = valid.shape[0], valid.device
    return GaussianState(
        valid=valid,
        max_radii2d=torch.zeros((P,), device=device),
        xyz_grad_accum=torch.zeros((P,), device=device),
        denom=torch.zeros((P,), device=device),
        joint_F=torch.zeros((23, 3, 3), device=device),
        lbs_weight_sum=torch.zeros((P, 24), device=device),
    )


def get_scaling(p: GaussianParams):
    return torch.exp(p.scaling)


def get_rotation(p: GaussianParams):
    return quat_normalize(p.rotation)


def get_opacity(p: GaussianParams):
    return torch.sigmoid(p.opacity)


def reset_opacity(p: GaussianParams) -> GaussianParams:
    """Opacities clamped to <= 0.01 (the reference's reset_opacity)."""
    return dataclasses.replace(p, opacity=inverse_sigmoid(torch.clamp_max(get_opacity(p), 0.01)))


def get_features(p: GaussianParams):
    return torch.cat([p.f_dc, p.f_rest], dim=1)  # (P, 16, 3)


def get_covariance(p: GaussianParams, transform=None, scaling_modifier: float = 1.0):
    return build_covariance(
        get_scaling(p), p.rotation, transform=transform, scaling_modifier=scaling_modifier
    )


def num_sh_coeffs(sh_degree: int) -> int:
    return (sh_degree + 1) ** 2


def create_from_points(points, colors, capacity: int, sh_degree: int = 3, device=None):
    """Initialize the cloud from a point set: scales from the mean-3NN
    distance, identity rotations, opacity 0.1. Dead capacity slots are
    masked invalid and parked far away with ~zero opacity.

    Returns (params, valid).
    """
    device = resolve_device(device)
    points = torch.as_tensor(np.asarray(points, np.float32), device=device)
    colors = torch.as_tensor(np.asarray(colors, np.float32), device=device)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} init points exceed capacity {capacity}")
    n_rest = num_sh_coeffs(sh_degree) - 1
    pad = capacity - n

    dist2 = torch.clamp_min(mean_knn_dist2(points), 1e-7)
    log_scale = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def padded(x, fill):
        return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)], dim=0)

    xyz = padded(points, 0.0)
    xyz[n:, 2] = -1e6
    rotation = torch.zeros((capacity, 4), device=device)
    rotation[:, 0] = 1.0
    params = GaussianParams(
        xyz=xyz,
        f_dc=padded(rgb_to_sh(colors)[:, None, :], 0.0),
        f_rest=torch.zeros((capacity, n_rest, 3), device=device),
        scaling=padded(log_scale, -10.0),
        rotation=rotation,
        opacity=padded(inverse_sigmoid(torch.full((n, 1), 0.1, device=device)), -15.0),
    )
    valid = torch.arange(capacity, device=device) < n
    return params, valid


def compact(params: GaussianParams, valid):
    """Keep the live slots, in their order: (params, valid) of capacity
    valid.sum(). Per-Gaussian caches (cached transforms) built before the
    compaction no longer line up and must be recomputed."""
    keep = torch.nonzero(valid).squeeze(1)
    out = GaussianParams(**{f: getattr(params, f)[keep] for f in FIELDS})
    return out, torch.ones(keep.shape[0], dtype=torch.bool, device=valid.device)
