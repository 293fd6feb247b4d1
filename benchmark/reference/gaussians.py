"""Gaussian cloud parameters under a capacity with a validity mask.

A frozen copy of moss_torch/models/gaussians.py for the benchmark's reference (its
plain path only, imports pointed into benchmark.reference).

Port of moss_tpu/models/gaussians.py:31-128: the same fields and activations
(exp / sigmoid / quat-normalize), capacity-padded with a `valid` mask so a
cloud moves between the two packages slot for slot, and the GaussianState
bookkeeping the training step keeps beside it. `compact` is the serving
counterpart of Trainer.compact_for_eval (train/trainer.py:1404): the port has
no static shapes, so it keeps exactly the live slots, in order.
"""
from __future__ import annotations

import dataclasses

import torch

from .transforms import build_covariance, quat_normalize

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


def get_features(p: GaussianParams):
    return torch.cat([p.f_dc, p.f_rest], dim=1)  # (P, 16, 3)


def get_covariance(p: GaussianParams, transform=None, scaling_modifier: float = 1.0):
    return build_covariance(
        get_scaling(p), p.rotation, transform=transform, scaling_modifier=scaling_modifier
    )


def num_sh_coeffs(sh_degree: int) -> int:
    return (sh_degree + 1) ** 2


