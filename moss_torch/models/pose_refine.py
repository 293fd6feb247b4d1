"""Autoregressive per-joint pose-correction MLP (port of moss_tpu/models/pose_refine.py).

A trunk (69 -> 128 -> 128 -> 69) gives a 3-vector per non-root joint; the 23
per-joint heads, each reading its joint's vector and all its ancestors', are
fused into one padded einsum over the static `_IDX`/`_MASK` gather; the smooth
Rodrigues map turns them into 23 correction rotations.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from ..ops.transforms import rodrigues_guarded
from .smpl import SMPL_PARENTS

NUM_JOINTS = 23  # non-root SMPL joints
TRUNK_WIDTH = 128


def _ancestors() -> List[List[int]]:
    anc: Dict[int, List[int]] = {}
    for i in range(1, len(SMPL_PARENTS)):
        joint = i - 1
        parent = SMPL_PARENTS[i] - 1
        anc[joint] = ([parent] + anc[parent]) if parent >= 0 else []
    return [anc[j] for j in range(NUM_JOINTS)]


ANCESTORS = _ancestors()
MAX_SLOTS = 1 + max(len(a) for a in ANCESTORS)  # self + deepest ancestor chain

# static gather index / mask: slot 0 = self, then ancestors in chain order
_IDX = np.zeros((NUM_JOINTS, MAX_SLOTS), np.int64)
_MASK = np.zeros((NUM_JOINTS, MAX_SLOTS), np.float32)
for _j, _anc in enumerate(ANCESTORS):
    _chain = [_j] + _anc
    _IDX[_j, : len(_chain)] = _chain
    _MASK[_j, : len(_chain)] = 1.0


def uniform_linear(fan_in: int, fan_out: int, generator, device) -> nn.Linear:
    """nn.Linear with torch's default U(+-1/sqrt(fan_in)) init drawn from `generator`."""
    lin = nn.Linear(fan_in, fan_out, device=device)
    bound = 1.0 / np.sqrt(fan_in)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


class PoseRefine(nn.Module):
    def __init__(self, generator=None, device=None):
        super().__init__()
        self.trunk0 = uniform_linear(69, TRUNK_WIDTH, generator, device)
        self.trunk1 = uniform_linear(TRUNK_WIDTH, TRUNK_WIDTH, generator, device)
        self.trunk2 = uniform_linear(TRUNK_WIDTH, 3 * NUM_JOINTS, generator, device)
        mask = torch.as_tensor(_MASK, device=device)
        heads_w = torch.empty((NUM_JOINTS, 3, 3 * MAX_SLOTS), device=device)
        heads_w.uniform_(-1e-5, 1e-5, generator=generator)
        # zero the padding columns so dead slots can never contribute
        self.heads_w = nn.Parameter(heads_w * mask.repeat_interleave(3, dim=-1)[:, None, :])
        self.heads_b = nn.Parameter(torch.zeros((NUM_JOINTS, 3), device=device))
        self.register_buffer("idx", torch.as_tensor(_IDX, device=device), persistent=False)
        self.register_buffer("mask", mask, persistent=False)

    def forward(self, poses) -> Dict[str, torch.Tensor]:
        """poses: (1, 72) axis-angle (root dropped) -> {"Rs": (23,3,3), "joint_feat": (23,3)}."""
        x = poses.reshape(1, -1)[:, 3:]
        h = torch.relu(self.trunk0(x))
        h = torch.relu(self.trunk1(h))
        joint_feat = self.trunk2(h).reshape(NUM_JOINTS, 3)
        gathered = joint_feat[self.idx] * self.mask[..., None]  # (23, S, 3)
        inputs = gathered.reshape(NUM_JOINTS, 3 * MAX_SLOTS)
        rvecs = torch.einsum("jok,jk->jo", self.heads_w, inputs) + self.heads_b
        return {"Rs": rodrigues_guarded(rvecs), "joint_feat": joint_feat}
