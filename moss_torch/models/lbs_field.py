"""Cross-attention LBS-weight delta field (port of moss_tpu/models/lbs_field.py).

NeRF-embedded Gaussian centres go through a 4-layer 128-wide MLP with a skip
at layer 2 to a 24-d query; keys/values are the 24 joint rotations flattened
to 9 (an all-ones 3x3 for the root); attention over the 9 rotation dims gives
a per-Gaussian 24-d log-space LBS-weight delta. Plain matmul + softmax.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .pose_refine import uniform_linear

NUM_FREQS = 10
EMBED_DIM = 3 + 3 * 2 * NUM_FREQS  # 63
WIDTH = 128
FEATURE_DIM = 24
ROT_DIM = 9


def positional_embed(x):
    """[x, sin/cos(2^k x)] for k = 0..9, (..., 3) -> (..., 63)."""
    freqs = 2.0 ** torch.arange(NUM_FREQS, dtype=x.dtype, device=x.device)
    ang = x[..., None, :] * freqs[:, None]  # (..., F, 3)
    enc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-2)  # (..., F, 2, 3)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


class LBSField(nn.Module):
    def __init__(self, generator=None, device=None):
        super().__init__()
        self.l0 = uniform_linear(EMBED_DIM, WIDTH, generator, device)
        self.l1 = uniform_linear(WIDTH, WIDTH, generator, device)
        self.l2 = uniform_linear(WIDTH, WIDTH, generator, device)
        self.l3 = uniform_linear(WIDTH + EMBED_DIM, WIDTH, generator, device)
        self.fc = uniform_linear(WIDTH, FEATURE_DIM, generator, device)
        self.query = uniform_linear(FEATURE_DIM, FEATURE_DIM, generator, device)
        self.key = uniform_linear(ROT_DIM, ROT_DIM, generator, device)
        self.value = uniform_linear(ROT_DIM, ROT_DIM, generator, device)

    def forward(self, points, Rs):
        """points: (N, 3) canonical centres; Rs: (23, 3, 3) -> (N, 24) deltas."""
        feat = positional_embed(points)
        net = torch.relu(self.l0(feat))
        net = torch.relu(self.l1(net))
        net = torch.relu(self.l2(net))
        net = torch.relu(self.l3(torch.cat([feat, net], dim=-1)))
        query = self.fc(net)  # (N, 24)

        key9 = torch.cat(
            [torch.ones((1, 3, 3), dtype=Rs.dtype, device=Rs.device), Rs], dim=0
        ).reshape(FEATURE_DIM, ROT_DIM)  # (24, 9)
        Q = self.query(query)  # (N, 24)
        K = self.key(key9)     # (24, 9)
        V = self.value(key9)   # (24, 9)
        attn = torch.softmax((Q @ K) / math.sqrt(FEATURE_DIM), dim=-1)  # (N, 9)
        return attn @ V.T  # (N, 24)
