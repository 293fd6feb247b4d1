"""The plain reference of one training step of an avatar, in PyTorch.

Frozen copies of moss_torch's plain modules (the SMPL rig's blend, the
deform chain and its kNN, the two correction MLPs, SH colour, the covariance
fold, the EWA projection, the six-term loss with LPIPS, SSIM, S3IM and the
Fisher NLL through torch.linalg.svd and per-group AdamW),
with their imports pointed here, plus a blend of its own (blend.py) that
composites each 16 x 16 tile's depth-ordered Gaussians in one cumulative
product. Nothing here imports moss_torch or any CUDA kernel; the benchmark
hands it the inputs it made and reads the program's outputs only to judge
them (step.py, check.py).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, else the current GPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", torch.cuda.current_device())
