"""One training iteration, plain: render, the six-term loss, autograd, AdamW.

moss_torch's train/train_step.py (TrainStep.grads and update) over this
package's copies: the frame rendered through the correction MLPs, the deform
chain and the tile blend (blend.py), the loss on the frame's crop, the grads
of every trained tensor, then per-group AdamW with tables this module works
out from the configuration (optim.step_tables). No densify statistics: the
benchmark compares the loss, the first gradient and the parameters' change.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from . import gaussians as G
from . import optim
from .losses import LossWeights, compute_losses
from .render import render_frame


@dataclasses.dataclass
class State:
    params: Dict            # {"gauss": GaussianParams, "mlps": {"pose", "lbs"}}
    valid: torch.Tensor     # (P,) bool
    opt_state: Dict         # {group: AdamState with 0-d int64 device counts}


def active_sh_degree(it: int, max_degree: int) -> int:
    """The SH degree iteration `it` (1-based) renders with (its step count
    before the step plus one, over 1000)."""
    return min(it // 1000, max_degree)


class ReferenceStep:
    """step(state, frame, it) runs iteration `it` in place and returns (loss,
    logs, grads): `optim` is a namespace of the configuration's optimizer
    fields, `model` of its sh_degree, motion_offset and white_background."""

    def __init__(self, scene, optim_cfg, model_cfg, lpips_params, crop_hw, length: int, device):
        self.scene, self.optim, self.model = scene, optim_cfg, model_cfg
        self.lpips_params, self.crop_hw, self.device = lpips_params, crop_hw, device
        o = optim_cfg
        self.weights = LossWeights(l1=o.w_l1, mask=o.w_mask, ssim=o.w_ssim, lpips=o.w_lpips,
                                   nll=o.w_nll, s3im=o.w_s3im)
        self.bg = torch.full((3,), 1.0 if model_cfg.white_background else 0.0, device=device)
        self.length = length
        self.tables = None

    def grads(self, state: State, frame, it: int):
        gauss = state.params["gauss"]
        leaves = G.GaussianParams(**{f: getattr(gauss, f).detach().requires_grad_()
                                     for f in G.FIELDS})
        mlps = state.params["mlps"]
        out = render_frame(leaves, state.valid, mlps, self.scene, frame.smpl_params,
                           frame.camera, self.bg, self.model.sh_degree,
                           motion_offset=self.model.motion_offset,
                           active_sh=active_sh_degree(it, self.model.sh_degree), device=self.device)
        total, logs = compute_losses(out, frame.image, frame.bkgd_mask, frame.bound_mask,
                                     frame.pose_rotmats, frame.crop_y0, frame.crop_x0,
                                     *self.crop_hw, lpips_params=self.lpips_params,
                                     weights=self.weights)
        groups = optim.param_groups({"gauss": leaves, "mlps": mlps})
        names = [(g, n) for g, tensors in groups.items() for n in tensors]
        flat = torch.autograd.grad(total, [groups[g][n] for g, n in names], allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {g: {} for g in groups}
        for (g, n), gr in zip(names, flat):
            grads[g][n] = torch.zeros_like(groups[g][n]) if gr is None else gr
        return total.detach(), {k: v.detach() for k, v in logs.items()}, grads

    def step(self, state: State, frame, it: int):
        total, logs, grads = self.grads(state, frame, it)
        if self.tables is None:
            self.tables = optim.step_tables(self.optim, self.model.white_background,
                                            optim.param_groups(state.params), 1.0, self.device,
                                            length=self.length)
        step = torch.full((), it - 1, dtype=torch.int64, device=self.device)
        optim.adamw_step_device(self.optim, state.params, grads, state.opt_state, self.tables,
                                step, 1.0)
        return total, logs, grads
