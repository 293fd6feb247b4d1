"""Per-group AdamW with the reference's learning rates (port of moss_tpu/train/optim.py).

One group per Gaussian field (xyz on an exponential schedule, the others at
constant rates) and one per correction MLP ("pose", "lbs"). The state is
{group: AdamState(count, mu, nu)}, mu and nu keyed by parameter name: the
field name for a Gaussian group, the module's parameter names for an MLP
group. That is moss_tpu's optax.multi_transform state group for group, and
the update is optax.adamw's, with decoupled weight decay:

    mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2,  count += 1
    p -= lr (mu / (1 - b1^count) / (sqrt(nu / (1 - b2^count)) + eps) + wd p)

with lr read at the count before the step. torch.optim.AdamW is not used: it
folds the decay in before the moments and has no per-group skips.
"""
from __future__ import annotations

import math
from typing import Dict, FrozenSet, NamedTuple

import torch

from ..config import OptimConfig
from ..models.gaussians import FIELDS

GAUSS_GROUPS = FIELDS  # xyz, f_dc, f_rest, scaling, rotation, opacity
MLP_GROUPS = ("pose", "lbs")
B1, B2 = 0.9, 0.999


class AdamState(NamedTuple):
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000) -> float:
    """Log-linear interpolated LR (the reference's get_expon_lr_func)."""
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def param_groups(params: Dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """{group: {name: tensor}} of the trained tensors of {"gauss", "mlps"}."""
    g = params["gauss"]
    groups = {f: {f: getattr(g, f)} for f in GAUSS_GROUPS}
    if params.get("mlps") is not None:
        for name in MLP_GROUPS:
            groups[name] = dict(params["mlps"][name].named_parameters())
    return groups


def group_lr(cfg: OptimConfig, group: str, count: int, spatial_lr_scale: float = 1.0) -> float:
    if group == "xyz":
        return expon_lr(count, cfg.position_lr_init * spatial_lr_scale,
                        cfg.position_lr_final * spatial_lr_scale,
                        lr_delay_mult=cfg.position_lr_delay_mult,
                        max_steps=cfg.position_lr_max_steps)
    return {
        "f_dc": cfg.feature_lr, "f_rest": cfg.feature_lr / 20.0, "opacity": cfg.opacity_lr,
        "scaling": cfg.scaling_lr, "rotation": cfg.rotation_lr,
        "pose": cfg.pose_refine_lr, "lbs": cfg.lbs_field_lr,
    }[group]


def init_state(params: Dict) -> Dict[str, AdamState]:
    return {
        group: AdamState(0, {n: torch.zeros_like(p) for n, p in tensors.items()},
                         {n: torch.zeros_like(p) for n, p in tensors.items()})
        for group, tensors in param_groups(params).items()
    }


@torch.no_grad()
def adamw_step(cfg: OptimConfig, params: Dict, grads: Dict[str, Dict[str, torch.Tensor]],
               state: Dict[str, AdamState], skip: FrozenSet[str] = frozenset(),
               spatial_lr_scale: float = 1.0) -> Dict[str, AdamState]:
    """Update the parameters in place; return the new state. Groups in `skip`
    keep their parameters and state (see skipped_groups)."""
    new_state = dict(state)
    for group, tensors in param_groups(params).items():
        if group in skip:
            continue
        count, mu, nu = state[group]
        lr = group_lr(cfg, group, count, spatial_lr_scale)
        c1 = 1.0 - B1 ** (count + 1)
        c2 = 1.0 - B2 ** (count + 1)
        mu_new, nu_new = {}, {}
        for name, p in tensors.items():
            g = grads[group][name]
            m = (1.0 - B1) * g + B1 * mu[name]
            v = (1.0 - B2) * (g * g) + B2 * nu[name]
            u = (m / c1) / (torch.sqrt(v / c2) + cfg.adam_eps) + cfg.weight_decay * p
            p.sub_(lr * u)
            mu_new[name], nu_new[name] = m, v
        new_state[group] = AdamState(count + 1, mu_new, nu_new)
    return new_state


def skipped_groups(cfg: OptimConfig, white_background: bool, it: int) -> FrozenSet[str]:
    """The groups whose update the reference skips at 1-based iteration `it`
    (the predicates of moss_tpu's apply_reference_update_skips, optim.py:97-168).

    torch's optimizer.step() skips a parameter whose grad is None, and the
    reference replaces tensors before its step:
      * densify iterations (densify_from < it < densify_until, it % interval
        == 0) replace all six Gaussian tensors: those groups skip;
      * opacity resets (it % opacity_reset_interval == 0, or it ==
        densify_from with a white background), nested under it <
        densify_until, replace opacity: it skips;
      * the final iteration takes no step at all.
    """
    final = it == cfg.iterations
    dens = (it % cfg.densification_interval == 0
            and cfg.densify_from_iter < it < cfg.densify_until_iter)
    reset = it % cfg.opacity_reset_interval == 0 or (
        white_background and it == cfg.densify_from_iter)
    reset = reset and it < cfg.densify_until_iter
    skip = set()
    if dens or final:
        skip.update(GAUSS_GROUPS)
    if reset or final:
        skip.add("opacity")
    if final:
        skip.update(MLP_GROUPS)
    return frozenset(skip)


def zero_group_moments(state: Dict[str, AdamState], group: str) -> Dict[str, AdamState]:
    """Zero one group's first and second moments and keep its count (the
    reference's replace_tensor_to_optimizer at an opacity reset)."""
    count, mu, nu = state[group]
    out = dict(state)
    out[group] = AdamState(count, {n: torch.zeros_like(t) for n, t in mu.items()},
                           {n: torch.zeros_like(t) for n, t in nu.items()})
    return out
