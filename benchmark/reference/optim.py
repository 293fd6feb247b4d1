"""Per-group AdamW with the reference's learning rates (port of moss_tpu/train/optim.py).

A frozen copy of moss_torch/train/optim.py for the benchmark's reference (its
plain path only, imports pointed into benchmark.reference).

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

The update is adamw_step_device, for a step that makes no host read (the
trainer's engines, a CUDA graph of the step): the counts are 0-d device
tensors, the count-dependent numbers (xyz's learning rate, 1 - b1^(count +
1), 1 - b2^(count + 1)) come from StepTables, computed on the host in
float64 and cast to float32, and the skips of iteration i from the tables'
skip row. The parameters and moments are updated in place, and the divisors
are float32 tensors: a Python float divisor would take another path on a
card (PyTorch multiplies by a reciprocal it rounds itself). adamw_step is
the same update for Python-int counts and a skip set, through tables it
builds for the one step (the form the tests hold to moss_tpu's optax).
"""
from __future__ import annotations

import math
from typing import Dict, FrozenSet, List, NamedTuple

import numpy as np
import torch

from .gaussians import FIELDS

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


def adamw_step(cfg: OptimConfig, params: Dict, grads: Dict[str, Dict[str, torch.Tensor]],
               state: Dict[str, AdamState], skip: FrozenSet[str] = frozenset(),
               spatial_lr_scale: float = 1.0) -> Dict[str, AdamState]:
    """adamw_step_device for int counts: the parameters and moments updated
    in place, the state returned with the counts advanced. Groups in `skip`
    keep their parameters and state (see skipped_groups)."""
    groups = list(param_groups(params))
    device = params["gauss"].xyz.device
    skip_row = np.array([[g in skip for g in groups]])
    tables = StepTables(groups, *_count_tables(cfg, max(int(state[g].count) for g in groups) + 1,
                                               spatial_lr_scale, device),
                        torch.as_tensor(skip_row, device=device), skip_row)
    counts = {g: torch.full((), int(s.count), dtype=torch.int64, device=device)
              for g, s in state.items()}
    adamw_step_device(cfg, params, grads, {g: AdamState(counts[g], s.mu, s.nu)
                                           for g, s in state.items()},
                      tables, torch.zeros((), dtype=torch.int64, device=device), spatial_lr_scale)
    return advance_counts(state, tables, 1, 1)


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


class StepTables(NamedTuple):
    """adamw_step_device's numbers for a run of `iterations` steps, on a device."""

    groups: List[str]          # the groups in param_groups order
    lr_xyz: torch.Tensor       # (iterations + 1,) f32 xyz learning rate at each count
    c1: torch.Tensor           # (iterations + 1,) f32 1 - b1^(count + 1)
    c2: torch.Tensor           # (iterations + 1,) f32 1 - b2^(count + 1)
    skip: torch.Tensor         # (iterations, len(groups)) bool: skipped at iteration i + 1
    skip_host: np.ndarray      # the same skips on the host


def _count_tables(cfg: OptimConfig, n: int, spatial_lr_scale: float, device):
    """(lr_xyz, c1, c2) of StepTables at counts 0..n - 1: float64 on the
    host, then float32 on the device."""
    def f32(vals):
        return torch.as_tensor(np.asarray(vals, np.float64).astype(np.float32), device=device)

    return (f32([group_lr(cfg, "xyz", k, spatial_lr_scale) for k in range(n)]),
            f32([1.0 - B1 ** (k + 1) for k in range(n)]),
            f32([1.0 - B2 ** (k + 1) for k in range(n)]))


def step_tables(cfg: OptimConfig, white_background: bool, groups, spatial_lr_scale: float,
                device, length: int = 0) -> StepTables:
    """The tables of adamw_step_device for iterations 1..length (default
    cfg.iterations; the final iteration's skips stay at cfg.iterations)."""
    device = torch.device(device)
    length = length or cfg.iterations
    groups = list(groups)
    skip = np.array([[g in skipped_groups(cfg, white_background, it) for g in groups]
                     for it in range(1, length + 1)], dtype=bool).reshape(-1, len(groups))
    return StepTables(groups, *_count_tables(cfg, length + 1, spatial_lr_scale, device),
                      skip=torch.as_tensor(skip, device=device), skip_host=skip)


def _take(table, i):
    """table[i] for a 0-d device index, without a host read."""
    return table.index_select(0, i.reshape(1)).squeeze(0)


@torch.no_grad()
def adamw_step_device(cfg: OptimConfig, params: Dict, grads: Dict[str, Dict[str, torch.Tensor]],
                      state: Dict[str, AdamState], tables: StepTables, step,
                      spatial_lr_scale: float = 1.0) -> None:
    """adamw_step at 0-based step `step` (a 0-d device int64), in place: the
    parameters, the moments and the counts (0-d device int64s in `state`) of
    the groups the skip row leaves on, with no host read."""
    skip_row = _take(tables.skip, step)
    for gi, (group, tensors) in enumerate(param_groups(params).items()):
        if tables.groups[gi] != group:
            raise ValueError(f"the tables' groups {tables.groups} are not the params'")
        count, mu, nu = state[group]
        skip = skip_row[gi]
        lr = (_take(tables.lr_xyz, count) if group == "xyz"
              else group_lr(cfg, group, 0, spatial_lr_scale))
        c1, c2 = _take(tables.c1, count), _take(tables.c2, count)
        for name, p in tensors.items():
            g = grads[group][name]
            m = (1.0 - B1) * g + B1 * mu[name]
            v = (1.0 - B2) * (g * g) + B2 * nu[name]
            u = (m / c1) / (torch.sqrt(v / c2) + cfg.adam_eps) + cfg.weight_decay * p
            p.copy_(torch.where(skip, p, p - lr * u))
            mu[name].copy_(torch.where(skip, mu[name], m))
            nu[name].copy_(torch.where(skip, nu[name], v))
        count.add_((~skip).to(count.dtype))


def advance_counts(state: Dict[str, AdamState], tables: StepTables, first: int,
                   last: int) -> Dict[str, AdamState]:
    """The host's AdamState after iterations first..last (1-based) ran on the
    device: each group's count plus the iterations that did not skip it, from
    the tables, with no device read."""
    ran = dict(zip(tables.groups, (~tables.skip_host[first - 1:last]).sum(0).tolist()))
    return {g: AdamState(s.count + ran.get(g, 0), s.mu, s.nu) for g, s in state.items()}
