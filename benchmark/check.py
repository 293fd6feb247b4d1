"""How `correct` is decided: the plain reference against what the timed path produced.

Training, from the cell's inputs, after the program's state is freed:

  * the reference takes the cell's initial state (the inputs the benchmark
    made, never the program's tensors) and runs the three iterations the
    program's set-up ran through the window's own call, on the same frames
    (the Trainer's epoch order, worked out again here);
  * loss_gap: the largest gap of a step's loss, over the sum of its six
    weighted terms' magnitudes (the Fisher NLL can be negative, and the
    loss itself then near 0);
  * grad_gap: the first gradient as the optimizer got it (the program's
    first moments after one step over 1 - b1, from zero moments), by the
    worst leaf: the gap of the program's norm and the reference's over the
    larger of the reference's norm of that leaf and the median leaf's;
  * change_gap: the parameters' change after the three steps, each leaf's
    gap as above, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's (below that a leaf moves under AdamW by
    rounding alone); of each optimizer group (xyz, f_dc, ..., the pose MLP,
    the LBS field: each its own rate, schedule and decay) its median leaf,
    and of those the worst group. A fault in one group's update shows in
    that group; the median within a group keeps out the LBS field's 9 x 9
    value map, whose change after three steps reads rounding: AdamW's first
    steps from zero moments move every entry by about its rate times the
    sign of its gradient, and entries of that map whose gradient comes from
    cancelling terms take their sign from rounding (PERF.md gives the look).

Each number has a limit in the cell's file; `correct` holds when every
number is at or under its limit and no checked step dropped pairs.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

from .inputs import Inputs, frame_order, reference_frame, reference_mlps
from .reference import gaussians as RG
from .reference import optim as RO
from .reference import smpl as RS
from .reference.render import SceneContext
from .reference.step import ReferenceStep, State

MOVED = 1e-3  # a leaf moves when its reference gradient is this share of the median leaf's


def reference_state(inp: Inputs, device) -> State:
    gauss = RG.GaussianParams(**{k: v.clone() for k, v in inp.gauss.items()})
    mlps = reference_mlps(inp.mlp_weights, device) if inp.config["model"]["motion_offset"] else None
    params = {"gauss": gauss, "mlps": mlps}
    opt = {g: RO.AdamState(torch.zeros((), dtype=torch.int64, device=device),
                           {n: torch.zeros_like(t) for n, t in ts.items()},
                           {n: torch.zeros_like(t) for n, t in ts.items()})
           for g, ts in RO.param_groups(params).items()}
    return State(params, inp.valid.clone(), opt)


def leaf_norms(groups) -> Dict[str, float]:
    return {f"{g}/{n}": float(torch.linalg.vector_norm(t.detach()))
            for g, ts in groups.items() for n, t in ts.items()}


def reference_steps(inp: Inputs, device, steps: int = 3) -> Dict:
    """The reference's losses, first gradient and change (each leaf's norm)
    over `steps` iterations from the cell's state."""
    big = RS.big_pose_params(inp.config["smpl"]["n_shapes"], device=device)
    scene = SceneContext(smpl=inp.rig, big_pose_params=big,
                         big_pose_vertices=inp.big_pose_vertices)
    state = reference_state(inp, device)
    init = {k: t.detach().clone() for g, ts in RO.param_groups(state.params).items()
            for k, t in ((f"{g}/{n}", t) for n, t in ts.items())}
    step = ReferenceStep(scene, inp.optim, inp.model, inp.lpips, inp.crop_hw,
                         inp.workload["run_iterations"], device)
    order = frame_order(inp.config["seed"], len(inp.frames), inp.start + steps)
    logs, grad = [], {}
    for k in range(1, steps + 1):
        it = inp.start + k
        _, terms, grads = step.step(state, reference_frame(inp.frames[order[it - 1]], device), it)
        logs.append({t: float(v) for t, v in terms.items()})
        if k == 1:
            grad = leaf_norms(grads)
    change = {k: float(torch.linalg.vector_norm(t.detach() - init[k]))
              for g, ts in RO.param_groups(state.params).items()
              for k, t in ((f"{g}/{n}", t) for n, t in ts.items())}
    return {"logs": logs, "grad": grad, "change": change}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of the reference's norm of
    that leaf and of the median leaf."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30) if np.isfinite(p) else float("inf")


def loss_scale(logs: Dict, w) -> float:
    """The size of a step's loss: its six weighted terms' magnitudes summed
    (the Fisher NLL can be negative, and the sum of the terms then near 0)."""
    return (w.w_l1 * abs(logs["l1"]) + w.w_mask * abs(logs["mask"])
            + w.w_ssim * abs(1.0 - logs["ssim"]) + w.w_lpips * abs(logs["lpips"])
            + w.w_nll * abs(logs["nll"]) + w.w_s3im * abs(logs["s3im"]))


def step_numbers(prog_logs: List[Dict], prog_grad: Dict, prog_change: Dict, ref: Dict,
                 weights) -> Dict:
    """The three numbers of the checked steps (module docstring), and each
    loss term's largest relative gap beside them."""
    loss_gap = max(abs(p["loss"] - r["loss"]) / loss_scale(r, weights)
                   if np.isfinite(p["loss"]) else float("inf")
                   for p, r in zip(prog_logs, ref["logs"]))
    terms = {t: max(rel(p[t], r[t]) for p, r in zip(prog_logs, ref["logs"]))
             for t in ref["logs"][0] if t != "loss"}
    grad = leaf_gaps(prog_grad, ref["grad"], ref["grad"])
    med = statistics.median(ref["grad"].values())
    moved = [k for k, v in ref["grad"].items() if v >= MOVED * med]
    change = leaf_gaps(prog_change, ref["change"], moved)
    groups = group_medians(change)
    worst_g, worst_c = max(grad, key=grad.get), max(change, key=change.get)
    worst_group = max(groups, key=groups.get)
    return {"loss_gap": loss_gap, "grad_gap": grad[worst_g], "change_gap": groups[worst_group],
            "_change_gap_worst_leaf": change[worst_c], "_grad_leaf": worst_g,
            "_change_leaf": worst_c, "_change_group": worst_group,
            "_moved_leaves": len(moved), "_leaves": len(ref["grad"]),
            "_change_by_leaf": change, "_terms": terms}


def group_medians(gaps: Dict[str, float]) -> Dict[str, float]:
    """Each optimizer group's median leaf gap, from {"group/leaf": gap}."""
    by: Dict[str, List[float]] = {}
    for k, v in gaps.items():
        by.setdefault(k.split("/")[0], []).append(v)
    return {g: statistics.median(v) for g, v in by.items()}


def judge(numbers: Dict, limits: Dict, overflow: int) -> (bool, List[str]):
    """(correct, lines): each number beside its limit; a number without a
    limit fails."""
    lines, ok = [], overflow == 0
    lines.append(f"checked_steps_overflow {overflow} limit 0")
    for k, v in numbers.items():
        if k.startswith("_"):
            continue
        lim = limits.get(k)
        good = lim is not None and np.isfinite(v) and v <= lim
        ok &= good
        lines.append(f"{k} {v!r} limit {lim!r}")
    return bool(ok), lines
