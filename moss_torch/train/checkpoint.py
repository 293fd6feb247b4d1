"""Checkpoints: the whole train state in one npz, and the reference's layout
(port of moss_tpu/train/checkpoint.py).

chkpnt{N}.npz holds one array per leaf of moss_tpu's TrainState, keyed by
jax.tree_util.keystr of its path, so a file written by either package loads
in the other. The key table is built here from the port's own structures:

  .params['gauss'].<field>                       GaussianParams, f32
  .params['mlps']['pose'|'lbs'][<layer>]['w'|'b'] linear weights (in, out), biases
  .params['mlps']['pose']['heads_w'|'heads_b']   the fused pose heads
  .opt_state.inner_states['<group>'].inner_state[0].count        int32
  .opt_state.inner_states['<group>'].inner_state[0].mu|nu<param path>
  .opt_state.inner_states['xyz'].inner_state[2].count             int32
  .gstate.<field>                                GaussianState (valid bool)
  .step                                          int32

optax's multi_transform keeps one masked AdamW chain per group over the whole
params tree, so a group's moments sit under its own leaves' paths; the masked
leaves have no key. The xyz group's chain also carries its schedule's count,
equal to its Adam count. nn.Linear keeps its weight (out, in), JAX (in, out):
the table transposes. A static scene has no MLPs, yet moss_tpu keeps a count
for the empty "pose" and "lbs" groups; the port keeps no state for them and
writes 0.

The reference layout (point_cloud/iteration_N/point_cloud.ply +
mlp_ckpt/iteration_N/ckpt.npz, or the reference's own ckpt.pth) carries the
live cloud and the MLP weights only.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data.ply import load_ply, save_ply
from ..models import gaussians as G
from ..models.lbs_field import LBSField
from ..models.pose_refine import MAX_SLOTS, NUM_JOINTS, PoseRefine
from .optim import GAUSS_GROUPS, MLP_GROUPS, AdamState
from .train_step import TrainState

POSE_LINEARS = ("trunk0", "trunk1", "trunk2")
LBS_LINEARS = ("l0", "l1", "l2", "l3", "fc", "query", "key", "value")
GSTATE_FIELDS = ("valid", "max_radii2d", "xyz_grad_accum", "denom", "joint_F", "lbs_weight_sum")
GROUPS = GAUSS_GROUPS + MLP_GROUPS


def mlp_table(group: str) -> List[Tuple[str, str, bool]]:
    """(JAX path within the group, the module's parameter name, transposed)."""
    rows = []
    for name in (POSE_LINEARS if group == "pose" else LBS_LINEARS):
        rows += [(f"['{name}']['b']", f"{name}.bias", False),
                 (f"['{name}']['w']", f"{name}.weight", True)]
    if group == "pose":
        rows += [("['heads_b']", "heads_b", False), ("['heads_w']", "heads_w", False)]
    return rows


def _np(t: torch.Tensor, transpose: bool = False) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.ascontiguousarray(a.T) if transpose else a


def _tensor(a: np.ndarray, device, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(a)
    return torch.as_tensor(np.ascontiguousarray(a.T if transpose else a), device=device)


def mlp_leaves(tensors: Dict[str, torch.Tensor], group: str, prefix: str) -> Dict[str, np.ndarray]:
    """One MLP group's tensors keyed by name -> {prefix + JAX path: array}."""
    return {prefix + path: _np(tensors[name], t) for path, name, t in mlp_table(group)}


def mlp_tensors(data, group: str, prefix: str, device) -> Dict[str, torch.Tensor]:
    """The inverse of mlp_leaves: {parameter name: tensor} from the keys."""
    return {name: _tensor(data[prefix + path], device, t) for path, name, t in mlp_table(group)}


def make_mlps(tensors: Dict[str, Dict[str, torch.Tensor]], device) -> Dict:
    """{"pose": PoseRefine, "lbs": LBSField} holding the given state dicts."""
    gen = torch.Generator(device=device).manual_seed(0)  # leaves the global RNG alone
    mlps = {"pose": PoseRefine(gen, device), "lbs": LBSField(gen, device)}
    for group, module in mlps.items():
        module.load_state_dict(tensors[group])
    return mlps


def flatten(ts: TrainState) -> Dict[str, np.ndarray]:
    """The TrainState as moss_tpu's npz leaves (see the module docstring)."""
    out = {}
    g = ts.params["gauss"]
    for f in G.FIELDS:
        out[f".params['gauss'].{f}"] = _np(getattr(g, f))
    mlps = ts.params.get("mlps")
    if mlps is not None:
        for group in MLP_GROUPS:
            out.update(mlp_leaves(dict(mlps[group].named_parameters()), group,
                                  f".params['mlps']['{group}']"))
    for group in GROUPS:
        pre = f".opt_state.inner_states['{group}'].inner_state[0]"
        st = ts.opt_state.get(group)
        out[pre + ".count"] = np.asarray(st.count if st is not None else 0, np.int32)
        if st is None:
            continue
        for m in ("mu", "nu"):
            moments = getattr(st, m)
            if group in GAUSS_GROUPS:
                out[f"{pre}.{m}['gauss'].{group}"] = _np(moments[group])
            else:
                out.update(mlp_leaves(moments, group, f"{pre}.{m}['mlps']['{group}']"))
    out[".opt_state.inner_states['xyz'].inner_state[2].count"] = np.asarray(
        ts.opt_state["xyz"].count, np.int32)
    for f in GSTATE_FIELDS:
        out[f".gstate.{f}"] = _np(getattr(ts.gstate, f))
    out[".step"] = np.asarray(ts.step, np.int32)
    return out


def save_checkpoint(path: str, ts: TrainState) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flatten(ts))


def read_params(data, device) -> Tuple[G.GaussianParams, torch.Tensor, Optional[Dict]]:
    """(params, valid, mlps or None) from an open chkpnt npz."""
    params = G.GaussianParams(**{f: _tensor(data[f".params['gauss'].{f}"], device)
                                 for f in G.FIELDS})
    valid = _tensor(data[".gstate.valid"], device)
    if ".params['mlps']['pose']['heads_w']" not in data.files:
        return params, valid, None
    return params, valid, make_mlps(
        {group: mlp_tensors(data, group, f".params['mlps']['{group}']", device)
         for group in MLP_GROUPS}, device)


def load_params(path: str, device=None):
    """(params, valid, mlps or None) from a chkpnt{N}.npz of either package."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        return read_params(data, device)


def restore_checkpoint(path: str, device=None) -> TrainState:
    """The TrainState a chkpnt{N}.npz of either package holds."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        params, valid, mlps = read_params(data, device)
        opt_state = {}
        for group in GROUPS:
            pre = f".opt_state.inner_states['{group}'].inner_state[0]"
            count = int(data[pre + ".count"])
            if group in GAUSS_GROUPS:
                mu, nu = ({group: _tensor(data[f"{pre}.{m}['gauss'].{group}"], device)}
                          for m in ("mu", "nu"))
            elif mlps is not None:
                mu, nu = (mlp_tensors(data, group, f"{pre}.{m}['mlps']['{group}']", device)
                          for m in ("mu", "nu"))
            else:
                continue
            opt_state[group] = AdamState(count, mu, nu)
        sched = int(data[".opt_state.inner_states['xyz'].inner_state[2].count"])
        if sched != opt_state["xyz"].count:
            raise ValueError(f"the xyz schedule's count {sched} differs from its Adam count "
                             f"{opt_state['xyz'].count}")
        gstate = G.GaussianState(valid=valid, **{
            f: _tensor(data[f".gstate.{f}"], device) for f in GSTATE_FIELDS if f != "valid"})
        step = int(data[".step"])
    return TrainState({"gauss": params, "mlps": mlps}, opt_state, gstate, step)


# ---- the reference's layout ---------------------------------------------------------------

def save_reference_layout(model_path: str, iteration: int, ts: TrainState) -> None:
    """The live cloud as point_cloud/iteration_N/point_cloud.ply and the MLPs
    as mlp_ckpt/iteration_N/ckpt.npz (keys as moss_tpu writes them)."""
    g, valid = ts.params["gauss"], ts.gstate.valid
    pc_dir = os.path.join(model_path, "point_cloud", f"iteration_{iteration}")
    os.makedirs(pc_dir, exist_ok=True)
    save_ply(os.path.join(pc_dir, "point_cloud.ply"),
             *(getattr(g, f)[valid] for f in ("xyz", "f_dc", "f_rest", "opacity", "scaling",
                                              "rotation")))
    mlps = ts.params.get("mlps")
    if mlps is not None:
        mlp_dir = os.path.join(model_path, "mlp_ckpt", f"iteration_{iteration}")
        os.makedirs(mlp_dir, exist_ok=True)
        flat = {}
        for group in MLP_GROUPS:
            flat.update(mlp_leaves(dict(mlps[group].named_parameters()), group, f"['{group}']"))
        flat["iter"] = np.asarray(iteration)
        np.savez_compressed(os.path.join(mlp_dir, "ckpt.npz"), **flat)


def convert_torch_mlp_state(autoreg_sd, lbs_sd, device=None) -> Dict:
    """The reference's Autoregression / CrossAttention_lbs state dicts (the
    ckpt.pth payload) as the port's {"pose": PoseRefine, "lbs": LBSField}:
    block_mlps.{0,2,4} are the pose trunk, fc_pose.{j}.0 the joint heads
    (placed in the first in_j columns of heads_w), bw_linears.{0-3} and bw_fc
    (1x1 conv1d weights) the LBS trunk. out_layer and gate_proj are unused in
    the reference's forward and ignored."""
    device = resolve_device(device)

    def t(v):
        return torch.as_tensor(np.asarray(v.detach().cpu() if torch.is_tensor(v) else v,
                                          np.float32), device=device)

    pose = {}
    for i, li in enumerate((0, 2, 4)):
        pose[f"trunk{i}.weight"] = t(autoreg_sd[f"block_mlps.{li}.weight"])
        pose[f"trunk{i}.bias"] = t(autoreg_sd[f"block_mlps.{li}.bias"])
    heads_w = torch.zeros((NUM_JOINTS, 3, 3 * MAX_SLOTS), device=device)
    heads_b = torch.zeros((NUM_JOINTS, 3), device=device)
    for j in range(NUM_JOINTS):
        w = t(autoreg_sd[f"fc_pose.{j}.0.weight"])  # (3, in_j)
        heads_w[j, :, :w.shape[1]] = w
        heads_b[j] = t(autoreg_sd[f"fc_pose.{j}.0.bias"])
    pose["heads_w"], pose["heads_b"] = heads_w, heads_b
    lbs = {}
    for name, src in [(f"l{i}", f"bw_linears.{i}") for i in range(4)] + [("fc", "bw_fc")]:
        lbs[f"{name}.weight"] = t(lbs_sd[f"{src}.weight"])[:, :, 0]
        lbs[f"{name}.bias"] = t(lbs_sd[f"{src}.bias"])
    for name in ("query", "key", "value"):
        lbs[f"{name}.weight"] = t(lbs_sd[f"{name}.weight"])
        lbs[f"{name}.bias"] = t(lbs_sd[f"{name}.bias"])
    return make_mlps({"pose": pose, "lbs": lbs}, device)


def load_reference_layout(model_path: str, iteration: int, ts: TrainState) -> TrainState:
    """The TrainState `ts` with the cloud and MLPs of the reference layout at
    `iteration` (the inverse of save_reference_layout; reads the reference's
    own trees too). The PLY's live rows fill the first slots of ts's capacity,
    the dead slots take create_from_points' fill (z = -1e6, opacity -15,
    scaling -10, rotation (1, 0, 0, 0)); the window statistics restart at 0
    and the optimizer state is ts's. Like moss_tpu, the state is stamped
    step `iteration`, though save_fn wrote the state after step
    iteration - 1. Use chkpnt{N}.npz for an exact resume."""
    g = ts.params["gauss"]
    device, P = g.xyz.device, g.capacity
    pc = load_ply(os.path.join(model_path, "point_cloud", f"iteration_{iteration}",
                               "point_cloud.ply"))
    n = pc["xyz"].shape[0]
    if n > P:
        raise ValueError(f"PLY has {n} points > template capacity {P}")
    if pc["f_rest"].shape[1] != g.f_rest.shape[1]:
        raise ValueError(f"PLY SH degree mismatch: {pc['f_rest'].shape[1]} rest coefficients "
                         f"vs template {g.f_rest.shape[1]}")

    def pad(x, fill):
        out = np.full((P,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    xyz, rotation = pad(pc["xyz"], 0.0), pad(pc["rotation"], 0.0)
    xyz[n:, 2] = -1e6
    rotation[n:, 0] = 1.0
    new_g = G.GaussianParams(
        xyz=_tensor(xyz, device), f_dc=_tensor(pad(pc["f_dc"], 0.0), device),
        f_rest=_tensor(pad(pc["f_rest"], 0.0), device),
        scaling=_tensor(pad(pc["scaling"], -10.0), device),
        rotation=_tensor(rotation, device), opacity=_tensor(pad(pc["opacity"], -15.0), device))
    mlps = ts.params.get("mlps")
    if mlps is not None:
        mlp_dir = os.path.join(model_path, "mlp_ckpt", f"iteration_{iteration}")
        mlp_npz, mlp_pth = os.path.join(mlp_dir, "ckpt.npz"), os.path.join(mlp_dir, "ckpt.pth")
        if os.path.exists(mlp_npz):
            with np.load(mlp_npz, allow_pickle=False) as data:
                mlps = make_mlps({group: mlp_tensors(data, group, f"['{group}']", device)
                                  for group in MLP_GROUPS}, device)
        elif os.path.exists(mlp_pth):
            # weights_only: the payload is plain tensor state dicts, and a
            # .pth from elsewhere is untrusted pickle otherwise
            ckpt = torch.load(mlp_pth, map_location="cpu", weights_only=True)
            mlps = convert_torch_mlp_state(ckpt["Autoregression"], ckpt["CrossAttention_lbs"],
                                           device)
        else:
            # random MLPs would render garbage with no hint why
            raise FileNotFoundError(
                f"model has deformation MLPs but neither {mlp_npz} nor ckpt.pth exists: the "
                f"mlp_ckpt tree is required to render a non-static model")
    zeros = torch.zeros((P,), device=device)
    gstate = dataclasses.replace(ts.gstate, valid=torch.arange(P, device=device) < n,
                                 max_radii2d=zeros, xyz_grad_accum=zeros.clone(),
                                 denom=zeros.clone())
    return ts._replace(params={**ts.params, "gauss": new_g, "mlps": mlps}, gstate=gstate,
                       step=int(iteration))
