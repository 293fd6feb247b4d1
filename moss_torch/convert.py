"""Carry the JAX package's weights and training state across into the port.

The inputs are numpy arrays (anything np.asarray reads) laid out as the JAX
package keeps them: the GaussianParams fields, the {"pose": ..., "lbs": ...}
MLP dicts ({"w": (in, out), "b": (out,)} per linear layer, the fused pose
heads as heads_w / heads_b), and the SMPLModel arrays. Mappings and objects
with attributes are both accepted. `load_jax_checkpoint` reads a
chkpnt{N}.npz written by moss_tpu's Trainer.save (one array per leaf, keyed
by jax.tree_util.keystr, moss_tpu/train/checkpoint.py:19-30) through
train/checkpoint.py, which reads and writes the whole TrainState.
`train_state_from_jax` carries a whole TrainState (params, the optax
multi_transform Adam states group by group, GaussianState, step),
`lpips_params_from_jax` the LPIPS tower, `frame_from_jax` a Frame and
`config_from_jax` a Config: with the TrainState, a port Trainer started by
set_state continues where a moss_tpu Trainer stands.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from . import config as C
from . import resolve_device
from .data.frames import Frame
from .models.gaussians import FIELDS, GaussianParams, GaussianState
from .models.lbs_field import LBSField
from .models.pose_refine import PoseRefine
from .models.smpl import SMPLModel
from .ops import lpips
from .render.camera import Camera
from .render.render import SceneContext
from .train import checkpoint
from .train.optim import GAUSS_GROUPS, AdamState
from .train.train_step import TrainState



def _get(tree, name):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _tensor(x, device, dtype=np.float32):
    return torch.as_tensor(np.array(x, dtype=dtype), device=device)


def gaussians_from_jax(tree, device=None) -> GaussianParams:
    device = resolve_device(device)
    return GaussianParams(**{f: _tensor(_get(tree, f), device) for f in FIELDS})


def _mlp_state(sub, group: str, device):
    """One MLP's JAX tree (weights or Adam moments) keyed by the torch
    module's parameter names; linear weights transposed to (out, in)."""
    out = {}
    for name in (checkpoint.POSE_LINEARS if group == "pose" else checkpoint.LBS_LINEARS):
        out[f"{name}.weight"] = _tensor(_get(_get(sub, name), "w"), device).T.contiguous()
        out[f"{name}.bias"] = _tensor(_get(_get(sub, name), "b"), device)
    if group == "pose":
        out["heads_w"] = _tensor(_get(sub, "heads_w"), device)
        out["heads_b"] = _tensor(_get(sub, "heads_b"), device)
    return out


def mlps_from_jax(tree, device=None):
    """{"pose": PoseRefine, "lbs": LBSField} holding the JAX weights."""
    device = resolve_device(device)
    mlps = {"pose": PoseRefine(device=device), "lbs": LBSField(device=device)}
    for group, module in mlps.items():
        module.load_state_dict(_mlp_state(_get(tree, group), group, device))
    return mlps


def scene_from_jax(smpl, big_pose_params, big_pose_vertices, device=None) -> SceneContext:
    """SceneContext from the JAX SMPLModel arrays, big-pose dict and vertices.
    A static scene (moss_tpu/data/colmap.py:260) has no body: smpl and
    big_pose_params None, its seed points as big_pose_vertices."""
    device = resolve_device(device)
    if smpl is None:
        return SceneContext(smpl=None, big_pose_params=None,
                            big_pose_vertices=_tensor(big_pose_vertices, device))
    model = SMPLModel(
        **{f: _tensor(_get(smpl, f), device)
           for f in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights")},
        faces=_tensor(_get(smpl, "faces"), device, np.int32),
        parents=tuple(int(p) for p in _get(smpl, "parents")),
    )
    big = {k: _tensor(_get(big_pose_params, k), device) for k in ("poses", "shapes", "R", "Th")}
    return SceneContext(smpl=model, big_pose_params=big,
                        big_pose_vertices=_tensor(big_pose_vertices, device))


def load_jax_checkpoint(path: str, device=None):
    """(params, valid, mlps or None) from a moss_tpu chkpnt{N}.npz."""
    return checkpoint.load_params(path, device)


def gstate_from_jax(gs, device=None) -> GaussianState:
    device = resolve_device(device)
    return GaussianState(
        valid=torch.as_tensor(np.array(_get(gs, "valid"), bool), device=device),
        **{f: _tensor(_get(gs, f), device)
           for f in ("max_radii2d", "xyz_grad_accum", "denom", "joint_F", "lbs_weight_sum")})


def adam_states_from_jax(opt_state, device=None):
    """{group: AdamState} from moss_tpu's optax multi_transform state: each
    group's MaskedState holds (ScaleByAdamState(count, mu, nu), ...) over the
    whole params tree, its own leaves unmasked. The MLP groups of a static
    scene (no MLPs) have no leaves, and the port no state for them."""
    device = resolve_device(device)
    out = {}
    for group, masked in opt_state.inner_states.items():
        adam = masked.inner_state[0]
        if group not in GAUSS_GROUPS and adam.mu.get("mlps") is None:
            continue

        def leaves(tree, group=group):
            if group in GAUSS_GROUPS:
                return {group: _tensor(getattr(tree["gauss"], group), device)}
            return _mlp_state(tree["mlps"][group], group, device)

        out[group] = AdamState(int(adam.count), leaves(adam.mu), leaves(adam.nu))
    return out


def train_state_from_jax(ts, device=None) -> TrainState:
    """A moss_tpu TrainState (params, optax state, GaussianState, step) as the port's."""
    device = resolve_device(device)
    mlps = ts.params.get("mlps")
    return TrainState(
        params={"gauss": gaussians_from_jax(ts.params["gauss"], device),
                "mlps": None if mlps is None else mlps_from_jax(mlps, device)},
        opt_state=adam_states_from_jax(ts.opt_state, device),
        gstate=gstate_from_jax(ts.gstate, device),
        step=int(ts.step),
    )


def lpips_params_from_jax(params, device=None):
    """moss_tpu's LPIPS params (numpy, HWIO; lpips_jax.init_random/load_params)."""
    return lpips.params_from_numpy(params, device)


def frame_from_jax(frame, device=None) -> Frame:
    device = resolve_device(device)
    cam = frame.camera
    camera = Camera(**{f: _tensor(getattr(cam, f), device)
                       for f in ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy")},
                    height=int(cam.height), width=int(cam.width))
    return Frame(
        camera=camera,
        **{f: _tensor(getattr(frame, f), device)
           for f in ("image", "bkgd_mask", "bound_mask", "poses", "shapes", "R", "Th",
                     "pose_rotmats")},
        crop_y0=int(frame.crop_y0), crop_x0=int(frame.crop_x0), pose_id=int(frame.pose_id))


def config_from_jax(cfg) -> C.Config:
    """A moss_tpu Config as the port's: the fields the port has, same values,
    but the rasterizer, which stays the port's default: moss_tpu's CPU tests
    pick "reference" to run without Pallas, where the port's default already
    blends with the plain version (a load_json of the cfg.json keeps it)."""

    def fields(cls, src):
        return cls(**{f.name: getattr(src, f.name) for f in dataclasses.fields(cls)})

    return C.Config(model=fields(C.ModelConfig, cfg.model), optim=fields(C.OptimConfig, cfg.optim),
                    pipe=C.PipelineConfig(
                        max_tiles_per_gaussian=int(cfg.pipe.max_tiles_per_gaussian),
                        test_iterations=tuple(cfg.pipe.test_iterations),
                        save_iterations=tuple(cfg.pipe.save_iterations)),
                    seed=int(cfg.seed))
