"""Carry the JAX package's weights across into the port.

The inputs are numpy arrays (anything np.asarray reads) laid out as the JAX
package keeps them: the GaussianParams fields, the {"pose": ..., "lbs": ...}
MLP dicts ({"w": (in, out), "b": (out,)} per linear layer, the fused pose
heads as heads_w / heads_b), and the SMPLModel arrays. Mappings and objects
with attributes are both accepted. `load_jax_checkpoint` reads a
chkpnt{N}.npz written by moss_tpu's Trainer.save (one array per leaf, keyed
by jax.tree_util.keystr, moss_tpu/train/checkpoint.py:19-30).
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from . import resolve_device
from .models.gaussians import FIELDS, GaussianParams
from .models.lbs_field import LBSField
from .models.pose_refine import PoseRefine
from .models.smpl import SMPLModel
from .render.render import SceneContext

_POSE_LINEARS = ("trunk0", "trunk1", "trunk2")
_LBS_LINEARS = ("l0", "l1", "l2", "l3", "fc", "query", "key", "value")


def _get(tree, name):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _tensor(x, device, dtype=np.float32):
    return torch.as_tensor(np.array(x, dtype=dtype), device=device)


def gaussians_from_jax(tree, device=None) -> GaussianParams:
    device = resolve_device(device)
    return GaussianParams(**{f: _tensor(_get(tree, f), device) for f in FIELDS})


def mlps_from_jax(tree, device=None):
    """{"pose": PoseRefine, "lbs": LBSField} holding the JAX weights."""
    device = resolve_device(device)
    pose, lbs = PoseRefine(device=device), LBSField(device=device)
    with torch.no_grad():
        for module, sub, names in ((pose, _get(tree, "pose"), _POSE_LINEARS),
                                   (lbs, _get(tree, "lbs"), _LBS_LINEARS)):
            for name in names:
                lin = getattr(module, name)
                lin.weight.copy_(_tensor(_get(_get(sub, name), "w"), device).T)
                lin.bias.copy_(_tensor(_get(_get(sub, name), "b"), device))
        pose_tree = _get(tree, "pose")
        pose.heads_w.copy_(_tensor(_get(pose_tree, "heads_w"), device))
        pose.heads_b.copy_(_tensor(_get(pose_tree, "heads_b"), device))
    return {"pose": pose, "lbs": lbs}


def scene_from_jax(smpl, big_pose_params, big_pose_vertices, device=None) -> SceneContext:
    """SceneContext from the JAX SMPLModel arrays, big-pose dict and vertices."""
    device = resolve_device(device)
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
    device = resolve_device(device)
    prefix = ".params['mlps']"
    with np.load(path, allow_pickle=False) as data:
        params = gaussians_from_jax(
            {f: data[f".params['gauss'].{f}"] for f in FIELDS}, device)
        valid = torch.as_tensor(data[".gstate.valid"], device=device)
        if not any(k.startswith(prefix) for k in data.files):
            return params, valid, None

        def leaf(*path):
            return data[prefix + "".join(f"['{p}']" for p in path)]

        tree = {
            "pose": {**{n: {"w": leaf("pose", n, "w"), "b": leaf("pose", n, "b")}
                        for n in _POSE_LINEARS},
                     "heads_w": leaf("pose", "heads_w"), "heads_b": leaf("pose", "heads_b")},
            "lbs": {n: {"w": leaf("lbs", n, "w"), "b": leaf("lbs", n, "b")}
                    for n in _LBS_LINEARS},
        }
    return params, valid, mlps_from_jax(tree, device)
