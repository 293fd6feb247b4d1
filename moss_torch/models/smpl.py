"""SMPL body model (port of moss_tpu/models/smpl.py:54-70, 146-310).

The synthetic rig is drawn with numpy in the JAX package's order, so the same
seed rebuilds the identical model. The 24-joint kinematic chain is an
unrolled loop of 4x4 matmuls (parents are static). The pickle / SMPL-X
loaders are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.transforms import rodrigues

# SMPL kinematic tree (kintree_table row 0 of the standard 24-joint rig)
SMPL_PARENTS: Tuple[int, ...] = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21
)
NUM_JOINTS = 24
NUM_VERTS = 6890


@dataclasses.dataclass(frozen=True)
class SMPLModel:
    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, S)
    posedirs: torch.Tensor     # (V, 3, 9 (J-1))
    J_regressor: torch.Tensor  # (J, V)
    weights: torch.Tensor      # (V, J) skinning weights
    faces: torch.Tensor        # (F, 3) int32
    parents: Tuple[int, ...] = SMPL_PARENTS


def synthetic_smpl(
    n_verts: int = NUM_VERTS, n_shapes: int = 10, seed: int = 3407,
    parents: Tuple[int, ...] = SMPL_PARENTS, device=None,
) -> SMPLModel:
    """Random SMPL-shaped body model, identical to moss_tpu's for the same seed."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    J = len(parents)

    joint_pos = np.zeros((J, 3), np.float32)
    for j in range(1, J):
        p = parents[j]
        joint_pos[j] = joint_pos[p] + rng.normal(0, 0.12, 3) + np.array(
            [0.0, 0.1 if j < 12 else -0.05, 0.0]
        )

    bone = rng.integers(0, J, n_verts)
    t = rng.uniform(0, 1, (n_verts, 1)).astype(np.float32)
    parent_of = np.array([parents[b] if parents[b] >= 0 else b for b in bone])
    v = joint_pos[bone] * t + joint_pos[parent_of] * (1 - t)
    v = v + rng.normal(0, 0.04, (n_verts, 3)).astype(np.float32)

    d = np.linalg.norm(v[:, None, :] - joint_pos[None], axis=-1)
    w = np.exp(-d / 0.07)
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)

    J_reg = np.exp(-(d.T) / 0.03)
    J_reg = (J_reg / J_reg.sum(-1, keepdims=True)).astype(np.float32)

    shapedirs = (rng.normal(0, 0.01, (n_verts, 3, n_shapes))).astype(np.float32)
    posedirs = (rng.normal(0, 0.001, (n_verts, 3, 9 * (J - 1)))).astype(np.float32)

    faces = rng.integers(0, n_verts, (2 * n_verts, 3)).astype(np.int32)

    def t_(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return SMPLModel(
        v_template=t_(v.astype(np.float32)), shapedirs=t_(shapedirs),
        posedirs=t_(posedirs), J_regressor=t_(J_reg), weights=t_(w),
        faces=t_(faces), parents=tuple(parents),
    )


def big_pose_params(n_shapes: int = 10, device=None):
    """The canonical legs/arms-spread rest pose (dataset_readers.py:586-590)."""
    device = resolve_device(device)
    poses = np.zeros((1, 72), np.float32)
    poses[0, 5] = np.deg2rad(45.0)
    poses[0, 8] = np.deg2rad(-45.0)
    poses[0, 23] = np.deg2rad(-30.0)
    poses[0, 26] = np.deg2rad(30.0)
    return {
        "poses": torch.as_tensor(poses, device=device),
        "shapes": torch.zeros((1, n_shapes), device=device),
        "R": torch.eye(3, device=device),
        "Th": torch.zeros((1, 3), device=device),
    }


def rigid_transform_chain(rot_mats, joints, parents: Tuple[int, ...]):
    """Per-joint world transforms A (B, J, 4, 4), rest-joint offset subtracted.

    rot_mats: (B, J, 3, 3); joints: (B, J, 3) rest joints.
    """
    B, J = joints.shape[0], joints.shape[1]
    rel = [joints[:, 0]]
    for j in range(1, J):
        rel.append(joints[:, j] - joints[:, parents[j]])
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=rot_mats.dtype,
                          device=rot_mats.device).expand(B, 1, 4)

    def make_T(R, t):
        return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)

    chain = [make_T(rot_mats[:, 0], rel[0])]
    for j in range(1, J):
        chain.append(chain[parents[j]] @ make_T(rot_mats[:, j], rel[j]))
    A = torch.stack(chain, dim=1)  # (B, J, 4, 4)

    rot_joint = torch.einsum("bjxy,bjy->bjx", A[..., :3, :3], joints)
    trans = A[..., :3, 3] - rot_joint
    return torch.cat(
        [torch.cat([A[..., :3, :3], trans[..., None]], dim=-1), A[..., 3:, :]],
        dim=-2,
    )


def shaped_vertices(model: SMPLModel, shapes):
    """v_template + shape blendshapes (shapes: (B, S))."""
    S = shapes.shape[-1]
    offs = torch.einsum("vds,bs->bvd", model.shapedirs[..., :S], shapes)
    return model.v_template[None] + offs


def transform_params(model: SMPLModel, params, rot_mats=None, correct_Rs=None):
    """(A, R, Th, joints, rot_mats) for LBS.

    params: dict with 'poses' (B,72), 'shapes' (B,S), 'R' (3,3), 'Th'.
    correct_Rs: optional (B, J-1, 3, 3) corrections right-multiplied into the
    non-root joint rotations.
    """
    v_shaped = shaped_vertices(model, params["shapes"])
    if rot_mats is None:
        B = params["poses"].shape[0]
        rot_mats = rodrigues(params["poses"].reshape(B, -1, 3))
        if correct_Rs is not None:
            non_root = rot_mats[:, 1:] @ correct_Rs
            rot_mats = torch.cat([rot_mats[:, :1], non_root], dim=1)
    joints = torch.einsum("jv,bvd->bjd", model.J_regressor, v_shaped)
    A = rigid_transform_chain(rot_mats, joints, model.parents)
    return A, params["R"], params["Th"], joints, rot_mats


def lbs_vertices(model: SMPLModel, poses, shapes):
    """Pose the template mesh; returns (verts (V,3), joints (J,3)) in SMPL space."""
    poses = poses.reshape(1, -1)
    shapes = shapes.reshape(1, -1)
    v_shaped = shaped_vertices(model, shapes)  # (1, V, 3)
    rot_mats = rodrigues(poses.reshape(1, -1, 3))  # (1, J, 3, 3)
    ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(1, -1)
    V = model.v_template.shape[0]
    pose_offs = (pose_feature @ model.posedirs.reshape(V * 3, -1).T).reshape(1, V, 3)
    v_posed = v_shaped + pose_offs
    joints = torch.einsum("jv,bvd->bjd", model.J_regressor, v_shaped)
    A = rigid_transform_chain(rot_mats, joints, model.parents)
    T = torch.einsum("vj,bjxy->bvxy", model.weights, A)  # (1, V, 4, 4)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    v_out = torch.einsum("bvxy,bvy->bvx", T, v_h)[..., :3]
    posed_joints = torch.einsum("bjxy,bjy->bjx", A[..., :3, :3], joints) + A[..., :3, 3]
    return v_out[0], posed_joints[0]
