"""SMPL and SMPL-X body models (port of moss_tpu/models/smpl.py).

The synthetic rigs are drawn with numpy in the JAX package's order, so the
same seed rebuilds the identical model: SMPL (J=24) and SMPL-X (J=55,
SMPLX_PARENTS, 20 shape values: 10 betas then 10 expression values, the
DNA-Rendering convention). The kinematic chain is an unrolled loop of 4x4
matmuls over the model's parents (static), so the same code poses either
rig. load_smpl_pickle reads the real SMPL asset (moss_tpu/models/smpl.py:72),
load_smplx_npz the SMPL-X one (:97).
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

# SMPL-X kinematic tree: 55 joints, 22 body + jaw/leye/reye + 2x15 hand
# (moss_tpu/models/smpl.py:45-51, the asset's kintree_table)
SMPLX_PARENTS: Tuple[int, ...] = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    15, 15, 15,                                                  # jaw, left_eye, right_eye
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,  # left hand
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,  # right hand
)
NUM_JOINTS_SMPLX = 55


@dataclasses.dataclass(frozen=True)
class SMPLModel:
    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, S)
    posedirs: torch.Tensor     # (V, 3, 9 (J-1))
    J_regressor: torch.Tensor  # (J, V)
    weights: torch.Tensor      # (V, J) skinning weights
    faces: torch.Tensor        # (F, 3) int32
    parents: Tuple[int, ...] = SMPL_PARENTS

    @property
    def num_joints(self) -> int:
        return len(self.parents)


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


def synthetic_smplx(n_verts: int = 2000, n_shapes: int = 20, seed: int = 3407,
                    device=None) -> SMPLModel:
    """Random SMPL-X-shaped model (J=55, 20 shape values, posedirs over the
    54 non-root joints), identical to moss_tpu's for the same seed."""
    return synthetic_smpl(n_verts, n_shapes, seed, parents=SMPLX_PARENTS, device=device)


def load_smpl_pickle(path: str, device=None) -> SMPLModel:
    """A real SMPL pickle (the reference's SMPL_to_tensor keys), read with the
    latin-1 unpickler its Python 2 arrays need. A scipy-sparse J_regressor
    becomes dense; a kintree_table root of 2^32 - 1 becomes -1."""
    import pickle

    device = resolve_device(device)
    with open(path, "rb") as f:
        u = pickle._Unpickler(f)
        u.encoding = "latin1"
        params = u.load()
    J_reg = params["J_regressor"]
    if hasattr(J_reg, "toarray"):
        J_reg = J_reg.toarray()
    parents_row = np.asarray(params["kintree_table"])[0].astype(np.int64)
    parents = (-1,) + tuple(int(p) if p < 2**31 else -1 for p in parents_row[1:])

    def t_(x, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x), dtype=dtype), device=device)

    return SMPLModel(
        v_template=t_(params["v_template"]), shapedirs=t_(params["shapedirs"]),
        posedirs=t_(params["posedirs"]), J_regressor=t_(J_reg), weights=t_(params["weights"]),
        faces=t_(np.asarray(params["f"]).astype(np.int64), np.int32), parents=parents)


def load_smplx_npz(path: str, num_betas: int = 10, num_expr: int = 10,
                   device=None) -> SMPLModel:
    """A real SMPL-X .npz. Its (V, 3, 400) shapedirs hold the betas in
    columns [:num_betas] and the expressions in [300:300 + num_expr]; the
    model keeps those, betas first, the DNA-Rendering reader's 'shapes'
    layout (an asset with fewer columns gives its first num_betas +
    num_expr). The parents come from kintree_table, the root as -1."""
    device = resolve_device(device)
    params = dict(np.load(path, allow_pickle=True))
    sd = np.asarray(params["shapedirs"], np.float32)
    if sd.shape[-1] >= 300 + num_expr:
        shapedirs = np.concatenate([sd[..., :num_betas], sd[..., 300:300 + num_expr]], axis=-1)
    else:
        shapedirs = sd[..., :num_betas + num_expr]
    parents_row = np.asarray(params["kintree_table"])[0].astype(np.int64)
    parents = (-1,) + tuple(int(p) for p in parents_row[1:])

    def t_(x, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x), dtype=dtype), device=device)

    return SMPLModel(
        v_template=t_(params["v_template"]), shapedirs=t_(shapedirs),
        posedirs=t_(params["posedirs"]), J_regressor=t_(params["J_regressor"]),
        weights=t_(params["weights"]),
        faces=t_(np.asarray(params["f"]).astype(np.int64), np.int32), parents=parents)


def big_pose_params_smplx(n_shapes: int = 20, device=None):
    """The big pose for SMPL-X (the reference's dataset_readers.py:769-785):
    SMPL's four body angles in the 165-dim full pose [global 3 | body 63 |
    jaw 3 | leye 3 | reye 3 | lhand 45 | rhand 45]."""
    device = resolve_device(device)
    poses = np.zeros((1, 165), np.float32)
    poses[0, 3 + 2] = np.deg2rad(45.0)
    poses[0, 3 + 5] = np.deg2rad(-45.0)
    poses[0, 3 + 20] = np.deg2rad(-30.0)
    poses[0, 3 + 23] = np.deg2rad(30.0)
    return {
        "poses": torch.as_tensor(poses, device=device),
        "shapes": torch.zeros((1, n_shapes), device=device),
        "R": torch.eye(3, device=device),
        "Th": torch.zeros((1, 3), device=device),
    }


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
    # made on the device: a copy from the host would be a sync in the step
    bottom = torch.cat([rot_mats.new_zeros((1, 3)), rot_mats.new_ones((1, 1))], 1).expand(B, 1, 4)

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

    params: dict with 'poses' (B, 3 J), 'shapes' (B, S), 'R' (3, 3), 'Th'.
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
