"""Canonical -> posed-world deformation of the Gaussian cloud.

A frozen copy of moss_torch/models/deform.py for the benchmark's reference (its
plain path only, imports pointed into benchmark.reference).

Port of moss_tpu/models/deform.py:34-227 (coarse_deform_c2source,
reference gaussian_model.py:820-923): k=1 nearest big-pose vertex -> skinning
weights (optionally corrected in log space), inverse big-pose chain,
blendshape offsets, target-pose chain, global R/Th. The per-Gaussian 3x3
algebra runs in component form on (N,) tensors, as in JAX; the running
`transforms` collects every linear factor for the covariance fold.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .knn import knn
from .transforms import rodrigues
from .smpl import SMPLModel, transform_params


def _safe_inv_det(det, eps):
    # sign-preserving clamp: det in (-eps, 0] clamps to -eps, not +eps (a +eps
    # fallback would silently mirror the inverse of a negative-det blend)
    safe = torch.where(det < 0, -eps, eps)
    return 1.0 / torch.where(torch.abs(det) > eps, det, safe)


def inv3x3(M, eps: float = 1e-12):
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    inv_det = _safe_inv_det(a * A + b * B + c * C, eps)
    adj = torch.stack(
        [
            A, -(b * i - c * h), (b * f - c * e),
            B, (a * i - c * g), -(a * f - c * d),
            C, -(a * h - b * g), (a * e - b * d),
        ],
        dim=-1,
    ).reshape(*M.shape[:-2], 3, 3)
    return adj * inv_det[..., None, None]


def _inv3x3c(a, b, c, d, e, f, g, h, i, eps: float = 1e-12):
    """Component-form 3x3 inverse: 9 (N,) tensors in, 9 out."""
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    inv_det = _safe_inv_det(a * A + b * B + c * C, eps)
    return (
        A * inv_det, -(b * i - c * h) * inv_det, (b * f - c * e) * inv_det,
        B * inv_det, (a * i - c * g) * inv_det, -(a * f - c * d) * inv_det,
        C * inv_det, -(a * h - b * g) * inv_det, (a * e - b * d) * inv_det,
    )


def _matvec3c(m, v):
    """m: 9 comps row-major, v: 3 comps -> 3 comps."""
    return (
        m[0] * v[0] + m[1] * v[1] + m[2] * v[2],
        m[3] * v[0] + m[4] * v[1] + m[5] * v[2],
        m[6] * v[0] + m[7] * v[1] + m[8] * v[2],
    )


def _matmat3c(a, b):
    """(a @ b) on 9-comp row-major representations."""
    return (
        a[0] * b[0] + a[1] * b[3] + a[2] * b[6],
        a[0] * b[1] + a[1] * b[4] + a[2] * b[7],
        a[0] * b[2] + a[1] * b[5] + a[2] * b[8],
        a[3] * b[0] + a[4] * b[3] + a[5] * b[6],
        a[3] * b[1] + a[4] * b[4] + a[5] * b[7],
        a[3] * b[2] + a[4] * b[5] + a[5] * b[8],
        a[6] * b[0] + a[7] * b[3] + a[8] * b[6],
        a[6] * b[1] + a[7] * b[4] + a[8] * b[7],
        a[6] * b[2] + a[7] * b[5] + a[8] * b[8],
    )


class DeformOut(NamedTuple):
    smpl_pts: torch.Tensor     # (N, 3) posed points in SMPL space
    world_pts: torch.Tensor    # (N, 3) posed points in world space
    bweights: torch.Tensor     # (N, J) final blend weights
    transforms: torch.Tensor   # (N, 3, 3) linear deformation (for covariance)
    translation: torch.Tensor  # (N, 3) affine part (for the cached eval path)


def coarse_deform_c2source(
    model: SMPLModel,
    query_pts,               # (N, 3) canonical (big-pose world) Gaussian centres
    params,                  # target-frame SMPL params dict
    t_params,                # big-pose params dict
    t_vertices,              # (V, 3) big-pose world vertices
    lbs_weight_delta=None,   # (N, J) learned log-space delta, or None
    correct_Rs=None,         # (J-1, 3, 3) learned pose corrections, or None
    vert_ids=None,           # optional precomputed (N,) nearest-vertex ids
) -> DeformOut:
    J = model.weights.shape[-1]
    V = t_vertices.shape[0]

    # 1. nearest SMPL vertex -> skinning weights
    if vert_ids is None:
        vert_ids = knn(query_pts, t_vertices, k=1)[1][:, 0]
    vert_ids = vert_ids.long()
    bweights = model.weights[vert_ids]  # (N, J)
    if lbs_weight_delta is not None:
        bweights = torch.softmax(torch.log(bweights + 1e-9) + lbs_weight_delta, dim=-1)

    # 2. big pose -> T pose
    A_big, _R, _Th, _joints, big_rot_mats = transform_params(model, t_params)
    Af = bweights @ A_big[0].reshape(J, 16)[:, :12]  # (N, 12): rows 0..2 of A
    a = tuple(Af[:, i] for i in (0, 1, 2, 4, 5, 6, 8, 9, 10))
    at = (Af[:, 3], Af[:, 7], Af[:, 11])
    q = (query_pts[:, 0] - at[0], query_pts[:, 1] - at[1], query_pts[:, 2] - at[2])
    r_inv = _inv3x3c(*a)
    pts = _matvec3c(r_inv, q)
    transforms = r_inv
    translation = _matvec3c(r_inv, (-at[0], -at[1], -at[2]))

    # 3a. remove big-pose pose-blendshape offsets
    ident = torch.eye(3, dtype=query_pts.dtype, device=query_pts.device)
    pose_feat_big = (big_rot_mats[0, 1:] - ident).reshape(-1)
    posedirs = model.posedirs.reshape(V * 3, -1)
    pose_offs_big = (posedirs @ pose_feat_big).reshape(V, 3)

    # 3b. shape offsets
    S = params["shapes"].shape[-1]
    shape_offs = torch.einsum("vds,s->vd", model.shapedirs[..., :S], params["shapes"][0])

    # 3c. target-pose blendshape offsets with correction Rs
    rot_mats = rodrigues(params["poses"].reshape(1, -1, 3))
    if correct_Rs is not None:
        rot_mats = torch.cat([rot_mats[:, :1], rot_mats[:, 1:] @ correct_Rs[None]], dim=1)
    pose_feat = (rot_mats[0, 1:] - ident).reshape(-1)
    pose_offs = (posedirs @ pose_feat).reshape(V, 3)

    # one combined (V, 3) offset table, one gather
    offs = (shape_offs + pose_offs - pose_offs_big)[vert_ids]
    pts = (pts[0] + offs[:, 0], pts[1] + offs[:, 1], pts[2] + offs[:, 2])
    translation = (
        translation[0] + offs[:, 0],
        translation[1] + offs[:, 1],
        translation[2] + offs[:, 2],
    )

    # 4. T pose -> target pose
    A_tgt, R_glob, Th, _joints, _ = transform_params(model, params, rot_mats=rot_mats)
    Bf = bweights @ A_tgt[0].reshape(J, 16)[:, :12]
    b = tuple(Bf[:, i] for i in (0, 1, 2, 4, 5, 6, 8, 9, 10))
    bt = (Bf[:, 3], Bf[:, 7], Bf[:, 11])
    sp = _matvec3c(b, pts)
    smpl = (sp[0] + bt[0], sp[1] + bt[1], sp[2] + bt[2])
    transforms = _matmat3c(b, transforms)
    tr = _matvec3c(b, translation)
    translation = (tr[0] + bt[0], tr[1] + bt[1], tr[2] + bt[2])

    # 5. SMPL space -> world
    R_glob = R_glob.reshape(3, 3)
    Th = Th.reshape(3)
    gi = inv3x3(R_glob)  # constant 3x3
    world = tuple(
        smpl[0] * gi[0, j] + smpl[1] * gi[1, j] + smpl[2] * gi[2, j] + Th[j]
        for j in range(3)
    )
    g9 = tuple(R_glob[i, j] for i in range(3) for j in range(3))
    transforms = _matmat3c(g9, transforms)
    translation = tuple(
        translation[0] * gi[0, j] + translation[1] * gi[1, j]
        + translation[2] * gi[2, j] + Th[j]
        for j in range(3)
    )

    return DeformOut(
        smpl_pts=torch.stack(smpl, dim=-1),
        world_pts=torch.stack(world, dim=-1),
        bweights=bweights,
        transforms=torch.stack(transforms, dim=-1).reshape(-1, 3, 3),
        translation=torch.stack(translation, dim=-1),
    )


def apply_cached_transform(query_pts, transforms, translation):
    """Cached eval path: x' = T x + t."""
    x, y, z = query_pts[..., 0], query_pts[..., 1], query_pts[..., 2]
    return torch.stack(
        [
            transforms[..., i, 0] * x + transforms[..., i, 1] * y
            + transforms[..., i, 2] * z + translation[..., i]
            for i in range(3)
        ],
        dim=-1,
    )
