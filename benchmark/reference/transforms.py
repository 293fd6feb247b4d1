"""Rotation / covariance primitives for Gaussian splats.

A frozen copy of moss_torch/ops/transforms.py for the benchmark's reference (its
plain path only, imports pointed into benchmark.reference).

Port of moss_tpu/ops/transforms.py. The covariance build and fold stay in
component form on (P,) tensors, as in JAX: every product is an elementwise
op over all Gaussians instead of a batched 3x3 matmul.
"""
from __future__ import annotations

import torch


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def quat_normalize(q, eps: float = 1e-12):
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + eps)


def quat_to_rotmat(q, normalize: bool = True):
    """Quaternion (w,x,y,z) -> rotation matrix, (..., 4) -> (..., 3, 3)."""
    if normalize:
        q = quat_normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(*q.shape[:-1], 3, 3)


def quat_multiply(a, b):
    """Hamilton product of (w, x, y, z) quaternions, broadcasting over batch dims."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def rotmat_to_quat(R, eps: float = 1e-8):
    """Rotation matrix -> quaternion (w,x,y,z), (..., 3, 3) -> (..., 4).

    Branch-free Shepperd selection of the largest of the four candidate
    magnitudes (first one on ties), then normalized with w >= 0.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    mags = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(mags, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + eps)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rodrigues(rot_vecs, eps: float = 1e-8):
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), angle = |v + 1e-8|."""
    angle = torch.linalg.norm(rot_vecs + eps, dim=-1, keepdim=True)
    axis = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(*rot_vecs.shape[:-1], 3, 3)
    eye = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return eye + sin * K + (1.0 - cos) * (K @ K)


def rodrigues_guarded(rvec, eps: float = 1e-5):
    """Axis-angle -> rotation with the pose MLP's smooth guard
    theta = sqrt(eps + |v|^2), C-infinity at v = 0."""
    theta = torch.sqrt(eps + torch.sum(rvec**2, dim=-1))
    v = rvec / theta[..., None]
    c = torch.cos(theta)
    s = torch.sin(theta)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    R = torch.stack(
        [
            x * x + (1 - x * x) * c, x * y * (1 - c) - z * s, x * z * (1 - c) + y * s,
            x * y * (1 - c) + z * s, y * y + (1 - y * y) * c, y * z * (1 - c) - x * s,
            x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, z * z + (1 - z * z) * c,
        ],
        dim=-1,
    )
    return R.reshape(*rvec.shape[:-1], 3, 3)


def build_covariance(scaling, rotation_q, transform=None, scaling_modifier: float = 1.0):
    """Covariance Sigma = (T R S)(T R S)^T packed as (P, 6) [xx, xy, xz, yy, yz, zz].

    scaling: (P, 3) activated scales; rotation_q: (P, 4) unnormalized
    quaternions; transform: optional (P, 3, 3) deformation folded in as
    Sigma' = T Sigma T^T.
    """
    q = quat_normalize(rotation_q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0 = scaling_modifier * scaling[..., 0]
    s1 = scaling_modifier * scaling[..., 1]
    s2 = scaling_modifier * scaling[..., 2]
    # L = R @ diag(s); cov = L L^T (6 unique comps)
    l00, l01, l02 = r00 * s0, r01 * s1, r02 * s2
    l10, l11, l12 = r10 * s0, r11 * s1, r12 * s2
    l20, l21, l22 = r20 * s0, r21 * s1, r22 * s2
    c00 = l00 * l00 + l01 * l01 + l02 * l02
    c01 = l00 * l10 + l01 * l11 + l02 * l12
    c02 = l00 * l20 + l01 * l21 + l02 * l22
    c11 = l10 * l10 + l11 * l11 + l12 * l12
    c12 = l10 * l20 + l11 * l21 + l12 * l22
    c22 = l20 * l20 + l21 * l21 + l22 * l22
    cov6 = torch.stack([c00, c01, c02, c11, c12, c22], dim=-1)
    if transform is not None:
        return fold_cov6(cov6, transform)
    return cov6


def fold_cov6(cov6, transform):
    """Sigma' = T Sigma T^T on the packed-6 representation, component form."""
    c00, c01, c02, c11, c12, c22 = (cov6[..., i] for i in range(6))
    t00, t01, t02 = transform[..., 0, 0], transform[..., 0, 1], transform[..., 0, 2]
    t10, t11, t12 = transform[..., 1, 0], transform[..., 1, 1], transform[..., 1, 2]
    t20, t21, t22 = transform[..., 2, 0], transform[..., 2, 1], transform[..., 2, 2]
    # U = T @ C (C symmetric)
    u00 = t00 * c00 + t01 * c01 + t02 * c02
    u01 = t00 * c01 + t01 * c11 + t02 * c12
    u02 = t00 * c02 + t01 * c12 + t02 * c22
    u10 = t10 * c00 + t11 * c01 + t12 * c02
    u11 = t10 * c01 + t11 * c11 + t12 * c12
    u12 = t10 * c02 + t11 * c12 + t12 * c22
    u20 = t20 * c00 + t21 * c01 + t22 * c02
    u21 = t20 * c01 + t21 * c11 + t22 * c12
    u22 = t20 * c02 + t21 * c12 + t22 * c22
    # Sigma' = U @ T^T (upper triangle)
    o00 = u00 * t00 + u01 * t01 + u02 * t02
    o01 = u00 * t10 + u01 * t11 + u02 * t12
    o02 = u00 * t20 + u01 * t21 + u02 * t22
    o11 = u10 * t10 + u11 * t11 + u12 * t12
    o12 = u10 * t20 + u11 * t21 + u12 * t22
    o22 = u20 * t20 + u21 * t21 + u22 * t22
    return torch.stack([o00, o01, o02, o11, o12, o22], dim=-1)


def pack_cov3d(cov):
    """(..., 3, 3) symmetric -> (..., 6) [xx, xy, xz, yy, yz, zz]."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1)


def unpack_cov3d(packed):
    """(..., 6) -> (..., 3, 3) symmetric."""
    xx, xy, xz, yy, yz, zz = (packed[..., i] for i in range(6))
    return torch.stack([torch.stack([xx, xy, xz], dim=-1), torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)
