"""Gaussian preprocess: 3D -> 2D projection, EWA covariance, conic, radius, culling.

A frozen copy of moss_torch/ops/projection.py for the benchmark's reference (its
plain path only, imports pointed into benchmark.reference).

Port of moss_tpu/ops/projection.py:29-204 (reference forward.cu:154-256):
near cull at view z <= 0.2, the +1e-7 w-guard, EWA cov2d with the 1.3 tan-fov
clamp and the +0.3 low-pass, conic = inverse cov2d, radius =
ceil(3 sqrt(max eigenvalue)), and the opacity-adaptive per-axis extents
`radius_xy` the binning intersects with the reference rect. Component form
on (P,) tensors throughout.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEAR_Z = 0.2   # reference auxiliary.h:151 near plane
LOWPASS = 0.3  # reference forward.cu:110-111 dilation of the 2D covariance


class Projected(NamedTuple):
    """Per-Gaussian screen-space quantities (all (P, ...) tensors)."""

    mean2d: torch.Tensor     # (P, 2) pixel coords
    depth: torch.Tensor      # (P,) view-space z
    conic: torch.Tensor      # (P, 3) inverse 2D covariance [a, b, c]
    radius: torch.Tensor     # (P,) int32 screen radius (0 for culled)
    color: torch.Tensor      # (P, C) per-view RGB (SH already evaluated)
    opacity: torch.Tensor    # (P,) activated opacity
    valid: torch.Tensor      # (P,) bool: survives culling
    radius_xy: Optional[torch.Tensor] = None  # (P, 2) int32 per-axis extents


def ndc2pix(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


def project_points(means3d, world_view, full_proj):
    """World points -> (view_z, ndc xyz), row-vector convention."""
    mx, my, mz = means3d[..., 0], means3d[..., 1], means3d[..., 2]

    def col(M, j):
        return mx * M[0, j] + my * M[1, j] + mz * M[2, j] + M[3, j]

    view_z = col(world_view, 2)
    p_w = 1.0 / (col(full_proj, 3) + 1e-7)
    p_proj = torch.stack(
        [col(full_proj, 0) * p_w, col(full_proj, 1) * p_w, col(full_proj, 2) * p_w],
        dim=-1,
    )
    return view_z, p_proj


def ewa_cov2d(means3d, cov3d_packed, world_view, focal_x, focal_y, tan_fovx, tan_fovy):
    """EWA 2D covariance, (P, 3) packed [xx, xy, yy] including the +0.3 low-pass."""
    U = world_view[:3, :3].T  # world->view rotation (x_view = U x_world)
    mx_, my_, mz_ = means3d[..., 0], means3d[..., 1], means3d[..., 2]

    def col(j):
        return (mx_ * world_view[0, j] + my_ * world_view[1, j]
                + mz_ * world_view[2, j] + world_view[3, j])

    t0, t1, tz = col(0), col(1), col(2)
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(t0 / tz, -limx, limx) * tz
    ty = torch.clamp(t1 / tz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2

    # M = J @ U (J rows are [j00, 0, j02], [0, j11, j12])
    m00 = j00 * U[0, 0] + j02 * U[2, 0]
    m01 = j00 * U[0, 1] + j02 * U[2, 1]
    m02 = j00 * U[0, 2] + j02 * U[2, 2]
    m10 = j11 * U[1, 0] + j12 * U[2, 0]
    m11 = j11 * U[1, 1] + j12 * U[2, 1]
    m12 = j11 * U[1, 2] + j12 * U[2, 2]

    # cov2d = M Sigma M^T on the packed-6 Sigma
    s00, s01, s02, s11, s12, s22 = (cov3d_packed[..., i] for i in range(6))
    v00 = m00 * s00 + m01 * s01 + m02 * s02
    v01 = m00 * s01 + m01 * s11 + m02 * s12
    v02 = m00 * s02 + m01 * s12 + m02 * s22
    v10 = m10 * s00 + m11 * s01 + m12 * s02
    v11 = m10 * s01 + m11 * s11 + m12 * s12
    v12 = m10 * s02 + m11 * s12 + m12 * s22
    xx = v00 * m00 + v01 * m01 + v02 * m02 + LOWPASS
    xy = v00 * m10 + v01 * m11 + v02 * m12
    yy = v10 * m10 + v11 * m11 + v12 * m12 + LOWPASS
    return torch.stack([xx, xy, yy], dim=-1)


def conic_and_radius(cov2d):
    """Invert the 2D covariance; (conic (P,3), radius (P,) float, det (P,))."""
    xx, xy, yy = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = xx * yy - xy * xy
    det_inv = 1.0 / torch.where(det != 0.0, det, 1.0)
    conic = torch.stack([yy * det_inv, -xy * det_inv, xx * det_inv], dim=-1)
    mid = 0.5 * (xx + yy)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lam1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lam1, mid - disc)))
    return conic, radius, det


def mark_visible(means3d, world_view, full_proj):
    """(P,) bool frustum visibility: the reference's markVisible, a check of
    the near plane only (rasterizer_impl.cu:141-153, auxiliary.h:139-152)."""
    depth, _ = project_points(means3d, world_view, full_proj)
    return depth > NEAR_Z


def preprocess(means3d, cov3d_packed, color, opacity, camera, valid_mask=None) -> Projected:
    """Culling + projection + conic for all P Gaussians.

    `color` is the per-view RGB (ops.sh.sh_to_color); `opacity` is (P,) or
    (P, 1) activated; `valid_mask` marks capacity-padding slots dead.
    """
    opacity = opacity.reshape(opacity.shape[0])
    depth, p_proj = project_points(means3d, camera.world_view, camera.full_proj)
    cov2d = ewa_cov2d(
        means3d, cov3d_packed, camera.world_view,
        camera.focal_x, camera.focal_y, camera.tan_fovx, camera.tan_fovy,
    )
    conic, radius, det = conic_and_radius(cov2d)
    mean2d = torch.stack(
        [ndc2pix(p_proj[..., 0], camera.width), ndc2pix(p_proj[..., 1], camera.height)],
        dim=-1,
    )
    valid = (depth > NEAR_Z) & (det > 0.0)
    if valid_mask is not None:
        valid = valid & valid_mask
    radius = torch.where(valid, radius, 0.0).to(torch.int32)
    # opacity-adaptive AABB half-extents: alpha = op exp(-q) reaches 1/255
    # only inside q <= ln(255 op); clamped at 3.4 sigma, with the binning
    # cull's 1e-3 q-space margin (projection.py:178-194)
    nsig = torch.sqrt(torch.clamp_min(
        2.0 * (torch.log(torch.clamp_min(opacity, 1e-12) * 255.0) + 1e-3), 0.0))
    nsig = torch.clamp_max(nsig, 3.4)
    # the two diagonal entries by basic indexing: a list index is copied from
    # the host, a sync on a card
    diag = torch.stack([cov2d[..., 0], cov2d[..., 2]], -1)
    ext = torch.ceil(nsig[:, None] * torch.sqrt(torch.clamp_min(diag, 0.0)))
    radius_xy = torch.minimum(ext, radius[:, None].to(ext.dtype)).to(torch.int32)
    return Projected(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        radius=radius,
        color=color,
        opacity=opacity,
        valid=valid & (radius > 0),
        radius_xy=radius_xy,
    )
