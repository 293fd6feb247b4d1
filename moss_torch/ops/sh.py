"""Real spherical-harmonics colour evaluation (port of moss_tpu/ops/sh.py).

colour = max(eval_sh + 0.5, 0), degree 0..4, channel-last coefficients.
"""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def rgb_to_sh(rgb):
    """Convert an RGB albedo in [0,1] into the degree-0 SH coefficient."""
    return (rgb - 0.5) / SH_C0


def eval_sh(deg: int, sh, dirs):
    """SH-weighted sum at unit directions: sh (..., K, C), dirs (..., 3) -> (..., C)."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree must be in [0,4], got {deg}")
    result = SH_C0 * sh[..., 0, :]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (
            result
            - SH_C1 * y * sh[..., 1, :]
            + SH_C1 * z * sh[..., 2, :]
            - SH_C1 * x * sh[..., 3, :]
        )
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * sh[..., 4, :]
                + SH_C2[1] * yz * sh[..., 5, :]
                + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                + SH_C2[3] * xz * sh[..., 7, :]
                + SH_C2[4] * (xx - yy) * sh[..., 8, :]
            )
            if deg > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                    + SH_C3[1] * xy * z * sh[..., 10, :]
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                    + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :]
                )
                if deg > 3:
                    result = (
                        result
                        + SH_C4[0] * xy * (xx - yy) * sh[..., 16, :]
                        + SH_C4[1] * yz * (3.0 * xx - yy) * sh[..., 17, :]
                        + SH_C4[2] * xy * (7.0 * zz - 1.0) * sh[..., 18, :]
                        + SH_C4[3] * yz * (7.0 * zz - 3.0) * sh[..., 19, :]
                        + SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0) * sh[..., 20, :]
                        + SH_C4[5] * xz * (7.0 * zz - 3.0) * sh[..., 21, :]
                        + SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0) * sh[..., 22, :]
                        + SH_C4[7] * xz * (xx - 3.0 * yy) * sh[..., 23, :]
                        + SH_C4[8]
                        * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy))
                        * sh[..., 24, :]
                    )
    return result


def sh_to_color(deg: int, sh, means3d, campos):
    """dir = normalize(mean - campos); colour = max(eval_sh + 0.5, 0)."""
    dirs = means3d - campos
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    rgb = eval_sh(deg, sh, dirs) + 0.5
    return torch.clamp_min(rgb, 0.0)


def degree_coeff_mask(active_deg, n_coeffs: int, device=None):
    """(n_coeffs, 1) f32 mask of the coefficients live at `active_deg`."""
    n_live = (active_deg + 1) * (active_deg + 1)
    return (torch.arange(n_coeffs, device=device) < n_live).to(torch.float32)[:, None]
