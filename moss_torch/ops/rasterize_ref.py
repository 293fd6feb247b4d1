"""The plain PyTorch version of the forward blend (port of moss_tpu/ops/rasterize_ref.py:51-173).

Per-pixel front-to-back compositing with the reference's skip and stop rules
(reference forward.cu:261-383):

  power = -0.5 (a dx^2 + c dy^2) - b dx dy     (skip if power > 0)
  alpha = min(0.99, opacity * exp(power))      (skip if alpha < 1/255)
  stop when T * (1 - alpha) < 1e-4             (the triggering splat is skipped)
  out_color = sum alpha_i T_i c_i + T_final * bg
  out_alpha = sum alpha_i T_i                  (weight, not 1 - T)
  out_depth = sum alpha_i T_i depth_i

and the tile-rect cutoff: a Gaussian reaches only pixels whose (tile_h,
tile_w) tile lies inside its reference rect. The sequential recurrence runs
as masked cumulative ops over depth-ordered chunks of `chunk` splats (see
_composite_chunk). This is the CPU path of the port and the oracle the CUDA
kernel (ops/rasterize_cuda.py) is held to.
"""
from __future__ import annotations

import torch

from .binning import tile_rect

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def _composite_chunk(T_in, done_in, alpha, feat):
    """Sequential compositing of one depth-ordered chunk, vectorized.

    T_in: (N,) carried transmittance; done_in: (N,) bool, pixel already
    stopped; alpha: (K, N) chunk alphas, 0 where skipped; feat: (K, F)
    per-splat features (rgb, depth, 1). Returns (T_out, done_out, acc (N, F)).
    """
    cum = torch.cumprod(1.0 - alpha, dim=0)  # inclusive
    T_incl = T_in[None] * cum
    trigger = (alpha > 0) & (T_incl < T_EPS)
    fired = (torch.cummax(trigger.to(torch.int32), dim=0).values > 0) | done_in[None]
    contrib = (alpha > 0) & ~fired
    a = torch.where(contrib, alpha, 0.0)
    # exclusive cumprod of (1 - a)
    cum2 = torch.cumprod(1.0 - a, dim=0)
    T_excl = T_in[None] * torch.cat([torch.ones_like(cum2[:1]), cum2[:-1]], dim=0)
    w = a * T_excl  # (K, N)
    acc = w.T @ feat
    return T_in * cum2[-1], fired[-1], acc


def rasterize_reference(proj, bg_color, height: int, width: int,
                        tile_h: int = 16, tile_w: int = 16, chunk: int = 128):
    """Rasterize pre-projected Gaussians; dict of (H, W, *) images."""
    device = proj.mean2d.device
    P = proj.mean2d.shape[0]
    grid_h = -(-height // tile_h)
    grid_w = -(-width // tile_w)

    order = torch.argsort(torch.where(proj.valid, proj.depth, float("inf")), stable=True)
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    color = proj.color[order]
    depth = proj.depth[order]
    opacity = proj.opacity[order]
    valid = proj.valid[order]
    min_y, min_x, max_y, max_x = tile_rect(
        mean2d, proj.radius[order], grid_h, grid_w, tile_h, tile_w)

    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    px = px.reshape(-1)
    py = py.reshape(-1)
    pt_y = torch.div(py, tile_h, rounding_mode="floor").to(torch.int32)
    pt_x = torch.div(px, tile_w, rounding_mode="floor").to(torch.int32)
    N = height * width
    C = color.shape[-1]
    # per-splat features accumulated with the blend weights: rgb, depth, 1
    feat = torch.cat([color, depth[:, None], torch.ones_like(depth[:, None])], dim=1)

    T = torch.ones((N,), dtype=torch.float32, device=device)
    done = torch.zeros((N,), dtype=torch.bool, device=device)
    acc = torch.zeros((N, C + 2), dtype=torch.float32, device=device)
    for s in range(0, P, chunk):
        sl = slice(s, s + chunk)
        dx = mean2d[sl, 0:1] - px[None]  # (K, N)
        dy = mean2d[sl, 1:2] - py[None]
        a, b, c = conic[sl, 0:1], conic[sl, 1:2], conic[sl, 2:3]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp_max(opacity[sl, None] * torch.exp(power), ALPHA_MAX)
        in_rect = (
            (pt_y[None] >= min_y[sl, None]) & (pt_y[None] < max_y[sl, None])
            & (pt_x[None] >= min_x[sl, None]) & (pt_x[None] < max_x[sl, None])
        )
        mask = valid[sl, None] & (power <= 0.0) & (alpha >= ALPHA_MIN) & in_rect
        alpha = torch.where(mask, alpha, 0.0)
        T, done, acc_k = _composite_chunk(T, done, alpha, feat[sl])
        acc = acc + acc_k

    out_color = acc[:, :C] + T[:, None] * bg_color[None, :]
    return {
        "color": out_color.reshape(height, width, C),
        "depth": acc[:, C].reshape(height, width),
        "alpha": acc[:, C + 1].reshape(height, width),
        "final_T": T.reshape(height, width),
    }
