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
kernels (ops/rasterize_cuda.py) are held to, forward and, through autograd,
backward.

pair_mask, a (P, num_tiles) bool table of the (Gaussian, tile) pairs a
budgeted pair list keeps (binning.kept_pair_mask), takes the place of the
tile rect: a Gaussian then reaches only the tiles its kept pairs name. A pair
that the binning's AABB and peak-alpha cull drop has alpha < 1/255 at every
pixel of its tile, so with budgets that drop nothing the image is the rect's.

remat=True (moss_tpu's rasterize_reference(remat=...)) runs each chunk under
torch.utils.checkpoint when grads are recorded: autograd then keeps only the
chunk's inputs and the carried T, and recomputes the (chunk, H*W) tensors in
the backward. Without it, autograd keeps several of them for every chunk,
hundreds of GB at 512x512 / 46k Gaussians. The blend draws no random
numbers, so the checkpoint keeps no RNG state (which also lets a CUDA graph
capture it).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .binning import tile_rect
from .projection import preprocess

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


class _CumprodNonzero(torch.autograd.Function):
    """torch.cumprod along dim 0 for factors that are never 0, with the
    backward torch takes for them (reversed_cumsum(out * g) / x, the same ops
    in the same order, so the same bits). torch's own backward first asks
    the host whether x holds a zero (`.item()`), a sync a queued segment
    would wait on and a CUDA graph cannot capture. The blend's factors
    1 - alpha lie in [0.01, 1]: alpha <= ALPHA_MAX."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=0)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        if x.shape[0] == 1:  # torch's backward returns g itself there
            return g
        return (out * g).flip(0).cumsum(0).flip(0).div(x)


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
    # exclusive cumprod of (1 - a); `cum` above feeds only comparisons, so no
    # gradient reaches its cumprod
    cum2 = _CumprodNonzero.apply(1.0 - a)
    T_excl = T_in[None] * torch.cat([torch.ones_like(cum2[:1]), cum2[:-1]], dim=0)
    w = a * T_excl  # (K, N)
    acc = w.T @ feat
    # a copy: the view fired[-1] would keep the whole (K, N) mask alive as
    # long as `done` lives, through every later chunk's remat (at 800x800
    # and 131,072 Gaussians, 1,024 chunks of 82 MB)
    return T_in * cum2[-1], fired[-1].clone(), acc


def _blend_chunk(T, done, mean2d, conic, opacity, valid, rect, feat, px, py, pt_y, pt_x,
                 pt=None):
    """One depth-ordered chunk: alphas with the skip and rect masks, then
    the sequential composite. rect: (K, 4) int (min_y, min_x, max_y, max_x),
    or a (K, num_tiles) bool pair mask read at the pixels' tiles `pt`."""
    dx = mean2d[:, 0:1] - px[None]  # (K, N)
    dy = mean2d[:, 1:2] - py[None]
    a, b, c = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(opacity[:, None] * torch.exp(power), ALPHA_MAX)
    if rect.dtype == torch.bool:
        in_rect = rect[:, pt]
    else:
        in_rect = (
            (pt_y[None] >= rect[:, 0:1]) & (pt_y[None] < rect[:, 2:3])
            & (pt_x[None] >= rect[:, 1:2]) & (pt_x[None] < rect[:, 3:4])
        )
    mask = valid[:, None] & (power <= 0.0) & (alpha >= ALPHA_MIN) & in_rect
    alpha = torch.where(mask, alpha, 0.0)
    return _composite_chunk(T, done, alpha, feat)


def rasterize_reference(proj, bg_color, height: int, width: int,
                        tile_h: int = 16, tile_w: int = 16, chunk: int = 128,
                        remat: bool = False, pair_mask=None):
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
    if pair_mask is None:
        rect = torch.stack(tile_rect(
            mean2d, proj.radius[order], grid_h, grid_w, tile_h, tile_w), dim=1)
    else:
        rect = pair_mask[order]

    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    px = px.reshape(-1)
    py = py.reshape(-1)
    pt_y = torch.div(py, tile_h, rounding_mode="floor").to(torch.int32)
    pt_x = torch.div(px, tile_w, rounding_mode="floor").to(torch.int32)
    pt = pt_y.long() * grid_w + pt_x.long()
    N = height * width
    C = color.shape[-1]
    # per-splat features accumulated with the blend weights: rgb, depth, 1
    feat = torch.cat([color, depth[:, None], torch.ones_like(depth[:, None])], dim=1)

    T = torch.ones((N,), dtype=torch.float32, device=device)
    done = torch.zeros((N,), dtype=torch.bool, device=device)
    acc = torch.zeros((N, C + 2), dtype=torch.float32, device=device)
    remat = remat and torch.is_grad_enabled()
    for s in range(0, P, chunk):
        sl = slice(s, s + chunk)
        args = (T, done, mean2d[sl], conic[sl], opacity[sl], valid[sl], rect[sl], feat[sl],
                px, py, pt_y, pt_x, pt)
        if remat:
            T, done, acc_k = checkpoint(_blend_chunk, *args, use_reentrant=False,
                                         preserve_rng_state=False)
        else:
            T, done, acc_k = _blend_chunk(*args)
        acc = acc + acc_k

    out_color = acc[:, :C] + T[:, None] * bg_color[None, :]
    return {
        "color": out_color.reshape(height, width, C),
        "depth": acc[:, C].reshape(height, width),
        "alpha": acc[:, C + 1].reshape(height, width),
        "final_T": T.reshape(height, width),
    }


def render_reference(means3d, cov3d_packed, color, opacity, camera, bg_color, valid_mask=None,
                     tile_h: int = 16, tile_w: int = 16):
    """preprocess + rasterize_reference in one call, the plain end-to-end
    forward: (images, proj)."""
    proj = preprocess(means3d, cov3d_packed, color, opacity, camera, valid_mask)
    return rasterize_reference(proj, bg_color, camera.height, camera.width, tile_h=tile_h,
                               tile_w=tile_w), proj
