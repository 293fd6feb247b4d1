"""The alpha blend, plain: each tile's Gaussians composited front to back.

The contract of moss_torch's blend (its ops/rasterize_ref.py, moss_tpu's
rasterize_reference): a Gaussian reaches only the pixels of the 16 x 16 tiles
inside its rect (tile_rect, the reference's getRect); in depth order, alpha =
min(0.99, opacity exp(power)), a splat skipped where power > 0 or alpha <
1/255; a pixel stops once T (1 - alpha) < 1e-4, the splat that stops it
skipped; color = sum alpha T c + T_final bg, depth and alpha (the sum of the
weights) alike. Where rasterize_ref.py walks every Gaussian over every pixel
in chunks, this lists the (Gaussian, tile) pairs of the rects, sorts them by
tile and depth, and runs one cumulative product per tile over its padded
list, tiles of similar length together, so a training frame's backward fits
a card at 512 x 512 and 1024 x 1024 in seconds. Autograd takes the grads.
"""
from __future__ import annotations

import torch

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
TILE = 16


def tile_rect(mean2d, radius, grid_h: int, grid_w: int, tile_h: int, tile_w: int):
    """(min_y, min_x, max_y, max_x) int32 tiles per Gaussian, max exclusive;
    radius 0 an empty rect (the reference's getRect, copied from
    moss_torch/ops/binning.py)."""
    x = mean2d[..., 0]
    y = mean2d[..., 1]
    r = radius.to(mean2d.dtype)

    def cell(v, tile, grid):
        return torch.clamp(torch.floor(v / tile), 0, grid).to(torch.int32)

    min_x = cell(x - r, tile_w, grid_w)
    max_x = cell(x + r + tile_w - 1, tile_w, grid_w)
    min_y = cell(y - r, tile_h, grid_h)
    max_y = cell(y + r + tile_h - 1, tile_h, grid_h)
    empty = radius <= 0
    max_x = torch.where(empty, min_x, max_x)
    max_y = torch.where(empty, min_y, max_y)
    return min_y, min_x, max_y, max_x


def tile_pairs(proj, height: int, width: int, tile: int = TILE):
    """(gaussian, tile) of every pair the rects make, sorted by tile then
    depth (ties by index), and the pairs per tile (grid_h * grid_w,)."""
    P = proj.mean2d.shape[0]
    device = proj.mean2d.device
    grid_h, grid_w = -(-height // tile), -(-width // tile)
    order = torch.argsort(torch.where(proj.valid, proj.depth, float("inf")), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(P, device=device)
    y0, x0, y1, x1 = (v.long() for v in tile_rect(proj.mean2d, proj.radius, grid_h, grid_w,
                                                    tile, tile))
    live = proj.valid & (proj.radius > 0)
    w = torch.where(live, x1 - x0, 0)
    n = torch.where(live, (y1 - y0) * w, 0)
    g = torch.repeat_interleave(torch.arange(P, device=device), n)
    k = torch.arange(g.shape[0], device=device) - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    t = (y0[g] + k // w[g]) * grid_w + x0[g] + k % w[g]
    key = torch.sort(t * P + rank[g]).indices
    g, t = g[key], t[key]
    return g, t, torch.bincount(t, minlength=grid_h * grid_w)


def _composite(alpha, feat):
    """One cumulative product along dim 1 of (tiles, L, pixels) alphas (0
    where skipped); feat (tiles, L, F). (acc (tiles, pixels, F), T_final)."""
    cum = torch.cumprod(1.0 - alpha, dim=1)
    trigger = (alpha > 0) & (cum < T_EPS)
    fired = torch.cummax(trigger.to(torch.int32), dim=1).values > 0
    a = torch.where((alpha > 0) & ~fired, alpha, 0.0)
    cum2 = torch.cumprod(1.0 - a, dim=1)
    T_excl = torch.cat([torch.ones_like(cum2[:, :1]), cum2[:, :-1]], dim=1)
    w = a * T_excl
    return torch.einsum("tlp,tlf->tpf", w, feat), cum2[:, -1]


def blend(proj, bg_color, height: int, width: int, tile: int = TILE,
          group_elems: int = 1 << 25):
    """The images of pre-projected Gaussians: {"color" (H, W, 3), "depth",
    "alpha", "final_T" (H, W)}. Tiles go in groups of about group_elems
    (pair, pixel) entries."""
    device = proj.mean2d.device
    grid_h, grid_w = -(-height // tile), -(-width // tile)
    n_tiles, n_px = grid_h * grid_w, tile * tile
    g, t, counts = tile_pairs(proj, height, width, tile)
    offsets = torch.cumsum(counts, 0) - counts
    feat = torch.cat([proj.color, proj.depth[:, None], torch.ones_like(proj.depth[:, None])], 1)
    C = feat.shape[1]
    busy = torch.nonzero(counts).squeeze(1)
    busy = busy[torch.argsort(counts[busy], descending=True, stable=True)]
    lens = counts[busy].tolist()
    lane = torch.arange(n_px, device=device)
    accs, Ts, done = [], [], []
    s = 0
    while s < len(lens):
        L = lens[s]
        e = min(len(lens), s + max(1, group_elems // (L * n_px)))
        tiles = busy[s:e]
        slot = torch.arange(L, device=device)
        pos = offsets[tiles][:, None] + slot[None]
        pad = slot[None] < counts[tiles][:, None]
        gi = g[torch.where(pad, pos, 0)]
        px = ((tiles % grid_w) * tile)[:, None].float() + (lane % tile).float()[None]
        py = ((tiles // grid_w) * tile)[:, None].float() + (lane // tile).float()[None]
        dx = proj.mean2d[gi, 0][..., None] - px[:, None, :]
        dy = proj.mean2d[gi, 1][..., None] - py[:, None, :]
        a, b, c = (proj.conic[gi, i][..., None] for i in range(3))
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp_max(proj.opacity[gi][..., None] * torch.exp(power), ALPHA_MAX)
        alpha = torch.where(pad[..., None] & (power <= 0.0) & (alpha >= ALPHA_MIN), alpha, 0.0)
        acc, T = _composite(alpha, torch.where(pad[..., None], feat[gi], 0.0))
        accs.append(acc)
        Ts.append(T)
        done.append(tiles)
        s = e
    acc = torch.zeros((n_tiles, n_px, C), device=device)
    T = torch.ones((n_tiles, n_px), device=device)
    if done:
        idx = torch.cat(done)
        acc = acc.index_copy(0, idx, torch.cat(accs))
        T = T.index_copy(0, idx, torch.cat(Ts))

    def image(x):
        x = x.reshape(grid_h, grid_w, tile, tile, *x.shape[2:]).transpose(1, 2)
        return x.reshape(grid_h * tile, grid_w * tile, *x.shape[4:])[:height, :width]

    acc, T = image(acc), image(T)
    return {"color": acc[..., :3] + T[..., None] * bg_color, "depth": acc[..., 3],
            "alpha": acc[..., 4], "final_T": T}
