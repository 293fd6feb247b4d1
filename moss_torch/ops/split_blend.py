"""The segment scheme of the split blend kernels, in plain PyTorch.

csrc/rasterize_fwd.cu and csrc/rasterize_bwd.cu cut a tile whose pair list
is longer than S pairs (`seg_len`) into ceil(count / S) consecutive segments
of its depth-ordered pairs, each walked by its own CTA:

  (a) local product: each segment but its tile's last walks its pairs from
      T = 1 with the blend step's skip tests and keeps, per pixel, the
      product L_k of (1 - alpha) over the splats it blends; where the step
      would stop, L_k is 0 and the walk ends. A walk that enters with some
      T <= 1 stops there or earlier (round to nearest is monotone), so the
      segments after it are discarded by (d) whatever L_k is. (The kernels
      take L_0 from segment 0's blend in (c), which also walks from T = 1:
      its exit T, or 0 where it stopped, the same number);
  (b) entering T: T_k = L_0 L_1 ... L_{k-1}, multiplied in segment order;
  (c) blend: each segment walks its pairs from T_k with the full blend step,
      stop included; a pixel that enters with T_k < 1e-4 counts as stopped
      before its first pair. Per pixel: the five sums acc_k (w r, w g, w b,
      w depth, w), the exit T and whether it stopped;
  (d) merge, in segment order: a pixel's planes sum acc_k over the segments
      up to and including the first that stopped, and final_T is that
      segment's exit T (the last segment's if none stopped). The segments
      after it are discarded: their T_k, a product, can land above 1e-4;
  (e) for the backward, per (segment, pixel): t_in, T_k where the segment is
      live (no earlier segment stopped) and 0 where it is not, and cum_k, the
      sum of acc_j over the segments before it.

The backward walks segment k from t_in, so it stops exactly where (c) did,
with s_after = (Qtail - g . cum_k) - the segment's own prefix of w dL/dw,
where g . acc = g_r acc_r + g_g acc_g + g_b acc_b + g_d acc_depth + g_a acc_w
is the sum of w dL/dw over the segment. A pair lies in one segment, so its
gradient row is still summed over the tile's pixels in one place.

A tile of at most S pairs is one segment: T_0 = 1, no merge, and both walks
are the unsplit ones. The CTA of slot b < num_tiles walks segment 0 of tile
b; slot num_tiles + m walks the segment that starts at the m-th multiple of S
in the pair list, if it is not a tile's first; so the kernels launch
num_tiles + ceil(num_pairs / S) CTAs, a number the host knows, and surplus
ones return at once (`segment_plan`).

These functions walk the pairs one step at a time, vectorized over
(segment, pixel), with the kernels' f32 arithmetic and order; they are the
plain versions the kernels are held to, at any tile shape. seg_len=None walks
every tile as one segment.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .binning import PairList
from .rasterize_ref import ALPHA_MAX, ALPHA_MIN, T_EPS

GRAD_COLS = 10  # d(mean_x, mean_y, conic a, b, c, opacity, r, g, b, depth)


def num_slots(num_tiles: int, num_pairs: int, seg_len: int) -> int:
    """CTAs a split kernel launches: one per tile, one per multiple of S."""
    return num_tiles + -(-num_pairs // seg_len)


class Plan(NamedTuple):
    """The segments of a pair list, in slot order; one entry per segment."""

    slots: int           # CTAs launched, surplus ones included
    slot: torch.Tensor   # (R,) the CTA that walks the segment
    tile: torch.Tensor   # (R,)
    k: torch.Tensor      # (R,) its place in its tile
    count: torch.Tensor  # (R,) segments of its tile
    start: torch.Tensor  # (R,) first pair
    end: torch.Tensor    # (R,) one past its last pair
    run_of: torch.Tensor  # (num_tiles, max segments) entry of segment k of tile t, -1 past the last


def segment_plan(tile_offsets, seg_len: Optional[int]) -> Plan:
    """The (tile, segment) of every CTA, as the kernels compute it
    (csrc/blend_common.cuh, segment_of)."""
    off = tile_offsets.long()
    device = off.device
    num_tiles = off.numel() - 1
    num_pairs = int(off[-1])
    counts = off[1:] - off[:-1]
    S = max(1, num_pairs, int(counts.max()) if num_tiles else 1) if seg_len is None else seg_len
    if S < 1:
        raise ValueError(f"seg_len must be positive, got {S}")
    K = torch.where(counts > 0, (counts + S - 1) // S, 1)
    anchor0 = (off[:-1] + S - 1) // S  # the first multiple of S in each tile, in units of S
    slots = num_slots(num_tiles, num_pairs, S)
    b = torch.arange(slots, device=device)
    a = (b - num_tiles) * S
    t = (torch.searchsorted(off, a, right=True) - 1).clamp(0, max(num_tiles - 1, 0))
    head = b < num_tiles
    t = torch.where(head, b, t)
    k = torch.where(head, 0, a // S - anchor0[t] + 1)
    valid = head | ((a < num_pairs) & (k >= 1) & (k < K[t]))
    slot, t, k = b[valid], t[valid], k[valid]
    start = off[t] + k * S
    end = torch.minimum(start + S, off[t + 1])
    run_of = torch.full((num_tiles, int(K.max()) if num_tiles else 1), -1, dtype=torch.long,
                        device=device)
    run_of[t, k] = torch.arange(t.numel(), device=device)
    return Plan(slots, slot, t, k, K[t], start, end, run_of)


def _pixels(tile, height, width, tile_h, tile_w):
    """(px, py, inside) of each segment's tile pixels, (R, tile_h tile_w)."""
    grid_w = -(-width // tile_w)
    lane = torch.arange(tile_h * tile_w, device=tile.device)
    px = ((tile % grid_w) * tile_w)[:, None] + lane % tile_w
    py = ((tile // grid_w) * tile_h)[:, None] + lane // tile_w
    return px, py, (px < width) & (py < height)


def _step(proj, g, fx, fy, T):
    """csrc/blend_common.cuh blend_step for one pair per segment at every
    pixel: (dx, dy, alpha, test_T, blend, stop) with blend and stop exclusive."""
    dx = proj.mean2d[g, 0:1] - fx
    dy = proj.mean2d[g, 1:2] - fy
    a, b, c = proj.conic[g, 0:1], proj.conic[g, 1:2], proj.conic[g, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(proj.opacity[g, None] * torch.exp(power), ALPHA_MAX)
    hit = (power <= 0.0) & (alpha >= ALPHA_MIN)
    test_T = T * (1.0 - alpha)
    stop = hit & (test_T < T_EPS)
    return dx, dy, alpha, test_T, hit & ~stop, stop


def _walk(pairs, proj, plan, fx, fy, done, T, local=False):
    """Walk every segment's pairs from T. local: (a), the product with a
    stop at 0; else (c): (T, done, stopped, acc (R, N, 5))."""
    R, N = T.shape
    stopped = torch.zeros_like(done)
    acc = T.new_zeros((R, N, 5))
    feat = torch.cat([proj.color, proj.depth[:, None], torch.ones_like(proj.depth[:, None])], 1)
    for j in range(int((plan.end - plan.start).max()) if R else 0):
        on = (plan.start + j < plan.end)[:, None] & ~done
        g = pairs.pair_gaussian[(plan.start + j).clamp_max(max(pairs.num_pairs - 1, 0))].long()
        _, _, alpha, test_T, blend, stop = _step(proj, g, fx, fy, T)
        blend, stop = blend & on, stop & on
        if not local:
            w = torch.where(blend, alpha * T, 0.0)
            acc = acc + w[..., None] * feat[g][:, None, :]
        T = torch.where(blend, test_T, torch.where(stop, 0.0, T) if local else T)
        done = done | stop
        stopped = stopped | stop
    return T, done, stopped, acc


def blend_split(pairs: PairList, proj, height: int, width: int, seg_len: Optional[int],
                tile_h: int = 16, tile_w: int = 16):
    """(img (6, H, W): r, g, b, depth, alpha, final_T; state) of steps
    (a)-(e); state = (plan, t_in (R, N), cum (R, N, 5)) for blend_split_bwd."""
    plan = segment_plan(pairs.tile_offsets, seg_len)
    px, py, inside = _pixels(plan.tile, height, width, tile_h, tile_w)
    fx, fy = px.float(), py.float()
    R, N = px.shape
    ones = torch.ones((R, N), device=px.device)
    # (a) and (b)
    L, _, _, _ = _walk(pairs, proj, plan, fx, fy, ~inside, ones, local=True)
    t_in = ones
    for j in range(plan.run_of.shape[1] - 1):
        prev = plan.run_of[plan.tile, j]
        t_in = torch.where((j < plan.k)[:, None], t_in * L[prev.clamp_min(0)], t_in)
    # (c)
    dead = inside & (t_in < T_EPS)
    t_out, _, stopped, acc = _walk(pairs, proj, plan, fx, fy, ~inside | dead, t_in)
    stopped = stopped | dead
    # (d) and (e), in segment order
    num_tiles = plan.run_of.shape[0]
    sums = acc.new_zeros((num_tiles, N, 5))
    final_T = acc.new_ones((num_tiles, N))
    live = torch.ones((num_tiles, N), dtype=torch.bool, device=px.device)
    cum = torch.zeros_like(acc)
    live_in = torch.zeros_like(stopped)
    for k in range(plan.run_of.shape[1]):
        has = plan.run_of[:, k] >= 0
        r = plan.run_of[has, k]
        lv = live[has]
        live_in[r] = lv
        cum[r] = sums[has]
        sums[has] = torch.where(lv[..., None], sums[has] + acc[r], sums[has])
        final_T[has] = torch.where(lv, t_out[r], final_T[has])
        live[has] = lv & ~stopped[r]
    img = torch.zeros((6, height * width), device=px.device)
    head = plan.k == 0
    pix = (py * width + px)[head][inside[head]]
    planes = torch.cat([sums, final_T[..., None]], -1)[plan.tile[head]][inside[head]]
    img[:, pix] = planes.T
    return img.reshape(6, height, width), (plan, torch.where(live_in, t_in, 0.0), cum)


def blend_split_bwd(pairs: PairList, proj, gimg, height: int, width: int, state,
                    tile_h: int = 16, tile_w: int = 16):
    """(num_pairs, 10) per-pair gradient rows of blend_split's planes, from
    its state. gimg: (6, H, W) g_r, g_g, g_b, g_depth, g_alpha, Qtail."""
    plan, t_in, cum = state
    px, py, inside = _pixels(plan.tile, height, width, tile_h, tile_w)
    fx, fy = px.float(), py.float()
    pix = torch.where(inside, py * width + px, 0)
    g = torch.where(inside[None], gimg.reshape(6, -1)[:, pix], 0.0)  # (6, R, N)
    prior = (g[0] * cum[..., 0] + g[1] * cum[..., 1] + g[2] * cum[..., 2] + g[3] * cum[..., 3]
             + g[4] * cum[..., 4])
    base = g[5] - prior
    T, done = t_in, ~inside | (t_in < T_EPS)
    prefix = torch.zeros_like(T)
    rows = proj.mean2d.new_zeros((pairs.num_pairs, GRAD_COLS))
    for j in range(int((plan.end - plan.start).max()) if plan.start.numel() else 0):
        on = (plan.start + j < plan.end)[:, None] & ~done
        idx = (plan.start + j).clamp_max(max(pairs.num_pairs - 1, 0))
        i = pairs.pair_gaussian[idx].long()
        dx, dy, alpha, test_T, blend, stop = _step(proj, i, fx, fy, T)
        blend, stop = blend & on, stop & on
        w = torch.where(blend, alpha * T, 0.0)
        col, dep = proj.color[i], proj.depth[i, None]
        dl_dw = col[:, 0:1] * g[0] + col[:, 1:2] * g[1] + col[:, 2:3] * g[2] + dep * g[3] + g[4]
        prefix = prefix + w * dl_dw
        s_after = base - prefix
        dp = torch.where(blend & (alpha < ALPHA_MAX),
                         (dl_dw * T - s_after / (1.0 - alpha)) * alpha, 0.0)
        s = [(dp * dx).sum(1), (dp * dy).sum(1), (dp * dx * dx).sum(1), (dp * dx * dy).sum(1),
             (dp * dy * dy).sum(1), dp.sum(1), (w * g[0]).sum(1), (w * g[1]).sum(1),
             (w * g[2]).sum(1), (w * g[3]).sum(1)]
        a, b, c = proj.conic[i, 0], proj.conic[i, 1], proj.conic[i, 2]
        row = torch.stack([-(a * s[0] + b * s[1]), -(c * s[1] + b * s[0]), -0.5 * s[2], -s[3],
                           -0.5 * s[4], s[5] / torch.clamp_min(proj.opacity[i], 1e-12),
                           *s[6:]], 1)
        walked = plan.start + j < plan.end
        rows[idx[walked]] = row[walked]
        T = torch.where(blend, test_T, T)
        done = done | stop
    return rows
