"""Tile binning for the CUDA blend kernel.

Port of the front half of moss_tpu/ops/binning.py (_pair_keys, :350-476)
for the port's 16x16 tiles:

  1. depth sort of all Gaussians, invalid entries at +inf (stable);
  2. the covered tile rect: the reference rect (`tile_rect`, with its
     deliberate under-cover max formula) intersected with the exact-cover
     opacity-adaptive AABB (`tile_rect_aabb`);
  3. the exact peak-alpha tile cull: a (splat, tile) pair whose largest
     alpha over the tile's pixel grid is below 1/255 (with a 1e-3 q-space
     margin) is dropped, which leaves the image unchanged;
  4. int64 keys tile << 32 | depth_rank, one torch.sort;
  5. per-tile [start, end) ranges, and per Gaussian the positions of its
     pairs (the inverse of the sort's permutation: the candidates were made
     in Gaussian order), which the backward's segment sum reads.

bin_pairs has two modes. With both budgets 0 the pair list is sized per
frame from the live pair count: nothing is dropped, and the shapes follow the
data (a repeat_interleave, a boolean index and two bincounts, each a host
sync on a CUDA tensor); the serving drivers use it. With a pair budget or a
rect cap (moss_tpu's NPb and max_tiles_per_gaussian) every shape is a
function of P, the budgets and the frame alone, as _pair_keys' are, so a
step that bins this way makes no host read and can be captured in a CUDA
graph: a (P, B) candidate table, slot s of a Gaussian's rect being tile
(min_y + s // n_x, min_x + s % n_x) while s < min(n_tiles, B); one sort with
the dead candidates keyed past the last tile; the first NPb keys kept; the
tile ranges and the live count by searchsorted; the per-Gaussian ranges by a
cumsum over the kept candidates in Gaussian order and a scatter. The drops
are counted: `overflow` = the rect cap's (tiles past B) + the pair budget's
(live pairs past NPb), as moss_tpu sums them.

moss_tpu's slot budget (default_slot_budget, worst_case_slot_budget and the
aligned 8x128 supertile layout of build_pair_rows, steps 6-8) has no
counterpart: the split blend kernels size their CTAs from the pair capacity
(num_tiles + ceil(NPb / S), ops/split_blend.num_slots) and read the live
count from tile_offsets[num_tiles] on the device, so they need no slot
layout.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def tile_rect(mean2d, radius, grid_h: int, grid_w: int, tile_h: int, tile_w: int):
    """Covered tile rectangle per Gaussian (reference auxiliary.h getRect).

    Returns (min_y, min_x, max_y, max_x) int32, max exclusive; radius 0 gives
    an empty rect. The reference's max formula floor((x + r + tile - 1)/tile)
    under-covers fractional x + r in the first pixel of a tile; that is the
    reference's semantics and is kept.
    """
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


def tile_rect_aabb(mean2d, radius, radius_xy, grid_h: int, grid_w: int,
                   tile_h: int, tile_w: int):
    """Reference rect intersected with the exact-cover per-axis AABB.

    Every pixel the intersection drops lies beyond radius_xy from the mean on
    one axis, where alpha < 1/255 by construction (projection.py), so the
    image is the same as with the reference rect, with fewer dead pairs.
    """
    x = mean2d[..., 0]
    y = mean2d[..., 1]
    rn_y, rn_x, rx_y, rx_x = tile_rect(mean2d, radius, grid_h, grid_w, tile_h, tile_w)
    rxf = radius_xy[..., 0].to(mean2d.dtype)
    ryf = radius_xy[..., 1].to(mean2d.dtype)

    def cell(v, tile, grid, plus):
        return torch.clamp(torch.floor(v / tile) + plus, 0, grid).to(torch.int32)

    min_y = torch.maximum(rn_y, cell(y - ryf, tile_h, grid_h, 0))
    min_x = torch.maximum(rn_x, cell(x - rxf, tile_w, grid_w, 0))
    max_y = torch.maximum(torch.minimum(rx_y, cell(y + ryf, tile_h, grid_h, 1)), min_y)
    max_x = torch.maximum(torch.minimum(rx_x, cell(x + rxf, tile_w, grid_w, 1)), min_x)
    empty = (radius <= 0) | (radius_xy[..., 0] <= 0) | (radius_xy[..., 1] <= 0)
    max_x = torch.where(empty, min_x, max_x)
    max_y = torch.where(empty, min_y, max_y)
    return min_y, min_x, max_y, max_x


def peak_alpha_live(mean2d, conic, opacity, tx, ty, tile_h: int, tile_w: int):
    """(n,) bool: can the splat reach alpha >= 1/255 anywhere in tile (ty, tx)?

    The max of alpha = op exp(-q) over the tile's pixel grid is found by
    minimizing the positive-definite q = 0.5(a dx^2 + c dy^2) + b dx dy over
    the rect of pixel centres: 0 at the mean if inside, else the clamped
    1-D minimizer on one of the 4 edges (binning.py:405-449).
    """
    ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
    dx0 = tx.to(mean2d.dtype) * tile_w - mean2d[:, 0]
    dx1 = dx0 + (tile_w - 1)
    dy0 = ty.to(mean2d.dtype) * tile_h - mean2d[:, 1]
    dy1 = dy0 + (tile_h - 1)

    def q(dx_, dy_):
        return 0.5 * (ca * dx_ * dx_ + cc * dy_ * dy_) + cb * dx_ * dy_

    a_safe = torch.clamp_min(ca, 1e-12)
    c_safe = torch.clamp_min(cc, 1e-12)

    def edge_x(dxe):  # vertical edge: dx fixed, dy in [dy0, dy1]
        return q(dxe, torch.clamp(-cb * dxe / c_safe, dy0, dy1))

    def edge_y(dye):  # horizontal edge: dy fixed, dx in [dx0, dx1]
        return q(torch.clamp(-cb * dye / a_safe, dx0, dx1), dye)

    inside = (dx0 <= 0) & (0 <= dx1) & (dy0 <= 0) & (0 <= dy1)
    qmin = torch.minimum(
        torch.minimum(edge_x(dx0), edge_x(dx1)),
        torch.minimum(edge_y(dy0), edge_y(dy1)),
    )
    qmin = torch.where(inside, 0.0, qmin)
    qcap = torch.log(torch.clamp_min(opacity, 1e-12) * 255.0) + 1e-3
    return qmin <= qcap


class PairList(NamedTuple):
    """Depth-ordered per-tile pair list for the blend kernel.

    pair_gaussian: (num_pairs,) int32 index into the Gaussian arrays, sorted
      by tile, depth order within a tile.
    tile_offsets: (num_tiles + 1,) int32; tile t's pairs are
      pair_gaussian[tile_offsets[t]:tile_offsets[t + 1]].
    tile_count: (num_tiles,) int32 live pairs per tile.
    overflow: () int32 pairs dropped: 0 without budgets; with them, the rect
      cap's drops plus the pair budget's.
    gaussian_pairs: (num_pairs,) int32 positions in the pair list, grouped by
      Gaussian; Gaussian g's pairs sit at
      gaussian_pairs[gaussian_offsets[g]:gaussian_offsets[g + 1]], in tile order.
    gaussian_offsets: (P + 1,) int32.

    With budgets num_pairs is the capacity NPb: the list's kept pairs are its
    first tile_offsets[num_tiles], and the positions past them belong to no
    tile and no Gaussian (gaussian_pairs holds them in order there).
    """

    pair_gaussian: torch.Tensor
    tile_offsets: torch.Tensor
    tile_count: torch.Tensor
    overflow: torch.Tensor
    gaussian_pairs: torch.Tensor
    gaussian_offsets: torch.Tensor

    @property
    def num_pairs(self) -> int:
        return self.pair_gaussian.shape[0]


ALIGN = 128             # NPb rounds up to a multiple of it (moss_tpu's align)
DEFAULT_MAX_TILES = 16  # the rect cap's default, moss_tpu/config.py:87


def npb(P: int, pair_budget: int, num_tiles: int, max_tiles: int, align: int = ALIGN) -> int:
    """The pair capacity NPb (moss_tpu's one rule, binning.py:276-287): the
    caller's budget, or 4 P + 64 num_tiles when it is 0, rounded up to
    `align`, at most the whole P x max_tiles candidate table."""
    if pair_budget == 0:
        pair_budget = 4 * P + 64 * num_tiles
    return min(-(-pair_budget // align) * align, P * max_tiles)


def default_pair_budget(P: int, height: int, width: int, tile_h: int = 16, tile_w: int = 16,
                        max_tiles_per_gaussian: int = DEFAULT_MAX_TILES,
                        align: int = ALIGN) -> int:
    """The NPb bin_pairs picks when pair_budget is 0 (moss_tpu's
    default_pair_budget at groups=1), so that a caller can compare a
    measured live count with it before installing a budget of its own."""
    num_tiles = -(-height // tile_h) * -(-width // tile_w)
    return npb(P, 0, num_tiles, max_tiles_per_gaussian, align)


def _depth_order(depth, valid):
    """(order, rank): the stable depth order, invalid entries last, and each
    Gaussian's place in it."""
    order = torch.argsort(torch.where(valid, depth, float("inf")), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return order, rank


class _Keys(NamedTuple):
    """Steps 1-4 of the budgeted build over the (P, B) candidate table."""

    order: torch.Tensor          # (P,) depth order
    keys: torch.Tensor           # (P B,) sorted tile << 32 | rank, dead ones last
    perm: torch.Tensor           # (P B,) candidate (Gaussian-major) of each sorted key
    total_live: torch.Tensor     # () live pairs before the NPb cut
    rect_overflow: torch.Tensor  # () rect tiles past the cap B
    max_rect: torch.Tensor       # () largest rect of a valid Gaussian, before the cap


def _budgeted_keys(mean2d, conic, opacity, depth, radius, radius_xy, valid, grid_h: int,
                   grid_w: int, tile_h: int, tile_w: int, B: int) -> _Keys:
    device = mean2d.device
    P = mean2d.shape[0]
    num_tiles = grid_h * grid_w
    order, rank = _depth_order(depth, valid)

    min_y, min_x, max_y, max_x = tile_rect_aabb(
        mean2d, radius, radius_xy, grid_h, grid_w, tile_h, tile_w)
    n_x = (max_x - min_x).long()
    n_tiles = n_x * (max_y - min_y).long()
    rect_overflow = torch.sum(torch.where(valid, torch.clamp_min(n_tiles - B, 0), 0))
    max_rect = torch.amax(torch.where(valid, n_tiles, 0)) if P else n_tiles.new_zeros(())

    # slot s of Gaussian g's rect, row-major in the rect (so in tile order)
    slot = torch.arange(B, device=device)[None, :]
    n_x_safe = torch.clamp_min(n_x, 1)[:, None]
    ty = min_y.long()[:, None] + torch.div(slot, n_x_safe, rounding_mode="floor")
    tx = min_x.long()[:, None] + slot % n_x_safe
    live = valid[:, None] & (slot < torch.clamp_max(n_tiles, B)[:, None])

    def per_slot(x):  # (P, ...) -> (P B, ...), each Gaussian's row B times
        return x[:, None].expand(P, B, *x.shape[1:]).reshape(P * B, *x.shape[1:])

    live = live & peak_alpha_live(per_slot(mean2d), per_slot(conic), per_slot(opacity),
                                  tx.reshape(-1), ty.reshape(-1), tile_h, tile_w).reshape(P, B)
    tile = torch.where(live, ty * grid_w + tx, num_tiles)
    keys, perm = torch.sort(((tile << 32) | rank[:, None]).reshape(-1), stable=True)
    end = torch.full((1,), num_tiles << 32, dtype=torch.int64, device=device)
    total_live = torch.searchsorted(keys, end)[0]
    return _Keys(order, keys, perm, total_live.to(torch.int32),
                 rect_overflow.to(torch.int32), max_rect.to(torch.int32))


def measure_pair_need(mean2d, conic, opacity, depth, radius, radius_xy, valid, height: int,
                      width: int, tile_h: int = 16, tile_w: int = 16,
                      max_tiles_per_gaussian: int = DEFAULT_MAX_TILES):
    """A frame's need for the two budgets, the counterpart of moss_tpu's
    measure_slot_need's total_live and max_rect (binning.py:479-526): the
    budgeted build probed with pair_budget = P x max_tiles, so nothing is cut.
    A dict of () int32 tensors: total_live (the live pairs under the rect
    cap, what NPb is sized from), max_rect (the largest rect of a valid
    Gaussian, before the cap, what the cap is sized from) and rect_overflow
    (the tiles the cap drops)."""
    grid_h, grid_w = -(-height // tile_h), -(-width // tile_w)
    k = _budgeted_keys(mean2d, conic, opacity, depth, radius, radius_xy, valid, grid_h,
                       grid_w, tile_h, tile_w, max_tiles_per_gaussian)
    return {"total_live": k.total_live, "max_rect": k.max_rect,
            "rect_overflow": k.rect_overflow}


def bin_pairs(mean2d, conic, opacity, depth, radius, radius_xy, valid,
              height: int, width: int, tile_h: int = 16, tile_w: int = 16,
              pair_budget: int = 0, max_tiles_per_gaussian: int = 0) -> PairList:
    """Build the pair list (module docstring steps 1-5): per frame with both
    budgets 0, else at the capacity npb(P, pair_budget, tiles, B), B being
    max_tiles_per_gaussian or DEFAULT_MAX_TILES."""
    if pair_budget > 0 or max_tiles_per_gaussian > 0:
        return _bin_budgeted(mean2d, conic, opacity, depth, radius, radius_xy, valid, height,
                             width, tile_h, tile_w, pair_budget,
                             max_tiles_per_gaussian or DEFAULT_MAX_TILES)
    device = mean2d.device
    P = mean2d.shape[0]
    grid_h = -(-height // tile_h)
    grid_w = -(-width // tile_w)
    num_tiles = grid_h * grid_w

    # 1. depth order and each Gaussian's rank in it
    order, rank = _depth_order(depth, valid)

    # 2. rects, then one candidate pair per covered tile
    min_y, min_x, max_y, max_x = tile_rect_aabb(
        mean2d, radius, radius_xy, grid_h, grid_w, tile_h, tile_w)
    n_x = (max_x - min_x).long()
    n_cand = torch.where(valid, n_x * (max_y - min_y).long(), 0)
    gid = torch.repeat_interleave(torch.arange(P, device=device), n_cand)
    first = torch.cumsum(n_cand, 0) - n_cand
    slot = torch.arange(gid.shape[0], device=device) - first[gid]
    nxg = n_x[gid]
    ty = min_y[gid].long() + slot // nxg
    tx = min_x[gid].long() + slot % nxg

    # 3. exact peak-alpha cull
    live = peak_alpha_live(mean2d[gid], conic[gid], opacity[gid], tx, ty, tile_h, tile_w)
    gid, tx, ty = gid[live], tx[live], ty[live]

    # 4. one sort of (tile << 32 | depth rank) keys; the keys are unique, so
    # the order is fixed
    tile = ty * grid_w + tx
    keys, perm = torch.sort((tile << 32) | rank[gid])
    pair_gaussian = order[keys & 0xFFFFFFFF].to(torch.int32)

    # 5. per-tile ranges; per-Gaussian ranges through the inverse permutation
    # (gid is sorted, so candidate slot perm[i] of pair i is in Gaussian order)
    tile_count = torch.bincount(keys >> 32, minlength=num_tiles)
    gaussian_pairs = torch.empty_like(perm)
    gaussian_pairs[perm] = torch.arange(perm.shape[0], device=device)

    def offsets(counts):
        out = torch.zeros(counts.shape[0] + 1, dtype=torch.int64, device=device)
        out[1:] = torch.cumsum(counts, 0)
        return out.to(torch.int32)

    return PairList(
        pair_gaussian=pair_gaussian,
        tile_offsets=offsets(tile_count),
        tile_count=tile_count.to(torch.int32),
        overflow=torch.zeros((), dtype=torch.int32, device=device),
        gaussian_pairs=gaussian_pairs.to(torch.int32),
        gaussian_offsets=offsets(torch.bincount(gid, minlength=P)),
    )


def _bin_budgeted(mean2d, conic, opacity, depth, radius, radius_xy, valid, height: int,
                  width: int, tile_h: int, tile_w: int, pair_budget: int, B: int) -> PairList:
    """bin_pairs at the capacity NPb: no data-dependent shape and no host read."""
    device = mean2d.device
    P = mean2d.shape[0]
    grid_h, grid_w = -(-height // tile_h), -(-width // tile_w)
    num_tiles = grid_h * grid_w
    k = _budgeted_keys(mean2d, conic, opacity, depth, radius, radius_xy, valid, grid_h,
                       grid_w, tile_h, tile_w, B)
    NPb = npb(P, pair_budget, num_tiles, B)
    keys, perm = k.keys[:NPb], k.perm[:NPb]
    tiles = torch.arange(num_tiles + 1, device=device) << 32
    tile_offsets = torch.searchsorted(keys, tiles)
    kept = tile_offsets[num_tiles]
    pair_gaussian = k.order[keys & 0xFFFFFFFF].to(torch.int32)

    # per-Gaussian ranges: each kept candidate's place among the kept ones in
    # Gaussian order (an exclusive cumsum), scattered to by its pair; the
    # positions past the kept count hold themselves
    pos = torch.arange(NPb, device=device)
    is_kept = pos < kept
    kept_c = torch.zeros(P * B, dtype=torch.int64, device=device)
    kept_c.scatter_(0, perm, is_kept.to(torch.int64))
    csum = torch.cumsum(kept_c, 0)
    dest = torch.where(is_kept, (csum - kept_c)[perm], pos)
    gaussian_pairs = torch.empty_like(pos).scatter_(0, dest, pos)
    gaussian_offsets = torch.cat([csum.new_zeros(1), csum.reshape(P, B)[:, -1]])
    budget_overflow = k.total_live - kept.to(torch.int32)
    return PairList(
        pair_gaussian=pair_gaussian,
        tile_offsets=tile_offsets.to(torch.int32),
        tile_count=(tile_offsets[1:] - tile_offsets[:-1]).to(torch.int32),
        overflow=k.rect_overflow + budget_overflow,
        gaussian_pairs=gaussian_pairs.to(torch.int32),
        gaussian_offsets=gaussian_offsets.to(torch.int32),
    )


def kept_pair_mask(pairs: PairList, num_gaussians: int, num_tiles: int):
    """(P, num_tiles) bool: which (Gaussian, tile) pairs the list keeps, with
    fixed shapes (the plain blend reads it in place of the tile rect)."""
    device = pairs.tile_offsets.device
    n = pairs.num_pairs
    pos = torch.arange(n, device=device)
    tile = torch.searchsorted(pairs.tile_offsets.long(), pos, right=True) - 1
    flat = torch.where(pos < pairs.tile_offsets[num_tiles].long(),
                       pairs.pair_gaussian.long() * num_tiles + tile, num_gaussians * num_tiles)
    mask = torch.zeros(num_gaussians * num_tiles + 1, dtype=torch.bool, device=device)
    mask[flat] = True
    return mask[:-1].reshape(num_gaussians, num_tiles)
