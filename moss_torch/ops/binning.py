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

The pair list is sized per frame from the live pair count, so there is no
static budget and nothing overflows. The 8x128-supertile, lane-group and
aligned-chunk layout of build_pair_rows (steps 6-8) exists for Mosaic and has
no counterpart here.
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
    overflow: () int32, always 0: every live pair is kept.
    gaussian_pairs: (num_pairs,) int32 positions in the pair list, grouped by
      Gaussian; Gaussian g's pairs sit at
      gaussian_pairs[gaussian_offsets[g]:gaussian_offsets[g + 1]], in tile order.
    gaussian_offsets: (P + 1,) int32.
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


def bin_pairs(mean2d, conic, opacity, depth, radius, radius_xy, valid,
              height: int, width: int, tile_h: int = 16, tile_w: int = 16) -> PairList:
    """Build the pair list (module docstring steps 1-5)."""
    device = mean2d.device
    P = mean2d.shape[0]
    grid_h = -(-height // tile_h)
    grid_w = -(-width // tile_w)
    num_tiles = grid_h * grid_w

    # 1. depth order and each Gaussian's rank in it
    order = torch.argsort(torch.where(valid, depth, float("inf")), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(P, device=device)

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
