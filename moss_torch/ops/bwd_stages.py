"""The backward blend kernel by stages: csrc/rasterize_bwd.cu's stage entry and its plain version.

Port of the stage-ablated copies of _bwd_kernel in
tools/bwd_kernel_floor.py::make_kernel.kern (:97), for the cost accounting of
tools/bwd_kernel_floor.py (moss_torch/tools/bwd_kernel_floor.py). Each stage
adds work to the one before it (csrc/rasterize_bwd.cu has the details):

  load       the batch loop, the staging of pair data, the gimg loads and
             the row writes; it walks every pair
  recompute  + the forward's blend step and T, with its stops
  suffix     + dL/dw, the prefix, s_after and dL/dpower
  full       + the per-pair sums and the row assembly: the production kernel
  full_soa   full with the rows written column-major, (10, num_pairs)

rasterize_bwd_stage returns (rows, observe). For full the rows are the
production kernel's per-pair gradient rows, for full_soa their transpose; for
the ablated stages the rows are each pair's staged data (mean2d, conic,
opacity, colour, depth) and observe (H, W) is each pixel's sum of its six
gradient values and of the stage's last quantity over the pairs it walked:
the six staged geometry values for load, w for recompute, dL/dpower for
suffix. A batch of 128 pairs (counted from the start of its tile segment,
csrc/blend_common.cuh) is staged only while some pixel of the segment
blends, so rows after a whole-tile stop stay 0. These observers keep nvcc
from deleting an ablated stage, and let a run check that each stage did its
work. Since the kernel walks tile segments (ops/split_blend.py), a split
tile's later segments add their observer sums to the first's in a second
kernel, part of an ablated stage's launch and time.

bwd_stage_plain computes the same outputs with tensors over every (pair,
pixel) of the pair list: T before each pair from a per-tile cumulative sum of
log(1 - alpha) in f64, the stop where T (1 - alpha) < 1e-4, the prefix of
w dL/dw in f64, then the per-pair sums. It is the plain version of the
backward kernel's per-pair rows, not only of its stages. On a CPU tensor
rasterize_bwd_stage runs it; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from . import rasterize_cuda as rc
from .binning import PairList
from .projection import Projected
from .rasterize_ref import ALPHA_MAX, ALPHA_MIN, T_EPS

STAGES = ("load", "recompute", "suffix", "full", "full_soa")
ABLATED = STAGES[:3]

# kernel launches since the last reset (set to 0 to count a run)
launches = 0

# stage; 8 input pointers; height, width, grid_w, num_tiles, num_pairs, seg_len, num_slots;
# state, rows, observe, observe_part
_SIGNATURE = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4


def rasterize_bwd_stage(pairs: PairList, proj: Projected, gimg, height: int, width: int,
                        stage: str, state=None):
    """(rows, observe) of the backward kernel at `stage`: rows (num_pairs,
    10), (10, num_pairs) for full_soa; observe (H, W) for the ablated stages,
    None for full and full_soa. gimg and state (needed on a CUDA tensor) as
    rc.rasterize_pairs_bwd takes them at rc.SEGMENT."""
    global launches
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r}: expected one of {STAGES}")
    device = proj.mean2d.device
    if device.type == "cpu":
        return bwd_stage_plain(pairs, proj, gimg, height, width, stage)
    grid_w, num_tiles = rc._check_pairs(pairs, device, height, width, proj.mean2d.shape[0])
    rc.check_kernel_inputs(proj, device)
    rc.check_gimg(gimg, device, height, width)
    if state is None:
        raise ValueError("rasterize_bwd_stage on a CUDA tensor needs the forward's state")
    slots = rc.check_state(state, pairs, num_tiles, rc.SEGMENT)
    shape = (rc.GRAD_COLS, pairs.num_pairs) if stage == "full_soa" else (pairs.num_pairs,
                                                                          rc.GRAD_COLS)
    rows = torch.zeros(shape, dtype=torch.float32, device=device)
    observe = part = None
    if stage in ABLATED:
        observe = torch.empty((height, width), dtype=torch.float32, device=device)
        part = torch.empty((slots, rc.TILE * rc.TILE), dtype=torch.float32, device=device)
    cuda_build.launch("rasterize_bwd", "moss_rasterize_bwd_stage", _SIGNATURE, device,
                      STAGES.index(stage), pairs.tile_offsets.data_ptr(),
                      pairs.pair_gaussian.data_ptr(),
                      *(getattr(proj, f).data_ptr() for f in rc._KERNEL_FIELDS), gimg.data_ptr(),
                      height, width, grid_w, num_tiles, pairs.num_pairs, rc.SEGMENT, slots,
                      state.data_ptr(), rows.data_ptr(),
                      *(0 if x is None else x.data_ptr() for x in (observe, part)))
    launches += 1
    return rows, observe


def seg_cumsum(x, start, t):
    """Inclusive cumulative sum of x over its pair axis (dim 0), restarted
    at every tile's first pair; start: each tile's first pair, t: each
    pair's tile."""
    cs = torch.cumsum(x, 0)
    base = torch.where((start > 0)[:, None], cs[(start - 1).clamp_min(0)], 0)
    return cs - base[t]


def bwd_stage_plain(pairs: PairList, proj: Projected, gimg, height: int, width: int,
                    stage: str):
    """rasterize_bwd_stage's outputs in plain PyTorch (module docstring)."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r}: expected one of {STAGES}")
    device = proj.mean2d.device
    g = pairs.pair_gaussian.long()
    staged = torch.cat([proj.mean2d[g], proj.conic[g], proj.opacity[g, None], proj.color[g],
                        proj.depth[g, None]], dim=1)
    gsum = gimg[0] + gimg[1] + gimg[2] + gimg[3] + gimg[4] + gimg[5]  # the kernel's order
    if pairs.num_pairs == 0:
        rows = torch.zeros((pairs.num_pairs, rc.GRAD_COLS), device=device)
        return (rows.T.contiguous() if stage == "full_soa" else rows,
                gsum if stage in ABLATED else None)

    tile = rc.TILE
    grid_w = -(-width // tile)
    num_tiles = pairs.tile_count.shape[0]
    t = torch.repeat_interleave(torch.arange(num_tiles, device=device), pairs.tile_count.long())
    lane = torch.arange(tile * tile, device=device)
    px = ((t % grid_w) * tile)[:, None] + lane % tile  # (num_pairs, 256)
    py = ((t // grid_w) * tile)[:, None] + lane // tile
    inside = (px < width) & (py < height)
    pix = torch.where(inside, py * width + px, 0)

    if stage == "load":
        # every pair is walked; its six geometry values, summed left to right
        v = staged[:, 0]
        for k in range(1, 6):
            v = v + staged[:, k]
        sums = torch.zeros(num_tiles, dtype=torch.float64, device=device)
        sums.index_add_(0, t, v.double())
        tile_of_pixel = ((torch.arange(height, device=device) // tile)[:, None] * grid_w
                         + torch.arange(width, device=device) // tile)
        return staged, gsum + sums[tile_of_pixel].float()

    gp = torch.where(inside[None], gimg.reshape(6, -1)[:, pix], 0.0)  # (6, num_pairs, 256)
    dx = proj.mean2d[g, 0:1] - px.float()
    dy = proj.mean2d[g, 1:2] - py.float()
    a, b, c = proj.conic[g, 0:1], proj.conic[g, 1:2], proj.conic[g, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(proj.opacity[g, None] * torch.exp(power), ALPHA_MAX)
    m = (power <= 0) & (alpha >= ALPHA_MIN) & inside
    start = pairs.tile_offsets[:-1].long()
    log1m = torch.where(m, torch.log1p(-alpha.double()), 0.0)
    T = torch.exp(seg_cumsum(log1m, start, t) - log1m).float()  # before the pair
    test_T = T * (1.0 - alpha)
    fired = m & (test_T < T_EPS)
    stopped = (seg_cumsum(fired.int(), start, t) - fired.int()) > 0  # stopped before it
    live = m & ~fired & ~stopped
    w = torch.where(live, alpha * T, 0.0)
    # the kernel stages a batch of 128 pairs of a tile segment only while some
    # pixel of the tile is still blending; the rows of the batches after it stay 0
    k = torch.arange(pairs.num_pairs, device=device)
    seg_start = start[t] + (k - start[t]) // rc.SEGMENT * rc.SEGMENT
    batch_start = seg_start + (k - seg_start) // 128 * 128
    staged = torch.where((inside & ~stopped).any(1)[batch_start, None], staged, 0.0)

    def per_pixel(x):
        """(H, W) sum over the pairs of each pixel's (num_pairs, 256) values."""
        out = torch.zeros(height * width, dtype=torch.float64, device=device)
        out.index_add_(0, pix[inside], x[inside].double())
        return out.reshape(height, width).float()

    if stage == "recompute":
        return staged, gsum + per_pixel(w)
    col, dep = proj.color[g], proj.depth[g, None]
    dl_dw = col[:, 0:1] * gp[0] + col[:, 1:2] * gp[1] + col[:, 2:3] * gp[2] + dep * gp[3] + gp[4]
    prefix = seg_cumsum((w * dl_dw).double(), start, t).float()
    s_after = gp[5] - prefix
    dp = torch.where(live & (alpha < ALPHA_MAX), (dl_dw * T - s_after / (1.0 - alpha)) * alpha,
                     0.0)
    if stage == "suffix":
        return staged, gsum + per_pixel(dp)

    s = [(dp * dx).sum(1), (dp * dy).sum(1), (dp * dx * dx).sum(1), (dp * dx * dy).sum(1),
         (dp * dy * dy).sum(1), dp.sum(1), (w * gp[0]).sum(1), (w * gp[1]).sum(1),
         (w * gp[2]).sum(1), (w * gp[3]).sum(1)]
    a, b, c = a[:, 0], b[:, 0], c[:, 0]
    rows = torch.stack([-(a * s[0] + b * s[1]), -(c * s[1] + b * s[0]), -0.5 * s[2], -s[3],
                        -0.5 * s[4], s[5] / torch.clamp_min(proj.opacity[g], 1e-12), *s[6:]], 1)
    return (rows.T.contiguous(), None) if stage == "full_soa" else (rows, None)

