"""The work a training step needs, counted from its shapes, and the H100's peaks.

What step_mfu and blend_roofline divide by. Every count is of what these
inputs need, whatever implements it, so a later redesign is measured by the
same yardstick.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit (the
card's power.limit is recorded beside every run): 989e12 bf16 FLOP/s on the
tensor cores, 67e12 f32 FLOP/s on the CUDA cores, 3.35e12 HBM bytes/s.

The blend (moss_torch/csrc/rasterize_fwd.cu, rasterize_bwd.cu,
segment_sum.cu), per frame, over the (Gaussian, tile) pairs a Gaussian can
reach (its reference rect, kept where its alpha reaches 1/255 at some pixel
of the tile: a pair that contributes nowhere need not be listed), each pixel
walking its tile's depth-ordered pairs until it stops, the stopping pair
included (chip_smoke.py's blend_work):
  * an evaluation (dx, dy, the quadratic form, expf, op e, min) is 14 f32
    operations; a contribution adds 13 forward (1 - alpha, T (1 - alpha),
    alpha T, five multiply-adds) and 38 backward (w, T (1 - alpha), dL/dw, the
    prefix, s_after, dL/dpower, the ten per-pair values and their ten adds);
  * forward bytes: the pair list and tile offsets, ten floats a Gaussian,
    six image planes; backward: those plus ten floats a pair written; the
    segment sum: ten floats a pair and its index read, ten a Gaussian
    written, one add a value (chip_smoke.py's kernel_bound, bwd_bound,
    segment_bound);
  * a kernel's bound is the larger of its bytes over HBM's rate and its
    operations over the f32 rate.

The step's other parts, at the precision each runs in:
  * LPIPS: VGG16's 13 3x3 convolutions on the crop (2 * 9 * C_in * C_out a
    pixel each, the map halved after each stage but the last), in bf16 on
    the tensor cores: the prediction's forward and its backward (the input's
    gradient only: the backbone is frozen), and the ground truth's forward
    when its tower is not cached;
  * SSIM and S3IM on the crop, f32: five fields blurred by two 11-tap
    passes (44 operations a pixel and channel each), and S3IM's ten phases
    of a 2-tap mix (3 each) on its vertical pass, with 20 operations of the
    map a pixel and channel on 1 and 10 phases; the backward counted as twice
    the forward;
  * the LBS-weight field on every live Gaussian, f32 GEMMs (2 operations a
    multiply-add): 63-128-128-128-(128+63)-128-24, the 24x24 query, the
    attention over 9; backward twice the forward. The pose MLP (one
    69-vector) is left out.
The deform chain, SH, projection, binning and AdamW are elementwise and
memory-bound; they count no operations here.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_EVAL = 14
OPS_PER_CONTRIB = 13
OPS_PER_CONTRIB_BWD = 38
GRAD_COLS = 10
TILE = 16
VGG16 = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
LBS_LAYERS = [(63, 128), (128, 128), (128, 128), (191, 128), (128, 24), (24, 24)]
LBS_ATTENTION = 2 * 24 * 9 + 2 * 9 * 24  # Q K and attn V^T a point


def peaks() -> Dict[str, float]:
    return {"bf16_flops": PEAK_BF16, "f32_flops": PEAK_F32, "hbm_bytes": PEAK_BYTES}


def vgg16_flops(h: int, w: int) -> int:
    """One forward of the LPIPS tower on an (h, w) image."""
    total, c_in = 0, 3
    for c_out, n in VGG16:
        for _ in range(n):
            total += 2 * 9 * c_in * c_out * h * w
            c_in = c_out
        h, w = max(h // 2, 1), max(w // 2, 1)
    return total


def ssim_flops(h: int, w: int, channels: int = 3, repeat: int = 10) -> int:
    """SSIM and S3IM forward on an (h, w) crop."""
    px = h * w * channels
    ssim = 5 * 2 * 44 * px + 20 * px
    s3im = 5 * (44 * px + repeat * 3 * px) + 20 * repeat * px
    return ssim + s3im


def lbs_flops(points: int) -> int:
    return points * (sum(2 * a * b for a, b in LBS_LAYERS) + LBS_ATTENTION)


def blend_work(proj, height: int, width: int, tile: int = TILE,
               max_pairs: int = 1 << 17) -> Dict[str, int]:
    """{"evaluations", "contributions", "pairs", "tiles", "gaussians"} that
    one frame's projected Gaussians need (module docstring), counted in
    float64 tile groups of at most max_pairs pairs."""
    from .reference.blend import tile_pairs

    g, t, counts = tile_pairs(proj, height, width, tile)
    grid_w = -(-width // tile)
    lane = torch.arange(tile * tile, device=g.device)
    px = ((t % grid_w) * tile)[:, None] + lane % tile
    py = ((t // grid_w) * tile)[:, None] + lane // tile
    keep = torch.zeros(g.shape[0], dtype=torch.bool, device=g.device)
    for s in range(0, g.shape[0], max_pairs):
        sl = slice(s, s + max_pairs)
        _, m = _alpha(proj, g[sl], px[sl], py[sl], height, width)
        keep[sl] = m.any(1)
    g, t = g[keep], t[keep]
    px, py = px[keep], py[keep]
    n_tiles = -(-height // tile) * grid_w
    counts = torch.bincount(t, minlength=n_tiles)
    offsets = torch.cumsum(counts, 0) - counts
    evals = contribs = 0
    t0 = 0
    cum = torch.cumsum(counts, 0)
    while t0 < n_tiles:
        t1 = int(torch.searchsorted(cum, offsets[t0] + max_pairs, right=True))
        t1 = min(max(t1, t0 + 1), n_tiles)
        lo, hi = int(offsets[t0]), int(offsets[t0] + counts[t0:t1].sum())
        if hi > lo:
            alpha, m = _alpha(proj, g[lo:hi], px[lo:hi], py[lo:hi], height, width)
            seg = t[lo:hi] - t0
            start = (offsets[t0:t1] - lo)[seg]
            log_T = _seg_cumsum(torch.where(m, torch.log1p(-alpha.double()), 0.0), start)
            fired = m & (log_T < math.log(1e-4))
            before = _seg_cumsum(fired.long(), start) - fired.long()
            inside = (px[lo:hi] < width) & (py[lo:hi] < height)
            evaluated = (before == 0) & inside
            evals += int(evaluated.sum())
            contribs += int((evaluated & m & ~fired).sum())
        t0 = t1
    return {"evaluations": evals, "contributions": contribs, "pairs": int(g.shape[0]),
            "tiles": n_tiles, "gaussians": int(torch.unique(g).numel())}


def _alpha(proj, g, px, py, height: int, width: int):
    dx = proj.mean2d[g, 0:1] - px
    dy = proj.mean2d[g, 1:2] - py
    a, b, c = proj.conic[g, 0:1], proj.conic[g, 1:2], proj.conic[g, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(proj.opacity[g, None] * torch.exp(power), 0.99)
    return alpha, (power <= 0) & (alpha >= 1.0 / 255.0) & (px < width) & (py < height)


def _seg_cumsum(x, start):
    """Inclusive cumulative sum along dim 0 restarting at each pair's tile
    start (start: each row's first row in x)."""
    c = torch.cumsum(x, 0)
    base = torch.where(start[:, None] > 0, c[(start - 1).clamp_min(0)], torch.zeros_like(c[:1]))
    return c - base


def blend_bounds(work: Dict[str, int], height: int, width: int) -> Dict[str, float]:
    """Seconds of the forward, backward and segment-sum kernels at the peaks."""
    P, n, T = work["gaussians"], work["pairs"], work["tiles"]
    fwd_bytes = 4 * (n + T + 10 * P + 6 * height * width)
    bwd_bytes = fwd_bytes + 4 * GRAD_COLS * n
    seg_bytes = 4 * (GRAD_COLS * n + n + (P + 1) + GRAD_COLS * P)
    fwd_ops = OPS_PER_EVAL * work["evaluations"] + OPS_PER_CONTRIB * work["contributions"]
    bwd_ops = OPS_PER_EVAL * work["evaluations"] + OPS_PER_CONTRIB_BWD * work["contributions"]
    return {"fwd": max(fwd_bytes / PEAK_BYTES, fwd_ops / PEAK_F32),
            "bwd": max(bwd_bytes / PEAK_BYTES, bwd_ops / PEAK_F32),
            "segment": max(seg_bytes / PEAK_BYTES, GRAD_COLS * n / PEAK_F32)}


def step_seconds_at_peak(work: Dict[str, int], crop_hw: Tuple[int, int], live: int,
                         gt_tower_cached: bool) -> Dict[str, float]:
    """The least seconds of one step's counted parts, each at its peak."""
    h, w = crop_hw
    vgg = vgg16_flops(h, w) * (2 if gt_tower_cached else 3)
    blend = (2 * OPS_PER_EVAL * work["evaluations"]
             + (OPS_PER_CONTRIB + OPS_PER_CONTRIB_BWD) * work["contributions"])
    return {"lpips": vgg / PEAK_BF16, "ssim_s3im": 3 * ssim_flops(h, w) / PEAK_F32,
            "lbs_field": 3 * lbs_flops(live) / PEAK_F32, "blend": blend / PEAK_F32}
