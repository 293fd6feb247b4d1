"""Tile rasterizer on the GPU: binning + the hand-written CUDA blend kernels.

Replaces moss_tpu/ops/rasterize_tpu.py::rasterize_tpu: the pair list comes
from ops/binning.bin_pairs at 16x16 tiles, the blend from
csrc/rasterize_fwd.cu (the port of _fwd_kernel) and its gradient from
csrc/rasterize_bwd.cu (the port of _bwd_kernel) plus csrc/segment_sum.cu,
which sums the per-pair gradient rows into Gaussians in a fixed order (the
VJP of binning._gather_rows), all inside one torch.autograd.Function. The
return dict matches rasterize_reference's plus `overflow`, the pairs the
binning dropped: 0 for the per-frame pair list (both budgets 0), the rect
cap's and the pair budget's drops with moss_tpu's static budgets
(pair_budget, max_tiles_per_gaussian; ops/binning.py). `bg` is added outside
the kernels, as rasterize_tpu.py:741-744 does, so its gradient is autograd's.

With budgets the pair arrays have the capacity NPb and no host reads a pair
count: the kernels launch num_tiles + ceil(NPb / S) CTAs, each reads the live
count tile_offsets[num_tiles] on the device and the surplus ones return
(csrc/blend_common.cuh segment_of), the forward's state and the backward's
rows are sized by the capacity, and the rows past the live count stay zero
and are read by no Gaussian's range.

Both blend kernels cut a tile of more than `seg_len` pairs into segments of
at most seg_len, one CTA each (ops/split_blend.py has the scheme and its
plain version): the forward launches one kernel twice (the tiles' first
segments, and the local products of the segments between a split tile's
first and last; then the later segments' blends, the last of a tile's CTAs
merging in segment order), once when no tile can be split, and returns, beside
the planes, the segments' state, from which the backward's CTAs start with
no exchange between them. seg_len defaults to SEGMENT, the one length the
training and serving paths use.

On a CPU tensor the wrapper runs the plain version (ops/rasterize_ref.py) at
the same tile shape, with autograd, reading the budgeted list's kept pairs
in place of the tile rect when there are budgets; on a CUDA tensor it
launches the kernels or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .binning import PairList, bin_pairs, kept_pair_mask
from .projection import Projected
from .rasterize_ref import rasterize_reference
from .split_blend import GRAD_COLS, num_slots

TILE = 16  # csrc/blend_common.cuh kTile
SEGMENT = 96  # pairs a blend kernel's CTA walks at most; longer tiles are split (PERF.md, §6)
STATE_PLANES = 9  # csrc/blend_common.cuh kStatePlanes: per (slot, pixel) segment state
SEGMENT_LONG = 32  # csrc/segment_sum.cu kLong: longer segments are summed by a whole warp

# launches since the last reset (set to 0 to count a run)
launches = 0          # rasterize_fwd (one call: two launches of its kernel, one when none splits)
bwd_launches = 0      # rasterize_bwd
segment_launches = 0  # segment_sum
# calls made while a CUDA graph captures the stream: recorded, not launched
# (the graph's replays run them); not in the counts above
captured = {"rasterize_fwd": 0, "rasterize_bwd": 0, "segment_sum": 0}

_KERNEL_FIELDS = ("mean2d", "conic", "opacity", "color", "depth")
_C_SIGNATURES = {
    # 7 input pointers; height, width, grid_w, num_tiles, num_pairs, seg_len, num_slots;
    # out, state, tickets
    ("rasterize_fwd", "moss_rasterize_fwd"): [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_void_p] * 3,
    # 8 input pointers (the 7 above + gimg); height, width, grid_w, num_tiles, num_pairs,
    # seg_len, num_slots; state, rows
    ("rasterize_bwd", "moss_rasterize_bwd"): [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_void_p] * 2,
    # rows, gaussian_pairs, offsets; num_gaussians; out
    ("segment_sum", "moss_segment_sum"): [ctypes.c_void_p] * 3 + [ctypes.c_int]
    + [ctypes.c_void_p],
}


def _launch(lib: str, symbol: str, device, *args):
    cuda_build.launch(lib, symbol, _C_SIGNATURES[(lib, symbol)], device, *args)


def check_kernel_inputs(proj: Projected, device: torch.device):
    """Raise unless the fields the kernels read are contiguous f32 on `device`
    with the shapes they index: (P,2), (P,3), (P,), (P,3), (P,)."""
    P = proj.mean2d.shape[0]
    shapes = {"mean2d": (P, 2), "conic": (P, 3), "opacity": (P,), "color": (P, 3),
              "depth": (P,)}
    for name in _KERNEL_FIELDS:
        t = getattr(proj, name)
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"proj.{name}: expected float32 on {device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"proj.{name}: expected shape {shapes[name]}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"proj.{name} must be contiguous")


def _check_pairs(pairs: PairList, device, height: int, width: int, P: int):
    """(grid_w, num_tiles) after checking the pair list the kernels index."""
    if device.type != "cuda":
        raise ValueError(f"the blend kernels run on a CUDA device, got {device}")
    grid_w = -(-width // TILE)
    num_tiles = -(-height // TILE) * grid_w
    for name in ("tile_offsets", "pair_gaussian", "gaussian_pairs", "gaussian_offsets"):
        t = getattr(pairs, name)
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"pairs.{name}: expected contiguous int32 on {device}")
    if tuple(pairs.tile_offsets.shape) != (num_tiles + 1,):
        raise ValueError(f"pairs.tile_offsets: expected ({num_tiles + 1},) for {height}x{width}")
    if tuple(pairs.gaussian_offsets.shape) != (P + 1,):
        raise ValueError(f"pairs.gaussian_offsets: expected ({P + 1},) for {P} Gaussians")
    return grid_w, num_tiles


def check_gimg(gimg, device, height: int, width: int):
    if (gimg.device != device or gimg.dtype != torch.float32 or not gimg.is_contiguous()
            or tuple(gimg.shape) != (6, height, width)):
        raise ValueError(f"gimg: expected contiguous float32 (6, {height}, {width}) on {device}")


def check_state(state, pairs: PairList, num_tiles: int, seg_len: int):
    """Raise unless `state` is the forward's segment state for this pair list
    and seg_len; returns its slot count."""
    if seg_len < 1:
        raise ValueError(f"seg_len must be positive, got {seg_len}")
    slots = num_slots(num_tiles, pairs.num_pairs, seg_len)
    if (state.device != pairs.tile_offsets.device or state.dtype != torch.float32
            or not state.is_contiguous()
            or tuple(state.shape) != (slots, STATE_PLANES, TILE * TILE)):
        raise ValueError(f"state: expected contiguous float32 ({slots}, {STATE_PLANES}, "
                         f"{TILE * TILE}) for seg_len {seg_len}, got {tuple(state.shape)}")
    return slots


def rasterize_pairs(pairs: PairList, proj: Projected, height: int, width: int,
                    seg_len: int = SEGMENT):
    """Launch the blend kernels on a built pair list: ((6, H, W) f32 planes
    r, g, b, depth, alpha (sum of weights), final_T; the segment state that
    rasterize_pairs_bwd takes)."""
    global launches
    device = proj.mean2d.device
    grid_w, num_tiles = _check_pairs(pairs, device, height, width, proj.mean2d.shape[0])
    check_kernel_inputs(proj, device)
    if seg_len < 1:
        raise ValueError(f"seg_len must be positive, got {seg_len}")
    slots = num_slots(num_tiles, pairs.num_pairs, seg_len)
    out = torch.empty((6, height, width), dtype=torch.float32, device=device)
    state = torch.empty((slots, STATE_PLANES, TILE * TILE), dtype=torch.float32, device=device)
    tickets = torch.empty((num_tiles,), dtype=torch.int32, device=device)  # the kernels zero them
    _launch("rasterize_fwd", "moss_rasterize_fwd", device,
            pairs.tile_offsets.data_ptr(), pairs.pair_gaussian.data_ptr(),
            *(getattr(proj, f).data_ptr() for f in _KERNEL_FIELDS),
            height, width, grid_w, num_tiles, pairs.num_pairs, seg_len, slots,
            out.data_ptr(), state.data_ptr(), tickets.data_ptr())
    if torch.cuda.is_current_stream_capturing():
        captured["rasterize_fwd"] += 1
    else:
        launches += 1
    return out, state


def rasterize_pairs_bwd(pairs: PairList, proj: Projected, gimg, height: int, width: int,
                        state, seg_len: int = SEGMENT):
    """Launch the backward kernel: (num_pairs, 10) f32 per-pair gradient rows,
    in pair-list order. gimg: (6, H, W) f32 upstream grads of r, g, b, depth,
    alpha, then Qtail (see csrc/rasterize_bwd.cu); state: rasterize_pairs's,
    at the same seg_len."""
    global bwd_launches
    device = proj.mean2d.device
    grid_w, num_tiles = _check_pairs(pairs, device, height, width, proj.mean2d.shape[0])
    check_kernel_inputs(proj, device)
    check_gimg(gimg, device, height, width)
    slots = check_state(state, pairs, num_tiles, seg_len)
    rows = torch.zeros((pairs.num_pairs, GRAD_COLS), dtype=torch.float32, device=device)
    _launch("rasterize_bwd", "moss_rasterize_bwd", device,
            pairs.tile_offsets.data_ptr(), pairs.pair_gaussian.data_ptr(),
            *(getattr(proj, f).data_ptr() for f in _KERNEL_FIELDS), gimg.data_ptr(),
            height, width, grid_w, num_tiles, pairs.num_pairs, seg_len, slots,
            state.data_ptr(), rows.data_ptr())
    if torch.cuda.is_current_stream_capturing():
        captured["rasterize_bwd"] += 1
    else:
        bwd_launches += 1
    return rows


def segment_sum_plain(rows, pairs: PairList):
    """The plain version of the segment sum: (P, C) sums of `rows` (pair-list
    order) over each Gaussian's pairs."""
    P = pairs.gaussian_offsets.shape[0] - 1
    lengths = (pairs.gaussian_offsets[1:] - pairs.gaussian_offsets[:-1]).long()
    if rows.shape[0] == 0:
        return rows.new_zeros((P, rows.shape[1]))
    return torch.segment_reduce(rows[pairs.gaussian_pairs.long()], "sum", lengths=lengths)


def segment_sum(rows, pairs: PairList):
    """(P, 10) per-Gaussian sums of the per-pair gradient rows, in a fixed
    order: csrc/segment_sum.cu on a CUDA tensor, the plain version on a CPU one."""
    global segment_launches
    device = rows.device
    if device.type == "cpu":
        return segment_sum_plain(rows, pairs)
    P = pairs.gaussian_offsets.shape[0] - 1
    for name in ("gaussian_pairs", "gaussian_offsets"):
        t = getattr(pairs, name)
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"pairs.{name}: expected contiguous int32 on {device}")
    if (rows.dtype != torch.float32 or not rows.is_contiguous()
            or tuple(rows.shape) != (pairs.num_pairs, GRAD_COLS)):
        raise ValueError(f"rows: expected contiguous float32 ({pairs.num_pairs}, {GRAD_COLS})")
    out = torch.empty((P, GRAD_COLS), dtype=torch.float32, device=device)
    _launch("segment_sum", "moss_segment_sum", device, rows.data_ptr(),
            pairs.gaussian_pairs.data_ptr(), pairs.gaussian_offsets.data_ptr(), P,
            out.data_ptr())
    if torch.cuda.is_current_stream_capturing():
        captured["segment_sum"] += 1
    else:
        segment_launches += 1
    return out


class _Blend(torch.autograd.Function):
    """The five per-Gaussian fields -> the (6, H, W) planes, through the
    kernels both ways. The pair list rides along as a constant."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, color, depth, pairs, height, width):
        proj = Projected(mean2d=mean2d, depth=depth, conic=conic, radius=None,
                         color=color, opacity=opacity, valid=None)
        img, state = rasterize_pairs(pairs, proj, height, width)
        ctx.save_for_backward(mean2d, conic, opacity, color, depth, img, state)
        ctx.pairs = pairs
        return img

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_img):
        mean2d, conic, opacity, color, depth, img, state = ctx.saved_tensors
        proj = Projected(mean2d=mean2d, depth=depth, conic=conic, radius=None,
                         color=color, opacity=opacity, valid=None)
        # Qtail = sum of g * out over the six planes, the g_T T term included
        gimg = torch.cat([g_img[:5], (g_img * img).sum(0, keepdim=True)]).contiguous()
        rows = rasterize_pairs_bwd(ctx.pairs, proj, gimg, img.shape[1], img.shape[2], state)
        grads = segment_sum(rows, ctx.pairs)
        return (grads[:, 0:2], grads[:, 2:5], grads[:, 5], grads[:, 6:9], grads[:, 9],
                None, None, None)


def bin_projected(proj: Projected, height: int, width: int, pair_budget: int = 0,
                  max_tiles_per_gaussian: int = 0) -> PairList:
    with torch.no_grad():
        return bin_pairs(proj.mean2d, proj.conic, proj.opacity, proj.depth, proj.radius,
                         proj.radius_xy, proj.valid, height, width, TILE, TILE,
                         pair_budget=pair_budget, max_tiles_per_gaussian=max_tiles_per_gaussian)


def rasterize_cuda(proj: Projected, bg_color, height: int, width: int, pair_budget: int = 0,
                   max_tiles_per_gaussian: int = 0):
    """Drop-in for rasterize_reference (same dict, plus `overflow`), differentiable
    in mean2d, conic, opacity, color, depth and bg_color. pair_budget and
    max_tiles_per_gaussian: the binning's static budgets (both 0: the
    per-frame pair list)."""
    device = proj.mean2d.device
    budgets = dict(pair_budget=pair_budget, max_tiles_per_gaussian=max_tiles_per_gaussian)
    if device.type == "cpu":
        if pair_budget == 0 and max_tiles_per_gaussian == 0:
            out = rasterize_reference(proj, bg_color, height, width, tile_h=TILE, tile_w=TILE)
            out["overflow"] = torch.zeros((), dtype=torch.int32)
            return out
        pairs = bin_projected(proj, height, width, **budgets)
        num_tiles = pairs.tile_offsets.shape[0] - 1
        mask = kept_pair_mask(pairs, proj.mean2d.shape[0], num_tiles)
        out = rasterize_reference(proj, bg_color, height, width, tile_h=TILE, tile_w=TILE,
                                  pair_mask=mask)
        out["overflow"] = pairs.overflow
        return out
    if device.type != "cuda":
        raise ValueError(f"rasterize_cuda runs on CPU or CUDA tensors, got {device}")
    if bg_color.device != device or tuple(bg_color.shape) != (3,):
        raise ValueError(f"bg_color: expected shape (3,) on {device}")
    pairs = bin_projected(proj, height, width, **budgets)
    img = _Blend.apply(*(getattr(proj, f) for f in _KERNEL_FIELDS), pairs, height, width)
    final_T = img[5]
    color = img[:3].permute(1, 2, 0) + final_T[..., None] * bg_color[None, None, :]
    return {
        "color": color,
        "depth": img[3],
        "alpha": img[4],
        "final_T": final_T,
        "overflow": pairs.overflow,
    }
