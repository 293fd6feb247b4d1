"""Tile rasterizer on the GPU: binning + the hand-written CUDA blend kernels.

Replaces moss_tpu/ops/rasterize_tpu.py::rasterize_tpu: the pair list comes
from ops/binning.bin_pairs at 16x16 tiles, the blend from
csrc/rasterize_fwd.cu (the port of _fwd_kernel) and its gradient from
csrc/rasterize_bwd.cu (the port of _bwd_kernel) plus csrc/segment_sum.cu,
which sums the per-pair gradient rows into Gaussians in a fixed order (the
VJP of binning._gather_rows), all inside one torch.autograd.Function. The
return dict matches rasterize_reference's plus `overflow` (always 0: the pair
list is sized per frame). `bg` is added outside the kernels, as
rasterize_tpu.py:741-744 does, so its gradient is autograd's.

On a CPU tensor the wrapper runs the plain version (ops/rasterize_ref.py) at
the same tile shape, with autograd; on a CUDA tensor it launches the kernels
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .binning import PairList, bin_pairs
from .projection import Projected
from .rasterize_ref import rasterize_reference

TILE = 16  # csrc/blend_common.cuh kTile
GRAD_COLS = 10  # csrc/rasterize_bwd.cu kGrads: d(mx, my, conic a, b, c, opacity, r, g, b, depth)

# kernel launches since the last reset (set to 0 to count a run)
launches = 0          # rasterize_fwd
bwd_launches = 0      # rasterize_bwd
segment_launches = 0  # segment_sum

_KERNEL_FIELDS = ("mean2d", "conic", "opacity", "color", "depth")
_C_SIGNATURES = {
    # 7 input pointers; height, width, grid_w, num_tiles; out
    ("rasterize_fwd", "moss_rasterize_fwd"): [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    # 8 input pointers (the 7 above + gimg); height, width, grid_w, num_tiles; rows
    ("rasterize_bwd", "moss_rasterize_bwd"): [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
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


def rasterize_pairs(pairs: PairList, proj: Projected, height: int, width: int):
    """Launch the blend kernel on a built pair list; (6, H, W) f32 planes
    r, g, b, depth, alpha (sum of weights), final_T."""
    global launches
    device = proj.mean2d.device
    grid_w, num_tiles = _check_pairs(pairs, device, height, width, proj.mean2d.shape[0])
    check_kernel_inputs(proj, device)
    out = torch.empty((6, height, width), dtype=torch.float32, device=device)
    _launch("rasterize_fwd", "moss_rasterize_fwd", device,
            pairs.tile_offsets.data_ptr(), pairs.pair_gaussian.data_ptr(),
            *(getattr(proj, f).data_ptr() for f in _KERNEL_FIELDS),
            height, width, grid_w, num_tiles, out.data_ptr())
    launches += 1
    return out


def rasterize_pairs_bwd(pairs: PairList, proj: Projected, gimg, height: int, width: int):
    """Launch the backward kernel: (num_pairs, 10) f32 per-pair gradient rows,
    in pair-list order. gimg: (6, H, W) f32 upstream grads of r, g, b, depth,
    alpha, then Qtail (see csrc/rasterize_bwd.cu)."""
    global bwd_launches
    device = proj.mean2d.device
    grid_w, num_tiles = _check_pairs(pairs, device, height, width, proj.mean2d.shape[0])
    check_kernel_inputs(proj, device)
    check_gimg(gimg, device, height, width)
    rows = torch.zeros((pairs.num_pairs, GRAD_COLS), dtype=torch.float32, device=device)
    _launch("rasterize_bwd", "moss_rasterize_bwd", device,
            pairs.tile_offsets.data_ptr(), pairs.pair_gaussian.data_ptr(),
            *(getattr(proj, f).data_ptr() for f in _KERNEL_FIELDS), gimg.data_ptr(),
            height, width, grid_w, num_tiles, rows.data_ptr())
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
    segment_launches += 1
    return out


class _Blend(torch.autograd.Function):
    """The five per-Gaussian fields -> the (6, H, W) planes, through the
    kernels both ways. The pair list rides along as a constant."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, color, depth, pairs, height, width):
        proj = Projected(mean2d=mean2d, depth=depth, conic=conic, radius=None,
                         color=color, opacity=opacity, valid=None)
        img = rasterize_pairs(pairs, proj, height, width)
        ctx.save_for_backward(mean2d, conic, opacity, color, depth, img)
        ctx.pairs = pairs
        return img

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_img):
        mean2d, conic, opacity, color, depth, img = ctx.saved_tensors
        proj = Projected(mean2d=mean2d, depth=depth, conic=conic, radius=None,
                         color=color, opacity=opacity, valid=None)
        # Qtail = sum of g * out over the six planes, the g_T T term included
        gimg = torch.cat([g_img[:5], (g_img * img).sum(0, keepdim=True)]).contiguous()
        rows = rasterize_pairs_bwd(ctx.pairs, proj, gimg, img.shape[1], img.shape[2])
        grads = segment_sum(rows, ctx.pairs)
        return (grads[:, 0:2], grads[:, 2:5], grads[:, 5], grads[:, 6:9], grads[:, 9],
                None, None, None)


def bin_projected(proj: Projected, height: int, width: int) -> PairList:
    with torch.no_grad():
        return bin_pairs(proj.mean2d, proj.conic, proj.opacity, proj.depth, proj.radius,
                         proj.radius_xy, proj.valid, height, width, TILE, TILE)


def rasterize_cuda(proj: Projected, bg_color, height: int, width: int):
    """Drop-in for rasterize_reference (same dict, plus `overflow`), differentiable
    in mean2d, conic, opacity, color, depth and bg_color."""
    device = proj.mean2d.device
    if device.type == "cpu":
        out = rasterize_reference(proj, bg_color, height, width, tile_h=TILE, tile_w=TILE)
        out["overflow"] = torch.zeros((), dtype=torch.int32)
        return out
    if device.type != "cuda":
        raise ValueError(f"rasterize_cuda runs on CPU or CUDA tensors, got {device}")
    if bg_color.device != device or tuple(bg_color.shape) != (3,):
        raise ValueError(f"bg_color: expected shape (3,) on {device}")
    pairs = bin_projected(proj, height, width)
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
