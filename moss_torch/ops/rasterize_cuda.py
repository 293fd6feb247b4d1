"""Tile rasterizer forward on the GPU: binning + the hand-written CUDA blend kernel.

Replaces moss_tpu/ops/rasterize_tpu.py::rasterize_tpu for serving: the pair
list comes from ops/binning.bin_pairs at 16x16 tiles and the blend from
csrc/rasterize_fwd.cu (the port of _fwd_kernel). The return dict matches
rasterize_reference's plus `overflow` (always 0: the pair list is sized per
frame). `bg` is added outside the kernel, as rasterize_tpu.py:741-744 does.

On a CPU tensor the wrapper runs the plain version (ops/rasterize_ref.py) at
the same tile shape; on a CUDA tensor it launches the kernel or raises.
There is no backward yet: it comes with the training slice.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .binning import PairList, bin_pairs
from .projection import Projected
from .rasterize_ref import rasterize_reference

TILE = 16  # csrc/rasterize_fwd.cu kTile

# kernel launches since the last reset (set to 0 to count a run)
launches = 0

_KERNEL_FIELDS = ("mean2d", "conic", "opacity", "color", "depth")


def _kernel_lib():
    lib = cuda_build.load("rasterize_fwd")
    fn = lib.moss_rasterize_fwd
    if fn.argtypes is None:
        # 7 input pointers; height, width, grid_w, num_tiles; out; stream
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def check_kernel_inputs(proj: Projected, device: torch.device):
    """Raise unless the fields the kernel reads are contiguous f32 on `device`
    with the shapes it indexes: (P,2), (P,3), (P,), (P,3), (P,)."""
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


def rasterize_pairs(pairs: PairList, proj: Projected, height: int, width: int):
    """Launch the blend kernel on a built pair list; (6, H, W) f32 planes
    r, g, b, depth, alpha (sum of weights), final_T."""
    global launches
    device = proj.mean2d.device
    if device.type != "cuda":
        raise ValueError(f"rasterize_pairs runs on a CUDA device, got {device}")
    check_kernel_inputs(proj, device)
    grid_w = -(-width // TILE)
    num_tiles = -(-height // TILE) * grid_w
    for name, t in (("tile_offsets", pairs.tile_offsets), ("pair_gaussian", pairs.pair_gaussian)):
        if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"pairs.{name}: expected contiguous int32 on {device}")
    if tuple(pairs.tile_offsets.shape) != (num_tiles + 1,):
        raise ValueError(f"pairs.tile_offsets: expected ({num_tiles + 1},) for {height}x{width}")
    fn = _kernel_lib()
    out = torch.empty((6, height, width), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = fn(
            pairs.tile_offsets.data_ptr(), pairs.pair_gaussian.data_ptr(),
            *(getattr(proj, f).data_ptr() for f in _KERNEL_FIELDS),
            height, width, grid_w, num_tiles, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rasterize_fwd kernel launch failed: cudaError {err}")
    launches += 1
    return out


def bin_projected(proj: Projected, height: int, width: int) -> PairList:
    return bin_pairs(proj.mean2d, proj.conic, proj.opacity, proj.depth, proj.radius,
                     proj.radius_xy, proj.valid, height, width, TILE, TILE)


def rasterize_cuda(proj: Projected, bg_color, height: int, width: int):
    """Drop-in for rasterize_reference (same dict, plus `overflow`)."""
    device = proj.mean2d.device
    if device.type == "cpu":
        out = rasterize_reference(proj, bg_color, height, width, tile_h=TILE, tile_w=TILE)
        out["overflow"] = torch.zeros((), dtype=torch.int32)
        return out
    if device.type != "cuda":
        raise ValueError(f"rasterize_cuda runs on CPU or CUDA tensors, got {device}")
    inputs = [getattr(proj, f) for f in _KERNEL_FIELDS] + [bg_color]
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            "rasterize_cuda has no backward kernel yet (it comes with the training "
            "slice); render under torch.inference_mode()")
    if bg_color.device != device or tuple(bg_color.shape) != (3,):
        raise ValueError(f"bg_color: expected shape (3,) on {device}")
    pairs = bin_projected(proj, height, width)
    img = rasterize_pairs(pairs, proj, height, width)
    final_T = img[5]
    color = img[:3].permute(1, 2, 0) + final_T[..., None] * bg_color[None, None, :]
    return {
        "color": color,
        "depth": img[3],
        "alpha": img[4],
        "final_T": final_T,
        "overflow": pairs.overflow,
    }
