"""3x3 SAME conv + bias (+ relu) over one NHWC image: csrc/conv3x3.cu and its plain version.

Port of tools/conv_pallas_proto.py::conv3x3_fused (:49-82), the TPU's fused
conv for the LPIPS VGG layer, in its layout: x (H, W, Cin), w (3, 3, Cin,
Cout) HWIO, b (Cout,). Like conv3x3_fused, the wrapper casts w and b to x's
type before the kernel, so in bf16 the bias is rounded to bf16 and then
added in f32; products are summed in f32 and the output is rounded once to
out_dtype (x's type by default).

Routes, by the tensors' device and type:
  * a CPU tensor: the plain version (conv3x3_plain);
  * bf16 on a CUDA device, Cin and Cout multiples of 8: the tensor-core
    kernel (wgmma), counted in `tc_launches`; an x or w that does not start
    on 16 bytes, as TMA needs, is copied to one that does first;
  * f32 on a CUDA device, and bf16 with Cin or Cout not a multiple of 8:
    the CUDA-core kernel, counted in `launches`, at the tile and cluster
    split that f32_tile picks for the shape.
A CUDA call launches one of the two kernels or raises. conv3x3_tc_stage runs
the stages of the tensor-core kernel, for timing what holds it back.
"""
from __future__ import annotations

import ctypes
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from . import cuda_build

# kernel launches since the last reset (set to 0 to count a run)
launches = 0        # the CUDA-core kernel (conv3x3_kernel)
tc_launches = 0     # the tensor-core kernel (conv3x3_tc_kernel)
stage_launches = 0  # its stages, conv3x3_tc_stage

# the tensor-core kernel's stages, by their code in csrc/conv3x3.cu (enum Stage)
STAGES = ("full", "copy", "operands", "products", "mma")

_DTYPES = (torch.float32, torch.bfloat16)
# x, w, b, out; H, W, cin, cout, relu, in_bf16, out_bf16, tile, split
_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
# x, w, b, out; H, W, cin, cout, relu, out_bf16, tile
_TC_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
# stage; x, w, b, out; H, W, cin, cout, relu, tile
_STAGE_SIGNATURE = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
_TILE_KEYS = ("rows", "channels", "threads", "smem_bytes", "ctas_per_sm")
_F32_TILE_KEYS = ("rows", "channels", "per_thread", "threads", "smem_bytes", "smem_bytes_split")
MAX_SPLIT = 8  # CTAs of a cluster that share the K walk (csrc/conv3x3.cu kMaxSplit)
_tc_tiles = {}
_f32_tiles = {}


@contextmanager
def _full_f32():
    """cuDNN's f32 convolutions in full f32: it takes TF32 by default."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def conv3x3_plain(x, w, b, relu: bool = True, out_dtype=None):
    """tools/conv_pallas_proto.py::ref_conv (:85-89) on the kernel's inputs:
    w and b in x's type, an f32 F.conv2d of them, + b, relu, out_dtype."""
    out_dtype = out_dtype or x.dtype
    w, b = w.to(x.dtype), b.to(x.dtype)
    with _full_f32():
        y = F.conv2d(x.float().permute(2, 0, 1)[None], w.float().permute(3, 2, 0, 1),
                     padding=1)[0].permute(1, 2, 0)
    y = y + b.float()
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def _query_tiles(symbol, keys, device):
    """The tiles the C library reports through `symbol`, by tile code."""
    fn = getattr(cuda_build.load("conv3x3"), symbol)
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    tiles = []
    with torch.cuda.device(device):
        while True:
            info = (ctypes.c_int * len(keys))()
            err = fn(len(tiles), info)
            if err == -1:
                break
            if err != 0:
                raise RuntimeError(f"conv3x3 tile query failed: cudaError {err}")
            tiles.append(dict(zip(keys, info)))
    return tuple(tiles)


def tc_tiles(device) -> tuple:
    """The tensor-core kernel's CTA tiles on a CUDA device, by tile code,
    largest first: {rows (of 16 pixels), channels, threads, smem_bytes
    (dynamic), ctas_per_sm}, as the C library reports them."""
    device = torch.device(device)
    if device not in _tc_tiles:
        _tc_tiles[device] = _query_tiles("moss_conv3x3_tc_tile", _TILE_KEYS, device)
    return _tc_tiles[device]


def f32_tiles(device) -> tuple:
    """The CUDA-core kernel's CTA tiles, by tile code: {rows (of 16 pixels),
    channels, per_thread (channels of a thread), threads, smem_bytes and
    smem_bytes_split (the most dynamic shared memory it takes at a split of
    1 and above 1)}, as the C library reports them."""
    device = torch.device(device)
    if device not in _f32_tiles:
        _f32_tiles[device] = _query_tiles("moss_conv3x3_f32_tile", _F32_TILE_KEYS, device)
    return _f32_tiles[device]


def f32_tile(H: int, W: int, cin: int, cout: int, tiles, sms: int) -> tuple:
    """(tile code, split) of the CUDA-core kernel for an (H, W, cin) image
    and cout output channels on a card with `sms` SMs. The tile's channels
    are the fewest that hold cout (64 above 64), so no FMA is spent on zero
    weights. The K walk (3 ceil(cin / 8) kernel rows of 8 input channels)
    stays in one CTA where a tile of those channels covers half the SMs
    without a split: there a split buys at most twice the CTAs, and the
    partials' sum would leave the sequential order of the plain version's
    sums at the layers whose K makes its rounding largest. Else the walk is
    split over 1-8 CTAs of a cluster. Among the candidates, the grids of at
    least one CTA per SM first, then those of half the SMs; then the
    smallest estimate of the busiest SM's time: a thread's FMAs (a split
    above 1 costs about one step more, the partials' exchange) times the
    larger of its SM's warps over its four schedulers and 2 (a warp alone
    issues at about half rate); ties to the smaller split, then the larger
    tile."""
    steps = 3 * -(-cin // 8)
    fit = [t["channels"] for t in tiles if t["channels"] >= min(cout, 64)]
    channels = min(fit) if fit else max(t["channels"] for t in tiles)
    cands = []
    for code, t in enumerate(tiles):
        if t["channels"] != channels:
            continue
        pixel_tiles = -(-H // t["rows"]) * -(-W // 16) * -(-cout // channels)
        for split in range(1, min(MAX_SPLIT, steps) + 1):
            ctas = pixel_tiles * split
            cover = 0 if ctas >= sms else 1 if 2 * ctas >= sms else 2
            warps = -(-ctas // sms) * -(-t["threads"] // 32)
            fmas = 4 * t["per_thread"] * 24 * (-(-steps // split) + (split > 1))
            cands.append(((cover, fmas * max(warps / 4, 2), split, -t["rows"]), code, split))
    if any(split == 1 and key[0] <= 1 for key, _, split in cands):
        cands = [c for c in cands if c[2] == 1]
    _, code, split = min(cands)
    return code, split


def tc_tile(H: int, W: int, cout: int, tiles, sms: int) -> int:
    """The tile code (an index of `tiles`, tc_tiles' list) for an (H, W)
    image and cout output channels on a card with `sms` SMs: the first tile
    that still gives three quarters of the SMs a tile, else the one that gives
    the most tiles; 128 channels only where cout > 64."""
    def count(code):
        t = tiles[code]
        return -(-H // t["rows"]) * -(-W // 16) * -(-cout // t["channels"])

    ok = [c for c, t in enumerate(tiles) if t["channels"] == 64 or cout > 64]
    busy = [c for c in ok if 4 * count(c) >= 3 * sms]
    return busy[0] if busy else max(ok, key=count)


def takes_tensor_cores(x, w) -> bool:
    """Whether a CUDA call goes to the tensor-core kernel (w already in x's type)."""
    return x.dtype == torch.bfloat16 and x.shape[2] % 8 == 0 and w.shape[3] % 8 == 0


def _aligned(t):
    """t, or a copy of it at a 16-byte aligned address (TMA needs one)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _checked(x, w, b, out_dtype):
    """(H, W, cin) of the inputs, after checking their shapes, types and device."""
    if x.dim() != 3 or x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"conv3x3: x must be (H, W, Cin) f32 or bf16 and out_dtype one of "
                         f"those, got {x.dtype} {tuple(x.shape)} -> {out_dtype}")
    H, W, cin = x.shape
    if w.shape[:3] != (3, 3, cin) or w.dim() != 4 or tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"conv3x3: w must be (3, 3, {cin}, Cout) and b (Cout,), got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv3x3: x, w and b must be on one device")
    if x.device.type != "cpu" and (x.device.type != "cuda" or not x.is_contiguous()):
        raise ValueError(f"conv3x3: x must be a contiguous CPU or CUDA tensor, got {x.device}")
    return H, W, cin


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def conv3x3(x, w, b, relu: bool = True, out_dtype=None):
    """(H, W, Cout) = relu(conv3x3(x, w) + b), SAME padding."""
    global launches, tc_launches
    out_dtype = out_dtype or x.dtype
    H, W, cin = _checked(x, w, b, out_dtype)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu, out_dtype)
    w = w.to(x.dtype).contiguous()
    b = b.to(x.dtype).contiguous()
    cout = w.shape[3]
    tensor_cores = takes_tensor_cores(x, w)
    if tensor_cores:
        x, w = _aligned(x), _aligned(w)
    out = torch.empty((H, W, cout), dtype=out_dtype, device=x.device)
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), H, W, cin, cout,
            int(relu))
    out_bf16 = int(out_dtype == torch.bfloat16)
    if tensor_cores:
        tile = tc_tile(H, W, cout, tc_tiles(x.device), _sms(x.device))
        cuda_build.launch("conv3x3", "moss_conv3x3_tc", _TC_SIGNATURE, x.device, *args,
                          out_bf16, tile)
        tc_launches += 1
    else:
        tile, split = f32_tile(H, W, cin, cout, f32_tiles(x.device), _sms(x.device))
        cuda_build.launch("conv3x3", "moss_conv3x3", _SIGNATURE, x.device, *args,
                          int(x.dtype == torch.bfloat16), out_bf16, tile, split)
        launches += 1
    return out


def conv3x3_stage_plain(x, w, b, stage: str, relu: bool = True):
    """What stage `stage` of the tensor-core kernel returns, bf16: the conv
    for "full"; relu(b) at every pixel for the others, which sum no
    products."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r}: expected one of {STAGES}")
    if stage == "full":
        return conv3x3_plain(x, w, b, relu, torch.bfloat16)
    y = b.to(x.dtype).float().expand(x.shape[0], x.shape[1], w.shape[3])
    return (torch.relu(y) if relu else y).to(torch.bfloat16)


def conv3x3_tc_stage(x, w, b, stage: str, relu: bool = True, tile=None):
    """Stage `stage` of the tensor-core kernel on bf16 x, w, b, bf16 out:
    "full" is the production kernel, the others leave out part of its work
    (csrc/conv3x3.cu, enum Stage), so their times say what holds it back.
    tile: a tile code (default: the one conv3x3 takes). Counted in
    `stage_launches`; on a CPU tensor, conv3x3_stage_plain."""
    global stage_launches
    H, W, cin = _checked(x, w, b, torch.bfloat16)
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r}: expected one of {STAGES}")
    if x.device.type == "cpu":
        return conv3x3_stage_plain(x, w, b, stage, relu)
    w = w.to(x.dtype).contiguous()
    b = b.to(x.dtype).contiguous()
    cout = w.shape[3]
    if not takes_tensor_cores(x, w):
        raise ValueError(f"conv3x3_tc_stage: the tensor-core kernel takes bf16 x with Cin and "
                         f"Cout multiples of 8, got {x.dtype}, {cin} -> {cout}")
    x, w = _aligned(x), _aligned(w)
    if tile is None:
        tile = tc_tile(H, W, cout, tc_tiles(x.device), _sms(x.device))
    out = torch.empty((H, W, cout), dtype=torch.bfloat16, device=x.device)
    cuda_build.launch("conv3x3", "moss_conv3x3_tc_stage", _STAGE_SIGNATURE, x.device,
                      STAGES.index(stage), x.data_ptr(), w.data_ptr(), b.data_ptr(),
                      out.data_ptr(), H, W, cin, cout, int(relu), tile)
    stage_launches += 1
    return out
