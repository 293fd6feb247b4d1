"""The blend kernels' reductions and scans on CUDA cores and tensor cores:
csrc/reduce_scan.cu and its plain versions.

Port of tools/mxu_micro.py's nine Pallas kernels (twelve runs, :245-272),
which ask whether the blend kernels' reductions and scans should move from
the vector units to the matrix unit. Each works on one chunk x (K = 128
splats, 8 x 128 pixels) f32, repeats its function `reps` times on x + i (or
on the alpha of rep i) and sums the repeats:

  moments(x, reps, mode)   (K, 8): sum_i (x + i).reshape(K, 1024) @ basis.
      "cuda" gives [S0, Sx, Sy, Sxx, Sxy, Syy, S0, Sx] (kern_moments_vpu,
      :77); "bf16" and "tf32x3" the product itself, whose columns 6-7 are 0
      (kern_moments_mxu at DEFAULT and HIGHEST, :81)
  reshape_only(x, reps)    (K, 128): sum_i (x + i), summed over the 8 rows (:94)
  acc(x, s, reps, mode)    (8, 8, 128): sum_i s @ (x + i). "cuda" computes rows
      0-4 and repeats rows 0-2 as rows 5-7 (kern_acc_vpu, :112); "bf16" and
      "tf32x3" compute all eight (kern_acc_mxu, :116)
  scan(x, reps, op, mode)  (K, 8, 128): op "add", the splat-axis cumsum of x +
      i ("cuda", "bf16", "split2": kern_cumsum_vpu :153, kern_cumsum_mxu
      :175); op "mul", the masked cumprod of 1 - a, a = clip(x 0.01 (i + 1), 0,
      0.9), with 1 where a <= 0.003 ("cuda": kern_cumprod_vpu :192; "split2":
      exp of the split2 cumsum of log1p(-a), kern_cumprod_logmxu :203)

Modes. "cuda": f32 on the CUDA cores. The tensor-core modes round their
operands as the kernel does and sum in f32: "bf16" one bf16 pass (round to
nearest even), the TPU's DEFAULT; "split2" hi = bf16(g), lo = bf16(g - hi),
two bf16 passes; "tf32x3" the TPU's HIGHEST as 3xTF32, big = tf32(a), small
= tf32(a - big), big.big + big.small + small.big, where tf32() rounds to
nearest with ties away from zero (cvt.rna.tf32.f32). bf16 and tf32 products
are exact in f32, so a plain version and its kernel differ only in the order
of their f32 sums. The CUDA-core scans are per-pixel sequential loops, not
the TPU's two-level Hillis-Steele scan: against it they differ by the order
of the sums, within 1e-5 of the max.

The tensor-core cumsums multiply only the diagonal block of L for each
16-splat slab and carry the slabs' running total (by an all-ones product for
bf16, by shuffles for split2); cumsum_stage runs their stages
(CUMSUM_STAGES: the products and carry on an operand made once, the operand
work alone, the mode's other carry), for timing what holds them back. The
log-space cumprod's kernel works in base 2 (log2(1 - a) by a polynomial,
LOG2_POLY, and 2^x), its plain version in natural logs as the JAX kernel
does; scan_stage runs the kernel's stages (SCAN_STAGES: products, logs and
exps alone). tf32x3_stage does the same for the 3xTF32 moments and
accumulators (TF32X3_STAGES: the products on an
operand split once, the split alone), whose kernels take the contraction
axis in the order mom_pixel and acc_pixel give (the C library's
moss_mxu_tc_order reports it), bf16_stage for the bf16 moments
(BF16_STAGES: the chunk's read, the operand work and the products alone),
whose kernel takes the pixels in mom_bf16_pixel's order, and for the bf16
accumulators (BF16_FAMILIES), whose kernel takes the m-tile's rows in
acc_pixel's order, and cuda_stage for the CUDA-core moments, accumulators,
cumsum, cumprod and reshape (CUDA_STAGES: the chunk's read, the store and the
observer alone). The CUDA-core moments sum each column's 8 rows weighted by
1, py and py^2, then the columns weighted by px (kern_moments_vpu's order);
the CUDA-core accumulators are register-blocked, a lane 4 pixels and a warp
16 splats, the warps' partial sums added in warp order; the CUDA-core cumsum
and cumprod walk the splats with up to WALK_GROUP reps side by side, which
leaves each output's sum over reps in rep order. ctas_per_sm gives the
occupancy of the CUDA-core kernels and the bf16 forms.

A kernel launch runs TILES identical copies of the chunk (the TPU's grid
of TILES = 256 programs); only tile 0 stores the output, and every CTA
writes a checksum of its part into an observer (TILES, parts), which must be
equal across tiles; the kernel library says how many parts (CTAs) a chunk-op
takes. The wrappers return (out, observer). On a CPU tensor they run the
plain version, with no observer; on a CUDA tensor they launch the kernel or
raise. The plain versions also take a stack of chunks (T, K, 8, 128), which
is how a launch's TILES copies are timed on their own.
"""
from __future__ import annotations

import ctypes
import math
from contextlib import contextmanager

import torch

from . import cuda_build

K, H, W = 128, 8, 128  # tools/mxu_micro.py:26-27
PIX = H * W
REPS, TILES = 16, 256  # :29-30

# kernel launches since the last reset (set to 0 to count a run)
moments_launches = 0  # moss_mxu_moments
reshape_launches = 0  # moss_mxu_reshape
acc_launches = 0      # moss_mxu_acc
scan_launches = 0     # moss_mxu_scan
stage_launches = 0    # moss_mxu_scan_stage
cumsum_stage_launches = 0  # moss_mxu_cumsum_stage
tf32x3_stage_launches = 0  # moss_mxu_moments_stage, moss_mxu_acc_stage
cuda_stage_launches = 0  # moss_mxu_{moments,acc,cumsum,cumprod}_cuda_stage
bf16_stage_launches = 0  # moss_mxu_{moments,acc}_bf16_stage
# launches of each of RUNS's forms through its family's wrapper, by run name
form_launches = {}

# the log-space cumprod kernel's stages, by their code in csrc/reduce_scan.cu
# (enum ScanStage)
SCAN_STAGES = ("full", "products", "logs", "exps")
# the tensor-core cumsums' stages, by their code in csrc/reduce_scan.cu (enum
# CumsumStage)
CUMSUM_STAGES = ("full", "products", "operand", "other_carry")
CUMSUM_MODES = ("bf16", "split2")
# log2(1 + f) / f on [-0.5, 0] in float32, constant term first: the table
# kLog2Poly of csrc/reduce_scan.cu::log2_poly
LOG2_POLY = (1.4426864, -0.7218736, 0.4700032, -0.46861637, -0.29185253, -1.9971113, -2.669445,
             -2.283522)

# the 3xTF32 kernels' stages, by their code in csrc/reduce_scan.cu (enum
# Tf32Stage)
TF32X3_STAGES = ("full", "products", "split")
# the 3xTF32 kernels' shapes (csrc/reduce_scan.cu): warps a CTA, k-steps of 8
# a warp walks in a rep, pixels a moments warp covers
TF32X3_WARPS, TF32X3_STEPS, MOM_SLICE = 8, 16, 128

# the CUDA-core moments, accumulator, cumsum, cumprod and reshape kernels'
# stages, by their code in csrc/reduce_scan.cu (enum CudaStage), and the run
# of RUNS each family's production form is
CUDA_STAGES = ("full", "loads")
CUDA_FAMILIES = ("moments", "acc", "cumsum", "cumprod", "reshape")
CUDA_RUNS = {"moments": "moments_cuda", "acc": "acc_cuda", "cumsum": "cumsum_cuda",
             "cumprod": "cumprod_cuda", "reshape": "reshape_only"}
# their shapes (csrc/reduce_scan.cu): warps a CTA of the moments and
# accumulator kernels, adjacent pixel columns a moments lane takes, splats an
# accumulator warp takes and adjacent pixels an accumulator lane takes; reps
# a scan's walk carries at most and splats a scan's thread loads ahead
CUDA_WARPS, MOM_CUDA_COLS, ACC_CUDA_SPLATS, ACC_CUDA_PIX = 8, 4, 16, 4
WALK_GROUP, WALK_BATCH = 16, 8
# the reshape kernel's shapes (csrc/reduce_scan.cu): threads a CTA, adjacent
# columns a thread takes (a float4 of each of the 8 rows), tiles a CTA walks
RESHAPE_THREADS, RESHAPE_COLS, RESHAPE_TILES = 256, 4, 16

# the bf16 moments and accumulator kernels' stages, by their code in
# csrc/reduce_scan.cu (enum Bf16Stage), their k-steps of 16 a warp walks in a
# rep (pixels of the moments, 8 warps a CTA, TF32X3_WARPS; splats of the
# accumulators, ACC_BF16_WARPS warps of 16 pixels a CTA) and the reps whose
# product chains run side by side
BF16_STAGES = ("full", "loads", "operands", "products")
BF16_FAMILIES = ("moments", "acc")
BF16_STEPS, BF16_IN_FLIGHT, ACC_BF16_WARPS = 8, 2, 4
# the kernels ctas_per_sm knows, in the order of moss_mxu_ctas_per_sm's codes
CTAS_KERNELS = ("moments_cuda", "acc_cuda", "cumprod_cuda", "moments_bf16", "cumsum_cuda",
                "acc_bf16", "reshape")

MODES = ("cuda", "bf16", "tf32x3")
SCAN_MODES = {"add": ("cuda", "bf16", "split2"), "mul": ("cuda", "split2")}
_MODE_CODE = {"cuda": 0, "bf16": 1, "tf32x3": 2, "split2": 3}
_OP_CODE = {"add": 0, "mul": 1}

# (name, family, mode, the JAX kernel it replaces) for tools/mxu_micro.py's
# twelve runs, in its order (:245-272); the family "cumsum" is scan "add",
# "cumprod" scan "mul"
RUNS = (
    ("moments_cuda", "moments", "cuda", "kern_moments_vpu"),
    ("moments_tf32x3", "moments", "tf32x3", "kern_moments_mxu HIGHEST"),
    ("moments_bf16", "moments", "bf16", "kern_moments_mxu DEFAULT"),
    ("reshape_only", "reshape", "cuda", "kern_reshape_only"),
    ("acc_cuda", "acc", "cuda", "kern_acc_vpu"),
    ("acc_tf32x3", "acc", "tf32x3", "kern_acc_mxu HIGHEST"),
    ("acc_bf16", "acc", "bf16", "kern_acc_mxu DEFAULT"),
    ("cumsum_cuda", "cumsum", "cuda", "kern_cumsum_vpu"),
    ("cumsum_bf16", "cumsum", "bf16", "kern_cumsum_mxu split=False"),
    ("cumsum_split2", "cumsum", "split2", "kern_cumsum_mxu split=True"),
    ("cumprod_cuda", "cumprod", "cuda", "kern_cumprod_vpu"),
    ("cumprod_logsplit2", "cumprod", "split2", "kern_cumprod_logmxu"),
)
RUN = {r[0]: r for r in RUNS}

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # pointers, then reps, tiles, [op,] [mode]
    "moss_mxu_moments": [_PTR] * 3 + [_INT] * 3,
    "moss_mxu_reshape": [_PTR] * 3 + [_INT] * 2,
    "moss_mxu_acc": [_PTR] * 4 + [_INT] * 3,
    "moss_mxu_scan": [_PTR] * 3 + [_INT] * 4,
    "moss_mxu_scan_stage": [_PTR] * 3 + [_INT] * 3,
    "moss_mxu_cumsum_stage": [_PTR] * 3 + [_INT] * 4,
    "moss_mxu_moments_stage": [_PTR] * 3 + [_INT] * 3,
    "moss_mxu_acc_stage": [_PTR] * 4 + [_INT] * 3,
    "moss_mxu_moments_cuda_stage": [_PTR] * 3 + [_INT] * 3,
    "moss_mxu_acc_cuda_stage": [_PTR] * 4 + [_INT] * 3,
    "moss_mxu_cumsum_cuda_stage": [_PTR] * 3 + [_INT] * 3,
    "moss_mxu_reshape_cuda_stage": [_PTR] * 3 + [_INT] * 3,
    "moss_mxu_cumprod_cuda_stage": [_PTR] * 3 + [_INT] * 3,
    "moss_mxu_moments_bf16_stage": [_PTR] * 3 + [_INT] * 3,
    "moss_mxu_acc_bf16_stage": [_PTR] * 4 + [_INT] * 3,
}


# ---- rounding and the operands ----------------------------------------------

def round_bf16(a):
    """a rounded to bf16, round to nearest even, back in f32."""
    return a.to(torch.bfloat16).float()


def round_tf32(a):
    """a rounded to tf32 (10 mantissa bits), to nearest with ties away from
    zero as cvt.rna.tf32.f32 does, back in f32."""
    bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def split_tf32(a):
    """(big, small) of 3xTF32."""
    big = round_tf32(a)
    return big, round_tf32(a - big)


def basis(device=None):
    """(1024, 8): [1, px, py, px^2, px py, py^2, 0, 0] (tools/mxu_micro.py:48-55)."""
    p = torch.arange(PIX, device=device)
    px, py = (p % W).float(), (p // W).float()
    z = torch.zeros_like(px)
    return torch.stack([px * 0 + 1, px, py, px * px, px * py, py * py, z, z], 1)


def tri(device=None):
    """(K, K) lower-triangular ones, the inclusive cumsum operator (:161-165)."""
    return torch.tril(torch.ones((K, K), device=device))


@contextmanager
def full_f32():
    """f32 matrix products in full f32: never TF32."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@contextmanager
def one_cpu_thread(t):
    """CPU products on one thread. The CPU BLAS splits a long contraction
    (moments' K = 1024) over its threads, so its sums' order, and their last
    bits, follow the thread count: on one thread a plain version gives the
    same bits in every call, whatever the process's thread setting."""
    if t.device.type != "cpu":
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _mm(a, b, mode):
    """a @ b with the operands rounded as `mode` rounds them, f32 sums."""
    with full_f32(), one_cpu_thread(a):
        if mode == "cuda":
            return a @ b
        if mode == "bf16":
            return round_bf16(a) @ round_bf16(b)
        if mode == "split2":  # b is the split operand; a (L) is exact in bf16
            hi = round_bf16(b)
            return a @ hi + a @ round_bf16(b - hi)
        big_a, small_a = split_tf32(a)
        big_b, small_b = split_tf32(b)
        return small_a @ big_b + big_a @ small_b + big_a @ big_b


def rep_alpha(x, i: int):
    """a = clip(x 0.01 (i + 1), 0, 0.9) of rep i, the scale rounded once to f32
    as the JAX kernel's weak-typed Python float is (:197)."""
    scale = torch.tensor(0.01 * (i + 1), dtype=torch.float32, device=x.device)
    return torch.clamp(x * scale, 0.0, 0.9)


def tf32_operand(a):
    """The operand register the 3xTF32 kernels hand the tensor cores for a:
    bits(a) + 0x1000, as an f32 (tf32(a) plus the 13 low bits the tensor
    cores do not read)."""
    return (a.contiguous().view(torch.int32) + 0x1000).view(torch.float32)


# ---- the 3xTF32 kernels' order of the contraction axis ------------------------

def mom_pixel(w: int, s: int, col: int) -> int:
    """csrc/reduce_scan.cu::mom_pixel: the pixel of column col of k-step s in
    warp w's slice of the moments kernel."""
    return MOM_SLICE * w + 32 * (col & 3) + 2 * s + (col >> 2)


def acc_pixel(w: int, r: int) -> int:
    """csrc/reduce_scan.cu::acc_pixel: the pixel (of its CTA's) of row r of
    warp w's m-tile in the bf16 and 3xTF32 accumulator kernels."""
    return 16 * w + 2 * (r & 7) + (r >> 3)


def tf32x3_order_plain(family: str):
    """mom_pixel over (warp, k-step, column), (8, 16, 8), for "moments";
    acc_pixel over (warp, row), (8, 16), for "acc"."""
    if family == "moments":
        return torch.tensor([[[mom_pixel(w, s, c) for c in range(8)]
                              for s in range(TF32X3_STEPS)] for w in range(TF32X3_WARPS)])
    return torch.tensor([[acc_pixel(w, r) for r in range(16)] for w in range(TF32X3_WARPS)])


def mom_bf16_pixel(w: int, s: int, col: int) -> int:
    """csrc/reduce_scan.cu::mom_bf16_pixel: the pixel of column col (0-15) of
    k-step s in warp w's slice of the bf16 moments kernel; lane t's columns
    2t, 2t + 1, 2t + 8, 2t + 9 are four adjacent pixels."""
    return MOM_SLICE * w + 16 * s + 4 * ((col & 7) >> 1) + (col & 1) + 2 * (col >> 3)


def bf16_order_plain():
    """mom_bf16_pixel over (warp, k-step, column), (8, 8, 16)."""
    return torch.tensor([[[mom_bf16_pixel(w, s, c) for c in range(16)]
                          for s in range(BF16_STEPS)] for w in range(TF32X3_WARPS)])


def _c_order(code: int, want):
    """The C library's table of family `code` (moss_mxu_tc_order), shaped as
    its Python copy `want`."""
    buf = (ctypes.c_int * want.numel())()
    fn = cuda_build.load("reduce_scan").moss_mxu_tc_order
    fn.argtypes, fn.restype = [_INT, ctypes.POINTER(ctypes.c_int)], _INT
    n = fn(code, buf)
    if n != want.numel():
        raise ValueError(f"moss_mxu_tc_order({code}) wrote {n} entries, not {want.numel()}")
    return torch.tensor(list(buf)).reshape(want.shape)


def tf32x3_order(family: str):
    """The C library's tables of tf32x3_order_plain."""
    return _c_order({"moments": 0, "acc": 1}[family], tf32x3_order_plain(family))


def bf16_order():
    """The C library's table of bf16_order_plain."""
    return _c_order(2, bf16_order_plain())


def _slot_column(col):
    """The C column (output column n of the moments, row n of the
    accumulators) whose element sums the A element of fragment column col
    in the split stage: columns t and t + 4 of lane t feed C columns 2t and
    2t + 1."""
    return 2 * (col % 4) + col // 4


# ---- plain versions -----------------------------------------------------------

# Each takes a chunk x (K, 8, 128) or a stack of them (T, K, 8, 128) and
# gives one output per chunk.

def _rows(x):
    """x as (..., K, PIX) and its leading (stack) shape."""
    lead = tuple(x.shape[:-3])
    return x.reshape(*lead, K, PIX), lead


def moments_plain(x, reps: int = REPS, mode: str = "cuda"):
    (g0, lead), b = _rows(x), basis(x.device)
    acc = torch.zeros((*lead, K, 8), device=x.device)
    for i in range(reps):
        m = _mm(g0 + float(i), b, mode)
        if mode == "cuda":
            m = torch.cat([m[..., :6], m[..., :2]], -1)
        acc = acc + m
    return acc


def reshape_only_plain(x, reps: int = REPS):
    g0, lead = _rows(x)
    acc = torch.zeros((*lead, K, PIX), device=x.device)
    for i in range(reps):
        acc = acc + (g0 + float(i))
    return acc.reshape(*lead, K, H, W).sum(-2)


def acc_plain(x, s, reps: int = REPS, mode: str = "cuda"):
    g0, lead = _rows(x)
    acc = torch.zeros((*lead, 8, PIX), device=x.device)
    for i in range(reps):
        if mode == "cuda":
            m = _mm(s[:5], g0 + float(i), mode)
            m = torch.cat([m, m[..., :3, :]], -2)
        else:
            m = _mm(s, g0 + float(i), mode)
        acc = acc + m
    return acc.reshape(*lead, 8, H, W)


def _sequential(g, op: str):
    """Inclusive scan over the splat axis (-2), one splat after another."""
    run = g[..., 0, :]
    rows = [run]
    for k in range(1, K):
        run = run + g[..., k, :] if op == "add" else run * g[..., k, :]
        rows.append(run)
    return torch.stack(rows, -2)


def scan_plain(x, reps: int = REPS, op: str = "add", mode: str = "cuda"):
    g0, lead = _rows(x)
    L = tri(x.device)
    acc = torch.zeros((*lead, K, PIX), device=x.device)
    for i in range(reps):
        if op == "add":
            g = g0 + float(i)
            cs = _sequential(g, op) if mode == "cuda" else _mm(L, g, mode)
        else:
            a = rep_alpha(g0, i)
            if mode == "cuda":
                cs = _sequential(torch.where(a > 0.003, 1.0 - a, 1.0), op)
            else:
                lg = torch.where(a > 0.003, torch.log1p(-a), 0.0)
                cs = torch.exp(_mm(L, lg, "split2"))
        acc = acc + cs
    return acc.reshape(*lead, K, H, W)


# ---- wrappers -------------------------------------------------------------------

def _check(x, reps, what, s=None):
    if x.dtype != torch.float32 or tuple(x.shape) != (K, H, W) or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous ({K}, {H}, {W}) f32 chunk, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if s is not None and (s.dtype != torch.float32 or tuple(s.shape) != (8, K)
                          or not s.is_contiguous() or s.device != x.device):
        raise ValueError(f"{what}: expected s contiguous (8, {K}) f32 on {x.device}, got "
                         f"{s.dtype} {tuple(s.shape)} on {s.device}")
    if reps < 0:
        raise ValueError(f"{what}: reps {reps} must be >= 0")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: runs on CPU or CUDA tensors, got {x.device}")


def _mode(mode, allowed, what):
    if mode not in allowed:
        raise ValueError(f"{what}: mode {mode!r} is not one of {allowed}")


def _parts(symbol, *codes):
    """CTAs per chunk-op of `symbol`'s kernel for these codes, from the
    kernel library: the observer's columns."""
    fn = getattr(cuda_build.load("reduce_scan"), f"{symbol}_parts")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_INT] * len(codes), _INT
    n = fn(*codes)
    if n <= 0:
        raise ValueError(f"{symbol}: no kernel for the codes {codes}")
    return n


def _count_form(name):
    form_launches[name] = form_launches.get(name, 0) + 1


def _launch(symbol, x, out, reps, *codes, s=None):
    """Launch `symbol` over TILES copies of the chunk; returns (out, observer)."""
    obs = torch.empty((TILES, _parts(symbol, *codes)), dtype=torch.float32, device=x.device)
    ptrs = [x.data_ptr()] + ([s.data_ptr()] if s is not None else [])
    cuda_build.launch("reduce_scan", symbol, _SIGNATURES[symbol], x.device, *ptrs,
                      out.data_ptr(), obs.data_ptr(), reps, TILES, *codes)
    return out, obs


def moments(x, reps: int = REPS, mode: str = "cuda"):
    """(out (K, 8), observer): the moments of sum_i (x + i)."""
    global moments_launches
    _check(x, reps, "moments")
    _mode(mode, MODES, "moments")
    if x.device.type == "cpu":
        return moments_plain(x, reps, mode), None
    out = torch.empty((K, 8), dtype=torch.float32, device=x.device)
    res = _launch("moss_mxu_moments", x, out, reps, _MODE_CODE[mode])
    moments_launches += 1
    _count_form(f"moments_{mode}")
    return res


def reshape_only(x, reps: int = REPS):
    """(out (K, 128), observer): sum_i (x + i) summed over the 8 rows."""
    global reshape_launches
    _check(x, reps, "reshape_only")
    if x.device.type == "cpu":
        return reshape_only_plain(x, reps), None
    out = torch.empty((K, W), dtype=torch.float32, device=x.device)
    res = _launch("moss_mxu_reshape", x, out, reps)
    reshape_launches += 1
    _count_form("reshape_only")
    return res


def acc(x, s, reps: int = REPS, mode: str = "cuda"):
    """(out (8, 8, 128), observer): sum_i s @ (x + i)."""
    global acc_launches
    _check(x, reps, "acc", s)
    _mode(mode, MODES, "acc")
    if x.device.type == "cpu":
        return acc_plain(x, s, reps, mode), None
    out = torch.empty((8, H, W), dtype=torch.float32, device=x.device)
    res = _launch("moss_mxu_acc", x, out, reps, _MODE_CODE[mode], s=s)
    acc_launches += 1
    _count_form(f"acc_{mode}")
    return res


def scan(x, reps: int = REPS, op: str = "add", mode: str = "cuda"):
    """(out (K, 8, 128), observer): sum_i of the splat-axis cumsum ("add") or
    masked cumprod ("mul")."""
    global scan_launches
    _check(x, reps, "scan")
    if op not in SCAN_MODES:
        raise ValueError(f"scan: op {op!r} is not one of {tuple(SCAN_MODES)}")
    _mode(mode, SCAN_MODES[op], f"scan {op}")
    if x.device.type == "cpu":
        return scan_plain(x, reps, op, mode), None
    out = torch.empty((K, H, W), dtype=torch.float32, device=x.device)
    res = _launch("moss_mxu_scan", x, out, reps, _OP_CODE[op], _MODE_CODE[mode])
    scan_launches += 1
    _count_form(f"cumsum_{mode}" if op == "add" else
                "cumprod_logsplit2" if mode == "split2" else f"cumprod_{mode}")
    return res


def _scan_op(family):
    return "add" if family == "cumsum" else "mul"


def _out_shape(family):
    return {"moments": (K, 8), "acc": (8, H, W), "reshape": (K, W)}.get(family, (K, H, W))


def _family_parts(family, mode):
    """The observer's columns of the kernel of `family` at `mode`."""
    if family in ("cumsum", "cumprod"):
        return _parts("moss_mxu_scan", _OP_CODE[_scan_op(family)], _MODE_CODE[mode])
    if family == "reshape":
        return _parts("moss_mxu_reshape")
    return _parts(f"moss_mxu_{family}", _MODE_CODE[mode])


def _launch_stage(symbol, family, mode, x, s, reps, *codes):
    """Launch a stage of `family`'s kernel at `mode` through its C entry point
    `symbol` with `codes` (the mode where the entry point takes it, then the
    stage) after reps and TILES: (out, observer)."""
    out = torch.empty(_out_shape(family), dtype=torch.float32, device=x.device)
    obs = torch.empty((TILES, _family_parts(family, mode)), dtype=torch.float32, device=x.device)
    ptrs = [x.data_ptr()] + ([s.data_ptr()] if family == "acc" else [])
    cuda_build.launch("reduce_scan", symbol, _SIGNATURES[symbol], x.device, *ptrs, out.data_ptr(),
                      obs.data_ptr(), reps, TILES, *codes)
    return out, obs


def scan_stage_plain(x, stage: str, reps: int = REPS):
    """What stage `stage` of the log-space cumprod kernel returns, summed over
    the reps, with a the rep's alpha masked to 0 where a <= 0.003: "full" the
    cumprod (scan_plain); "products" the split2 cumsum of -a; "logs"
    log2(1 - a); "exps" 2^-a."""
    if stage not in SCAN_STAGES:
        raise ValueError(f"stage {stage!r}: expected one of {SCAN_STAGES}")
    if stage == "full":
        return scan_plain(x, reps, "mul", "split2")
    g0, lead = _rows(x)
    L = tri(x.device)
    acc = torch.zeros((*lead, K, PIX), device=x.device)
    for i in range(reps):
        a = rep_alpha(g0, i)
        a = torch.where(a > 0.003, a, 0.0)
        if stage == "products":
            acc = acc + _mm(L, -a, "split2")
        elif stage == "logs":
            acc = acc + torch.log1p(-a) / math.log(2.0)
        else:
            acc = acc + torch.exp2(-a)
    return acc.reshape(*lead, K, H, W)


def scan_stage(x, stage: str, reps: int = REPS):
    """(out (K, 8, 128), observer) of stage `stage` of the log-space cumprod
    kernel (scan op "mul", mode "split2"): "full" is that kernel, the others
    leave out part of its work, so their times say what holds it back.
    Counted in `stage_launches`; on a CPU tensor, scan_stage_plain."""
    global stage_launches
    _check(x, reps, "scan_stage")
    if stage not in SCAN_STAGES:
        raise ValueError(f"stage {stage!r}: expected one of {SCAN_STAGES}")
    if x.device.type == "cpu":
        return scan_stage_plain(x, stage, reps), None
    res = _launch_stage("moss_mxu_scan_stage", "cumprod", "split2", x, None, reps,
                        SCAN_STAGES.index(stage))
    stage_launches += 1
    return res


def _pair_register(lo_elem, hi_elem):
    """The f32 whose bits are the bf16 pair register pack_bf16(lo_elem,
    hi_elem) of csrc/reduce_scan.cu, from two bf16-rounded f32 values: hi_elem
    in the high half, lo_elem's bf16 bits in the low half."""
    low = (lo_elem.contiguous().view(torch.int32) >> 16) & 0xFFFF
    return (hi_elem.contiguous().view(torch.int32) | low).view(torch.float32)


def _cumsum_args(mode, stage, what):
    if mode not in CUMSUM_MODES:
        raise ValueError(f"{what}: mode {mode!r}: expected one of {CUMSUM_MODES}")
    if stage not in CUMSUM_STAGES:
        raise ValueError(f"{what}: stage {stage!r}: expected one of {CUMSUM_STAGES}")


def cumsum_stage_plain(x, mode: str, stage: str, reps: int = REPS):
    """What stage `stage` of the tensor-core cumsum of `mode` returns: "full"
    and "other_carry" the cumsum (scan_plain); "products" the reps' sums of
    L @ r(x), r rounded once; "operand" per pair of splats (2j, 2j + 1) and pixel, the
    sum over reps of the hi pair register of v = x + i (_pair_register) in
    splat 2j + 1 and of the lo pair register (split2) or 0 (bf16) in splat
    2j."""
    _cumsum_args(mode, stage, "cumsum_stage_plain")
    if stage in ("full", "other_carry"):
        return scan_plain(x, reps, "add", mode)
    g0, lead = _rows(x)
    acc = torch.zeros((*lead, K, PIX), device=x.device)
    if stage == "products":
        cs = _mm(tri(x.device), g0, mode)
        for _ in range(reps):
            acc = acc + cs
        return acc.reshape(*lead, K, H, W)
    for i in range(reps):
        v = g0 + float(i)
        hi = round_bf16(v)
        pairs = torch.zeros_like(acc)
        pairs[..., 1::2, :] = _pair_register(hi[..., 0::2, :], hi[..., 1::2, :])
        if mode == "split2":
            lo = round_bf16(v - hi)
            pairs[..., 0::2, :] = _pair_register(lo[..., 0::2, :], lo[..., 1::2, :])
        acc = acc + pairs
    return acc.reshape(*lead, K, H, W)


def cumsum_stage(x, mode: str, stage: str, reps: int = REPS):
    """(out (K, 8, 128), observer) of stage `stage` of the tensor-core cumsum
    kernel of `mode` (scan op "add"): "full" is that kernel, "other_carry" the
    same function with the mode's other carry, the others leave out part of
    its work, so their times say what holds it back. Counted in `cumsum_stage_launches`;
    on a CPU tensor, cumsum_stage_plain."""
    global cumsum_stage_launches
    _cumsum_args(mode, stage, "cumsum_stage")
    _check(x, reps, "cumsum_stage")
    if x.device.type == "cpu":
        return cumsum_stage_plain(x, mode, stage, reps), None
    res = _launch_stage("moss_mxu_cumsum_stage", "cumsum", mode, x, None, reps, _MODE_CODE[mode],
                        CUMSUM_STAGES.index(stage))
    cumsum_stage_launches += 1
    return res


def _slot_onehot(family: str, device):
    """The split stage's sum as a 0/1 matrix: (1024, 8) pixel to the moments'
    output column, (8, K) accumulator row to splat, by each element's
    fragment column (_slot_column)."""
    if family == "moments":
        order = tf32x3_order_plain("moments")
        m = torch.zeros((PIX, 8))
        m[order.reshape(-1), _slot_column(torch.arange(8).expand_as(order)).reshape(-1)] = 1.0
    else:
        k = torch.arange(K)
        m = torch.zeros((8, K))
        m[_slot_column(k % 8), k] = 1.0
    return m.to(device)


def _tf32x3_args(family, stage, what):
    if family not in ("moments", "acc"):
        raise ValueError(f"{what}: family {family!r} is not 'moments' or 'acc'")
    if stage not in TF32X3_STAGES:
        raise ValueError(f"{what}: stage {stage!r}: expected one of {TF32X3_STAGES}")


def tf32x3_stage_plain(family: str, x, s, stage: str, reps: int = REPS):
    """What stage `stage` of the 3xTF32 moments ("moments") or accumulator
    ("acc") kernel returns: "full" the 3xTF32 product (moments_plain,
    acc_plain); "products" the reps' sums of (big.B_big + big.B_small) +
    big.B_big with big = tf32(x), split once; "split" the sum over reps of
    each element's small operand register tf32_operand(v - tf32(v)), v = x +
    i, into the output element its fragment slot feeds (_slot_onehot)."""
    _tf32x3_args(family, stage, "tf32x3_stage_plain")
    if stage == "full":
        return (moments_plain(x, reps, "tf32x3") if family == "moments"
                else acc_plain(x, s, reps, "tf32x3"))
    g0, lead = _rows(x)
    moments_ = family == "moments"
    acc = torch.zeros((*lead, K, 8) if moments_ else (*lead, 8, PIX), device=x.device)
    with full_f32(), one_cpu_thread(x):
        if stage == "products":
            big = round_tf32(g0)
            b_big, b_small = split_tf32(basis(x.device) if moments_ else s)
            if moments_:
                cb, cs = big @ b_big, big @ b_big + big @ b_small
            else:
                cb, cs = b_big @ big, b_big @ big + b_small @ big
            for _ in range(reps):
                acc = acc + (cb + cs)
        else:
            onehot = _slot_onehot(family, x.device)
            for i in range(reps):
                v = g0 + float(i)
                small = tf32_operand(v - round_tf32(v))
                acc = acc + (small @ onehot if moments_ else onehot @ small)
    return acc if moments_ else acc.reshape(*lead, 8, H, W)


def tf32x3_stage(family: str, x, s, stage: str, reps: int = REPS):
    """(out, observer) of stage `stage` of the 3xTF32 moments or accumulator
    kernel: "full" is that kernel (mode "tf32x3"), the others leave out part
    of its work, so their times say what holds it back. s is read by "acc"
    only. Counted in `tf32x3_stage_launches`; on a CPU tensor,
    tf32x3_stage_plain."""
    global tf32x3_stage_launches
    _tf32x3_args(family, stage, "tf32x3_stage")
    _check(x, reps, "tf32x3_stage", s if family == "acc" else None)
    if x.device.type == "cpu":
        return tf32x3_stage_plain(family, x, s, stage, reps), None
    res = _launch_stage(f"moss_mxu_{family}_stage", family, "tf32x3", x, s, reps,
                        TF32X3_STAGES.index(stage))
    tf32x3_stage_launches += 1
    return res


def _cuda_stage_args(family, stage, what):
    if family not in CUDA_FAMILIES:
        raise ValueError(f"{what}: family {family!r} is not one of {CUDA_FAMILIES}")
    if stage not in CUDA_STAGES:
        raise ValueError(f"{what}: stage {stage!r}: expected one of {CUDA_STAGES}")


def cuda_stage_plain(family: str, x, s, stage: str, reps: int = REPS):
    """What stage `stage` of the CUDA-core moments ("moments"), accumulator
    ("acc"), cumsum ("cumsum"), cumprod ("cumprod") or reshape ("reshape")
    kernel returns: "full" the function (its run of CUDA_RUNS); "loads" for
    the contractions the sum of x over the contracted axis in the first
    output, the moments' columns 0 and 6 (S0) or the accumulators' rows 0 and
    5, every other output 0, for the scans x itself, for the reshape x summed
    over the 8 rows, whatever `reps`."""
    _cuda_stage_args(family, stage, "cuda_stage_plain")
    if stage == "full":
        return run_plain(CUDA_RUNS[family], x, s, reps)
    if family in ("cumsum", "cumprod"):
        return x.clone()
    if family == "reshape":
        return x.sum(-2)
    g0, lead = _rows(x)
    if family == "moments":
        out = torch.zeros((*lead, K, 8), device=x.device)
        out[..., 0] = out[..., 6] = g0.sum(-1)
        return out
    out = torch.zeros((*lead, 8, PIX), device=x.device)
    out[..., 0, :] = out[..., 5, :] = g0.sum(-2)
    return out.reshape(*lead, 8, H, W)


def cuda_stage(family: str, x, s, stage: str, reps: int = REPS):
    """(out, observer) of stage `stage` of the CUDA-core moments, accumulator,
    cumsum, cumprod or reshape kernel: "full" is that kernel (mode "cuda"),
    "loads" leaves out the reps, so its time says what the chunk's read, the
    store and the observer cost. s is read by "acc" only. Counted in
    `cuda_stage_launches`; on a CPU tensor, cuda_stage_plain."""
    global cuda_stage_launches
    _cuda_stage_args(family, stage, "cuda_stage")
    _check(x, reps, "cuda_stage", s if family == "acc" else None)
    if x.device.type == "cpu":
        return cuda_stage_plain(family, x, s, stage, reps), None
    res = _launch_stage(f"moss_mxu_{family}_cuda_stage", family, "cuda", x, s, reps,
                        CUDA_STAGES.index(stage))
    cuda_stage_launches += 1
    return res


def _bf16_stage_args(family, stage, what):
    if family not in BF16_FAMILIES:
        raise ValueError(f"{what}: family {family!r} is not one of {BF16_FAMILIES}")
    if stage not in BF16_STAGES:
        raise ValueError(f"{what}: stage {stage!r}: expected one of {BF16_STAGES}")


def bf16_stage_plain(family: str, x, s, stage: str, reps: int = REPS):
    """What stage `stage` of the bf16 moments ("moments", (K, 8)) or
    accumulator ("acc", (8, 8, 128)) kernel returns: "full" the function at
    mode "bf16" (moments_plain, acc_plain); "loads" x summed once, whatever
    `reps`, into the even output columns (moments) or rows (acc) 2t by the
    lane t that holds it: over the pixels p with (p % 16) // 4 == t
    (mom_bf16_pixel), over the splats k with (k % 8) // 2 == t; "operands" the
    sum over reps of the pair registers of v = x + i (_pair_register): for
    the moments, of pixels p, p + 1 into column 2t and of p + 2, p + 3 into
    column 2t + 1, p = 16 j + 4 t; for the accumulators, of splats 2j, 2j + 1
    into row _slot_column(j % 8); "products" the reps' sums of the product of
    bf16(x) and bf16 of the basis or of s, x rounded once."""
    _bf16_stage_args(family, stage, "bf16_stage_plain")
    if stage == "full":
        return moments_plain(x, reps, "bf16") if family == "moments" else acc_plain(x, s, reps,
                                                                                    "bf16")
    g0, lead = _rows(x)
    moments_ = family == "moments"
    out = torch.zeros((*lead, K, 8) if moments_ else (*lead, 8, PIX), device=x.device)
    if stage == "products":
        cs = _mm(g0, basis(x.device), "bf16") if moments_ else _mm(s, g0, "bf16")
        for _ in range(reps):
            out = out + cs
    elif moments_ and stage == "loads":
        out[..., 0::2] = g0.reshape(*lead, K, PIX // 16, 4, 4).sum((-3, -1))
    elif moments_:
        for i in range(reps):
            hi = round_bf16(g0 + float(i)).reshape(*lead, K, PIX // 16, 4, 4)
            pairs = torch.stack([_pair_register(hi[..., 0], hi[..., 1]),
                                 _pair_register(hi[..., 2], hi[..., 3])], -1)  # (.., K, j, t, 2)
            out = out + pairs.sum(-3).reshape(*lead, K, 8)
    elif stage == "loads":
        out[..., 0::2, :] = g0.reshape(*lead, K // 8, 4, 2, PIX).sum((-4, -2))
    else:
        rows = [_slot_column(col) for col in range(8)]
        for i in range(reps):
            hi = round_bf16(g0 + float(i))
            pairs = _pair_register(hi[..., 0::2, :], hi[..., 1::2, :])  # (.., K / 2, PIX)
            by_col = pairs.reshape(*lead, K // 16, 8, PIX).sum(-3)       # (.., j % 8, PIX)
            out = out + by_col[..., [rows.index(n) for n in range(8)], :]
    return out if moments_ else out.reshape(*lead, 8, H, W)


def bf16_stage(family: str, x, s, stage: str, reps: int = REPS):
    """(out, observer) of stage `stage` of the bf16 moments or accumulator
    kernel: "full" is that kernel (mode "bf16"), the others leave out part of
    its work, so their times say what holds it back. s is read by "acc"
    only. Counted in `bf16_stage_launches`; on a CPU tensor,
    bf16_stage_plain."""
    global bf16_stage_launches
    _bf16_stage_args(family, stage, "bf16_stage")
    _check(x, reps, "bf16_stage", s if family == "acc" else None)
    if x.device.type == "cpu":
        return bf16_stage_plain(family, x, s, stage, reps), None
    res = _launch_stage(f"moss_mxu_{family}_bf16_stage", family, "bf16", x, s, reps,
                        BF16_STAGES.index(stage))
    bf16_stage_launches += 1
    return res


def ctas_per_sm(name: str) -> int:
    """CTAs an SM of the kernel of run `name` (one of CTAS_KERNELS) at its
    production launch of REPS, from the C library's occupancy query
    (moss_mxu_ctas_per_sm); needs a card."""
    fn = cuda_build.load("reduce_scan").moss_mxu_ctas_per_sm
    fn.argtypes, fn.restype = [_INT], _INT
    n = fn(CTAS_KERNELS.index(name))
    if n <= 0:
        raise RuntimeError(f"moss_mxu_ctas_per_sm({name}) returned {n}")
    return n


# ---- the twelve runs by name ----------------------------------------------------

def run(name: str, x, s, reps: int = REPS):
    """Run `name` of RUNS through its wrapper: (out, observer)."""
    _, family, mode, _ = RUN[name]
    if family == "moments":
        return moments(x, reps, mode)
    if family == "reshape":
        return reshape_only(x, reps)
    if family == "acc":
        return acc(x, s, reps, mode)
    return scan(x, reps, _scan_op(family), mode)


def run_plain(name: str, x, s, reps: int = REPS):
    """The plain version of `name` of RUNS, on a chunk or a stack of chunks."""
    _, family, mode, _ = RUN[name]
    if family == "moments":
        return moments_plain(x, reps, mode)
    if family == "reshape":
        return reshape_only_plain(x, reps)
    if family == "acc":
        return acc_plain(x, s, reps, mode)
    return scan_plain(x, reps, _scan_op(family), mode)


def launch_counts():
    """{family: launches} of the four kernels."""
    return {"moments": moments_launches, "reshape": reshape_launches, "acc": acc_launches,
            "scan": scan_launches}


def reset_launch_counts():
    global moments_launches, reshape_launches, acc_launches, scan_launches, stage_launches
    global tf32x3_stage_launches, cumsum_stage_launches, cuda_stage_launches, bf16_stage_launches
    moments_launches = reshape_launches = acc_launches = scan_launches = stage_launches = 0
    tf32x3_stage_launches = cumsum_stage_launches = cuda_stage_launches = bf16_stage_launches = 0
    form_launches.clear()
