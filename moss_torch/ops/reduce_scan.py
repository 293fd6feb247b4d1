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


def _mm(a, b, mode):
    """a @ b with the operands rounded as `mode` rounds them, f32 sums."""
    with full_f32():
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
    return res


# ---- the twelve runs by name ----------------------------------------------------

def _scan_op(family):
    return "add" if family == "cumsum" else "mul"


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
    global moments_launches, reshape_launches, acc_launches, scan_launches
    moments_launches = reshape_launches = acc_launches = scan_launches = 0
