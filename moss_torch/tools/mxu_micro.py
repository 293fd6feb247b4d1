"""Reductions and scans of the blend kernels on CUDA cores vs tensor cores.

Counterpart of tools/mxu_micro.py, which asks whether the blend kernels'
reductions and scans should move from the vector units to the matrix unit;
on the H100 the question is CUDA cores against tensor cores. It runs the
JAX tool's twelve runs (csrc/reduce_scan.cu through ops/reduce_scan.py) at
its shapes and inputs: a chunk x (128 splats, 8 x 128 pixels) and s (8, 128)
from default_rng(0) (:240-243), REPS = 16 repeats in the kernel, a grid of
TILES = 256 copies of the chunk. Per run it prints the ms of a launch and the
ns per chunk-op (ms / (TILES REPS)), as the JAX tool's run() does (:235),
beside the run's bound and two times of the same work, TILES x REPS
chunk-ops: the plain version on a stack of the TILES chunks, and one PyTorch
call that computes the same function (torch.matmul in f32 or bf16, a sum,
torch.cumsum, torch.cumprod) batched over the TILES x REPS chunks, its stack
built outside the timed window. Then the JAX tool's numeric lines
(:279-300): the moments of each form against an f64 sum_i (x + i) @ basis,
and the tensor-core forms of the accumulators and scans against the
CUDA-core forms.

    python -m moss_torch.tools.mxu_micro

Runs on the GPU; main(device="cpu") runs the plain versions on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops import reduce_scan as rs
from ..ops.reduce_scan import H, K, PIX, REPS, RUNS, TILES, W
from .timing import device_name, timer

# H100 SXM peaks (NVIDIA datasheet, dense): FLOP/s on the CUDA cores in f32,
# on the tensor cores in bf16 and TF32; HBM bytes/s
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
ELEMS = K * PIX  # elements of a chunk
# FLOPs of one pass of a contraction per chunk-op: (K, 1024) @ (1024, 8) for
# the moments, (8, K) @ (K, 1024) for the accumulators
CONTRACTION_FLOPS = 2 * K * PIX * 8
# FLOPs of one tensor-core scan pass per chunk-op: the 36 16x16 blocks of the
# lower-triangular L on or below its diagonal (the kernel skips the 28 zero
# ones), each against the 1024 pixels. 72x the scan's adds: this is the
# formulation's work, not the function's, so it gives the L product's rate
# and a bound of the formulation beside the scan's own bound
SCAN_TC_FLOPS = 2 * 16 * 16 * PIX * 36
# per run: (tensor-core FLOPs per chunk-op the function needs, their peak or
# None, f32 operations per element and rep on the CUDA cores: an FMA counts
# 2, a log1pf or expf 1, which keeps the bound low, and a rounding
# conversion 0). CUDA-core forms: moments 12 (x + i, v px, v py, three adds,
# three FMAs), reshape 2 (x + i, the add), acc 11 (x + i, five FMAs), cumsum 3
# (x + i, the running add, the add into the sum), cumprod 7 (x c, the clip's
# max and min, 1 - a, the select, the running product, the add). The
# tensor-core contractions count their passes' FLOPs and their operand work
# (x + i; 3xTF32 also the split's subtract). The tensor-core scans are bound
# by the scan itself: the cumsum's 3 (bf16), plus the split's subtract
# (split2 4); the log-space cumprod x c, max, min, the select, log1pf, the
# split's subtract, the running add, expf and the add into the sum (9)
OPS = {
    "moments_cuda": (0, None, 12),
    "moments_tf32x3": (3 * CONTRACTION_FLOPS, PEAK_TF32, 2),
    "moments_bf16": (CONTRACTION_FLOPS, PEAK_BF16, 1),
    "reshape_only": (0, None, 2),
    "acc_cuda": (0, None, 11),
    "acc_tf32x3": (3 * CONTRACTION_FLOPS, PEAK_TF32, 2),
    "acc_bf16": (CONTRACTION_FLOPS, PEAK_BF16, 1),
    "cumsum_cuda": (0, None, 3),
    "cumsum_bf16": (0, None, 3),
    "cumsum_split2": (0, None, 4),
    "cumprod_cuda": (0, None, 7),
    "cumprod_logsplit2": (0, None, 9),
}
# passes of the triangular product of the tensor-core scans
SCAN_TC_PASSES = {"cumsum_bf16": 1, "cumsum_split2": 2, "cumprod_logsplit2": 2}
OUT_ELEMS = {"moments": K * 8, "reshape": K * 128, "acc": 8 * PIX, "cumsum": ELEMS,
             "cumprod": ELEMS}
RTOL = 1e-5  # kernel vs plain: max |out - plain| <= RTOL max |plain|
TIMING = {"n": 10, "reps": 5, "warmup": 2}
PLAIN_TIMING = {"n": 3, "reps": 1, "warmup": 1}  # the plain versions and library calls
LABEL = {  # the JAX tool's names (:246-272)
    "moments_cuda": "moments CUDA cores", "moments_tf32x3": "moments TC 3xTF32",
    "moments_bf16": "moments TC bf16", "reshape_only": "reshape only",
    "acc_cuda": "acc CUDA cores", "acc_tf32x3": "acc TC 3xTF32", "acc_bf16": "acc TC bf16",
    "cumsum_cuda": "cumsum CUDA cores", "cumsum_bf16": "cumsum TC bf16",
    "cumsum_split2": "cumsum TC split2", "cumprod_cuda": "cumprod CUDA cores",
    "cumprod_logsplit2": "cumprod log+TC split2",
}


def inputs(dev):
    """The JAX tool's x (K, 8, 128) and s (8, K), from default_rng(0)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(K, 8, 128)).astype(np.float32)
    s = rng.normal(size=(8, K)).astype(np.float32)
    return torch.as_tensor(x, device=dev), torch.as_tensor(s, device=dev)


def bound(name):
    """The least time of one launch of `name` (TILES x REPS chunk-ops): the
    larger of the bytes (x and s read once, the output written once) at
    HBM's rate and the operations at the peak of each unit they run on. For
    a tensor-core scan also the bound of its formulation, the triangular
    product's FLOPs at the bf16 peak."""
    family = rs.RUN[name][1]
    tc_flops, tc_peak, f32_per_elem = OPS[name]
    bytes_ = 4 * (ELEMS + (8 * K if family == "acc" else 0) + OUT_ELEMS[family])
    chunk_ops = TILES * REPS
    t_bytes = bytes_ / PEAK_BYTES
    t_tc = chunk_ops * tc_flops / tc_peak if tc_flops else 0.0
    t_ops = max(t_tc, chunk_ops * ELEMS * f32_per_elem / PEAK_F32)
    row = {"bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes > t_ops else "operations",
           "tc_flops": chunk_ops * tc_flops, "f32_ops": chunk_ops * ELEMS * f32_per_elem,
           "bytes": bytes_}
    if name in SCAN_TC_PASSES:
        row["formulation_tc_flops"] = chunk_ops * SCAN_TC_PASSES[name] * SCAN_TC_FLOPS
        row["formulation_bound_ms"] = 1e3 * row["formulation_tc_flops"] / PEAK_BF16
    return row


def chunk_stack(x, tiles):
    """The chunk repeated for `tiles` tiles, (tiles, K, 8, 128), contiguous:
    the plain versions' input for a launch's work."""
    return x.expand(tiles, *x.shape).contiguous()


def library_call(name, x, s, tiles=TILES):
    """One PyTorch call that computes `name`'s function on each of the tiles
    x REPS chunk-ops of a launch, its stack (tiles REPS, K, 1024) built here,
    outside the timed window: a matmul for the contractions, a sum over the 8
    rows for reshape_only, cumsum or cumprod over the splats for the scans."""
    _, family, mode, _ = rs.RUN[name]
    i = torch.arange(REPS, dtype=torch.float32, device=x.device).view(REPS, 1, 1)
    x0 = x.reshape(1, K, PIX)
    if family == "cumprod":
        scale = torch.tensor([0.01 * (r + 1) for r in range(REPS)], dtype=torch.float32,
                             device=x.device).view(REPS, 1, 1)
        a = torch.clamp(x0 * scale, 0.0, 0.9)  # rep_alpha of every rep
        per_rep = torch.where(a > 0.003, 1.0 - a, 1.0)
    else:
        per_rep = x0 + i
    g = per_rep.expand(tiles, REPS, K, PIX).reshape(tiles * REPS, K, PIX)
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    if family == "moments":
        gb, b = g.to(dtype), rs.basis(x.device).to(dtype)
        return lambda: torch.matmul(gb, b)
    if family == "acc":
        gb, sb = g.to(dtype), s.to(dtype)
        return lambda: torch.matmul(sb, gb)
    if family == "reshape":
        g4 = g.view(tiles * REPS, K, H, W)
        return lambda: g4.sum(2)
    if family == "cumsum":
        return lambda: torch.cumsum(g, dim=1)
    return lambda: torch.cumprod(g, dim=1)


def scaled_err(a, b):
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)


def _rel(a, b):
    """The JAX tool's relative error: max |a - b| / (|b| + 1e-3)."""
    return float(((a - b).abs() / (b.abs() + 1e-3)).max())


def numeric_lines(outs, x):
    """The JAX tool's numeric checks (:273-300) on the runs' outputs, plus the
    same errors as shares of the max. Like with like: the moments' columns
    0-5 and the accumulators' rows 0-4, which every form computes."""
    xs = x.double().reshape(K, PIX)
    b = rs.basis(x.device).double()
    ref = sum((xs + i) @ b for i in range(REPS))[:, :6]
    res = {"moments_rel_err_vs_f64": {m: _rel(outs[f"moments_{m}"].double()[:, :6], ref)
                                      for m in ("cuda", "tf32x3", "bf16")},
           "moments_err_of_max_vs_f64": {m: scaled_err(outs[f"moments_{m}"].double()[:, :6], ref)
                                         for m in ("cuda", "tf32x3", "bf16")}}
    pairs = (("acc", "tf32x3", "cuda", slice(0, 5)), ("acc", "bf16", "cuda", slice(0, 5)),
             ("cumsum", "split2", "cuda", slice(None)), ("cumsum", "bf16", "cuda", slice(None)),
             ("cumprod", "logsplit2", "cuda", slice(None)))
    for fam, a, bname, rows in pairs:
        got, want = outs[f"{fam}_{a}"][rows], outs[f"{fam}_{bname}"][rows]
        res[f"{fam}_{a}_vs_{bname}"] = {"rel": _rel(got, want), "of_max": scaled_err(got, want)}
    print("moments rel err vs f64: " + "  ".join(
        f"{m} {res['moments_rel_err_vs_f64'][m]:.2e} ({res['moments_err_of_max_vs_f64'][m]:.2e}"
        " of the max)" for m in ("cuda", "tf32x3", "bf16")))
    for fam, a, bname, _ in pairs:
        r = res[f"{fam}_{a}_vs_{bname}"]
        print(f"{fam:8s} |{a} - {bname}| rel: {r['rel']:.2e}  ({r['of_max']:.2e} of the max)")
    return res


def main(device=None, timing=None, tiles=TILES):
    """Run, check, time and print the twelve runs; return {"runs": {name:
    row}, "numeric": the numeric lines}. timing: cuda_ms / cpu_ms keywords
    for every timing (by default TIMING for the kernels, PLAIN_TIMING for the
    plain versions and library calls); tiles: the copies of the chunk those
    two are timed on (a launch's TILES; fewer only to keep a run on the host
    small)."""
    dev = resolve_device(device)
    time_ms = timer(dev)
    timing, plain_timing = timing or TIMING, timing or PLAIN_TIMING
    x, s = inputs(dev)
    xt = chunk_stack(x, tiles)
    print(f"device: {device_name(dev)}; chunk ({K}, 8, 128) f32, REPS = {REPS}, TILES = {TILES}")
    rows, outs = {}, {}
    with rs.full_f32():
        for name, _, _, jax_kernel in RUNS:
            if name == "moments_cuda":
                print("# A. moments (pixel-axis contraction), per chunk amplified x16 x256")
            elif name == "acc_cuda":
                print("# B. fwd accumulators (splat-axis contraction)")
            elif name == "cumsum_cuda":
                print("# C. splat-axis scans (cumsum / masked cumprod over K=128)")
            out = rs.run(name, x, s)[0]
            plain = rs.run_plain(name, x, s)
            err = scaled_err(out, plain)
            if not (err <= RTOL and torch.isfinite(out).all()):
                raise AssertionError(f"{name}: kernel off its plain version by {err:.2e} of "
                                     "the max")
            outs[name] = out
            ms = time_ms(lambda: rs.run(name, x, s), **timing)
            plain_ms = time_ms(lambda: rs.run_plain(name, xt, s), **plain_timing)
            lib = library_call(name, x, s, tiles)
            lib_ms = time_ms(lib, **plain_timing)
            del lib
            chunk_ops = tiles * REPS
            row = {"replaces": f"tools/mxu_micro.py::{jax_kernel}", "ms": ms,
                   "ns_per_chunk_op": ms / (TILES * REPS) * 1e6, "timed_tiles": tiles,
                   "plain_ms": plain_ms, "plain_ns_per_chunk_op": plain_ms / chunk_ops * 1e6,
                   "library_ms": lib_ms, "library_ns_per_chunk_op": lib_ms / chunk_ops * 1e6,
                   "max_abs_err": float((out - plain).abs().max()), "scaled_err": err,
                   **bound(name)}
            if "formulation_tc_flops" in row:  # the triangular product's rate
                row["formulation_tflops"] = row["formulation_tc_flops"] / ms / 1e9
            rows[name] = row
            print(f"{LABEL[name]:24s} {ms:8.3f} ms total  {row['ns_per_chunk_op']:8.1f} "
                  f"ns/chunk-op  bound {row['bound_ms']:7.4f} ms  plain "
                  f"{row['plain_ns_per_chunk_op']:9.1f} ns/chunk-op  library "
                  f"{row['library_ns_per_chunk_op']:8.1f} ns/chunk-op  err {err:.1e}")
    return {"device": device_name(dev), "reps": REPS, "tiles": TILES, "runs": rows,
            "numeric": numeric_lines(outs, x)}


if __name__ == "__main__":
    main()
