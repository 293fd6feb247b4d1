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
CUDA-core forms; and the stages of the tensor-core cumsums (the products and
carry on an operand made once, the operand work alone, the other carry,
ops.reduce_scan.CUMSUM_STAGES), of the log-space cumprod kernel (products,
logs and exps alone, ops.reduce_scan.SCAN_STAGES), of the 3xTF32 moments
and accumulator kernels (the products on an operand split once, the split
alone, ops.reduce_scan.TF32X3_STAGES), of the bf16 moments and accumulator
kernels (the chunk's read, the operand work and the products alone,
ops.reduce_scan.BF16_STAGES) and of the CUDA-core moments, accumulator,
cumsum and cumprod kernels (the chunk's read, the store and the observer
alone, ops.reduce_scan.CUDA_STAGES), each against its plain version and
timed, which say what holds them back.

    python -m moss_torch.tools.mxu_micro

Runs on the GPU; main(device="cpu") runs the plain versions on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops import reduce_scan as rs
from ..ops.reduce_scan import H, K, PIX, REPS, RUNS, TILES, W
from .timing import device_name, sm_clock_hz, timer

# H100 SXM peaks (NVIDIA datasheet, dense): FLOP/s on the CUDA cores in f32,
# on the tensor cores in bf16 and TF32; HBM bytes/s
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
MUFU_PER_CLOCK = 16 * 132  # transcendental ops a clock: 16 an SM, 132 SMs
FP32_PER_CLOCK = 128 * 132  # FP32-pipe lanes a clock: 128 an SM (one warp instruction a scheduler)
ELEMS = K * PIX  # elements of a chunk
# transcendentals a run's function takes per element and rep: the log-space
# cumprod's logarithm and exponential
TRANSCENDENTALS = {"cumprod_logsplit2": 2}
# FLOPs of one pass of a contraction per chunk-op: (K, 1024) @ (1024, 8) for
# the moments, (8, K) @ (K, 1024) for the accumulators
CONTRACTION_FLOPS = 2 * K * PIX * 8
# FLOPs of one 16x16 block of L against the 1024 pixels of a chunk-op. A
# tensor-core scan pass multiplies SCAN_TC_BLOCKS of them: the bf16 cumsum the
# diagonal block of each of the 8 16-splat slabs and an all-ones block for
# the carry after each but the last (15), the split2 cumsum the 8 diagonal
# blocks (its carry is shuffled), the log-space cumprod the 36 blocks of L on
# or below its diagonal (72x the scan's adds). This is the formulation's work, not the
# function's, so it gives the products' rate and a bound of the formulation
# beside the scan's own bound
BLOCK_FLOPS = 2 * 16 * 16 * PIX
SCAN_TC_BLOCKS = {"cumsum_bf16": 15, "cumsum_split2": 8, "cumprod_logsplit2": 36}
# per run: (tensor-core FLOPs per chunk-op the function needs, their peak or
# None, f32 operations per element and rep on the CUDA cores: an FMA counts
# 2, a log1pf or expf 1, which keeps the bound low, and a rounding
# conversion 0). CUDA-core forms: moments 6, the separable form's least work
# (kern_moments_vpu's order) per 8-row column: 8 adds x + i, 7 adds of the
# row sum, 6 FMAs each for the sums weighted by py and py^2 (each starts at
# row 1's term, row 0's weight is 0), then 3 adds and 3 FMAs into the six
# moments, 48 a column; reshape 2 (x + i, the add), acc 11 (x + i, five
# FMAs), cumsum 3 (x + i, the running add, the add into the sum), cumprod 7 (x c, the clip's
# max and min, 1 - a, the select, the running product, the add). The
# tensor-core contractions count their passes' FLOPs and their operand work
# (x + i; 3xTF32 also the split's subtract). The tensor-core scans are bound
# by the scan itself: the cumsum's 3 (bf16), plus the split's subtract
# (split2 4); the log-space cumprod x c, max, min, the select, log1pf, the
# split's subtract, the running add, expf and the add into the sum (9)
OPS = {
    "moments_cuda": (0, None, 6),
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
# FP32-pipe instructions an element and rep of the runs made of adds alone:
# their issue floor, at FP32_PER_CLOCK and the SM clock, sits above the bound,
# which counts an FMA as two operations (the reshape's x + i and the add, the
# cumsum's x + i, the running add and the add into the sum)
FADDS = {"reshape_only": 2, "cumsum_cuda": 3}
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


def bound(name, clock_hz=None):
    """The least time of one launch of `name` (TILES x REPS chunk-ops): the
    larger of the bytes (x and s read once, the output written once) at
    HBM's rate and the operations at the peak of each unit they run on. For
    a tensor-core scan also the bound of its formulation, the FLOPs of the
    blocks of L it multiplies at the bf16 peak; for a run with transcendentals, given
    the SM clock, their time were they all MUFU ops (sfu_bound_ms), at
    MUFU_PER_CLOCK; for a run of FADDS, given the SM clock, the time of its
    adds at one warp instruction a clock a scheduler (issue_floor_ms)."""
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
        row["formulation_tc_flops"] = (chunk_ops * SCAN_TC_PASSES[name] * SCAN_TC_BLOCKS[name]
                                       * BLOCK_FLOPS)
        row["formulation_bound_ms"] = 1e3 * row["formulation_tc_flops"] / PEAK_BF16
    if name in TRANSCENDENTALS and clock_hz:
        row["transcendentals"] = chunk_ops * ELEMS * TRANSCENDENTALS[name]
        row["sm_clock_hz"] = clock_hz
        row["sfu_bound_ms"] = 1e3 * row["transcendentals"] / (MUFU_PER_CLOCK * clock_hz)
    if name in FADDS and clock_hz:
        row["sm_clock_hz"] = clock_hz
        row["issue_floor_ms"] = (1e3 * chunk_ops * ELEMS * FADDS[name]
                                 / (FP32_PER_CLOCK * clock_hz))
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


def _stage_row(what, out, obs, plain, time_fn, time_ms, timing):
    """Check a stage's output against its plain version (raising past RTOL
    of the max) and its observers across tiles; time it."""
    err = scaled_err(out, plain)
    if not (err <= RTOL and torch.isfinite(out).all()):
        raise AssertionError(f"{what}: off its plain version by {err:.2e} of the max")
    observers_equal = obs is None or bool(torch.equal(obs, obs[:1].expand_as(obs)))
    if not observers_equal:
        raise AssertionError(f"{what}: the tiles' observers differ")
    return {"ms": time_ms(time_fn, **(timing or TIMING)), "scaled_err": err,
            "observers_equal": observers_equal}


def cumsum_stages(x, time_ms, timing=None):
    """The tensor-core cumsums' stages (rs.CUMSUM_STAGES) in both modes on the
    chunk, each against its plain version, its observers equal across tiles,
    its ms; {mode: {stage: row}}."""
    rows = {}
    for mode in rs.CUMSUM_MODES:
        rows[mode] = {}
        for stage in rs.CUMSUM_STAGES:
            out, obs = rs.cumsum_stage(x, mode, stage)
            row = _stage_row(f"cumsum {mode} stage {stage}", out, obs,
                             rs.cumsum_stage_plain(x, mode, stage),
                             lambda: rs.cumsum_stage(x, mode, stage), time_ms, timing)
            rows[mode][stage] = row
            print(f"cumsum TC {mode:6s} stage {stage:8s} {row['ms']:8.4f} ms  err "
                  f"{row['scaled_err']:.1e}")
    return rows


def scan_stages(x, time_ms, timing=None):
    """The log-space cumprod kernel's stages (rs.SCAN_STAGES) on the chunk:
    each against its plain version (raising past RTOL of the max), its
    observers equal across tiles, its ms; {stage: row}."""
    rows = {}
    for stage in rs.SCAN_STAGES:
        out, obs = rs.scan_stage(x, stage)
        row = _stage_row(f"scan stage {stage}", out, obs, rs.scan_stage_plain(x, stage),
                         lambda: rs.scan_stage(x, stage), time_ms, timing)
        rows[stage] = row
        print(f"cumprod log+TC split2 stage {stage:8s} {row['ms']:8.4f} ms  err "
              f"{row['scaled_err']:.1e}")
    return rows


def tf32x3_stages(x, s, time_ms, timing=None):
    """The 3xTF32 moments and accumulator kernels' stages
    (rs.TF32X3_STAGES) on the chunk: each against its plain version
    (raising past RTOL of the max), its observers equal across tiles, its
    ms; {family: {stage: row}}."""
    rows = {}
    for family in ("moments", "acc"):
        rows[family] = {}
        for stage in rs.TF32X3_STAGES:
            out, obs = rs.tf32x3_stage(family, x, s, stage)
            row = _stage_row(f"{family} 3xTF32 stage {stage}", out, obs,
                             rs.tf32x3_stage_plain(family, x, s, stage),
                             lambda: rs.tf32x3_stage(family, x, s, stage), time_ms, timing)
            rows[family][stage] = row
            print(f"{family:7s} TC 3xTF32 stage {stage:8s} {row['ms']:8.4f} ms  err "
                  f"{row['scaled_err']:.1e}")
    return rows


def bf16_stages(x, s, time_ms, timing=None):
    """The bf16 moments and accumulator kernels' stages (rs.BF16_STAGES) on
    the chunk: each against its plain version (raising past RTOL of the max),
    its observers equal across tiles, its ms; {family: {stage: row}}."""
    rows = {}
    for family in rs.BF16_FAMILIES:
        rows[family] = {}
        for stage in rs.BF16_STAGES:
            out, obs = rs.bf16_stage(family, x, s, stage)
            row = _stage_row(f"{family} bf16 stage {stage}", out, obs,
                             rs.bf16_stage_plain(family, x, s, stage),
                             lambda: rs.bf16_stage(family, x, s, stage), time_ms, timing)
            rows[family][stage] = row
            print(f"{family:7s} TC bf16 stage {stage:8s} {row['ms']:8.4f} ms  err "
                  f"{row['scaled_err']:.1e}")
    return rows


def cuda_stages(x, s, time_ms, timing=None):
    """The CUDA-core moments, accumulator, cumsum and cumprod kernels' stages
    (rs.CUDA_STAGES) on the chunk: each against its plain version (raising
    past RTOL of the max), its observers equal across tiles, its ms;
    {family: {stage: row}}."""
    rows = {}
    for family in rs.CUDA_FAMILIES:
        rows[family] = {}
        for stage in rs.CUDA_STAGES:
            out, obs = rs.cuda_stage(family, x, s, stage)
            row = _stage_row(f"{family} CUDA cores stage {stage}", out, obs,
                             rs.cuda_stage_plain(family, x, s, stage),
                             lambda: rs.cuda_stage(family, x, s, stage), time_ms, timing)
            rows[family][stage] = row
            print(f"{family:7s} CUDA cores stage {stage:6s} {row['ms']:8.4f} ms  err "
                  f"{row['scaled_err']:.1e}")
    return rows


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
    clock_hz = sm_clock_hz(dev)
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
                   **bound(name, clock_hz)}
            if "formulation_tc_flops" in row:  # the rate of the products of L's blocks
                row["formulation_tflops"] = row["formulation_tc_flops"] / ms / 1e9
            rows[name] = row
            print(f"{LABEL[name]:24s} {ms:8.3f} ms total  {row['ns_per_chunk_op']:8.1f} "
                  f"ns/chunk-op  bound {row['bound_ms']:7.4f} ms  plain "
                  f"{row['plain_ns_per_chunk_op']:9.1f} ns/chunk-op  library "
                  f"{row['library_ns_per_chunk_op']:8.1f} ns/chunk-op  err {err:.1e}")
            if "sfu_bound_ms" in row:
                print(f"{'':24s} SFU bound {row['sfu_bound_ms']:.4f} ms: "
                      f"{row['transcendentals']:.4g} transcendentals at {MUFU_PER_CLOCK} a "
                      f"clock, {clock_hz / 1e9:.3f} GHz")
            if "issue_floor_ms" in row:
                print(f"{'':24s} FADD issue floor {row['issue_floor_ms']:.4f} ms: {FADDS[name]} an "
                      f"element and rep at {FP32_PER_CLOCK} a clock, "
                      f"{row['sm_clock_hz'] / 1e9:.3f} GHz")
    return {"device": device_name(dev), "reps": REPS, "tiles": TILES, "runs": rows,
            "numeric": numeric_lines(outs, x), "cumsum_stages": cumsum_stages(x, time_ms, timing),
            "scan_stages": scan_stages(x, time_ms, timing),
            "tf32x3_stages": tf32x3_stages(x, s, time_ms, timing),
            "bf16_stages": bf16_stages(x, s, time_ms, timing),
            "cuda_stages": cuda_stages(x, s, time_ms, timing)}


if __name__ == "__main__":
    main()
