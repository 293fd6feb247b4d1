"""The tensor cores' TF32 and bf16 rates at N = 8 by instruction form, and
what a TF32 operand register carries: csrc/tc_rate.cu.

The tensor-core moments and accumulators of csrc/reduce_scan.cu multiply by
a matrix only 8 wide (the basis, or s). This tool measures the rate at which
the product instructions Hopper offers run at that width, on constant
operands with nothing else in the kernel: in TF32 mma.sync m16n8k8 (eight
independent accumulators a warp) and wgmma m64n8k8 and m64n16k8 (A from
registers, B from shared memory, eight products a commit group, one group
in flight), in bf16 mma.sync m16n8k16 (the bf16 moments' product), each at
1-4 CTAs of 256 threads an SM. Then each again with its kernels' operand
work beside the products, on registers the products do not read: for TF32
the 3xTF32 split (6 instructions an element, 8 elements a round of 8
products), for bf16 the bf16 moments' x + i and packs (64 adds and 32
cvt.rn.bf16x2 a round of 8 products, folded by xor); and that work alone:
whether the form lets the two overlap. And it checks, on random
operands, that an m16n8k8 product of the unmasked bits(v) + 0x1000 that
reduce_scan.cu's split_operand hands the tensor cores is bitwise the product
of cvt.rna.tf32.f32(v): that the tensor cores read only a TF32 operand's 19
high bits.

    python -m moss_torch.tools.tc_rate

Runs on the GPU only; prints a line per form and CTA count (alone, with its
operand work, the work alone), the check, and the card's name and power
limit.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from .. import resolve_device
from ..ops import cuda_build
from .timing import cuda_ms

PEAK_TF32, PEAK_BF16 = 495e12, 989e12  # H100 SXM, dense (NVIDIA datasheet)
FORMS = {"mma_m16n8k8": 0, "wgmma_m64n8k8": 1, "wgmma_m64n16k8": 2, "mma_bf16_m16n8k16": 4}
WORK_ALONE = 3  # csrc/tc_rate.cu kNone: operand work and no products
# csrc/tc_rate.cu enum Work: the 3xTF32 split, the bf16 moments' x + i and packs
WORK = {"split": 1, "bf16": 2}
# each form's peak and the operand work of the kernels that take it
PEAK = {f: PEAK_BF16 if "bf16" in f else PEAK_TF32 for f in FORMS}
FORM_WORK = {f: "bf16" if "bf16" in f else "split" for f in FORMS}
# multiply-adds of one instruction of a warp (mma.sync) or a warpgroup (wgmma)
MACS = {"mma_m16n8k8": 16 * 8 * 8, "wgmma_m64n8k8": 64 * 8 * 8, "wgmma_m64n16k8": 64 * 16 * 8,
        "mma_bf16_m16n8k16": 16 * 8 * 16}
THREADS, ITERS, SMS = 256, 2048, 132
CTAS_PER_SM = (1, 2, 4)
LOW_BITS_DRAWS = 16

# kernel launches since the last reset (set to 0 to count a run)
rate_launches = 0
low_bits_launches = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def tflops(form: str, ms: float, blocks: int, threads: int = THREADS, iters: int = ITERS):
    """TFLOP/s of a launch of `form` that took `ms`: eight instructions a
    round for each warp (mma.sync) or warpgroup (wgmma)."""
    issuers = threads // (32 if form.startswith("mma") else 128)
    return 2 * MACS[form] * 8 * iters * issuers * blocks / (ms * 1e-3) / 1e12


def rate(form, blocks: int, device, work=None, out=None):
    """One launch of `form` (a name of FORMS, or None for the work alone),
    with the operand work `work` (a name of WORK, or None) beside it, over
    `blocks` CTAs; returns the output buffer."""
    global rate_launches
    out = torch.empty(THREADS, dtype=torch.float32, device=device) if out is None else out
    code = WORK_ALONE if form is None else FORMS[form]
    cuda_build.launch("tc_rate", "moss_tc_rate", [_INT, _INT, _PTR, _INT, _INT, _INT], device,
                      code, WORK[work] if work else 0, out.data_ptr(), blocks, THREADS, ITERS)
    rate_launches += 1
    return out


def low_bits(device, seed=0):
    """Max |d_bits - d_rna| over LOW_BITS_DRAWS random m16n8k8 products (0 when
    the tensor cores ignore an operand's 13 low bits)."""
    global low_bits_launches
    rng = np.random.default_rng(seed)
    worst = 0.0
    for _ in range(LOW_BITS_DRAWS):
        a = torch.as_tensor((rng.normal(size=(16, 8)) * 10 ** rng.uniform(-3, 3, (16, 8)))
                            .astype(np.float32), device=device)
        b = torch.as_tensor(rng.normal(size=(8, 8)).astype(np.float32), device=device)
        d = torch.empty((2, 16, 8), dtype=torch.float32, device=device)
        cuda_build.launch("tc_rate", "moss_tc_low_bits", [_PTR] * 3, device, a.data_ptr(),
                          b.data_ptr(), d.data_ptr())
        low_bits_launches += 1
        worst = max(worst, float((d[1] - d[0]).abs().max()))
    return worst


def main(device=None):
    """{"low_bits_max_abs_diff", "rates": {form: {ctas_per_sm: {ms, tflops,
    share_of_peak, work, ms_with_work}}}, "work_alone_ms": {work:
    {ctas_per_sm: ms}}, "nvidia_smi"}."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("tc_rate measures the tensor cores: it needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    diff = low_bits(dev)
    print(f"mma.sync tf32 on bits(v) + 0x1000 against cvt.rna(v): max |diff| {diff}", flush=True)
    if diff != 0.0:
        raise AssertionError("the tensor cores read a TF32 operand's low 13 bits")
    out = torch.empty(THREADS, dtype=torch.float32, device=dev)
    def time(form, blocks, work):
        return cuda_ms(lambda: rate(form, blocks, dev, work, out), n=5, reps=2, warmup=1)

    alone = {work: {per_sm: time(None, per_sm * SMS, work) for per_sm in CTAS_PER_SM}
             for work in WORK}
    rates = {}
    for form in FORMS:
        rates[form] = {}
        work = FORM_WORK[form]
        for per_sm in CTAS_PER_SM:
            blocks = per_sm * SMS
            ms, with_work = time(form, blocks, None), time(form, blocks, work)
            tf = tflops(form, ms, blocks)
            share = tf * 1e12 / PEAK[form]
            rates[form][per_sm] = {"ms": ms, "tflops": tf, "share_of_peak": share, "work": work,
                                   "ms_with_work": with_work}
            print(f"{form:17s} {per_sm} CTA(s) of {THREADS} an SM: {ms:8.4f} ms  {tf:6.1f} "
                  f"TFLOP/s  ({100 * share:.1f}% of the {'bf16' if 'bf16' in form else 'TF32'} "
                  f"peak); with the {work} work {with_work:.4f} ms, the work alone "
                  f"{alone[work][per_sm]:.4f}", flush=True)
    print(smi, flush=True)
    return {"low_bits_max_abs_diff": diff, "rates": rates, "work_alone_ms": alone,
            "nvidia_smi": smi}


if __name__ == "__main__":
    main()
