"""The readings the limits of `correct` are set from, and the control.

    python3 -m benchmark.control --workload zju.steady --seeds 1 2 3 --modes program tf32

For each seed, in one process: the cell's inputs, the program's set-up and
its checked steps, then the reference, and the numbers check.py compares;
one JSON line each. Mode "program" runs the program as the
configuration states (float32 with TF32 off): its readings are the sound
runs' that set a limit's lower end. Mode "tf32" is the control: the program
with TF32 switched on for its matmuls and cuDNN convolutions, the precision
step below the configuration's; the reference always runs without it.
Modes "half_batch", "altered" and "unchanged" plant a fault in the program
(MODES). The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from . import check
from .harness import Run
from .inputs import make_inputs


@contextlib.contextmanager
def tf32():
    """The control: TF32 on for the program's matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def half_batch():
    """A fault: the loss's means taken over the upper half of each frame's
    bound region, the lower half left out."""
    from moss_torch.train import train_step

    def make(real):
        def half(out, gt, bkgd, bound, *a, **k):
            rows = torch.arange(bound.shape[0], device=bound.device)[:, None]
            return real(out, gt, bkgd, bound * (rows < bound.shape[0] // 2), *a, **k)
        return half
    return patched(train_step, "compute_losses", make)


def altered():
    """A fault: the rendered image altered where the blend produces it, one
    16 x 16 tile's red off by 0.05 at the image's centre."""
    from moss_torch.train import trainer

    def make(real):
        def alter(*a, **k):
            out = dict(real(*a, **k))
            c = out["color"]
            y, x = c.shape[0] // 32 * 16, c.shape[1] // 32 * 16
            bump = torch.zeros_like(c)
            bump[y:y + 16, x:x + 16, 0] = 0.05
            out["color"] = c + bump
            return out
        return alter
    return patched(trainer, "rasterize_cuda", make)


def unchanged():
    """A fault: AdamW leaves every parameter and moment as it was."""
    from moss_torch.train import optim

    return patched(optim, "adamw_step_device", lambda real: (lambda *a, **k: None))


MODES = {"program": contextlib.nullcontext, "tf32": tf32, "half_batch": half_batch,
         "altered": altered, "unchanged": unchanged}


def readings(workload: str, seed: int, mode: str, device, config=None, workload_data=None):
    """check.py's numbers of one seed under `mode` (MODES: the program as the
    configuration states, the control, or a planted fault)."""
    inp = make_inputs(workload, seed, device, config=config, workload=workload_data)
    with MODES[mode]():
        run = Run(inp, device, 0.0)
        run.run(window=False)
    prog = (run.checked_logs(), run.first_grad, run.first_change)
    overflow = run.checked_overflow()
    run.free()
    numbers = check.step_numbers(*prog, check.reference_steps(inp, device), inp.optim)
    numbers["_overflow"] = overflow
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+", default=["program", "tf32"], choices=list(MODES))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        for mode in args.modes:
            t0 = time.perf_counter()
            numbers = readings(args.workload, seed, mode, device)
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "s": time.perf_counter() - t0, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
