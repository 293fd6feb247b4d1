"""One run of one benchmark cell of moss_torch on the card.

    python3 -m benchmark.run --workload zju.steady --seed 7 --seconds 30 --trace 0

From the root of a checkout: builds the cell's inputs from --seed
(inputs.py), trains the port's Trainer under the cell's engine through set-up
and the window (harness.py), frees the program, checks what its timed path
produced against the plain reference (check.py), and prints one JSON line
last on stdout: correct, attempted (the window's iterations), failed, the
cell's end-to-end metrics (--trace 0) or its per-layer ones (--trace 1,
each read by benchmark/metrics/<name>.py), the device, and last `checks`,
each number compared beside its limit (also the last lines on stderr).
Which metrics a cell reports is read from BENCHMARK.json's `workloads`
lists; a metric `a.b` without a reader of its own is read by `a`'s. Exits
non-zero with no result line when no card is there, and when jax, jaxlib,
flax or moss_tpu is loaded in this process once the window has closed: looked
for after the window and again after the readers and the reference ran.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "moss_tpu")
# each traffic's end-to-end metric of the window's wall time over its iterations
MS_PER_ITER = {"steady": "train_ms_per_iter"}


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_metrics(bench, cell: str, kind: str):
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def finite(v):
    """A number as JSON takes it: a non-finite float becomes null."""
    return v if not isinstance(v, float) or v == v and abs(v) != float("inf") else None


class Context:
    """What a per-layer reader (benchmark/metrics/<name>.py) reads."""

    def __init__(self, run, trace):
        self.run, self.trace = run, trace
        self._work = None

    def step_work(self):
        if self._work is None:
            self._work = self.run.traced_work()
        return self._work


def read_metric(name: str, ctx):
    """benchmark/metrics/<name>.py's read(ctx), or, where a name `a.b` has no
    file of its own, a.py's."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def measure(bench, workload: str, seed: int, seconds: float, trace: bool, device,
            config=None, workload_data=None):
    """(result, stderr lines) of one run of `workload` on `device`; result
    None when a forbidden module is loaded. config and workload_data replace
    the cell's files (the tests' small sizes)."""
    import torch

    from . import check
    from .harness import Run
    from .inputs import make_inputs

    cuda = device.type == "cuda"
    t_inputs = time.perf_counter()
    inp = make_inputs(workload, seed, device, config=config, workload=workload_data)
    if cuda:
        torch.cuda.synchronize(device)
    run = Run(inp, device, seconds, trace=trace)
    run.marks["inputs"] = time.perf_counter()
    run.run()
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    setup_s = run.t_start - T_PROCESS
    found = forbidden_modules()
    if found:
        return None, [f"modules of {found} are loaded in the benchmark's process after the window"]

    metrics = {}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power": power_limit() if cuda else None}
    breakdown = None
    if trace:
        from .trace import Trace

        tr = None if run.profiled is None else Trace(run.profiled["prof"], run.profiled["wall_s"],
                                                     run.profiled["steps"])
        ctx = Context(run, tr)
        for m in cell_metrics(bench, workload, "per_layer"):
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tr is not None:
            device_info.update(busy_s=tr.busy_s, window_s=tr.wall_s)
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        e2e = {MS_PER_ITER[inp.workload["traffic"]]: 1e3 * run.window_s / run.iterations,
               "peak_alloc_gb": peak / 1e9, "setup_s": setup_s}
        for m in cell_metrics(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    prog = (run.checked_logs(), run.first_grad, run.first_change)
    overflow, failed, attempted = run.checked_overflow(), run.failed(), run.iterations
    marks, t_window, segments = run.marks, run.t_start, run.setup_segments
    window = {"from": run.it_start, "to": run.it_end, "seconds": run.window_s,
              "budgets": run.budgets_final, "live": run.live_final}
    run.free()
    del run
    t_ref = time.perf_counter()
    numbers = check.step_numbers(*prog, check.reference_steps(inp, device), inp.optim)
    ref_s = time.perf_counter() - t_ref
    limits = inp.workload["limits"]
    correct, lines = check.judge(numbers, limits, overflow)
    stages = [("start", T_PROCESS), ("torch", t_inputs)] + list(marks.items()) + [
        ("segments", t_window)]
    setup_parts = {b[0]: b[1] - a[1] for a, b in zip(stages, stages[1:])}
    lines.insert(0, json.dumps({"window": window, "reference_s": ref_s, "setup_s": setup_s,
                                "setup_parts": setup_parts, "setup_segments": segments,
                                "numbers": {k: finite(v) for k, v in numbers.items()}}))
    checks = {k: {"value": finite(v), "limit": limits.get(k)}
              for k, v in numbers.items() if not k.startswith("_")}
    checks["checked_steps_overflow"] = {"value": overflow, "limit": 0}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    found = forbidden_modules()
    if found:
        return None, [f"modules of {found} are loaded in the benchmark's process after the "
                      "readers and the reference ran"]
    return out, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"this cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    # the configurations' precision: float32 without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, lines = measure(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0))
    if out is None:
        print("\n".join(lines), file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
