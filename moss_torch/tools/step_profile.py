"""Profile one training step of the trainer's full-width cell by operator, on
one card, for one or two checkouts of this repository.

    python -m moss_torch.tools.step_profile [--other ROOT] [--steps N] [--json FILE]

The cell is chip_smoke.py's `trainer` and `engines` scene: the synthetic SMPL
body (6,890 vertices), four 512 x 512 train frames and one test frame, the
46,080-Gaussian capacity, a 256 x 256 crop, the six-term loss and the random
LPIPS tower, the Trainer's cloud at its first step. Each variant runs in a
child process that imports its checkout's moss_torch (which builds that
checkout's kernels), takes 3 warm-up steps, then STEPS steps on the host
clock and STEPS under torch.profiler, and prints one RESULT line.

Variants, where the checkout has what they need:
  step          the Trainer's step_fn, a step a call on the TrainState with
                int counts and the frame's int crop (in a checkout without the
                static pair budgets: the per-frame pair list)
  per_frame     the same step built with no budgets (rasterize_fn None): the
                per-frame pair list
  engine        the queued engine's form: make_train_many with graph=False on
                the device-state TrainState over the staged frames (device
                crop offsets), one call of STEPS steps and one log read
  engine_b16    engine with the rect cap installed at 16 and the same pair
                budget

For each: host ms a step, device-busy ms a step (the kernels' time summed),
kernel launches a step, the kernels by device time a step, and the operators
by inclusive device time a step (aten ops and the autograd engine's backward
functions, so a backward kernel is named by the forward op it differentiates).
With --other the other checkout's `step` runs first and last, this one's
variants between. Runs on the GPU only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VARIANTS = ("step", "per_frame", "engine", "engine_b16")

CHILD = r"""
import dataclasses, json, sys, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from moss_torch.config import Config, ModelConfig, OptimConfig, PipelineConfig
from moss_torch.data.synthetic import make_frames, make_scene
from moss_torch.ops import lpips
from moss_torch.train import train_step as T
from moss_torch.train.trainer import Trainer

if not torch.cuda.is_available():
    sys.exit("step_profile needs a CUDA device")
variant, steps = sys.argv[1], int(sys.argv[2])
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
scene = make_scene(n_verts=6890, device=dev)
frames, _ = make_frames(scene, n_frames=5, H=512, W=512, crop=256, opacity=0.5)
cfg = Config(model=ModelConfig(), optim=OptimConfig(
    iterations=60, densify_from_iter=10, densify_until_iter=55, densification_interval=10,
    opacity_reset_interval=30), pipe=PipelineConfig(test_iterations=(), save_iterations=()))
lp = lpips.init_random(3407, device=dev)
tr = Trainer(scene, frames[:4], frames[4:], cfg, lp, crop_hw=(256, 256), device=dev)
feats = tr._gt_lpips_features()
budgets = getattr(tr, "budgets", None)

if variant in ("step", "per_frame"):
    step = tr.step_fn if variant == "step" else T.make_train_step(
        scene, cfg, None, lp, 256, 256, spatial_lr_scale=tr.extent, device=dev)[1]
    state = [tr.ts]

    def run(n):
        for i in range(n):
            state[0], logs = step(state[0], tr.train_frames[i % 4], 0, feats[i % 4])
        float(logs["loss"])
else:
    from moss_torch.train import optim
    if variant == "engine_b16":
        tr._install_budgets(tr._pair_budget, 16)
    budgets = tr.budgets
    long = dataclasses.replace(cfg.optim, iterations=10_000)
    tr.step_fn.tables = optim.step_tables(long, False, optim.param_groups(tr.ts.params),
                                          tr.extent, dev)
    staged = T.stage_frames(tr.train_frames)
    stacked = [torch.stack(f) for f in zip(*feats)]
    many = T.make_train_many(tr.step_fn, cfg.model.sh_degree, per_step_logs=True, graph=False)
    ts = T.device_state(tr.ts)

    def run(n):
        order = torch.arange(n, device=dev) % 4
        _, logs = many(ts, staged, order, stacked)
        logs["loss"].cpu()

run(3)
torch.cuda.synchronize()
t0 = time.perf_counter()
run(steps)
torch.cuda.synchronize()
host_ms = (time.perf_counter() - t0) * 1e3 / steps
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    run(steps)
    torch.cuda.synchronize()
kernels = {}
for e in prof.events():
    if e.device_type == DeviceType.CUDA:
        kernels[e.name[:90]] = kernels.get(e.name[:90], 0.0) + e.time_range.elapsed_us() / 1e3
busy = sum(kernels.values())
ops = []
launches = 0
for a in prof.key_averages():
    if a.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"):
        launches += a.count
    total = getattr(a, "device_time_total", None)
    total = a.cuda_time_total if total is None else total
    if a.device_type != DeviceType.CUDA and total > 0:
        ops.append((a.key[:110], total / 1e3 / steps, a.count / steps))
ops.sort(key=lambda r: -r[1])
print("RESULT " + json.dumps({
    "variant": variant, "budgets": budgets, "host_ms_per_step": host_ms,
    "device_busy_ms_per_step": busy / steps, "launches_per_step": launches / steps,
    "kernels_ms_per_step": sorted(((k, v / steps) for k, v in kernels.items()),
                                  key=lambda kv: -kv[1])[:30],
    "ops_inclusive_ms_per_step": ops[:70]}), flush=True)
"""


def run_child(root: str, variant: str, steps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    proc = subprocess.run([sys.executable, "-c", CHILD, variant, str(steps)], cwd=root, env=env,
                          capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{root} {variant}: exit {proc.returncode}\n{proc.stderr[-4000:]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout's root: its `step` runs first and last")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--json", help="write every result to this file")
    args = ap.parse_args(argv)
    turns = [(THIS_ROOT, v) for v in args.variants.split(",")]
    if args.other:
        turns = [(args.other, "step")] + turns + [(args.other, "step")]
    out = []
    for root, variant in turns:
        r = run_child(root, variant, args.steps)
        r["root"] = root
        out.append(r)
        print(json.dumps({k: r[k] for k in ("root", "variant", "budgets", "host_ms_per_step",
                                             "device_busy_ms_per_step", "launches_per_step")}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"nvidia_smi": smi, "turns": out}, f, indent=1)


if __name__ == "__main__":
    main()
