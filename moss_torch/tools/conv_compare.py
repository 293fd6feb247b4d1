"""Time the f32 conv kernel (csrc/conv3x3.cu, the CUDA-core one) of two
checkouts of this repository on one card, in turns.

    python -m moss_torch.tools.conv_compare OTHER_ROOT [--json FILE]

Runs four child processes in the order OTHER, THIS, THIS, OTHER. Each imports
its own checkout's moss_torch, which builds that checkout's kernels into the
checkout's build directory, and times ops.conv3x3.conv3x3 on f32 inputs at
conv_proto's check() shapes and VGG16 layers (conv_proto.check_inputs and
layer_inputs: the JAX tool's draws), with cuda_ms at conv_proto.TIMING, and
cuDNN f32 (TF32 off) on the same inputs. Prints one JSON line per turn, then
each root's per-shape median over its two turns, the sums over the check
shapes and over the layers, and the card's name and power limit. Both
checkouts need those entry points, which every checkout since the f32 kernel
was added has. Runs on the GPU only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# one turn, run with its checkout's root first on sys.path: {"checks": {shape:
# ms}, "layers": {shape: ms}, "cudnn_checks", "cudnn_layers"}
CHILD = r"""
import json, sys
import torch
from moss_torch.ops.conv3x3 import conv3x3
from moss_torch.tools import conv_proto
from moss_torch.tools.timing import cuda_ms
if not torch.cuda.is_available():
    sys.exit("conv_compare needs a CUDA device")
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
out = {"checks": {}, "layers": {}, "cudnn_checks": {}, "cudnn_layers": {}}
rows = [("checks", "x".join(map(str, s)), x, w, b) for s, x, w, b in conv_proto.check_inputs(dev)]
rows += [("layers", "x".join(map(str, (H, H, ci, co))), x, w, b)
         for (H, ci, co), x, w, b in conv_proto.layer_inputs(dev)]
for kind, key, x, w, b in rows:
    out[kind][key] = cuda_ms(lambda: conv3x3(x, w, b), **conv_proto.TIMING)
    out["cudnn_" + kind][key] = cuda_ms(conv_proto.library_conv(x, w, b), **conv_proto.TIMING)
print("RESULT " + json.dumps(out), flush=True)
"""


def turn(root: str) -> dict:
    """One child process on `root`'s checkout; its RESULT line."""
    env = {**os.environ, "PYTHONPATH": root}
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, env=env, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"conv_compare turn on {root} failed:\n{proc.stdout}\n{proc.stderr}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def summary(turns) -> dict:
    """Each key's median over the turns, and its sums over the check shapes
    and over the layers."""
    keys = ("checks", "layers", "cudnn_checks", "cudnn_layers")
    med = {k: {s: float(np.median([t[k][s] for t in turns])) for s in turns[0][k]} for k in keys}
    return {**med, **{f"sum_{k}": sum(med[k].values()) for k in keys}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", help="the other checkout's root directory")
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args(argv)
    other = os.path.abspath(args.other_root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    order = [other, THIS_ROOT, THIS_ROOT, other]
    turns = []
    for root in order:
        res = turn(root)
        turns.append(res)
        print(json.dumps({"root": root, **res}), flush=True)
    result = {"nvidia_smi": smi, "order": order,
              "other": {"root": other, **summary([turns[0], turns[3]])},
              "this": {"root": THIS_ROOT, **summary([turns[1], turns[2]])}}
    for name in ("other", "this"):
        r = result[name]
        print(f"{name} ({r['root']}): check shapes "
              + "  ".join(f"{s} {ms:.5f}" for s, ms in r["checks"].items())
              + f"  sum {r['sum_checks']:.5f} ms (cuDNN f32 {r['sum_cudnn_checks']:.5f}); "
              f"layers sum {r['sum_layers']:.4f} ms (cuDNN f32 {r['sum_cudnn_layers']:.4f})",
              flush=True)
    print(smi, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
