"""Time one family of kernels of two checkouts of this repository on one card,
in turns.

    python -m moss_torch.tools.compare OTHER_ROOT [--what conv|mxu|sort] [--json FILE]

Runs four child processes in the order OTHER, THIS, THIS, OTHER. Each imports
its own checkout's moss_torch, which builds that checkout's kernels into the
checkout's build directory, and times them:

  conv  the f32 conv kernel (csrc/conv3x3.cu, the CUDA-core one):
        ops.conv3x3.conv3x3 on f32 inputs at conv_proto's check() shapes and
        VGG16 layers (conv_proto.check_inputs and layer_inputs: the JAX tool's
        draws) with cuda_ms at conv_proto.TIMING, and cuDNN f32 (TF32 off) on
        the same inputs
  mxu   the twelve reduction and scan runs (csrc/reduce_scan.cu): each of
        ops.reduce_scan.RUNS through rs.run on mxu_micro.inputs, with cuda_ms
        at mxu_micro.TIMING, and a sha256 of each run's output
  sort  the two sort passes (csrc/sort_pass.cu) on the tools' (4096, 128)
        int32 block: the lane pass at each stride 1-64 and the row pass at
        each stride 1-2048, each at R and 4R repeats, with cuda_ms at its
        defaults; whether each output at R equals its plain version, and a
        sha256 of it

Prints one JSON line per turn, then each root's per-entry median over its two
turns and its sums, the entries whose output digests are the same in all four
turns (bitwise equal across the checkouts), for sort each entry's 4R over R
time (a pass folded by the compiler would give about 1) and each root's
2^19-key network with every pass at its own stride's time, and the card's name
and power limit. Both checkouts need those entry points: every checkout since
the f32 conv kernel was added (conv), since the reduce_scan kernels were
(mxu) or since the sort passes were (sort). Runs on the GPU only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_PRELUDE = r"""
import json, sys
import torch
from moss_torch.tools.timing import cuda_ms
if not torch.cuda.is_available():
    sys.exit("compare needs a CUDA device")
dev = torch.device("cuda", 0)
"""
# one turn, run with its checkout's root first on sys.path: a RESULT line of
# {kind: {entry: ms}}
CHILD = {
    "conv": _PRELUDE + r"""
from moss_torch.ops.conv3x3 import conv3x3
from moss_torch.tools import conv_proto
torch.backends.cudnn.allow_tf32 = False
out = {"checks": {}, "layers": {}, "cudnn_checks": {}, "cudnn_layers": {}}
rows = [("checks", "x".join(map(str, s)), x, w, b) for s, x, w, b in conv_proto.check_inputs(dev)]
rows += [("layers", "x".join(map(str, (H, H, ci, co))), x, w, b)
         for (H, ci, co), x, w, b in conv_proto.layer_inputs(dev)]
for kind, key, x, w, b in rows:
    out[kind][key] = cuda_ms(lambda: conv3x3(x, w, b), **conv_proto.TIMING)
    out["cudnn_" + kind][key] = cuda_ms(conv_proto.library_conv(x, w, b), **conv_proto.TIMING)
print("RESULT " + json.dumps(out), flush=True)
""",
    "mxu": _PRELUDE + r"""
from moss_torch.ops import reduce_scan as rs
from moss_torch.tools import mxu_micro
import hashlib
x, s = mxu_micro.inputs(dev)
out = {"runs": {}}
digests = {}
with rs.full_f32():
    for name, *_ in rs.RUNS:
        out["runs"][name] = cuda_ms(lambda: rs.run(name, x, s), **mxu_micro.TIMING)
        digests[name] = hashlib.sha256(rs.run(name, x, s)[0].cpu().numpy().tobytes()).hexdigest()
print("RESULT " + json.dumps({**out, "digests": digests}), flush=True)
""",
    "sort": _PRELUDE + r"""
from moss_torch.ops import sort_pass as sp
import hashlib
import numpy as np
x = torch.as_tensor(np.random.default_rng(0).integers(0, 1 << 30, (sp.ROWS, sp.LANES), np.int32),
                    device=dev)
passes = {"lane": (sp.lane_pass, sp.lane_pass_plain, [1 << j for j in range(7)]),
          "row": (sp.row_pass, sp.row_pass_plain, [1 << j for j in range(12)])}
out, exact, digests = {}, {}, {}
for kind, (fn, plain, strides) in passes.items():
    for reps, r in (("R", sp.R), ("4R", 4 * sp.R)):
        out[f"{kind}_{reps}"] = {f"s{s}": cuda_ms(lambda: fn(x, s, r)) for s in strides}
    for s in strides:
        got = fn(x, s, sp.R)
        exact[f"{kind}_s{s}"] = bool(torch.equal(got, plain(x, s, sp.R)))
        digests[f"{kind}_s{s}"] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
print("RESULT " + json.dumps({**out, "exact": exact, "digests": digests}), flush=True)
""",
}
# the kinds of a RESULT that hold no times
UNTIMED = ("digests", "exact")


def turn(root: str, what: str) -> dict:
    """One child process on `root`'s checkout; its RESULT line."""
    env = {**os.environ, "PYTHONPATH": root}
    proc = subprocess.run([sys.executable, "-c", CHILD[what]], cwd=root, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"compare turn ({what}) on {root} failed:\n{proc.stdout}\n{proc.stderr}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def summary(turns) -> dict:
    """Each entry's median over the turns, and each kind's sum of them (the
    timed kinds: all but UNTIMED)."""
    med = {k: {e: float(np.median([t[k][e] for t in turns])) for e in turns[0][k]}
           for k in turns[0] if k not in UNTIMED}
    return {**med, **{f"sum_{k}": sum(med[k].values()) for k in med}}


def fold_ratios(med) -> dict:
    """{pass: {stride: its 4R time over its R time}} of a sort summary, whose
    kinds <pass>_R and <pass>_4R hold each stride's time."""
    return {k: {s: med[f"{k}_4R"][s] / ms for s, ms in med[f"{k}_R"].items()}
            for k in ("lane", "row")}


def network_by_stride_ms(med) -> float:
    """ms of the tools' 2^19-key bitonic network from a sort summary: each
    lane and row pass at its own stride's median time at R over R
    (sort_micro's network_by_stride_ms)."""
    from ..ops.sort_pass import LANES, R, ROWS, lane_passes_by_stride, row_passes_by_stride

    n_keys = ROWS * LANES
    passes = {"lane": lane_passes_by_stride(n_keys), "row": row_passes_by_stride(n_keys)}
    return sum(n * med[f"{k}_R"][f"s{s}"] / R for k, by in passes.items() for s, n in by.items())


def same_outputs(turns) -> dict:
    """{entry: whether every turn gave its output the same digest}, for the
    kinds that report digests; {} for the others."""
    if "digests" not in turns[0]:
        return {}
    return {e: len({t["digests"][e] for t in turns}) == 1 for e in turns[0]["digests"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", help="the other checkout's root directory")
    ap.add_argument("--what", choices=sorted(CHILD), default="conv",
                    help="the kernels to time (default conv)")
    ap.add_argument("--json", help="also write the result to this file")
    args = ap.parse_args(argv)
    other = os.path.abspath(args.other_root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    order = [other, THIS_ROOT, THIS_ROOT, other]
    turns = []
    for root in order:
        res = turn(root, args.what)
        turns.append(res)
        print(json.dumps({"root": root, **res}), flush=True)
    result = {"what": args.what, "nvidia_smi": smi, "order": order,
              "other": {"root": other, **summary([turns[0], turns[3]])},
              "this": {"root": THIS_ROOT, **summary([turns[1], turns[2]])},
              "bitwise_equal": same_outputs(turns)}
    if "exact" in turns[0]:
        result["exact_in_all_turns"] = {e: all(t["exact"][e] for t in turns)
                                        for e in turns[0]["exact"]}
        print("exact against the plain version in all four turns: " + "  ".join(
            f"{e} {ok}" for e, ok in result["exact_in_all_turns"].items()), flush=True)
    if args.what == "sort":
        result["fold_ratio"] = {name: fold_ratios(result[name]) for name in ("other", "this")}
        result["network_by_stride_ms"] = {name: network_by_stride_ms(result[name])
                                          for name in ("other", "this")}
        print("network_by_stride_ms (each lane and row pass at its own stride's median): " +
              "  ".join(f"{name} {ms:.5f}" for name, ms in result["network_by_stride_ms"].items()),
              flush=True)
        for name in ("other", "this"):
            print(f"{name} 4R / R: " + "; ".join(
                f"{k}: " + "  ".join(f"{e} {q:.2f}" for e, q in v.items())
                for k, v in result["fold_ratio"][name].items()), flush=True)
    for name in ("other", "this"):
        r = result[name]
        kinds = [k for k in turns[0] if k not in UNTIMED]
        print(f"{name} ({r['root']}): " + "; ".join(
            f"{k}: " + "  ".join(f"{e} {ms:.5f}" for e, ms in r[k].items())
            + f"  sum {r['sum_' + k]:.5f} ms" for k in kinds), flush=True)
    if result["bitwise_equal"]:
        print("outputs bitwise equal in all four turns: " + "  ".join(
            f"{e} {same}" for e, same in result["bitwise_equal"].items()), flush=True)
    print(smi, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
