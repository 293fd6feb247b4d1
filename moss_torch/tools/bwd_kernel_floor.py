"""The backward blend kernel's time, stage by stage, on the GPU.

Counterpart of tools/bwd_kernel_floor.py's main(): it times
csrc/rasterize_bwd.cu with stages ablated (moss_torch/ops/bwd_stages.py):

  load       the loop, the staging of pair data, the gimg loads, the row
             writes; no blend math, so it walks every pair
  recompute  + the forward's blend step and T
  suffix     + dL/dw, the prefix, s_after, dL/dpower
  full       + the per-pair sums and row assembly (the production kernel)
  full_soa   full, rows written column-major

on bench.py's scene at 512x512 / 46,080 Gaussians (moss_torch.data.synthetic.
bench_scene, the same numpy draws as tools/bwd_kernel_floor.py:64-77) with
the JAX tool's cotangent (:84-91): dL/d(r, g, b) = 1, dL/d depth = 0.01,
dL/d alpha = 1, dL/d final_T = 0. A stage's time means nothing until its
output is checked, so full and full_soa must first equal the production
kernel's rows bit for bit (full_soa after a transpose). It then prints each
stage's time and the successive differences; stage cost = the difference.

    python -m moss_torch.tools.bwd_kernel_floor

Runs on the GPU; main(device="cpu") runs the plain versions on the host,
where there is no production kernel to check against.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..data.synthetic import bench_scene
from ..ops import rasterize_cuda as rc
from ..ops.bwd_stages import STAGES, rasterize_bwd_stage
from .timing import device_name, timer

COTANGENT = (1.0, 1.0, 1.0, 0.01, 1.0)  # dL/d(r, g, b, depth, alpha); dL/d final_T = 0
TIMING = {"n": 10, "reps": 5, "warmup": 2}
DELTAS = (("loop + staging", None, "load"), ("forward recompute", "load", "recompute"),
          ("suffix / d-alpha", "recompute", "suffix"), ("moments + assembly", "suffix", "full"),
          ("column-major rows", "full", "full_soa"))


def floor_inputs(proj, height: int, width: int):
    """(pairs, gimg) for the tool's cotangent: gimg holds the five constant
    planes and Qtail = r + g + b + 0.01 depth + alpha (g_T = 0), from the
    forward blend of proj on a black background (:84-91)."""
    pairs = rc.bin_projected(proj, height, width)
    with torch.no_grad():
        out = rc.rasterize_cuda(proj, torch.zeros(3, device=proj.mean2d.device), height, width)
    rgb = out["color"]
    q_tail = rgb[..., 0] + rgb[..., 1] + rgb[..., 2] + 0.01 * out["depth"] + out["alpha"]
    gimg = torch.stack([torch.full_like(q_tail, g) for g in COTANGENT] + [q_tail])
    return pairs, gimg.contiguous()


def check_against_production(pairs, proj, gimg, height: int, width: int):
    """{stage: max |rows - production rows|} for full and full_soa; raises
    unless both are bitwise equal to rc.rasterize_pairs_bwd's rows."""
    prod = rc.rasterize_pairs_bwd(pairs, proj, gimg, height, width)
    full, _ = rasterize_bwd_stage(pairs, proj, gimg, height, width, "full")
    soa, _ = rasterize_bwd_stage(pairs, proj, gimg, height, width, "full_soa")
    diffs = {}
    for stage, rows in (("full", full), ("full_soa", soa.T)):
        diffs[stage] = float((rows - prod).abs().max()) if rows.numel() else 0.0
        equal = torch.equal(rows, prod)
        print(f"{stage:10s} max|rows - production| = {diffs[stage]:.3e}"
              + ("" if equal else "  (MISMATCH: the timing below is meaningless)"))
        if not equal:
            raise AssertionError(f"stage {stage} differs from the production kernel")
    return diffs


def measure(proj, height: int, width: int):
    """Check, then time every stage and the production kernel on proj."""
    dev = proj.mean2d.device
    time_ms = timer(dev)
    pairs, gimg = floor_inputs(proj, height, width)
    print(f"{pairs.num_pairs} pairs, {int((pairs.tile_count > 0).sum())} busy tiles, "
          f"longest {int(pairs.tile_count.max())}")
    if dev.type == "cuda":
        diffs = check_against_production(pairs, proj, gimg, height, width)
    else:
        diffs = None
        print("no production kernel on the CPU: the stages run their plain version")

    stage_ms = {s: time_ms(lambda s=s: rasterize_bwd_stage(pairs, proj, gimg, height, width, s),
                           **TIMING) for s in STAGES}
    for s in STAGES:
        print(f"{s:10s} {stage_ms[s]:8.4f} ms")
    deltas = {}
    print("\nstage deltas:")
    for name, before, stage in DELTAS:
        deltas[name] = stage_ms[stage] - (stage_ms[before] if before else 0.0)
        print(f"  {name:22s} {deltas[name]:8.4f} ms")
    prod_ms = None
    if dev.type == "cuda":
        prod_ms = time_ms(lambda: rc.rasterize_pairs_bwd(pairs, proj, gimg, height, width),
                          **TIMING)
        print(f"\nproduction rasterize_bwd {prod_ms:8.4f} ms (the full stage's kernel)")
    return {"pairs": pairs.num_pairs, "busy_tiles": int((pairs.tile_count > 0).sum()),
            "max_tile_pairs": int(pairs.tile_count.max()), "max_abs_diff_to_production": diffs,
            "stage_ms": stage_ms, "deltas_ms": deltas, "production_ms": prod_ms}


def main(device=None, H: int = 512, P: int = 46080):
    """Print and return measure() on bench.py's scene at H x H, P Gaussians."""
    dev = resolve_device(device)
    proj, _ = bench_scene(dev, H=H, P=P)
    print(f"device: {device_name(dev)}; bench scene {H}x{H}, {P} Gaussians")
    return {"device": device_name(dev), **measure(proj, H, H)}


if __name__ == "__main__":
    main()
