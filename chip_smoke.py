"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

  1. device  the card (nvidia-smi name and power limit, capability); TF32 off
  2. build   every CUDA kernel of the serving path, from moss_torch/csrc
  3. kernel  the forward blend kernel against its plain PyTorch version at
             512x512 / 16x16 tiles on three scenes (bench.py's 46,080-splat
             scene, the same at opacity 0.01, a dense opaque one that
             exercises termination), with its time, the binning's, the plain
             version's, and the bound the card sets for the same work
  4. slice   the serving path through the user entry points: a 6,890-vertex
             synthetic SMPL scene, a 45,695-Gaussian cloud in a 46,080
             capacity, random MLPs, a 512x512 camera; render_frame on the full
             path (pose MLPs + LBS field + deform) and, after compacting the
             cloud, on the cached-transform path, each held to the same call
             through the plain rasterizer; the blend kernel's launch count is
             set to 0 just before one drive of the path and read just after

then the kernels line and the last line {"ok": true, "device": {...}}.
Needs a CUDA device and nvcc; builds into build/moss_torch/.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from moss_torch.config import ModelConfig
from moss_torch.data.synthetic import make_camera, make_scene, random_pose
from moss_torch.models import gaussians as G
from moss_torch.models.lbs_field import LBSField
from moss_torch.models.pose_refine import PoseRefine
from moss_torch.ops import cuda_build, rasterize_cuda as rc
from moss_torch.ops.projection import preprocess
from moss_torch.ops.rasterize_ref import rasterize_reference
from moss_torch.ops.transforms import build_covariance, inverse_sigmoid
from moss_torch.render.camera import Camera
from moss_torch.render.render import render_frame

HW = 512
MODEL = ModelConfig()
CAPACITY = MODEL.capacity  # 46,080, bench.py:90-91
N_LIVE = 45695         # the reference's densification cap (gaussian_model.py:496)
N_VERTS = 6890
# H100 SXM peaks (NVIDIA datasheet): HBM bytes/s, f32 FLOP/s off the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations of one (pair, pixel) evaluation in csrc/rasterize_fwd.cu
# (dx, dy; the quadratic form; expf; op*e; min) and the extra ones of a
# contribution (1 - alpha, T (1 - alpha), alpha T, five multiply-adds)
OPS_PER_EVAL = 14
OPS_PER_CONTRIB = 13
# image rule of tests/test_rasterize_tpu.py:50-59: atol, share of pixels
# allowed as termination-threshold flips, largest flip
ATOL, OUTLIER_FRAC, OUTLIER_ATOL, DEPTH_ATOL = 3e-5, 2e-3, 1.0, 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def mismatch(a, b, atol=ATOL):
    """(pixels beyond atol, their allowance, max abs diff) of two images."""
    diff = (a - b).abs().reshape(-1)
    return int((diff > atol).sum()), OUTLIER_FRAC * diff.numel() + 1, float(diff.max())


def check_images(out, ref, what):
    """Hold `out` to `ref` under the image rule; max abs error over all images."""
    worst = 0.0
    for key, atol in (("color", ATOL), ("alpha", ATOL), ("depth", DEPTH_ATOL),
                      ("final_T", ATOL)):
        a, b = out[key], ref[key]
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{what} {key}: shape {tuple(a.shape)} or non-finite values")
        n_out, allowed, mx = mismatch(a, b, atol)
        if n_out > allowed or mx > OUTLIER_ATOL:
            raise AssertionError(
                f"{what} {key}: {n_out} pixels beyond {atol} (allowed {allowed:.0f}), max {mx:.3e}")
        worst = max(worst, mx)
    return worst


def cuda_ms(fn, n=20, reps=10, warmup=3):
    """Device ms per call of fn: the median over n samples, each a run of
    `reps` back-to-back calls between two CUDA events, after warm-up. One
    call per event pair would also time the wrapper's host work before the
    launch, while the stream sits idle."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return float(np.median(times))


def host_ms(fn, n=10, warmup=2):
    """Median host-clock time of n calls of fn, each ended by a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def device_breakdown(fn, top=6):
    """One call of fn under torch.profiler: host wall time, device-busy time
    (the sum of its kernels' device times), idle share, and the kernels that
    took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in kernels:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "kernel_launches": len(kernels),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}


def blend_work(proj, pairs, height, width):
    """(evaluations, contributions) that these inputs need: each pixel walks
    its tile's depth-ordered pairs until it stops (the stopping pair
    included); a contribution is an evaluation that is blended."""
    tile = rc.TILE
    grid_w = -(-width // tile)
    counts = pairs.tile_count.long()
    t = torch.repeat_interleave(torch.arange(counts.numel(), device=counts.device), counts)
    g = pairs.pair_gaussian.long()
    lane = torch.arange(tile * tile, device=counts.device)
    px = ((t % grid_w) * tile)[:, None] + lane % tile
    py = ((t // grid_w) * tile)[:, None] + lane // tile
    inside = (px < width) & (py < height)
    dx = proj.mean2d[g, 0:1] - px
    dy = proj.mean2d[g, 1:2] - py
    a, b, c = proj.conic[g, 0:1], proj.conic[g, 1:2], proj.conic[g, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(proj.opacity[g, None] * torch.exp(power), 0.99)
    m = (power <= 0) & (alpha >= 1.0 / 255.0) & inside
    start = pairs.tile_offsets[:-1].long()

    def seg_cumsum(x):  # cumulative sum restarted at every tile's first pair
        cs = torch.cumsum(x, 0)
        base = torch.where((start > 0)[:, None], cs[(start - 1).clamp_min(0)], 0)
        return cs - base[t]

    log_T = seg_cumsum(torch.where(m, torch.log1p(-alpha.double()), 0.0))
    fired = m & (log_T < math.log(1e-4))
    before = seg_cumsum(fired.int()) - fired.int()
    evaluated = (before == 0) & inside
    contrib = evaluated & m & ~fired
    return int(evaluated.sum()), int(contrib.sum())


def kernel_bound(proj, pairs, height, width):
    evals, contribs = blend_work(proj, pairs, height, width)
    P = proj.mean2d.shape[0]
    bytes_ = 4 * (pairs.num_pairs + pairs.tile_offsets.numel() + 10 * P + 6 * height * width)
    flops = OPS_PER_EVAL * evals + OPS_PER_CONTRIB * contribs
    t_bytes, t_ops = bytes_ / PEAK_BYTES, flops / PEAK_F32
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "evaluations": evals, "contributions": contribs, "bytes": bytes_, "flops": flops}


def measure_kernel(proj, bg, height, width):
    """Kernel vs plain on one projected cloud: errors, times and the bound."""
    out = rc.rasterize_cuda(proj, bg, height, width)
    ref = rasterize_reference(proj, bg, height, width, tile_h=rc.TILE, tile_w=rc.TILE)
    err = check_images(out, ref, "kernel vs plain")
    pairs = rc.bin_projected(proj, height, width)
    return ref, {
        "pairs": pairs.num_pairs,
        "max_tile_pairs": int(pairs.tile_count.max()),
        "busy_tiles": int((pairs.tile_count > 0).sum()),
        "overflow": int(out["overflow"]),
        "max_abs_err": err,
        "ms": cuda_ms(lambda: rc.rasterize_pairs(pairs, proj, height, width)),
        "bin_ms": host_ms(lambda: rc.bin_projected(proj, height, width)),
        "plain_ms": host_ms(
            lambda: rasterize_reference(proj, bg, height, width, tile_h=rc.TILE, tile_w=rc.TILE),
            n=3, warmup=1),
        **kernel_bound(proj, pairs, height, width),
    }


def bench_scene(dev, opacity=None, dense=False, H=HW, P=CAPACITY):
    """bench.py:92-113's scene (numpy default_rng(0), same draw order)."""
    rng = np.random.default_rng(0)
    f = 550.0 * H / 512.0
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1.0]])
    cam = Camera.from_KRT(K, np.eye(3), np.zeros(3), H, H, device=dev)
    means = np.stack(
        [rng.uniform(-0.4, 0.4, P), rng.uniform(-0.7, 0.7, P), rng.uniform(1.5, 2.5, P)], -1
    ).astype(np.float32)
    scales = rng.uniform(0.004, 0.012, (P, 3)).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    colors = rng.uniform(size=(P, 3)).astype(np.float32)
    op = rng.uniform(0.3, 0.95, P).astype(np.float32)
    if dense:  # tests/test_rasterize_tpu.py:76-90: packed, enlarged, near-opaque
        means[:, :2] *= 0.5
        scales *= 1.5
        op[:] = 0.97
    if opacity is not None:
        op[:] = opacity

    def t(x):
        return torch.as_tensor(x, device=dev)

    cov3d = build_covariance(t(scales), t(quats))
    return preprocess(t(means), cov3d, t(colors), t(op), cam), cam


def phase_kernel(dev, H=HW, P=CAPACITY):
    bg = torch.zeros(3, device=dev)
    for name, kw in (("bench", {}), ("bench_opacity_0.01", {"opacity": 0.01}),
                     ("dense_opaque", {"dense": True})):
        proj, _ = bench_scene(dev, H=H, P=P, **kw)
        ref, row = measure_kernel(proj, bg, H, H)
        if kw.get("dense"):
            min_T = float(ref["final_T"].min())
            if min_T >= 1e-3:
                raise AssertionError(f"dense scene did not exercise termination: min T {min_T}")
            row["min_final_T"] = min_T
        emit({"phase": "kernel", "scene": name, "hw": H, "gaussians": P, **row})


def make_cloud(scene, dev, capacity=CAPACITY, n_live=N_LIVE, seed=0):
    """Trained-scale cloud: points jittered 1 cm around the big-pose vertices,
    sigma <= 1 cm (tools/bench_eval_fps.py:96-103), opacity U(0.3, 0.95),
    SH degree 3 with small random higher coefficients."""
    rng = np.random.default_rng(seed)
    verts = scene.big_pose_vertices.cpu().numpy()
    pts = verts[rng.integers(0, verts.shape[0], n_live)] + rng.normal(0, 0.01, (n_live, 3))
    params, valid = G.create_from_points(
        pts.astype(np.float32), rng.uniform(size=(n_live, 3)), capacity, MODEL.sh_degree,
        device=dev)
    params.scaling = torch.clamp_max(params.scaling, math.log(0.01))
    op = torch.as_tensor(rng.uniform(0.3, 0.95, (capacity, 1)).astype(np.float32), device=dev)
    params.opacity = torch.where(valid[:, None], inverse_sigmoid(op), params.opacity)
    f_rest = rng.normal(0, 0.05, params.f_rest.shape).astype(np.float32)
    params.f_rest = torch.as_tensor(f_rest, device=dev) * valid[:, None, None]
    return params, valid


def phase_slice(dev, H=HW, n_verts=N_VERTS, capacity=CAPACITY, n_live=N_LIVE, frames=10):
    """The serving path end to end; returns (kernel row inputs, launches)."""
    scene = make_scene(n_verts=n_verts, device=dev)
    params, valid = make_cloud(scene, dev, capacity, n_live)
    gen = torch.Generator(device=dev).manual_seed(0)
    mlps = {"pose": PoseRefine(gen, dev), "lbs": LBSField(gen, dev)}
    cam = make_camera(H, H, device=dev)
    rng = np.random.default_rng(1)
    smpl_params = {
        "poses": torch.as_tensor(random_pose(rng), device=dev)[None],
        "shapes": torch.zeros((1, 10), device=dev),
        "R": torch.eye(3, device=dev),
        "Th": torch.zeros((1, 3), device=dev),
    }
    bg = torch.zeros(3, device=dev)

    def render(p, v, **kw):
        return render_frame(p, v, mlps, scene, smpl_params, cam, bg, MODEL.sh_degree,
                            motion_offset=MODEL.motion_offset,
                            static_scene=MODEL.static_scene, device=dev, **kw)

    def images(out):
        return {"color": out["render"], "alpha": out["render_alpha"],
                "depth": out["render_depth"], "final_T": out["final_T"]}

    # the serving path, driven once: a full-path frame, then compact, cache
    # the transforms on the compacted cloud (tools/bench_eval_fps.py:119-123)
    # and serve a cached-path frame; the launch count covers exactly this
    rc.launches = 0
    full = render(params, valid)
    params_c, valid_c = G.compact(params, valid)
    cache = render(params_c, valid_c)
    kw = {"cached_transforms": cache["transforms"], "cached_translation": cache["translation"]}
    cached = render(params_c, valid_c, **kw)
    launches = rc.launches
    if launches != 3:
        raise AssertionError(f"the serving path launched the blend kernel {launches} times, not 3")

    full_ref = render(params, valid, rasterize_fn=rasterize_reference)
    err_full = check_images(images(full), images(full_ref), "full path")
    cached_ref = render(params_c, valid_c, rasterize_fn=rasterize_reference, **kw)
    err_cached = check_images(images(cached), images(cached_ref), "cached path")
    full_ms = host_ms(lambda: render(params, valid), n=frames)
    cached_ms = host_ms(lambda: render(params_c, valid_c, **kw), n=frames)
    visible = int(full["visibility_filter"].sum())
    if visible == 0 or float(full["render_alpha"].max()) <= 0:
        raise AssertionError("the slice rendered nothing")
    emit({"phase": "slice", "hw": H, "capacity": capacity, "live": int(valid.sum()),
          "compacted": int(valid_c.numel()), "visible": visible,
          "overflow": int(full["overflow"]), "full_ms_per_frame": full_ms,
          "cached_ms_per_frame": cached_ms, "max_abs_err_full": err_full,
          "max_abs_err_cached": err_cached, "blend_launches": launches})
    emit({"phase": "profile", "path": "full", **device_breakdown(lambda: render(params, valid))})
    emit({"phase": "profile", "path": "cached",
          **device_breakdown(lambda: render(params_c, valid_c, **kw))})

    # the kernel at the shapes the serving path gives it: the full path's
    # projected cloud, captured at the rasterizer's door
    seen = []
    render(params, valid, rasterize_fn=lambda proj, *a: seen.append(proj) or rc.rasterize_cuda(proj, *a))
    _, row = measure_kernel(seen[0], bg, H, H)
    emit({"phase": "kernel", "scene": "slice_full_path", "hw": H, "gaussians": capacity, **row})
    row["max_abs_err"] = max(row["max_abs_err"], err_full, err_cached)
    return row, launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    cuda_build.build_all(["rasterize_fwd"])
    ptxas = [ln.strip() for ln in cuda_build.build_logs.get("rasterize_fwd", "").splitlines()
             if "registers" in ln or "bytes stack" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    with torch.inference_mode():
        phase_kernel(dev)
        row, launches = phase_slice(dev)
    emit({"kernels": [{
        "name": "rasterize_fwd", "route": "cuda", "source": "moss_torch/csrc/rasterize_fwd.cu",
        "replaces": "moss_tpu/ops/rasterize_tpu.py:288", "launches": launches,
        "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
        "tolerance": f"atol {ATOL} (depth {DEPTH_ATOL}); at most {OUTLIER_FRAC} of pixels beyond",
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
