"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

  1. device  the card (nvidia-smi name and power limit, capability); TF32 off
  2. build   every CUDA kernel of the serving and training paths, from
             moss_torch/csrc, one nvcc each, all at once
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
  5. train_kernel  the backward blend kernel plus the segment sum against
             autograd through the plain version (remat) at 512x512, on the
             bench scene and (in phase 6) on the training slice's own
             projected input: grads within the scaled atol, two backward passes
             bitwise equal, with their times, the plain backward's, and bounds
  6. train   the training path through the user entry points: the slice's
             cloud and MLPs, 4 frames from make_frames at 512x512, a 256x256
             crop, the six-term loss with the seeded random LPIPS backbone,
             make_train_step; one step's grads held to the same step through
             the plain rasterizer; then 2 warm-up and 5 timed steps, with every
             kernel's launch count set to 0 just before and read just after
             (one launch of each per step), and one profiled step; and the
             backward kernel's stages (phase 9) on the slice's projected input
  7. tool_sort  the two sort-pass kernels against their plain versions,
             exactly, at every stride of a 2^19-key network; a pass's time
             against R; then moss_torch.tools.sort_micro, counted
  8. tool_conv  the 3x3 conv kernel against its plain version at the JAX
             tool's check() shapes and the eight VGG16 layer shapes, in f32
             (atol 1e-4) and bf16 (2e-2 of the max); then
             moss_torch.tools.conv_proto, counted
  9. tool_bwd_floor  the backward kernel's stages: full and full_soa bitwise
             equal to the production kernel, every stage held to its plain
             version, with times and bounds; then
             moss_torch.tools.bwd_kernel_floor, counted
 10. tool_mxu  the twelve reductions and scans of csrc/reduce_scan.cu (CUDA
             cores, bf16, split2 and 3xTF32 tensor-core forms): their
             observers bitwise equal across the 256 tiles, a launch's time
             against REPS; then moss_torch.tools.mxu_micro, counted, which
             holds each against its plain version (1e-5 of the max)

Each tool phase sets its kernels' launch counts to 0 just before it drives
the tool's main() and reads them just after. Then the kernels line and the
last line {"ok": true, "device": {...}}.
Needs a CUDA device and nvcc; builds into build/moss_torch/.
"""
from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from moss_torch.config import Config, ModelConfig
from moss_torch.data.synthetic import bench_scene, make_camera, make_frames, make_scene, \
    random_pose
from moss_torch.models import gaussians as G
from moss_torch.models.lbs_field import LBSField
from moss_torch.models.pose_refine import PoseRefine
from moss_torch.ops import bwd_stages, conv3x3 as conv, cuda_build, lpips, \
    rasterize_cuda as rc, reduce_scan as rs, sort_pass
from moss_torch.ops.rasterize_ref import rasterize_reference
from moss_torch.ops.transforms import inverse_sigmoid
from moss_torch.render.render import render_frame
from moss_torch.tools import bwd_kernel_floor, conv_proto, mxu_micro, sort_micro
from moss_torch.tools.timing import cuda_ms
from moss_torch.train.losses import compute_losses, crop_window
from moss_torch.train.train_step import TrainState, make_train_step

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
# f32 operations of one contribution in csrc/rasterize_bwd.cu beyond the
# evaluation: w, T (1 - alpha), dL/dw (4 multiply-adds), the prefix, s_after,
# dL/dpower (5), the ten per-pair values (10), and their ten adds into the
# tile's sum
OPS_PER_CONTRIB_BWD = 38
# image rule of tests/test_rasterize_tpu.py:50-59: atol, share of pixels
# allowed as termination-threshold flips, largest flip
ATOL, OUTLIER_FRAC, OUTLIER_ATOL, DEPTH_ATOL = 3e-5, 2e-3, 1.0, 1e-4
# grad rule of tests/test_rasterize_tpu.py:150 (divide by max|g_ref|) and :166
GRAD_ATOL, BG_RTOL = 5e-4, 1e-4
# the CUDA sources under moss_torch/csrc
KERNELS = ("rasterize_fwd", "rasterize_bwd", "segment_sum", "sort_pass", "conv3x3",
           "reduce_scan")
PEAK_BF16 = 989e12  # dense bf16 FLOP/s on the tensor cores
# the sort passes' int32 min and max, counted at the f32 rate above: the
# datasheet gives no int32 rate, and the SMs have half as many int32 lanes as
# f32 ones, so this bound is low
PEAK_INT32 = PEAK_F32
# observer planes of the ablated backward stages against their plain version:
# max |a - b| / max |b| beyond this on at most OUTLIER_FRAC of the pixels
OBSERVE_RTOL = 1e-4
CROP = 256         # the trainer's crop (moss_tpu/train/trainer.py:139-140)
TRAIN_FRAMES = 4


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
    host = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.key.startswith(("aten::", "cuda", "autograd::"))]
    syncs = sum(c for k, _, c in host if k in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    # the (23, 3, 3) SVD of the Fisher loss, on the host and on the device
    svd = {"host_self_ms": sum(ms for k, ms, _ in host if "svd" in k.lower()),
           "device_ms": sum(ms for k, ms in by_name.items()
                            if any(w in k.lower() for w in ("svd", "gesvd", "jacobi")))}
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "kernel_launches": len(kernels),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            "host_syncs": syncs, "svd": svd,
            "top_host_self_ms": [h[:2] for h in sorted(host, key=lambda h: -h[1])[:top]]}


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
    log_T = bwd_stages.seg_cumsum(torch.where(m, torch.log1p(-alpha.double()), 0.0), start, t)
    fired = m & (log_T < math.log(1e-4))
    before = bwd_stages.seg_cumsum(fired.int(), start, t) - fired.int()
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


def bwd_bound(proj, pairs, height, width, stage="full", work=None):
    """The least time for the backward kernel's work on these inputs, at
    `stage` (ops/bwd_stages.py): the pair list, ten floats per Gaussian and
    six gradient planes read, ten floats per pair (and an ablated stage's
    observer plane) written; the operations: load adds six staged values per
    walked (pair, pixel); the other stages do the forward's evaluations and,
    per contribution, 3 (w, T, the observer), 15 (+ dL/dw, prefix, s_after,
    dL/dpower) or OPS_PER_CONTRIB_BWD. work: blend_work's (evaluations,
    contributions), computed if not given."""
    evals, contribs = work or blend_work(proj, pairs, height, width)
    P = proj.mean2d.shape[0]
    bytes_ = 4 * (pairs.num_pairs + pairs.tile_offsets.numel() + 10 * P + 6 * height * width
                  + rc.GRAD_COLS * pairs.num_pairs
                  + (height * width if stage in bwd_stages.ABLATED else 0))
    if stage == "load":
        flops = 6 * pairs.num_pairs * rc.TILE * rc.TILE  # H and W are multiples of the tile
    else:
        per = {"recompute": 3, "suffix": 15}.get(stage, OPS_PER_CONTRIB_BWD)
        flops = OPS_PER_EVAL * evals + per * contribs
    t_bytes, t_ops = bytes_ / PEAK_BYTES, flops / PEAK_F32
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "evaluations": evals, "contributions": contribs, "bytes": bytes_, "flops": flops}


def segment_bound(pairs, P):
    """Rows and positions read once, the (P, 10) sums written; one add per value."""
    bytes_ = 4 * (rc.GRAD_COLS * pairs.num_pairs + pairs.num_pairs + (P + 1) + rc.GRAD_COLS * P)
    flops = rc.GRAD_COLS * pairs.num_pairs
    t_bytes, t_ops = bytes_ / PEAK_BYTES, flops / PEAK_F32
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def blend_grads(proj, bg, height, width, upstream, raster):
    """Grads of sum(out * upstream) for the five kernel fields and bg."""
    leaves = [getattr(proj, f).detach().clone().requires_grad_() for f in rc._KERNEL_FIELDS]
    bg = bg.detach().clone().requires_grad_()
    out = raster(proj._replace(**dict(zip(rc._KERNEL_FIELDS, leaves))), bg, height, width)
    loss = sum((out[k] * upstream[k]).sum() for k in upstream)
    return torch.autograd.grad(loss, leaves + [bg]), out


def scaled_err(g, g_ref):
    return float((g - g_ref).abs().max()) / (float(g_ref.abs().max()) + 1e-8)


def measure_backward(proj, bg, height, width, seed=0):
    """Backward kernel + segment sum vs autograd through the plain version
    (remat) on one projected cloud, with upstream grads drawn from `seed`:
    errors, bitwise repeat, times and bounds."""
    gen = torch.Generator(device=bg.device).manual_seed(seed)
    up = {k: torch.randn(s, generator=gen, device=bg.device)
          for k, s in (("color", (height, width, 3)), ("depth", (height, width)),
                       ("alpha", (height, width)), ("final_T", (height, width)))}
    plain = functools.partial(rasterize_reference, tile_h=rc.TILE, tile_w=rc.TILE, remat=True)
    g, out = blend_grads(proj, bg, height, width, up, rc.rasterize_cuda)
    again, _ = blend_grads(proj, bg, height, width, up, rc.rasterize_cuda)
    if not all(torch.equal(a, b) for a, b in zip(g, again)):
        raise AssertionError("two backward passes on the same input differ")
    g_ref, _ = blend_grads(proj, bg, height, width, up, plain)
    errs = {f: scaled_err(a, b) for f, a, b in zip(rc._KERNEL_FIELDS, g[:-1], g_ref[:-1])}
    bg_rel = float(((g[-1] - g_ref[-1]).abs() / g_ref[-1].abs()).max())
    if max(errs.values()) > GRAD_ATOL or bg_rel > BG_RTOL or not all(torch.isfinite(x).all() for x in g):
        raise AssertionError(f"backward kernel vs plain: scaled errors {errs}, bg rel {bg_rel:.2e}")

    # the kernels alone, at the inputs the autograd.Function gives them
    pairs = rc.bin_projected(proj, height, width)
    img = rc.rasterize_pairs(pairs, proj, height, width)
    # the grads of the six planes; final_T also carries the bg term
    g_img = torch.stack([up["color"][..., 0], up["color"][..., 1], up["color"][..., 2],
                         up["depth"], up["alpha"], up["final_T"] + (up["color"] * bg).sum(-1)])
    gimg = torch.cat([g_img[:5], (g_img * img).sum(0, keepdim=True)]).contiguous()
    rows = rc.rasterize_pairs_bwd(pairs, proj, gimg, height, width)
    P = proj.mean2d.shape[0]
    index = pairs.pair_gaussian.long()

    def library():
        return torch.zeros((P, rc.GRAD_COLS), device=rows.device).index_add_(0, index, rows)

    if scaled_err(rc.segment_sum(rows, pairs), library()) > 1e-5:
        raise AssertionError("segment sum vs index_add_ disagree")

    def plain_fwd():
        with torch.no_grad():
            plain(proj, bg, height, width)

    fwd_ms = host_ms(plain_fwd, n=2, warmup=1)
    fwd_bwd_ms = host_ms(lambda: blend_grads(proj, bg, height, width, up, plain), n=2, warmup=1)
    bound = bwd_bound(proj, pairs, height, width)
    return {
        "pairs": pairs.num_pairs,
        "max_tile_pairs": int(pairs.tile_count.max()),
        "busy_tiles": int((pairs.tile_count > 0).sum()),
        "scaled_err": errs, "bg_rel_err": bg_rel, "bitwise_repeat": True,
        "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(g[:-1], g_ref[:-1])),
        "ms": cuda_ms(lambda: rc.rasterize_pairs_bwd(pairs, proj, gimg, height, width)),
        "plain_ms": fwd_bwd_ms - fwd_ms, "plain_fwd_bwd_ms": fwd_bwd_ms,
        **bound,
        "segment": {"ms": cuda_ms(lambda: rc.segment_sum(rows, pairs)),
                    "library_ms": cuda_ms(library),
                    "plain_ms": cuda_ms(lambda: rc.segment_sum_plain(rows, pairs)),
                    "max_abs_err": float((rc.segment_sum(rows, pairs)
                                          - rc.segment_sum_plain(rows, pairs)).abs().max()),
                    **segment_bound(pairs, P)},
    }


def raster_grads(step, ts, frame, feat, raster, g_img=None):
    """Grads of the step's params and zero mean2d offset through one render
    with `raster`, for image grads g_img of (render, render_alpha), by default
    the six-term loss's own; returns ({group: {name: grad}}, g_img)."""
    gauss = ts.params["gauss"]
    leaves = G.GaussianParams(**{f: getattr(gauss, f).detach().requires_grad_() for f in G.FIELDS})
    offset = torch.zeros((gauss.capacity, 2), device=gauss.xyz.device, requires_grad=True)
    mlps = ts.params["mlps"]
    out = render_frame(leaves, ts.gstate.valid, mlps, step.scene, frame.smpl_params,
                       frame.camera, step.bg, MODEL.sh_degree, rasterize_fn=raster,
                       mean2d_offset=offset, active_sh=0, device=gauss.xyz.device)
    images = [out["render"], out["render_alpha"]]
    if g_img is None:
        total, _ = compute_losses(out, frame.image, frame.bkgd_mask, frame.bound_mask,
                                  frame.pose_rotmats, frame.crop_y0, frame.crop_x0,
                                  step.crop_h, step.crop_w, lpips_params=step.lpips_params,
                                  weights=step.weights, gt_lpips_feats=feat)
        g_img = torch.autograd.grad(total, images, retain_graph=True)
    groups = {**{f: {f: getattr(leaves, f)} for f in G.FIELDS},
              **{k: dict(m.named_parameters()) for k, m in mlps.items()},
              "mean2d_offset": {"mean2d_offset": offset}}
    names = [(k, n) for k, tensors in groups.items() for n in tensors]
    flat = torch.autograd.grad(images, [groups[k][n] for k, n in names], grad_outputs=g_img,
                               allow_unused=True)
    grads = {k: {} for k in groups}
    for (k, n), gr in zip(names, flat):
        grads[k][n] = torch.zeros_like(groups[k][n]) if gr is None else gr
    return grads, g_img


def grad_errors(g, g_ref):
    """{group.name: max|g - g_ref| / scale}: scale is the leaf's max|g_ref|,
    or for an MLP the max over the whole MLP, some of whose parameters have a
    grad that is 0 but for rounding (tests/test_torch_grads.py)."""
    errs = {}
    for group, ref in g_ref.items():
        mlp_scale = max(float(t.abs().max()) for t in ref.values())
        for name, b in ref.items():
            scale = mlp_scale if group in ("pose", "lbs") else float(b.abs().max())
            errs[f"{group}.{name}"] = float((g[group][name] - b).abs().max()) / (scale + 1e-30)
    return errs


def phase_train_kernel(dev, H=HW, P=CAPACITY):
    proj, _ = bench_scene(dev, H=H, P=P)
    row = measure_backward(proj, torch.zeros(3, device=dev), H, H)
    emit({"phase": "train_kernel", "scene": "bench", "hw": H, "gaussians": P, **row})
    return row


def phase_train(dev, H=HW, n_verts=N_VERTS, capacity=CAPACITY, n_live=N_LIVE,
                n_frames=TRAIN_FRAMES, crop=CROP, steps=5, warmup=2):
    """The training path end to end; returns (the backward kernel's row at
    its input, launches of each kernel in the driven run)."""
    scene = make_scene(n_verts=n_verts, device=dev)
    params, valid = make_cloud(scene, dev, capacity, n_live)
    gen = torch.Generator(device=dev).manual_seed(0)
    mlps = {"pose": PoseRefine(gen, dev), "lbs": LBSField(gen, dev)}
    frames, _ = make_frames(scene, n_frames=n_frames, H=H, W=H, crop=crop)
    lp = lpips.init_random(3407, device=dev)
    feats = [lpips.gt_features(lp, crop_window(f.image, f.crop_y0, f.crop_x0, crop, crop))
             for f in frames]
    cfg = Config(model=MODEL)
    init, step = make_train_step(scene, cfg, None, lp, crop, crop, device=dev)
    plain = functools.partial(rasterize_reference, tile_h=rc.TILE, tile_w=rc.TILE, remat=True)
    _, plain_step = make_train_step(scene, cfg, plain, lp, crop, crop, device=dev)
    state = {"gauss": params, "mlps": mlps}
    ts = TrainState(state, init(state), G.initial_state(valid), 0)

    # one step through the kernels against the same step through the plain
    # rasterizer, from the same state. The gate holds the loss's image grads
    # fixed (taken once, from the kernel's render) and sends them back through
    # both renders: the bf16 LPIPS towers turn the two renders' 1e-6
    # differences into image grads that differ by up to 1e-3 (PERF.md, Findings),
    # a sensitivity of the loss, not of the rasterizer. The whole step's grads
    # through each path are reported beside it.
    g, g_img = raster_grads(step, ts, frames[0], feats[0], None)
    g_ref, _ = raster_grads(step, ts, frames[0], feats[0], plain, g_img)
    errs = grad_errors(g, g_ref)
    if max(errs.values()) > GRAD_ATOL:
        raise AssertionError(f"train step grads, kernel vs plain: {errs}")
    _, logs, _, gw, offw = step.grads(ts, frames[0], 0, feats[0])
    _, logs_ref, _, gw_ref, offw_ref = plain_step.grads(ts, frames[0], 0, feats[0])
    whole = grad_errors({**gw, "mean2d_offset": {"mean2d_offset": offw}},
                        {**gw_ref, "mean2d_offset": {"mean2d_offset": offw_ref}})
    loss_rel = abs(float(logs["loss"]) - float(logs_ref["loss"])) / abs(float(logs_ref["loss"]))

    # the kernels at the shapes the training path gives them
    seen = []
    render_frame(params, valid, mlps, scene, frames[0].smpl_params, frames[0].camera,
                 step.bg, MODEL.sh_degree, device=dev,
                 rasterize_fn=lambda proj, *a: seen.append(proj) or rc.rasterize_cuda(proj, *a))
    proj = rc.Projected(*(t.detach() if torch.is_tensor(t) else t for t in seen[0]))
    row = measure_backward(proj, step.bg, H, H)
    emit({"phase": "train_kernel", "scene": "train_slice", "hw": H, "gaussians": capacity, **row})
    emit({"phase": "tool_bwd_floor", "scene": "train_slice", "hw": H, "gaussians": capacity,
          **measure_stages(proj, H, H)})
    emit({"phase": "kernel", "scene": "train_slice", "hw": H, "gaussians": capacity,
          **measure_kernel(proj, step.bg, H, H)[1]})

    # the training path, driven once: warm-up and timed steps
    rc.launches = rc.bwd_launches = rc.segment_launches = 0
    times, losses = [], []
    for i in range(warmup + steps):
        k = i % n_frames
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, logs = step(ts, frames[k], 0, feats[k])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(logs["loss"]))
        if int(logs["raster_overflow"]) != 0:
            raise AssertionError("the pair list overflowed")
    launches = {"rasterize_fwd": rc.launches, "rasterize_bwd": rc.bwd_launches,
                "segment_sum": rc.segment_launches}
    if any(n != warmup + steps for n in launches.values()):
        raise AssertionError(f"{warmup + steps} steps launched the kernels {launches} times")
    gs = ts.gstate
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if float(gs.xyz_grad_accum.max()) <= 0 or float(gs.denom.max()) <= 0:
        raise AssertionError("the densify statistics stayed 0")
    emit({"phase": "train", "hw": H, "capacity": capacity, "live": int(valid.sum()), "crop": crop,
          "frames": n_frames, "ms_per_step": float(np.median(times[warmup:])),
          "step_ms": times, "losses": losses,
          "loss_terms": {k: float(v) for k, v in logs.items()},
          "kernel_vs_plain_grad_scaled_err": max(errs.values()),
          "whole_step_grad_scaled_err": {k: max(v for n, v in whole.items()
                                                if n.split(".")[0] == k)
                                         for k in {n.split(".")[0] for n in whole}},
          "kernel_vs_plain_loss_rel_err": loss_rel,
          "xyz_grad_accum_max": float(gs.xyz_grad_accum.max()),
          "denom_max": float(gs.denom.max()), "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    holder = [ts]

    def one_step():
        holder[0], _ = step(holder[0], frames[0], 0, feats[0])

    emit({"phase": "profile", "path": "train_step", **device_breakdown(one_step, top=10)})
    return row, launches


def phase_tool_sort(dev):
    """The sort passes against their plain versions at every stride of the
    tool's 2^19-key network, a pass's time against R, then the tool."""
    R = sort_pass.R
    x = torch.as_tensor(np.random.default_rng(0).integers(
        0, 1 << 30, (sort_pass.ROWS, sort_pass.LANES), np.int32), device=dev)
    for s in (1, 2, 4, 8, 16, 32, 64):
        if not torch.equal(sort_pass.lane_pass(x, s, R), sort_pass.lane_pass_plain(x, s, R)):
            raise AssertionError(f"lane pass at stride {s} differs from its plain version")
    for s in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048):
        if not torch.equal(sort_pass.row_pass(x, s, R), sort_pass.row_pass_plain(x, s, R)):
            raise AssertionError(f"row pass at stride {s} differs from its plain version")
    # a compare-exchange is idempotent: if the compiler had folded the
    # repeats, four times R would take about the time of R
    vs_r = {}
    for name, fn in (("lane_s64", lambda r: sort_pass.lane_pass(x, 64, r)),
                     ("lane_s1", lambda r: sort_pass.lane_pass(x, 1, r)),
                     ("row_S64", lambda r: sort_pass.row_pass(x, 64, r))):
        vs_r[name] = {r: cuda_ms(lambda r=r: fn(r)) for r in (R, 4 * R)}
        if vs_r[name][4 * R] < 1.5 * vs_r[name][R]:
            raise AssertionError(f"{name}: {vs_r[name]} ms at R and 4R; the repeats were folded")
    plain = {"lane": cuda_ms(lambda: sort_pass.lane_pass_plain(x, 64, R), n=5, reps=2),
             "row": cuda_ms(lambda: sort_pass.row_pass_plain(x, 64, R), n=5, reps=2)}

    sort_pass.lane_launches = sort_pass.row_launches = 0
    res = sort_micro.main(dev)
    launches = {"lane": sort_pass.lane_launches, "row": sort_pass.row_launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"the sort tool launched the pass kernels {launches} times")
    # one launch = R passes over the block: read once, written once, one
    # int32 min or max per element and pass
    t_bytes = 2 * x.numel() * 4 / PEAK_BYTES
    t_ops = R * x.numel() / PEAK_INT32
    bound = {"bound_ms": 1e3 * max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes > t_ops else "operations"}
    rows = {k: {"ms": res[f"{k}_pass_ms"] * R, "plain_ms": plain[k], "max_abs_err": 0.0, **bound}
            for k in ("lane", "row")}
    emit({"phase": "tool_sort", "keys": x.numel(), "reps": R, "ms_vs_reps": vs_r,
          "launches": launches, "plain_ms_per_launch": plain,
          **{k: v for k, v in res.items() if k != "torch_sort_ms"},
          "torch_sort_ms": {str(k): v for k, v in res["torch_sort_ms"].items()}, **bound})
    return rows, launches


def phase_tool_conv(dev):
    """The conv kernel against its plain version at the tool's check()
    shapes and at the eight VGG16 layers in f32 and bf16, then the tool."""
    f32_err, bf16_err, bf16_abs = 0.0, 0.0, 0.0
    vs_f64 = {"kernel": 0.0, "plain": 0.0}  # both f32 versions against an f64 conv

    def check_f32(x, w, b):
        y, ref = conv.conv3x3(x, w, b), conv.conv3x3_plain(x, w, b)
        exact = torch.relu(torch.nn.functional.conv2d(
            x.double().permute(2, 0, 1)[None], w.double().permute(3, 2, 0, 1), padding=1)[0]
            .permute(1, 2, 0) + b.double())
        for k, v in (("kernel", y), ("plain", ref)):
            vs_f64[k] = max(vs_f64[k], float((v.double() - exact).abs().max()))
        return float((y - ref).abs().max())

    for _, x, w, b in conv_proto.check_inputs(dev):
        f32_err = max(f32_err, check_f32(x, w, b))
    for layer, x, w, b in conv_proto.layer_inputs(dev):
        f32_err = max(f32_err, check_f32(x, w, b))
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        for relu in (True, False):
            y, ref = conv.conv3x3(xb, wb, b, relu=relu), conv.conv3x3_plain(xb, wb, b, relu=relu)
            bf16_err = max(bf16_err, conv_proto.scaled_err(y, ref))
            bf16_abs = max(bf16_abs, float((y.float() - ref.float()).abs().max()))
    if f32_err > conv_proto.F32_ATOL or bf16_err > conv_proto.BF16_RTOL:
        raise AssertionError(f"conv3x3 vs plain: f32 max abs err {f32_err}, bf16 {bf16_err}")

    conv.launches = 0
    res = conv_proto.main(dev)
    launches = conv.launches
    if launches == 0:
        raise AssertionError("the conv tool did not launch the conv kernel")
    layers = res["layers"]
    t_ops = sum(r["flops"] for r in layers) / PEAK_BF16
    t_bytes = sum(r["bytes"] for r in layers) / PEAK_BYTES
    row = {"ms": sum(r["ms"] for r in layers), "plain_ms": sum(r["plain_ms"] for r in layers),
           "library_ms": sum(r["library_ms"] for r in layers),
           "bound_ms": sum(r["bound_ms"] for r in layers),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", "max_abs_err": bf16_abs}
    emit({"phase": "tool_conv", "f32_max_abs_err": f32_err, "f32_max_abs_err_vs_f64": vs_f64,
          "bf16_scaled_err": bf16_err,
          "launches": launches, "layers": layers, "check_max_abs_err": res["check_max_abs_err"],
          "sum_over_layers": row})
    return row, launches


def check_stages(proj, height, width):
    """Every stage of the backward kernel against its plain version
    (ops/bwd_stages.py): (pairs, gimg, errors)."""
    pairs, gimg = bwd_kernel_floor.floor_inputs(proj, height, width)
    errs = {}
    for stage in bwd_stages.STAGES:
        rows, obs = bwd_stages.rasterize_bwd_stage(pairs, proj, gimg, height, width, stage)
        rows_p, obs_p = bwd_stages.bwd_stage_plain(pairs, proj, gimg, height, width, stage)
        if stage in bwd_stages.ABLATED:
            if not torch.equal(rows, rows_p):
                raise AssertionError(f"stage {stage}: staged rows differ from the plain version")
            scale = float(obs_p.abs().max())
            n_out, allowed, mx = mismatch(obs / scale, obs_p / scale, OBSERVE_RTOL)
            if n_out > allowed or not torch.isfinite(obs).all():
                raise AssertionError(f"stage {stage}: observer off its plain version on {n_out} "
                                     f"pixels (allowed {allowed:.0f}), max {mx:.2e} of the max")
            errs[stage] = mx
        else:
            errs[stage] = scaled_err(rows, rows_p)
            errs[f"{stage}_max_abs"] = float((rows - rows_p).abs().max())
            if errs[stage] > GRAD_ATOL:
                raise AssertionError(f"stage {stage}: rows off the plain version by "
                                     f"{errs[stage]:.2e} of the max")
    return pairs, gimg, errs


def measure_stages(proj, height, width, drive=None):
    """The backward kernel's stages on one projected cloud: each held to its
    plain version; then drive(), by default the tool's measure() on proj,
    which holds full and full_soa bitwise to the production kernel and times
    every stage; beside it the plain versions' times and the bounds."""
    pairs, gimg, errs = check_stages(proj, height, width)
    res = drive() if drive else bwd_kernel_floor.measure(proj, height, width)
    work = blend_work(proj, pairs, height, width)
    plain_ms = {s: cuda_ms(lambda s=s: bwd_stages.bwd_stage_plain(pairs, proj, gimg, height,
                                                                     width, s),
                           n=3, reps=1, warmup=1) for s in bwd_stages.STAGES}
    bounds = {s: {k: v for k, v in bwd_bound(proj, pairs, height, width, s, work).items()
                  if k.startswith("bound")} for s in bwd_stages.STAGES}
    return {**res, "scaled_err_vs_plain": errs, "plain_ms": plain_ms, "bounds": bounds,
            "evaluations": work[0], "contributions": work[1]}


def phase_tool_bwd_floor(dev, H=HW, P=CAPACITY):
    """The stages on bench's scene through the tool's main(), counted."""
    proj, _ = bench_scene(dev, H=H, P=P)
    counted = {}

    def drive():
        bwd_stages.launches = 0
        res = bwd_kernel_floor.main(dev, H=H, P=P)
        counted["launches"] = bwd_stages.launches
        if counted["launches"] < len(bwd_stages.STAGES):
            raise AssertionError(f"the stage tool launched the stages {counted} times")
        return res

    row = measure_stages(proj, H, H, drive)
    bounds = row["bounds"].values()
    bound_ms = sum(b["bound_ms"] for b in bounds)
    by_bytes = sum(b["bound_ms"] for b in bounds if b["bound_by"] == "bytes")
    total = {"ms": sum(row["stage_ms"].values()), "plain_ms": sum(row["plain_ms"].values()),
             "bound_ms": bound_ms, "bound_by": "bytes" if by_bytes > bound_ms / 2 else "operations",
             "max_abs_err": max(row["scaled_err_vs_plain"][f"{s}_max_abs"]
                                for s in ("full", "full_soa"))}
    emit({"phase": "tool_bwd_floor", "scene": "bench", "hw": H, "gaussians": P,
          "launches": counted["launches"], **row, "sum_over_stages": total})
    return total, counted["launches"]


# the four kernels of csrc/reduce_scan.cu: (kernels-line name, launch-count
# key, the runs of rs.RUNS it carries, the TPU kernels it replaces)
MXU_KERNELS = (
    ("mxu_moments", "moments", ("moments",), "tools/mxu_micro.py:58",
     "kern_moments_vpu :58, kern_moments_mxu :81"),
    ("mxu_reshape", "reshape", ("reshape",), "tools/mxu_micro.py:94", "kern_reshape_only :94"),
    ("mxu_acc", "acc", ("acc",), "tools/mxu_micro.py:102", "kern_acc_vpu :102, kern_acc_mxu :116"),
    ("mxu_scan", "scan", ("cumsum", "cumprod"), "tools/mxu_micro.py:153",
     "kern_cumsum_vpu :153, kern_cumsum_mxu :175, kern_cumprod_vpu :192, "
     "kern_cumprod_logmxu :203"),
)


def phase_tool_mxu(dev):
    """The twelve reduction and scan runs: their observers across tiles and a
    launch's time against REPS; then the tool, counted, which holds each run
    to its plain version (raising past mxu_micro.RTOL) and times it. Returns
    ({kernel: row summed over its runs}, {kernel: launches})."""
    x, s = mxu_micro.inputs(dev)
    checks = {}
    for name, *_ in rs.RUNS:
        _, obs = rs.run(name, x, s)
        if not torch.equal(obs, obs[:1].expand_as(obs)):
            raise AssertionError(f"{name}: the tiles' observers differ")
        # had the compiler folded the repeats, 4 REPS would take about REPS's time
        vs_reps = {r: cuda_ms(lambda r=r: rs.run(name, x, s, reps=r))
                   for r in (rs.REPS, 4 * rs.REPS)}
        if vs_reps[4 * rs.REPS] <= 1.5 * vs_reps[rs.REPS]:
            raise AssertionError(f"{name}: {vs_reps} ms at REPS and 4 REPS; the repeats were "
                                 "folded")
        checks[name] = {"observers_equal": True, "observer_shape": list(obs.shape),
                        "ms_vs_reps": vs_reps}

    rs.reset_launch_counts()
    res = mxu_micro.main(dev)
    launches = rs.launch_counts()
    if min(launches.values()) == 0:
        raise AssertionError(f"the mxu tool launched the kernels {launches} times")
    rows = res["runs"]
    kernels = {}
    for kname, key, families, _, _ in MXU_KERNELS:
        names = [n for n, fam, *_ in rs.RUNS if fam in families]
        by_ops = sum(rows[n]["bound_ms"] for n in names if rows[n]["bound_by"] == "operations")
        bound_ms = sum(rows[n]["bound_ms"] for n in names)
        kernels[kname] = {
            # each timed over a launch's TILES x REPS chunk-ops
            **{k: sum(rows[n][k] for n in names) for k in ("ms", "plain_ms", "library_ms")},
            "bound_ms": bound_ms, "bound_by": "operations" if by_ops >= bound_ms / 2 else "bytes",
            "max_abs_err": max(rows[n]["max_abs_err"] for n in names),
            "variants": {n: {k: rows[n][k] for k in ("ms", "ns_per_chunk_op", "bound_ms",
                                                      "plain_ms", "library_ms", "max_abs_err")}
                         for n in names}}
    emit({"phase": "tool_mxu", "reps": rs.REPS, "tiles": rs.TILES, "checks": checks,
          "launches": launches, **res})
    return kernels, {k[0]: launches[k[1]] for k in MXU_KERNELS}


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
    cuda_build.build_all(KERNELS)
    ptxas = {n: [ln.strip() for ln in cuda_build.build_logs.get(n, "").splitlines()
                 if any(k in ln for k in ("entry function", "registers", "bytes stack"))]
             for n in KERNELS}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    with torch.inference_mode():
        phase_kernel(dev)
        row, serve_launches = phase_slice(dev)
    phase_train_kernel(dev)
    bwd, train_launches = phase_train(dev)
    sort_rows, sort_launches = phase_tool_sort(dev)
    conv_row, conv_launches = phase_tool_conv(dev)
    floor_row, floor_launches = phase_tool_bwd_floor(dev)
    mxu_rows, mxu_launches = phase_tool_mxu(dev)
    grad_tol = f"grads: max|g - g_plain| / max|g_plain| <= {GRAD_ATOL}; bg rtol {BG_RTOL}"

    def entry(name, source, replaces, launches, by_path, measured, tolerance, library_ms=None,
              **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_by_path": by_path,
                "max_abs_err": measured["max_abs_err"], "ms": measured["ms"],
                "plain_ms": measured["plain_ms"], "bound_ms": measured["bound_ms"],
                "bound_by": measured["bound_by"], "library_ms": library_ms,
                "tolerance": tolerance, **extra}

    mxu_tol = (f"max|out - plain| <= {mxu_micro.RTOL} max|plain| (tensor-core forms against a "
               "plain version rounding as the kernel does); observers bitwise equal across "
               "tiles; ms, bound, plain (on the TILES chunks stacked) and library (one "
               "PyTorch call over the TILES x REPS chunks) each of a launch's TILES x REPS "
               "chunk-ops, summed over the variants")

    emit({"kernels": [
        entry("rasterize_fwd", "moss_torch/csrc/rasterize_fwd.cu",
              "moss_tpu/ops/rasterize_tpu.py:288",
              serve_launches + train_launches["rasterize_fwd"],
              {"serve": serve_launches, "train": train_launches["rasterize_fwd"]}, row,
              f"atol {ATOL} (depth {DEPTH_ATOL}); at most {OUTLIER_FRAC} of pixels beyond"),
        entry("rasterize_bwd", "moss_torch/csrc/rasterize_bwd.cu",
              "moss_tpu/ops/rasterize_tpu.py:383", train_launches["rasterize_bwd"],
              {"train": train_launches["rasterize_bwd"]}, bwd, grad_tol),
        entry("segment_sum", "moss_torch/csrc/segment_sum.cu", "moss_tpu/ops/binning.py:51",
              train_launches["segment_sum"], {"train": train_launches["segment_sum"]},
              bwd["segment"], "1e-5 of the max against index_add_; grads as rasterize_bwd",
              library_ms=bwd["segment"]["library_ms"]),
        entry("sort_lane_pass", "moss_torch/csrc/sort_pass.cu", "tools/sort_micro.py:47",
              sort_launches["lane"], {"tools": sort_launches["lane"]}, sort_rows["lane"],
              "exact, every stride; ms per launch of R = 64 passes at s = 64"),
        entry("sort_row_pass", "moss_torch/csrc/sort_pass.cu", "tools/sort_micro.py:68",
              sort_launches["row"], {"tools": sort_launches["row"]}, sort_rows["row"],
              "exact, every stride; ms per launch of R = 64 passes at S = 64"),
        entry("conv3x3", "moss_torch/csrc/conv3x3.cu", "tools/conv_pallas_proto.py:28",
              conv_launches, {"tools": conv_launches}, conv_row,
              f"f32 atol {conv_proto.F32_ATOL}; bf16 max|y - y_plain| <= "
              f"{conv_proto.BF16_RTOL} max|y_plain|; ms summed over the eight VGG16 layers",
              library_ms=conv_row["library_ms"]),
        entry("rasterize_bwd_stages", "moss_torch/csrc/rasterize_bwd.cu",
              "tools/bwd_kernel_floor.py:97", floor_launches, {"tools": floor_launches},
              floor_row, "full, full_soa bitwise equal to rasterize_bwd; rows vs plain "
              f"{GRAD_ATOL} of the max, observers {OBSERVE_RTOL}; ms summed over the five "
              "stages on bench"),
        *(entry(kname, "moss_torch/csrc/reduce_scan.cu", replaces, mxu_launches[kname],
                {"tools": mxu_launches[kname]}, mxu_rows[kname], mxu_tol,
                library_ms=mxu_rows[kname]["library_ms"],
                replaces_all=f"tools/mxu_micro.py: {all_}",
                variants=mxu_rows[kname]["variants"])
          for kname, _, _, replaces, all_ in MXU_KERNELS),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
