"""One training iteration: render -> loss -> grads -> AdamW -> densify stats.

Port of moss_tpu/train/train_step.py:30-152, run eagerly: autograd through
render_frame (the blend kernels' autograd.Function, the deform chain and the
MLPs) and the six-term loss, then per-group AdamW with the reference's update
skips, then the densification statistics. The screen-space gradient
statistic reads the grad of a zero (P, 2) mean2d offset times [W/2, H/2],
the reference's units, so its 0.0002 densify threshold transfers unchanged.

The state is updated in place: the Gaussian fields of params["gauss"]
(plain tensors), the MLP modules' parameters, the Adam moments and the
densify statistics, always through optim.adamw_step_device. With a TrainState
whose step and Adam counts are 0-d device tensors (`device_state`), the step
reads no host value and advances those in place too: the frame's crop and
the SH degree may be device ints, and the optimizer's count-dependent numbers
come from the tables the caller set on the step (`tables`, optim.StepTables).
That is the step the trainer's engines run. With one whose step and counts
are ints (the sharded step, tests), the update runs on its device form with
tables the step builds for its run, and the TrainState comes back with the
ints advanced.

make_train_many is moss_tpu's (train_step.py:155-201): K steps over frames
staged on the device (stage_frames: a stacked Frame, the crop offsets as
device ints) and a device `order`, the SH degree taken per step from the
step count. On a CUDA tensor it captures one step, forward, backward, AdamW
and the densify statistics, as a torch.cuda.CUDAGraph after a warm-up step
that is the first of the K, and replays it for the others; the frame index,
the step count and the learning rate are read from device tensors, and the
state lives in fixed tensors that each replay advances. A capture is made
again only when a tensor the step reads or writes was replaced (densify,
reset, load) or the step itself was (budgets installed). On a CPU tensor, or
with graph=False, it runs the same step K times.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from .. import resolve_device
from ..config import Config
from ..data.frames import Frame
from ..models import gaussians as G
from ..render.render import SceneContext, render_frame
from . import optim
from .losses import LossWeights, compute_losses


class TrainState(NamedTuple):
    params: Dict                        # {"gauss": GaussianParams, "mlps": {"pose", "lbs"} or None}
    opt_state: Dict[str, optim.AdamState]
    gstate: G.GaussianState
    step: int


def active_sh_degree(step, max_degree: int):
    """SH degree grows every 1000 iterations (the reference's train_ZJU.py:85-86).
    A 0-d device int gives a 0-d device int."""
    if isinstance(step, torch.Tensor):
        return torch.clamp_max(torch.div(step, 1000, rounding_mode="floor"), max_degree)
    return min(step // 1000, max_degree)


def device_state(ts: TrainState, step=None, counts=None) -> TrainState:
    """ts with its step and Adam counts as 0-d int64 tensors on the params'
    device (the given ones, else new ones holding ts's ints)."""
    device = ts.params["gauss"].xyz.device
    if step is None:  # filled on the device: a host copy would sync
        step = torch.full((), int(ts.step), dtype=torch.int64, device=device)
    counts = counts or {g: torch.full((), int(s.count), dtype=torch.int64, device=device)
                        for g, s in ts.opt_state.items()}
    return TrainState(ts.params, {g: optim.AdamState(counts[g], s.mu, s.nu)
                                  for g, s in ts.opt_state.items()}, ts.gstate, step)


def stage_frames(frames: List[Frame]) -> Frame:
    """The frames as one Frame on their device: every tensor stacked on a new
    leading dim (the cameras' too; one image size), crop_y0, crop_x0 and
    pose_id as (F,) int64 tensors."""
    cams = [f.camera for f in frames]
    if len({(c.height, c.width) for c in cams}) != 1:
        raise ValueError("stage_frames needs one image size")
    device = frames[0].image.device
    camera = dataclasses.replace(cams[0], **{k: torch.stack([getattr(c, k) for c in cams])
                                             for k in _CAMERA_FIELDS})
    fields = {}
    for f in dataclasses.fields(Frame):
        if f.name != "camera":
            vals = [getattr(fr, f.name) for fr in frames]
            fields[f.name] = (torch.stack(vals) if isinstance(vals[0], torch.Tensor)
                              else torch.tensor(vals, dtype=torch.int64, device=device))
    return Frame(camera=camera, **fields)


_CAMERA_FIELDS = ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy")


def staged_frame(frames: Frame, idx) -> Frame:
    """Frame idx ((1,) device int64) of stage_frames' stack, read on the device."""
    def take(x):
        return x.index_select(0, idx).squeeze(0)

    camera = dataclasses.replace(frames.camera, **{k: take(getattr(frames.camera, k))
                                                   for k in _CAMERA_FIELDS})
    return Frame(camera=camera, **{f.name: take(getattr(frames, f.name))
                                   for f in dataclasses.fields(Frame) if f.name != "camera"})


class TrainStep:
    """The step of make_train_step; `grads` is its first half alone."""

    def __init__(self, scene: SceneContext, cfg: Config, rasterize_fn: Optional[Callable],
                 lpips_params, crop_h: int, crop_w: int, spatial_lr_scale: float = 1.0,
                 device=None):
        self.scene, self.cfg = scene, cfg
        self.rasterize_fn = rasterize_fn
        self.lpips_params = lpips_params
        self.crop_h, self.crop_w = crop_h, crop_w
        self.spatial_lr_scale = spatial_lr_scale
        self.device = resolve_device(device)
        o = cfg.optim
        self.weights = LossWeights(l1=o.w_l1, mask=o.w_mask, ssim=o.w_ssim, lpips=o.w_lpips,
                                   nll=o.w_nll, s3im=o.w_s3im)
        self.bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0,
                             device=self.device)
        self.tables: Optional[optim.StepTables] = None  # the device-state step's
        self._int_tables: Optional[optim.StepTables] = None  # the int-state step's own
        self._ndc_scale = {}

    # what the gradient is taken of: total * loss_scale (the sharded step
    # differentiates its data mean)
    loss_scale = 1.0

    def init(self, params: Dict) -> Dict[str, optim.AdamState]:
        return optim.init_state(params)

    def loss_inputs(self, out: Dict) -> Dict:
        """The render output the loss reads (the sharded step lets the
        Fisher NLL's gradient through on one band's rank only)."""
        return out

    def grads(self, ts: TrainState, frame: Frame, sh_degree: int, gt_lpips_feats=None):
        """(total, logs, render out, {group: {name: grad}}, mean2d-offset grad)."""
        cfg = self.cfg
        gauss = ts.params["gauss"]
        leaves = G.GaussianParams(**{f: getattr(gauss, f).detach().requires_grad_()
                                     for f in G.FIELDS})
        mlps = ts.params.get("mlps")
        offset = torch.zeros((gauss.capacity, 2), device=self.device, requires_grad=True)
        out = render_frame(
            leaves, ts.gstate.valid, mlps, self.scene, frame.smpl_params, frame.camera,
            self.bg, cfg.model.sh_degree, rasterize_fn=self.rasterize_fn,
            mean2d_offset=offset, motion_offset=cfg.model.motion_offset,
            active_sh=sh_degree, static_scene=cfg.model.static_scene, device=self.device)
        total, logs = compute_losses(
            self.loss_inputs(out), frame.image, frame.bkgd_mask, frame.bound_mask,
            frame.pose_rotmats, frame.crop_y0, frame.crop_x0, self.crop_h, self.crop_w,
            lpips_params=self.lpips_params, weights=self.weights,
            gt_lpips_feats=gt_lpips_feats)
        groups = optim.param_groups({"gauss": leaves, "mlps": mlps})
        names = [(g, n) for g, tensors in groups.items() for n in tensors]
        scaled = total if self.loss_scale == 1.0 else total * self.loss_scale
        flat = torch.autograd.grad(scaled, [groups[g][n] for g, n in names] + [offset],
                                   allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {g: {} for g in groups}
        for (g, n), gr in zip(names, flat[:-1]):
            grads[g][n] = torch.zeros_like(groups[g][n]) if gr is None else gr
        logs = {k: v.detach() for k, v in logs.items()}
        return total.detach(), logs, out, grads, flat[-1]

    def ndc_scale(self, cam) -> torch.Tensor:
        """(2,) [W / 2, H / 2]: the screen-space gradient's units."""
        key = (cam.width, cam.height)
        if key not in self._ndc_scale:  # filled on the device: a host copy would sync
            self._ndc_scale[key] = torch.cat([
                torch.full((1,), cam.width * 0.5, device=self.device),
                torch.full((1,), cam.height * 0.5, device=self.device)])
        return self._ndc_scale[key]

    def update(self, ts: TrainState, grads) -> Dict[str, optim.AdamState]:
        """AdamW on ts (optim.adamw_step_device, in place); the opt_state with
        the counts advanced: ts's own under a device-state ts (the caller's
        tables), else a new one with the ints advanced (tables the step builds
        for its run, at least cfg.optim.iterations long)."""
        cfg = self.cfg
        if isinstance(ts.step, torch.Tensor):
            if self.tables is None:
                raise ValueError("a device-state step needs the optimizer tables (step.tables)")
            optim.adamw_step_device(cfg.optim, ts.params, grads, ts.opt_state, self.tables,
                                    ts.step, self.spatial_lr_scale)
            return ts.opt_state
        tables = self._int_tables
        if tables is None or tables.skip_host.shape[0] <= ts.step:
            tables = self._int_tables = optim.step_tables(
                cfg.optim, cfg.model.white_background, optim.param_groups(ts.params),
                self.spatial_lr_scale, ts.params["gauss"].xyz.device,
                length=max(cfg.optim.iterations, 2 * (ts.step + 1)))
        dev = device_state(ts)
        optim.adamw_step_device(cfg.optim, ts.params, grads, dev.opt_state, tables, dev.step,
                                self.spatial_lr_scale)
        return optim.advance_counts(ts.opt_state, tables, ts.step + 1, ts.step + 1)

    def __call__(self, ts: TrainState, frame: Frame, sh_degree: int, gt_lpips_feats=None):
        """One iteration; (TrainState, logs) (module docstring): a device_state
        TrainState is advanced in place and returned."""
        _, logs, out, grads, offset_grad = self.grads(ts, frame, sh_degree, gt_lpips_feats)
        opt_state = self.update(ts, grads)

        # densification statistics (the reference's add_densification_stats)
        with torch.no_grad():
            gs = ts.gstate
            vis = out["visibility_filter"]
            gnorm = torch.linalg.norm(offset_grad * self.ndc_scale(frame.camera)[None, :], dim=-1)
            pose_out = out["pose_out"]
            stats = dict(  # written in place
                xyz_grad_accum=gs.xyz_grad_accum + torch.where(vis, gnorm, 0.0),
                denom=gs.denom + vis.to(torch.float32),
                max_radii2d=torch.where(
                    vis, torch.maximum(gs.max_radii2d, out["radii"].to(torch.float32)),
                    gs.max_radii2d),
                joint_F=gs.joint_F + pose_out["Rs"] if pose_out is not None else gs.joint_F,
                lbs_weight_sum=(gs.lbs_weight_sum + out["lbs_weights"]
                                if pose_out is not None and out["lbs_weights"] is not None
                                else gs.lbs_weight_sum),
            )
            for k, v in stats.items():
                if getattr(gs, k) is not None and v is not getattr(gs, k):
                    getattr(gs, k).copy_(v)
            logs["psnr_proxy"] = -10.0 * torch.log10(logs["l1"] ** 2 + 1e-12)
            logs["num_points"] = gs.num_valid
            if out.get("overflow") is not None:
                logs["raster_overflow"] = out["overflow"]
        if isinstance(ts.step, torch.Tensor):
            ts.step.add_(1)
            return ts, logs
        return TrainState(ts.params, opt_state, gs, ts.step + 1), logs


def make_train_step(scene: SceneContext, cfg: Config, rasterize_fn: Optional[Callable],
                    lpips_params, crop_h: int, crop_w: int, spatial_lr_scale: float = 1.0,
                    device=None):
    """(init_fn, step_fn) as moss_tpu's make_train_step; step_fn(ts, frame,
    sh_degree, gt_lpips_feats=None) -> (TrainState, logs). rasterize_fn None
    is rasterize_cuda. step_fn.grads is the step's gradient half alone."""
    step = TrainStep(scene, cfg, rasterize_fn, lpips_params, crop_h, crop_w,
                     spatial_lr_scale, device)
    return step.init, step


class TrainMany:
    """make_train_many's function: many(ts, frames, order, gt_lpips_feats=None)
    -> (ts, logs). ts: a device_state TrainState, advanced in place by
    len(order) steps; frames: stage_frames' stack; order: (K,) int64 frame
    indices on the device; gt_lpips_feats: the frames' LPIPS towers stacked,
    a list of (F, 1, H', W', C) tensors, or None. logs: with per_step_logs a
    dict of (K,) tensors (the integer logs as int64, the others float64),
    else the last step's with raster_overflow summed over the K.

    Counts: captures (graphs captured), replays (graph replays, each one
    step), capture_ms (each capture's host time, warm-up step excluded),
    pool_mb (the card memory the last capture reserved), captured_launches
    ({kernel: calls} the last capture recorded, ops/rasterize_cuda.py's and
    ops/fisher.py's `captured` counts, which each replay runs). The kernel
    wrappers' launch counts hold only what they launched: the warm-up steps,
    not the captures or the replays."""

    def __init__(self, step_fn, max_sh_degree: Optional[int] = None,
                 per_step_logs: bool = False, graph: bool = True):
        self.step_fn, self.max_sh_degree = step_fn, max_sh_degree
        self.per_step_logs, self.graph = per_step_logs, graph
        self.captures, self.replays, self.capture_ms, self.pool_mb = 0, 0, [], 0.0
        self.captured_launches: Dict[str, int] = {}
        self._graph = None
        self._signature = None
        self._keys: Optional[List[str]] = None
        self._ints: set = set()
        self._order = self._pos = self._logs = None

    def _buffers(self, order):
        K, device = order.shape[0], order.device
        if self._order is None or self._order.shape[0] < K or self._order.device != device:
            self._order = torch.zeros(K, dtype=torch.int64, device=device)
            self._pos = torch.zeros(1, dtype=torch.int64, device=device)
            self._logs = None
        self._order[:K].copy_(order)
        self._pos.zero_()

    def _body(self, ts, frames, feats):
        idx = self._order.index_select(0, self._pos)
        frame = staged_frame(frames, idx)
        f = None if feats is None else [x.index_select(0, idx).squeeze(0) for x in feats]
        deg = (active_sh_degree(ts.step + 1, self.max_sh_degree)
               if self.max_sh_degree is not None else 0)
        _, logs = self.step_fn(ts, frame, deg, f)
        if self._keys is None:
            self._keys = sorted(logs)
            self._ints = {k for k in logs if not torch.is_floating_point(torch.as_tensor(logs[k]))}
        if self._logs is None:
            self._logs = torch.zeros((self._order.shape[0], len(self._keys)), dtype=torch.float64,
                                     device=self._order.device)
        row = torch.stack([torch.as_tensor(logs[k]).to(torch.float64).reshape(()) for k in self._keys])
        self._logs.index_copy_(0, self._pos, row[None])
        self._pos.add_(1)

    def __call__(self, ts: TrainState, frames: Frame, order, gt_lpips_feats=None):
        if not isinstance(ts.step, torch.Tensor):
            raise ValueError("make_train_many runs a device_state TrainState")
        K = order.shape[0]
        self._buffers(order)
        if self.graph and order.device.type == "cuda":
            self._run_graph(ts, frames, gt_lpips_feats, K)
        else:
            for _ in range(K):
                self._body(ts, frames, gt_lpips_feats)
        rows = self._logs[:K].clone()  # the next call writes the buffer again
        logs = {k: rows[:, i] for i, k in enumerate(self._keys)}
        logs = {k: (v.to(torch.int64) if k in self._ints else v) for k, v in logs.items()}
        if self.per_step_logs:
            return ts, logs
        last = {k: v[-1] for k, v in logs.items()}
        if "raster_overflow" in logs:
            last["raster_overflow"] = logs["raster_overflow"].sum()
        return ts, last

    def _run_graph(self, ts, frames, feats, K):
        from ..ops import fisher
        from ..ops import rasterize_cuda as rc

        # what the graph holds: the step (its budgets, buffers and tables, kept
        # alive here, so no later object takes their place) and every tensor
        # it reads or writes, by address and shape
        tables = getattr(self.step_fn, "tables", None)
        signature = (self.step_fn, tables, tuple(
            (t.data_ptr(), tuple(t.shape)) for t in _state_tensors(ts, frames, feats)
            + [self._order] + ([] if tables is None else [tables.lr_xyz, tables.c1, tables.c2,
                                                          tables.skip])))
        left = K
        old = self._signature
        if old is None or old[0] is not self.step_fn or old[1] is not tables or \
                old[2] != signature[2]:
            self._graph, self._signature = None, None
            device = self._order.device
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):  # the warm-up: the first of the K steps
                self._body(ts, frames, feats)
            torch.cuda.current_stream(device).wait_stream(side)
            left -= 1
            before = {**rc.captured, "svd3": fisher.captured}
            # torch.cuda.graph empties the cache as it starts: do it first, so
            # that the reserved memory's growth is the graph's pool
            t0 = time.perf_counter()
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._body(ts, frames, feats)
            torch.cuda.synchronize(device)
            self.capture_ms.append((time.perf_counter() - t0) * 1e3)
            self.pool_mb = (torch.cuda.memory_reserved(device) - reserved) / 2**20
            self.captured_launches = {k: n - before[k] for k, n in
                                      {**rc.captured, "svd3": fisher.captured}.items()}
            self._graph, self._signature = graph, signature
            self.captures += 1
        for _ in range(left):
            self._graph.replay()
        self.replays += left


def _state_tensors(ts: TrainState, frames: Frame, feats):
    """The tensors a device-state step reads or writes, in a fixed order."""
    out = [ts.step]
    g = ts.params["gauss"]
    out += [getattr(g, f) for f in G.FIELDS]
    if ts.params.get("mlps") is not None:
        for k in sorted(ts.params["mlps"]):
            out += [p for _, p in sorted(ts.params["mlps"][k].named_parameters())]
    for grp in sorted(ts.opt_state):
        s = ts.opt_state[grp]
        out += [s.count, *(s.mu[n] for n in sorted(s.mu)), *(s.nu[n] for n in sorted(s.nu))]
    out += [t for t in (getattr(ts.gstate, f.name) for f in dataclasses.fields(ts.gstate))
            if isinstance(t, torch.Tensor)]
    out += [t for f in dataclasses.fields(Frame) if f.name != "camera"
            for t in [getattr(frames, f.name)]]
    out += [getattr(frames.camera, k) for k in _CAMERA_FIELDS]
    out += list(feats or [])
    return out


def make_train_many(step_fn, max_sh_degree: Optional[int] = None, per_step_logs: bool = False,
                    graph: bool = True) -> TrainMany:
    """moss_tpu's make_train_many for the port (module docstring; TrainMany):
    K steps of step_fn in one call, a CUDA graph of the step on a CUDA tensor
    unless graph=False. With max_sh_degree the SH degree of each step is
    min((step + 1) // 1000, max_sh_degree), from the device step count;
    without it, 0."""
    return TrainMany(step_fn, max_sh_degree, per_step_logs, graph)
