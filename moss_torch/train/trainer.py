"""The trainer: one eager loop around the training step, densification,
opacity resets and evaluation (port of moss_tpu/train/trainer.py).

Trainer.train keeps moss_tpu's order of work (the reference's train_ZJU.py):
frames in epoch-shuffled order from np.random.default_rng(cfg.seed); the SH
degree warms up every 1000 iterations; after step i it densifies when
densify_from_iter < i < densify_until_iter and i % densification_interval
== 0 (the size prune from i > opacity_reset_interval on), then resets the
opacities when i % opacity_reset_interval == 0 or, on a white background,
i == densify_from_iter, both only while i < densify_until_iter. The eval and
save_fn of iteration i run on the state after step i - 1 (at the last
iteration, the final state), ckpt_fn(i) after step i. A non-finite loss
raises FloatingPointError.

Each step is dispatched and its scalar logs read back (one sync), so the
loop needs no queue and no segmenting; moss_tpu's pair-budget probe, resize
and heal machinery and its queued and scan engines (XLA's static shapes and
the TPU relay) have no counterpart. Densify noise comes from a torch
Generator seeded with (cfg.seed, iteration), so a resumed run replays it.

save / load / resume_latest write and read chkpnt{N}.npz in moss_tpu's
schema (train/checkpoint.py); compact_for_eval keeps moss_tpu's rule for the
serving capacity.
"""
from __future__ import annotations

import dataclasses
import glob
import math
import os
import re
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..data.frames import Frame
from ..data.prefetch import iter_frames
from ..models import gaussians as G
from ..models.lbs_field import LBSField
from ..models.pose_refine import PoseRefine
from ..ops import lpips
from ..ops.ssim import psnr as psnr_fn
from ..ops.ssim import ssim as ssim_fn
from ..render.render import SceneContext, render_frame
from . import checkpoint, optim
from .densify import densify_and_prune, densify_and_prune_static
from .losses import crop_window
from .train_step import TrainState, active_sh_degree, make_train_step


# the scene's spatial scale: the monocular reference forces the camera
# radius to 1 (dataset_readers.py:714), so every body scene trains at 1; a
# static COLMAP/Blender scene passes its nerfpp_norm radius (data/colmap.py)
EXTENT = 1.0


def init_gaussians_and_mlps(scene: SceneContext, cfg: Config, device=None):
    """(params, gstate, mlps or None): the cloud seeded on the big-pose body
    vertices, SMPL's or SMPL-X's (a static scene's points), an even subsample
    when n_init_points is smaller, random colours from cfg.seed, and the
    correction MLPs from a Generator seeded with cfg.seed (None without
    motion_offset, as for SMPL-X and static scenes)."""
    device = resolve_device(device)
    verts = scene.big_pose_vertices.detach().cpu().numpy()
    if cfg.model.n_init_points < verts.shape[0]:
        sel = np.linspace(0, verts.shape[0] - 1, cfg.model.n_init_points)
        verts = verts[np.round(sel).astype(np.int64)]
    init_colors = np.random.default_rng(cfg.seed).random((verts.shape[0], 3)).astype(np.float32)
    params, valid = G.create_from_points(verts, init_colors, capacity=cfg.model.capacity,
                                         sh_degree=cfg.model.sh_degree, device=device)
    mlps = None
    if cfg.model.motion_offset:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        mlps = {"pose": PoseRefine(gen, device), "lbs": LBSField(gen, device)}
    return params, G.initial_state(valid), mlps


class Trainer:
    """Trains one avatar. train_frames and test_frames are Frames on the
    trainer's device; lpips_params are the LPIPS tower's weights
    (ops/lpips.py). Renders go through rasterize_cuda: the blend kernels for
    CUDA tensors, their plain version for CPU ones. extent is the scene's
    spatial scale: the xyz learning rate's factor and densification's size
    unit. log_fn(it, logs) gets each iteration's logs as Python numbers."""

    def __init__(self, scene: SceneContext, train_frames: List[Frame], test_frames: List[Frame],
                 cfg: Config, lpips_params, crop_hw=None, extent: float = EXTENT,
                 log_fn: Optional[Callable[[int, Dict], None]] = None, device=None):
        self.device = resolve_device(device)
        if cfg.model.static_scene and cfg.model.motion_offset:
            raise ValueError("static_scene has no body model: set motion_offset=False")
        self.scene, self.cfg, self.extent = scene, cfg, extent
        self.train_frames, self.test_frames = train_frames, test_frames
        self.lpips_params = lpips_params
        self.log_fn = log_fn
        H, W = train_frames[0].camera.height, train_frames[0].camera.width
        self.crop_hw = crop_hw if crop_hw is not None else (min(H, 256), min(W, 256))
        self.bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0,
                             device=self.device)
        params, gstate, mlps = init_gaussians_and_mlps(scene, cfg, device=self.device)
        p = {"gauss": params, "mlps": mlps}
        init_fn, self.step_fn = self._make_step()
        self.ts = TrainState(p, init_fn(p), gstate, 0)
        self.metrics_history: List[Dict] = []

    def _make_step(self):
        return make_train_step(self.scene, self.cfg, None, self.lpips_params, *self.crop_hw,
                               spatial_lr_scale=self.extent, device=self.device)

    def set_state(self, ts: TrainState):
        """Replace the train state (a converted moss_tpu state, a checkpoint)."""
        self.ts = ts

    def save(self, path: str):
        """The whole train state as a chkpnt{N}.npz (moss_tpu's schema)."""
        checkpoint.save_checkpoint(path, self.ts)

    def load(self, path: str):
        """Restore a chkpnt{N}.npz written by either package. The config's
        capacity follows the file's (a compacted state), and the step
        function is rebuilt for it."""
        ts = checkpoint.restore_checkpoint(path, self.device)
        if (ts.params["mlps"] is None) == self.cfg.model.motion_offset:
            raise ValueError(f"{path}: MLPs {'absent' if ts.params['mlps'] is None else 'present'}"
                             f" but motion_offset={self.cfg.model.motion_offset}")
        self._set_capacity(ts.params["gauss"].capacity)
        self.ts = ts

    def _set_capacity(self, capacity: int):
        if capacity != self.cfg.model.capacity:
            self.cfg = dataclasses.replace(
                self.cfg, model=dataclasses.replace(self.cfg.model, capacity=capacity))
            _, self.step_fn = self._make_step()

    def compact_for_eval(self, granularity: int = 2048) -> int:
        """Shrink the capacity to the live cloud, for serving: live slots to
        the front in their order (np.argsort(~valid, kind="stable")), cut to
        the next multiple of `granularity` (at least one), the optimizer state
        re-initialized at the new shape and the step function rebuilt. The
        densify statistics and headroom do not survive, and a per-Gaussian
        cache built before (cached transforms) no longer lines up. Returns the
        new capacity (the old one when the cloud already fills it)."""
        valid = self.ts.gstate.valid
        n = int(valid.sum())
        cap2 = max(granularity, -(-n // granularity) * granularity)
        g = self.ts.params["gauss"]
        if cap2 >= g.capacity:
            return g.capacity
        perm = torch.as_tensor(np.argsort(~valid.cpu().numpy(), kind="stable")[:cap2],
                               device=self.device)
        gs = self.ts.gstate
        params = {**self.ts.params,
                  "gauss": G.GaussianParams(**{f: getattr(g, f)[perm] for f in G.FIELDS})}
        gstate = G.GaussianState(
            valid=gs.valid[perm], max_radii2d=gs.max_radii2d[perm],
            xyz_grad_accum=gs.xyz_grad_accum[perm], denom=gs.denom[perm], joint_F=gs.joint_F,
            lbs_weight_sum=gs.lbs_weight_sum[perm])
        self._set_capacity(cap2)
        self.ts = TrainState(params, optim.init_state(params), gstate, self.ts.step)
        return cap2

    def resume_latest(self, model_path: str) -> int:
        """Load the newest chkpnt{N}.npz under model_path; its step, 0 if none."""
        cands = glob.glob(os.path.join(model_path, "chkpnt*.npz"))
        if not cands:
            return 0
        self.load(max(cands, key=lambda p: int(re.findall(r"(\d+)", os.path.basename(p))[0])))
        return int(self.ts.step)

    def _gt_lpips_features(self):
        """Every train frame's ground-truth LPIPS tower at its crop, once: the
        ground truth does not change, so the step need not recompute it."""
        if self.cfg.optim.w_lpips == 0.0:
            return None
        ch, cw = self.crop_hw
        return [lpips.gt_features(self.lpips_params,
                                  crop_window(f.image, f.crop_y0, f.crop_x0, ch, cw))
                for f in self.train_frames]

    def train(self, iterations: Optional[int] = None, eval_iters=None, save_fn=None,
              save_iters=None, ckpt_fn=None) -> List[Dict]:
        """Train to `iterations` (default cfg.optim.iterations), continuing
        from ts.step. eval_iters / save_iters default to cfg.pipe's
        test_iterations / save_iterations; save_fn(i) and each eval run on
        iteration i's pre-step state, ckpt_fn(i) at the eval iterations on
        its post-step state. Returns metrics_history."""
        cfg = self.cfg
        iters = iterations or cfg.optim.iterations
        start = int(self.ts.step)
        if start >= iters:
            return self.metrics_history
        if iters != cfg.optim.iterations:
            # the run length decides the final step's skip: it redefines the run
            self.cfg = cfg = dataclasses.replace(
                cfg, optim=dataclasses.replace(cfg.optim, iterations=iters))
            _, self.step_fn = self._make_step()
        eval_iters = set(cfg.pipe.test_iterations if eval_iters is None else eval_iters)
        save_iters = set(cfg.pipe.save_iterations if save_iters is None else save_iters)

        def fire_map(its):
            # label i fires on the state after step i - 1; the last iteration
            # takes no step, so its label fires at the end
            return {(i - 1 if i < iters else i): i for i in its if i <= iters}

        eval_at, save_at = fire_map(eval_iters), fire_map(save_iters)
        ckpt_at = {i for i in eval_iters if i <= iters}
        rng = np.random.default_rng(cfg.seed)
        order: List[int] = []
        while len(order) < iters:
            order.extend(rng.permutation(len(self.train_frames)).tolist())
        feats = self._gt_lpips_features()
        t0 = time.time()

        def fire_eval_save(it):
            lbl = eval_at.get(it)
            if lbl is not None:
                m = self.evaluate(sh_it=lbl)
                m["iteration"] = lbl
                m["elapsed_s"] = time.time() - t0
                self.metrics_history.append(m)
            if save_fn is not None and it in save_at:
                save_fn(save_at[it])

        if start in eval_at or start in save_at:
            fire_eval_save(start)
        o = cfg.optim
        for it in range(start + 1, iters + 1):
            idx = order[it - 1]
            self.ts, logs = self.step_fn(self.ts, self.train_frames[idx],
                                         active_sh_degree(it, cfg.model.sh_degree),
                                         None if feats is None else feats[idx])
            logs = _to_host(logs)
            if not math.isfinite(logs["loss"]):
                raise FloatingPointError(f"non-finite loss {logs['loss']} at iteration {it}")
            if self.log_fn is not None:
                self.log_fn(it, logs)
            if o.densify_from_iter < it < o.densify_until_iter and \
                    it % o.densification_interval == 0:
                self.densify(it)
            if it < o.densify_until_iter and (
                    it % o.opacity_reset_interval == 0
                    or (cfg.model.white_background and it == o.densify_from_iter)):
                self.reset_opacity()
            fire_eval_save(it)
            if ckpt_fn is not None and it in ckpt_at:
                ckpt_fn(it)
        return self.metrics_history

    def densify_noise(self, it: int):
        """The round's standard normals, (3, P, 3) ((2, P, 3) for a static
        scene), from a Generator on the trainer's device seeded by (seed, it)."""
        seed = int(np.random.SeedSequence((self.cfg.seed, it)).generate_state(1)[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        n = 2 if self.cfg.model.static_scene else 3
        return torch.randn((n, self.ts.params["gauss"].capacity, 3), generator=gen,
                           device=self.device)

    def densify(self, it: int):
        """One densification round after step `it`; returns its stats."""
        cfg = self.cfg
        noise = self.densify_noise(it)
        use_size = it > cfg.optim.opacity_reset_interval
        ts = self.ts
        if cfg.model.static_scene:
            params, gstate, opt_state, stats = densify_and_prune_static(
                ts.params["gauss"], ts.gstate, ts.opt_state, noise, cfg.optim, self.extent,
                use_size)
        else:
            params, gstate, opt_state, stats = densify_and_prune(
                ts.params["gauss"], ts.gstate, ts.opt_state, noise, cfg.optim, self.extent,
                self.scene.big_pose_vertices, use_size)
        self.ts = TrainState({**ts.params, "gauss": params}, opt_state, gstate, ts.step)
        return stats

    def reset_opacity(self):
        """Clamp the opacities to <= 0.01 and zero the opacity group's Adam
        moments, keeping its count (the reference's replace_tensor_to_optimizer)."""
        ts = self.ts
        self.ts = TrainState({**ts.params, "gauss": G.reset_opacity(ts.params["gauss"])},
                             optim.zero_group_moments(ts.opt_state, "opacity"), ts.gstate,
                             ts.step)

    @torch.no_grad()
    def render_eval(self, frame: Frame, sh_degree=None):
        deg = sh_degree if sh_degree is not None else self.cfg.model.sh_degree
        return render_frame(self.ts.params["gauss"], self.ts.gstate.valid,
                            self.ts.params.get("mlps"), self.scene, frame.smpl_params,
                            frame.camera, self.bg, deg, motion_offset=self.cfg.model.motion_offset,
                            static_scene=self.cfg.model.static_scene, device=self.device)

    @torch.no_grad()
    def evaluate(self, frames=None, sh_it: Optional[int] = None) -> Dict:
        """Mean PSNR, SSIM and LPIPS (f32) over `frames` (default the test
        split; Frames, or FrameSpecs decoded on a prefetch thread) on the
        full image, the render and ground truth clipped to [0, 1]; SH at the
        degree of iteration sh_it (default ts.step). raster_overflow is the
        pairs dropped, always 0 in the port."""
        cfg = self.cfg
        frames = frames if frames is not None else self.test_frames
        deg = active_sh_degree(int(self.ts.step) if sh_it is None else int(sh_it),
                               cfg.model.sh_degree)
        per_frame = []
        for frame in iter_frames(frames, None, device=self.device):
            out = render_frame(self.ts.params["gauss"], self.ts.gstate.valid,
                               self.ts.params.get("mlps"), self.scene, frame.smpl_params,
                               frame.camera, self.bg, cfg.model.sh_degree,
                               motion_offset=cfg.model.motion_offset,
                               static_scene=cfg.model.static_scene, active_sh=deg,
                               device=self.device)
            img = torch.clamp(out["render"], 0.0, 1.0)
            gt = torch.clamp(frame.image, 0.0, 1.0)
            per_frame.append(torch.stack([psnr_fn(img, gt), ssim_fn(img, gt),
                                          lpips.lpips(self.lpips_params, img, gt)]))
        n = max(len(per_frame), 1)
        sums = [0.0, 0.0, 0.0]
        for row in (torch.stack(per_frame).tolist() if per_frame else []):
            sums = [s + v for s, v in zip(sums, row)]
        return {"psnr": sums[0] / n, "ssim": sums[1] / n, "lpips": sums[2] / n,
                "raster_overflow": 0}


def _to_host(logs: Dict) -> Dict:
    """A step's 0-d log tensors as Python numbers, in one transfer."""
    keys = list(logs)
    vals = torch.stack([torch.as_tensor(logs[k]).to(torch.float64).reshape(())
                        for k in keys]).tolist()
    return {k: (int(v) if not torch.is_floating_point(torch.as_tensor(logs[k])) else v)
            for k, v in zip(keys, vals)}
