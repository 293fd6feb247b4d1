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
writes a failure snapshot (the frame's rasterizer inputs under the current
params, <cfg.model_path>/snapshot_iter{N}.npz) and raises FloatingPointError
naming it.

The ground truth's LPIPS towers are computed once per train frame and kept
while they fit in MOSS_LPIPS_GT_CACHE bytes (default 8 GiB; 0 turns the
cache off), else each step computes its frame's again, as moss_tpu does.

Each step is dispatched and its scalar logs read back (one sync), so the
loop needs no queue and no segmenting; moss_tpu's pair-budget probe, resize
and heal machinery and its queued and scan engines (XLA's static shapes and
the TPU relay) have no counterpart. Densify noise comes from a torch
Generator seeded with (cfg.seed, iteration), so a resumed run replays it.

save / load / resume_latest write and read chkpnt{N}.npz in moss_tpu's
schema (train/checkpoint.py); compact_for_eval keeps moss_tpu's rule for the
serving capacity.

Options, as moss_tpu's: a TBWriter (`tb`) gets the eval-time dump; a
NetworkGUI (`gui`, the SIBR remote viewer) is polled after every iteration,
as the reference polls it (train_ZJU.py:67-80; moss_tpu polls only at its
host boundaries because its dispatch is queued); a parallel Mesh (`mesh`)
trains over pixel bands and frames on several ranks (parallel/sharded.py),
n_data frames a step from the same epoch-shuffled order, evals on the full
image on every rank alike, and resume_latest's step checked uniform across
ranks. The callers write files on rank 0 only.
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
from ..render.camera import Camera
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
    (ops/lpips.py), and lpips_backbone says what they are, "random" or
    "pretrained" (ops/lpips.backbone's kind), which every evaluate reports
    as moss_tpu's does. Renders go through rasterize_cuda: the blend kernels for
    CUDA tensors, their plain version for CPU ones. extent is the scene's
    spatial scale: the xyz learning rate's factor and densification's size
    unit. log_fn(it, logs) gets each iteration's logs as Python numbers.
    tb, gui, source_path and mesh: the module docstring; with a mesh the
    trainer runs on the mesh's device."""

    def __init__(self, scene: SceneContext, train_frames: List[Frame], test_frames: List[Frame],
                 cfg: Config, lpips_params, crop_hw=None, extent: float = EXTENT,
                 log_fn: Optional[Callable[[int, Dict], None]] = None, tb=None, mesh=None,
                 gui=None, source_path: str = "", lpips_backbone: str = "random", device=None):
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.device)
        if cfg.model.static_scene and cfg.model.motion_offset:
            raise ValueError("static_scene has no body model: set motion_offset=False")
        self.scene, self.cfg, self.extent = scene, cfg, extent
        self.train_frames, self.test_frames = train_frames, test_frames
        self.lpips_params, self.lpips_backbone = lpips_params, lpips_backbone
        self.log_fn = log_fn
        self.tb, self.mesh, self.gui, self.source_path = tb, mesh, gui, source_path
        self._tb_gt_logged = False
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
        if self.mesh is not None:
            from ..parallel.sharded import make_sharded_train_step

            return make_sharded_train_step(self.scene, self.cfg, self.mesh, *self.crop_hw,
                                           self.lpips_params, spatial_lr_scale=self.extent)
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
        """Load the newest chkpnt{N}.npz under model_path; its step, 0 if
        none. On several ranks the step must be the same on each
        (parallel.distributed.assert_uniform_across_processes raises if not)."""
        from ..parallel.distributed import assert_uniform_across_processes

        cands = glob.glob(os.path.join(model_path, "chkpnt*.npz"))
        step = 0
        if cands:
            self.load(max(cands, key=lambda p: int(re.findall(r"(\d+)", os.path.basename(p))[0])))
            step = int(self.ts.step)
        assert_uniform_across_processes(step, what="resume checkpoint step")
        return step

    def _gt_lpips_features(self):
        """Every train frame's ground-truth LPIPS tower at its crop, once: the
        ground truth does not change, so the step need not recompute it. None
        (each step computes its frame's) when the towers need more than
        MOSS_LPIPS_GT_CACHE bytes (default 8 GiB; 0 or less: always),
        moss_tpu's budget (its trainer.py:722-760): MonoCap's 100 frames at
        a 1024 x 1024 crop would take 25.6 GB."""
        if self.cfg.optim.w_lpips == 0.0 or not self.train_frames:
            return None
        budget = int(os.environ.get("MOSS_LPIPS_GT_CACHE", 8 << 30))
        ch, cw = self.crop_hw
        need = lpips.gt_feature_bytes(ch, cw) * len(self.train_frames)
        if budget <= 0 or need > budget:
            if budget > 0:
                print(f"[trainer] gt-LPIPS tower cache disabled: needs {need / 2**30:.1f} GiB > "
                      f"MOSS_LPIPS_GT_CACHE {budget / 2**30:.1f} GiB — paying one gt VGG "
                      "forward per step instead")
            return None
        return [lpips.gt_features(self.lpips_params,
                                  crop_window(f.image, f.crop_y0, f.crop_x0, ch, cw))
                for f in self.train_frames]

    @torch.no_grad()
    def _dump_failure_snapshot(self, it: int, frame: Frame, logs: Dict, reason: str):
        """Write the rasterizer's inputs for `frame` under the CURRENT params
        (the Projected fields and bg), the iteration, the frame's height and
        width, the reason and the step's logs (log_<key>) to
        <cfg.model_path>/snapshot_iter{it}.npz, moss_tpu's failure snapshot
        (its trainer.py:629-683, the reference debug mode's snapshot on a
        kernel failure). moss_tpu's slot_budget, pair_budget and max_tiles
        keys are left out: the port sizes its pair list per frame and has no
        budgets. Returns the path, or None with no model_path."""
        outdir = getattr(self.cfg, "model_path", "") or ""
        if not outdir:
            return None
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"snapshot_iter{it}.npz")
        captured = {}

        def capture(proj, bg, h, w):
            captured.update(proj._asdict())
            captured["bg"] = bg
            z = torch.zeros((h, w), device=bg.device)
            return {"color": torch.zeros((h, w, 3), device=bg.device), "depth": z, "alpha": z,
                    "final_T": z}

        try:
            render_frame(self.ts.params["gauss"], self.ts.gstate.valid,
                         self.ts.params.get("mlps"), self.scene, frame.smpl_params, frame.camera,
                         self.bg, self.cfg.model.sh_degree, rasterize_fn=capture,
                         motion_offset=self.cfg.model.motion_offset,
                         static_scene=self.cfg.model.static_scene, device=self.device)
        except Exception as e:  # the capture itself must never mask the error
            print(f"[trainer] failure-snapshot raster capture failed: {e!r}")
        arrays = {k: v.detach().cpu().numpy() for k, v in captured.items() if v is not None}
        np.savez(path, **arrays, reason=np.asarray(reason), iteration=np.asarray(it),
                 height=np.asarray(frame.camera.height), width=np.asarray(frame.camera.width),
                 **{f"log_{k}": np.asarray(v) for k, v in (logs or {}).items()})
        print(f"[trainer] {reason} at iter {it} — raster inputs dumped to {path}")
        return path

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
        # epoch-shuffled frames; a mesh's step takes n_data of them
        n_data = 1 if self.mesh is None else self.mesh.n_data
        rng = np.random.default_rng(cfg.seed)
        order: List[int] = []
        while len(order) < iters * n_data:
            order.extend(rng.permutation(len(self.train_frames)).tolist())
        feats = self._gt_lpips_features()
        t0 = time.time()

        def fire_eval_save(it):
            lbl = eval_at.get(it)
            if lbl is not None:
                m = self.evaluate(tb_step=lbl, sh_it=lbl)
                m["iteration"] = lbl
                m["elapsed_s"] = time.time() - t0
                self.metrics_history.append(m)
            if save_fn is not None and it in save_at:
                save_fn(save_at[it])

        if start in eval_at or start in save_at:
            fire_eval_save(start)
        o = cfg.optim
        for it in range(start + 1, iters + 1):
            deg = active_sh_degree(it, cfg.model.sh_degree)
            if self.mesh is None:
                idx = order[it - 1]
                self.ts, logs = self.step_fn(self.ts, self.train_frames[idx], deg,
                                             None if feats is None else feats[idx])
            else:
                self.ts, logs = self.step_fn(self.ts, self.train_frames,
                                             order[(it - 1) * n_data:it * n_data], deg, feats)
            logs = _to_host(logs)
            if not math.isfinite(logs["loss"]):
                # the params are poisoned: dump the frame's raster inputs, then abort
                frame = self.train_frames[order[(it - 1) * n_data]]
                path = self._dump_failure_snapshot(it, frame, logs, "non-finite loss")
                raise FloatingPointError(f"non-finite loss {logs['loss']} at iteration {it}"
                                         + (f" — snapshot at {path}" if path else ""))
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
            if self.gui is not None:
                self.gui.poll(self._gui_render, self.source_path, training_done=it >= iters)
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
    def _gui_render(self, spec: dict):
        """The current cloud from a viewer's camera. A render needs a pose:
        the viewer watches the first train frame's (moss_tpu's rule; the
        reference's hook is off for want of one, train_ZJU.py:327)."""
        cam = Camera.from_viewer_spec(spec, device=self.device)
        frame = self.train_frames[0]
        out = render_frame(self.ts.params["gauss"], self.ts.gstate.valid,
                           self.ts.params.get("mlps"), self.scene, frame.smpl_params, cam,
                           self.bg, self.cfg.model.sh_degree,
                           motion_offset=self.cfg.model.motion_offset,
                           static_scene=self.cfg.model.static_scene,
                           scaling_modifier=float(spec.get("scale_modifier", 1.0)),
                           device=self.device)
        return out["render"]

    @torch.no_grad()
    def render_eval(self, frame: Frame, sh_degree=None):
        deg = sh_degree if sh_degree is not None else self.cfg.model.sh_degree
        return render_frame(self.ts.params["gauss"], self.ts.gstate.valid,
                            self.ts.params.get("mlps"), self.scene, frame.smpl_params,
                            frame.camera, self.bg, deg, motion_offset=self.cfg.model.motion_offset,
                            static_scene=self.cfg.model.static_scene, device=self.device)

    @torch.no_grad()
    def evaluate(self, frames=None, tb_step: Optional[int] = None,
                 sh_it: Optional[int] = None) -> Dict:
        """Mean PSNR, SSIM and LPIPS (f32) over `frames` (default the test
        split; Frames, or FrameSpecs decoded on a prefetch thread) on the
        full image, the render and ground truth clipped to [0, 1]; SH at the
        degree of iteration sh_it (default ts.step). raster_overflow is the
        pairs dropped, always 0 in the port. With tb_step and a TBWriter:
        the first five renders, their ground truth at the first such eval,
        the live opacities' histogram and the live count (moss_tpu's dump,
        the reference's training_report, train_ZJU.py:249-263)."""
        cfg = self.cfg
        frames = frames if frames is not None else self.test_frames
        deg = active_sh_degree(int(self.ts.step) if sh_it is None else int(sh_it),
                               cfg.model.sh_degree)
        per_frame = []
        log_tb = tb_step is not None and self.tb is not None
        for i, frame in enumerate(iter_frames(frames, None, device=self.device)):
            out = render_frame(self.ts.params["gauss"], self.ts.gstate.valid,
                               self.ts.params.get("mlps"), self.scene, frame.smpl_params,
                               frame.camera, self.bg, cfg.model.sh_degree,
                               motion_offset=cfg.model.motion_offset,
                               static_scene=cfg.model.static_scene, active_sh=deg,
                               device=self.device)
            img = torch.clamp(out["render"], 0.0, 1.0)
            gt = torch.clamp(frame.image, 0.0, 1.0)
            if log_tb and i < 5:
                self.tb.image(f"test/view_{i}/render", img, tb_step)
                if not self._tb_gt_logged:
                    self.tb.image(f"test/view_{i}/ground_truth", frame.image, tb_step)
            per_frame.append(torch.stack([psnr_fn(img, gt), ssim_fn(img, gt),
                                          lpips.lpips(self.lpips_params, img, gt)]))
        if log_tb:
            valid = self.ts.gstate.valid
            opacity = torch.sigmoid(self.ts.params["gauss"].opacity[:, 0])
            self.tb.histogram("scene/opacity_histogram", opacity[valid], tb_step)
            self.tb.scalar("scene/total_points", int(valid.sum()), tb_step)
            self._tb_gt_logged = True
        n = max(len(per_frame), 1)
        sums = [0.0, 0.0, 0.0]
        for row in (torch.stack(per_frame).tolist() if per_frame else []):
            sums = [s + v for s, v in zip(sums, row)]
        # provenance: random-backbone LPIPS is not comparable to the reference's
        return {"psnr": sums[0] / n, "ssim": sums[1] / n, "lpips": sums[2] / n,
                "raster_overflow": 0, "lpips_backbone": self.lpips_backbone}


def _to_host(logs: Dict) -> Dict:
    """A step's 0-d log tensors as Python numbers, in one transfer."""
    keys = list(logs)
    vals = torch.stack([torch.as_tensor(logs[k]).to(torch.float64).reshape(())
                        for k in keys]).tolist()
    return {k: (int(v) if not torch.is_floating_point(torch.as_tensor(logs[k])) else v)
            for k, v in zip(keys, vals)}
