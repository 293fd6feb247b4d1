"""The trainer: the loop around the training step, densification, opacity
resets and evaluation (port of moss_tpu/train/trainer.py).

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

Static pair budgets, as moss_tpu's (its trainer.py:179-628): the binning's
pair capacity NPb and rect cap B (ops/binning.py) are probed on up to eight
train frames through the whole deform chain with opacity-blind extents
(_probe_pair_need), sized with 2x headroom at init when densification lies
ahead and 1.5x after, bucket-quantized and never shrinking, and installed in
the step (_install_budgets). They are probed again after every densify
round, from scratch on load, set_state and compact_for_eval. A segment whose
summed raster_overflow is above 0 re-probes every train frame and grows past
the budget that dropped pairs (the self-heal); when drops persist at the
largest budget, the failure snapshot is written. With the budgets installed
every shape of the step is fixed and the step reads no host value. With a
mesh the train budgets are per band, probed on every band (each rank renders
H / n_tile rows, so they must cover the densest band), and evaluate,
render_eval and the viewer, which render the full image, get budgets of
their own probed on the full frame (_resize_eval_budgets), with the train
budgets' grow policy at 2x headroom; an eval that drops pairs regrows them.

Three dispatch engines, moss_tpu's (Trainer.train(dispatch_engine=...)),
between host boundaries (densify, reset, SH bump, eval, save, and every
boundary_interval iterations; _host_boundaries):
  * "queued" (default): every step is launched with no host read; the
    segment's per-step logs are read once at its boundary (_log_segment);
  * "scan": make_train_many blocks of the gcd of the label schedule's gaps,
    each a CUDA graph of the step replayed (train/train_step.py); on the CPU
    the same step without a graph;
  * "eager": a step at a time, its logs read every 10 iterations.
All three run the same device-state step (train_step.device_state), so their
states are bitwise equal. With a mesh the step is parallel/sharded.py's in its
device form: the split and its LPIPS towers staged on every rank, each step's
frames gathered by index on the device; "queued" and "eager" run as above,
and "scan" prints moss_tpu's line and runs "queued" (no CUDA graph over
collectives). Densify noise comes from a torch Generator seeded with
(cfg.seed, iteration), so a resumed run replays it.

save / load / resume_latest write and read chkpnt{N}.npz in moss_tpu's
schema (train/checkpoint.py); compact_for_eval keeps moss_tpu's rule for the
serving capacity.

Options, as moss_tpu's: a TBWriter (`tb`) gets the eval-time dump; a
NetworkGUI (`gui`, the SIBR remote viewer) is polled at the host boundaries
under "queued" and "scan", as moss_tpu polls it, and after every iteration
under "eager" (the reference's train_ZJU.py:67-80); a parallel Mesh (`mesh`)
trains over pixel bands and frames on several ranks (parallel/sharded.py),
n_data frames a step from the same epoch-shuffled order, evals on the full
image on every rank alike, and resume_latest's step checked uniform across
ranks. The callers write files on rank 0 only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
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
from ..ops import binning, lpips
from ..ops.rasterize_cuda import TILE, rasterize_cuda
from ..ops.ssim import psnr as psnr_fn
from ..ops.ssim import ssim as ssim_fn
from ..parallel.sharded import band_shift, make_sharded_train_step
from ..render.camera import Camera
from ..render.render import SceneContext, render_frame
from . import checkpoint, optim
from .densify import densify_and_prune, densify_and_prune_static
from .losses import crop_window
from .train_step import (TrainState, active_sh_degree, device_state, make_train_many,
                         make_train_step, stage_frames)

ENGINES = ("queued", "scan", "eager")
SCAN_ON_A_MESH = ("[trainer] dispatch_engine='scan' is single-chip only — mesh mode uses the "
                  "queued engine (device-resident frames, zero per-step host tensor work)")


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
        self._reset_budget_state()
        self._installed = self._eval_installed = False
        self._budget_version = 0
        self.boundary_interval = 100  # the unconditional host boundary's cadence
        self.segment_sync_mode = None  # e.g. "error": torch.cuda's sync debug mode in segments
        self._many = None  # the engines' make_train_many, kept across train() calls
        self._tables = None  # the running train()'s optim.StepTables
        params, gstate, mlps = init_gaussians_and_mlps(scene, cfg, device=self.device)
        p = {"gauss": params, "mlps": mlps}
        init_fn, self.step_fn = self._make_step()
        self.ts = TrainState(p, init_fn(p), gstate, 0)
        self.metrics_history: List[Dict] = []
        self._resize_pair_buffer()

    def _raster_fn(self, max_tiles: int):
        """rasterize_cuda with the installed pair budget and rect cap `max_tiles`
        (None before the budgets are installed)."""
        if not self._installed:
            return None
        return functools.partial(rasterize_cuda, pair_budget=self._pair_budget,
                                 max_tiles_per_gaussian=max_tiles)

    def _make_step(self):
        if self.mesh is not None:
            # before the first install the bands bin on the per-frame list
            init_fn, self._train_step = make_sharded_train_step(
                self.scene, self.cfg, self.mesh, *self.crop_hw, self.lpips_params,
                spatial_lr_scale=self.extent, pair_budget=self._pair_budget,
                max_tiles=self._max_tiles if self._installed else 0)
        else:
            init_fn, self._train_step = make_train_step(
                self.scene, self.cfg, self._raster_fn(self._max_tiles), self.lpips_params,
                *self.crop_hw, spatial_lr_scale=self.extent, device=self.device)
        self._train_step.tables = self._tables  # a step rebuilt mid-run keeps the run's
        return init_fn, self._train_step

    @property
    def _eval_raster(self):
        """The rasterize_fn of evaluate, render_eval and the viewer: the train
        budgets on one card, the full-image eval budgets with a mesh. They
        render cameras no probe saw: a rect cap lowered below the configured
        one must not clip them."""
        B0 = self.cfg.pipe.max_tiles_per_gaussian
        if self.mesh is None:
            return self._raster_fn(max(B0, self._max_tiles))
        if not self._eval_installed:
            return None
        return functools.partial(rasterize_cuda, pair_budget=self._eval_pair,
                                 max_tiles_per_gaussian=max(B0, self._eval_max_tiles))

    # ---- the static budgets ---------------------------------------------------

    def _budget_shape(self, full_image: bool = False):
        """(height, width) the budgets are sized for: a band's with a mesh,
        the full frame's without one or with full_image (the eval budgets)."""
        cam = self.train_frames[0].camera
        n_tile = 1 if self.mesh is None or full_image else self.mesh.n_tile
        return cam.height // n_tile, cam.width

    def _num_tiles(self, full_image: bool = False) -> int:
        h, w = self._budget_shape(full_image)
        return -(-h // TILE) * -(-w // TILE)

    def _default_pair_budget(self, max_tiles: int, full_image: bool = False) -> int:
        h, w = self._budget_shape(full_image)
        return binning.default_pair_budget(self.cfg.model.capacity, h, w, TILE, TILE, max_tiles)

    def _capacity_of(self, pair_budget: int, max_tiles: int, full_image: bool = False) -> int:
        """The NPb that pair_budget (0: the default) gives at rect cap max_tiles."""
        return binning.npb(self.cfg.model.capacity, pair_budget, self._num_tiles(full_image),
                           max_tiles)

    def _probe_frames(self) -> List[Frame]:
        """Up to 8 train frames spread evenly over the split (moss_tpu's sample)."""
        n = len(self.train_frames)
        if n <= 8:
            return self.train_frames
        idx = np.unique(np.round(np.linspace(0, n - 1, 8)).astype(np.int64))
        return [self.train_frames[i] for i in idx]

    @torch.no_grad()
    def _probe_pair_need(self, frames: List[Frame], max_tiles: int,
                         n_tile: Optional[int] = None) -> np.ndarray:
        """(2,) int64 [live pairs, largest rect] over `frames` under the current
        cloud, through the whole deform chain (binning.measure_pair_need, so
        nothing is cut), with OPACITY-BLIND extents: each splat's box at
        opacity 1, 3.4 sigma on each axis within its radius (moss_tpu's
        trainer.py:218-240). Opacities train, and an init cloud at 0.1 probes
        boxes about 1.8x smaller in pairs than the same splats at 0.9; the
        blind boxes bound every opacity the optimizer can reach, while the
        render stays adaptive. With n_tile bands (default the mesh's, else 1)
        each band is measured at its H / n_tile rows, mean2d shifted by its
        first row, and the elementwise max over the bands is taken (moss_tpu's
        _probe_slot_need(n_tile=...)). One host read for all the frames."""
        if n_tile is None:
            n_tile = 1 if self.mesh is None else self.mesh.n_tile
        needs = []

        def measure(proj, bg, h, w):
            c = proj.conic
            det = torch.clamp_min(c[:, 0] * c[:, 2] - c[:, 1] ** 2, 1e-30)
            cov_diag = torch.stack([c[:, 2] / det, c[:, 0] / det], -1)
            ext = torch.ceil(3.4 * torch.sqrt(torch.clamp_min(cov_diag, 0.0)))
            blind_xy = torch.minimum(ext, proj.radius[:, None].to(ext.dtype)).to(torch.int32)
            hb = h // n_tile
            for b in range(n_tile):
                m = binning.measure_pair_need(
                    proj.mean2d - band_shift(b * hb, proj.mean2d.device), proj.conic,
                    torch.ones_like(proj.opacity), proj.depth, proj.radius, blind_xy, proj.valid,
                    hb, w, TILE, TILE, max_tiles)
                needs.append(torch.stack([m["total_live"], m["max_rect"]]))
            z = torch.zeros((h, w), device=bg.device)
            return {"color": torch.zeros((h, w, 3), device=bg.device), "depth": z, "alpha": z,
                    "final_T": z}

        for f in frames:
            render_frame(self.ts.params["gauss"], self.ts.gstate.valid,
                         self.ts.params.get("mlps"), self.scene, f.smpl_params, f.camera, self.bg,
                         self.cfg.model.sh_degree, rasterize_fn=measure,
                         motion_offset=self.cfg.model.motion_offset,
                         static_scene=self.cfg.model.static_scene, device=self.device)
        return torch.stack(needs).amax(0).cpu().numpy().astype(np.int64)

    def _resize_pair_buffer(self, full: bool = False, grow_from: int = 0):
        """Probe and grow the train budgets and, with a mesh, the full-image
        eval budgets (moss_tpu's _resize_pair_buffer)."""
        self._resize_train_budgets(full, grow_from)
        if self.mesh is not None:
            self._resize_eval_budgets(full)

    def _resize_train_budgets(self, full: bool = False, grow_from: int = 0):
        """moss_tpu's _resize_train_budgets without the slot budget: probe the
        cloud's need (per band with a mesh) and grow the pair budget and the
        rect cap with 2x headroom before the densify window and 1.5x after,
        bucket-quantized, never shrinking; the step is rebuilt only when one
        grows (or at the first install). At the first probe only, a rect cap
        above 1.25x the largest rect is lowered to it (at least 8): the key
        sort runs over P x B entries. A rect larger than the cap raises it to
        the next power of two (at most 1024 and the tile count) and probes
        again. With grow_from (the capacity that dropped pairs; full re-probes
        every train frame) the pair budget ends past grow_from by 1, 2, 4, 8,
        16 buckets at consecutive heals, at most the whole P x B table; when
        nothing can grow, _overflow_persists is set for the caller's snapshot."""
        if not self.train_frames:
            return
        first_probe = not self._init_probe_done
        self._init_probe_done = True
        probe = self.train_frames if full else self._probe_frames()
        B = self._max_tiles
        live, max_rect = (int(v) for v in self._probe_pair_need(probe, B))
        B0 = self.cfg.pipe.max_tiles_per_gaussian
        lowered = False
        if (first_probe and not grow_from and B == B0 and max_rect > 0
                and -(-max_rect * 5 // 4) < B0):
            B = max(8, -(-max_rect * 5 // 4))
            lowered = True
        if max_rect > B:
            b_cap = min(1024, self._num_tiles())
            want = 1 << int(np.ceil(np.log2(max_rect)))
            B = min(max(want, B), b_cap)
            if want > b_cap:
                print(f"[trainer] a splat touches {max_rect} tiles (> rect-cap clamp {b_cap}): "
                      "its tiles past the cap stay counted, not binned")
            live, max_rect = (int(v) for v in self._probe_pair_need(probe, B))
        o = self.cfg.optim
        densify_ahead = (self._pair_budget == 0 and o.densify_until_iter > o.densify_from_iter
                         and o.iterations > o.densify_from_iter)
        factor = 2.0 if densify_ahead else 1.5
        bucket = 32768 if self._default_pair_budget(self._max_tiles) >= 4 * 32768 else 2048
        max_tiles = B if lowered else max(B, self._max_tiles)
        target = max(-(-int(live * factor) // bucket) * bucket, self._pair_budget)
        pair_budget = 0 if target <= self._default_pair_budget(max_tiles) else target
        if grow_from:
            # any drop revokes an init-lowered rect cap; the pair budget ends past
            # the one that dropped, escalating over consecutive heals
            max_tiles = max(max_tiles, B0)
            self._heal_events += 1
            step = bucket * (1 << min(self._heal_events - 1, 4))
            hard = self.cfg.model.capacity * max_tiles
            grown = min(max(self._capacity_of(pair_budget, max_tiles), grow_from + step), hard)
            if (grown <= self._capacity_of(self._pair_budget, self._max_tiles)
                    and max_tiles == self._max_tiles):
                print(f"[trainer] overflow persists at the largest pair budget "
                      f"{self._capacity_of(self._pair_budget, self._max_tiles)}: budgets "
                      "unchanged")
                self._overflow_persists = True
                return
            pair_budget = grown
        elif self._installed and pair_budget == self._pair_budget and \
                max_tiles == self._max_tiles:
            return
        self._install_budgets(pair_budget, max_tiles)

    def _resize_eval_budgets(self, full: bool = False, grow_from: int = 0):
        """A mesh's full-image budgets for evaluate, render_eval and the viewer
        (moss_tpu's _resize_eval_budgets without the slot budget): the train
        budgets' policy on the full frame's need at 2x headroom (eval views
        are unprobed cameras), with no rect-cap lowering and no snapshot
        signal; grow_from (the eval capacity that dropped pairs) as there."""
        if self.mesh is None or not self.train_frames:
            return
        probe = self.train_frames if full else self._probe_frames()
        B = self._eval_max_tiles
        live, max_rect = (int(v) for v in self._probe_pair_need(probe, B, n_tile=1))
        if max_rect > B:
            b_cap = min(1024, self._num_tiles(full_image=True))
            B = min(max(1 << int(np.ceil(np.log2(max_rect))), B), b_cap)
            live, max_rect = (int(v) for v in self._probe_pair_need(probe, B, n_tile=1))
        bucket = (32768 if self._default_pair_budget(self._eval_max_tiles, full_image=True)
                  >= 4 * 32768 else 2048)
        max_tiles = max(B, self._eval_max_tiles)
        target = max(-(-int(live * 2.0) // bucket) * bucket, self._eval_pair)
        pair_budget = (0 if target <= self._default_pair_budget(max_tiles, full_image=True)
                       else target)
        if grow_from:
            max_tiles = max(max_tiles, self.cfg.pipe.max_tiles_per_gaussian)
            self._eval_heal_events += 1
            step = bucket * (1 << min(self._eval_heal_events - 1, 4))
            hard = self.cfg.model.capacity * max_tiles
            grown = min(max(self._capacity_of(pair_budget, max_tiles, full_image=True),
                            grow_from + step), hard)
            cur = self._capacity_of(self._eval_pair, self._eval_max_tiles, full_image=True)
            if grown <= cur and max_tiles == self._eval_max_tiles:
                print(f"[trainer] eval overflow persists at the largest pair budget {cur}: "
                      "eval budgets unchanged")
                return
            pair_budget = grown
        elif self._eval_installed and pair_budget == self._eval_pair and \
                max_tiles == self._eval_max_tiles:
            return
        self._install_eval_budgets(pair_budget, max_tiles)

    def _install_budgets(self, pair_budget: int = 0, max_tiles: int = 16):
        """Rebuild the step with the budgets (pair_budget 0: the default NPb)."""
        self._pair_budget, self._max_tiles = pair_budget, max_tiles
        self._installed = True
        _, self.step_fn = self._make_step()
        self._budget_version += 1

    def _install_eval_budgets(self, pair_budget: int = 0, max_tiles: int = 16):
        """A mesh's full-image eval budgets (_eval_raster reads them)."""
        self._eval_pair, self._eval_max_tiles = pair_budget, max_tiles
        self._eval_installed = True
        self._budget_version += 1

    def _reset_budget_state(self):
        """Forget the probe and heal history: the next _resize_pair_buffer
        probes the current cloud from scratch (moss_tpu's, trainer.py:1347)."""
        self._pair_budget = self._eval_pair = 0
        self._max_tiles = self._eval_max_tiles = self.cfg.pipe.max_tiles_per_gaussian
        self._init_probe_done = False
        self._heal_events = self._eval_heal_events = 0
        self._overflow_persists = False

    def _reprobe_from_scratch(self):
        """After a new cloud (load, set_state, compact_for_eval): probe afresh
        and install unconditionally, so no budget of the old cloud survives."""
        self._reset_budget_state()
        self._resize_pair_buffer()
        self._install_budgets(self._pair_budget, self._max_tiles)
        if self.mesh is not None:
            self._install_eval_budgets(self._eval_pair, self._eval_max_tiles)

    @property
    def budgets(self) -> Dict:
        """The installed budgets: pair_budget (0: the default), the capacity
        NPb it gives (a band's with a mesh), max_tiles (the rect cap), how many
        times a set was installed, and under "eval" what _eval_raster renders
        the full image with (a mesh's eval budgets, else the train ones)."""
        if self.mesh is None:
            ev = (self._installed, self._pair_budget, self._max_tiles)
        else:
            ev = (self._eval_installed, self._eval_pair, self._eval_max_tiles)
        B = max(self.cfg.pipe.max_tiles_per_gaussian, ev[2])
        return {"pair_budget": self._pair_budget, "max_tiles": self._max_tiles,
                "npb": self._capacity_of(self._pair_budget, self._max_tiles)
                if self._installed else None, "installs": self._budget_version,
                "eval": {"pair_budget": ev[1], "max_tiles": B,
                         "npb": self._capacity_of(ev[1], B, full_image=True) if ev[0] else None}}

    def set_state(self, ts: TrainState):
        """Replace the train state (a converted moss_tpu state, a checkpoint);
        the budgets are probed afresh on its cloud."""
        self.ts = ts
        self._reprobe_from_scratch()

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
        self._reprobe_from_scratch()

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
        self._reprobe_from_scratch()
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
        kernel failure), with the installed pair_budget and max_tiles
        (moss_tpu's slot_budget has no counterpart). Returns the path, or
        None with no model_path."""
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
                 pair_budget=np.asarray(self._pair_budget), max_tiles=np.asarray(self._max_tiles),
                 **{f"log_{k}": np.asarray(v) for k, v in (logs or {}).items()})
        print(f"[trainer] {reason} at iter {it} — raster inputs dumped to {path}")
        return path

    def _host_boundaries(self, iters: int, eval_iters) -> List[int]:
        """The iterations after which host work runs, moss_tpu's list
        (trainer.py:764-801): the last; the eval and save labels given; the
        1000-multiples (the SH degree); the densify rounds; the opacity
        resets (nested under densify_until_iter); densify_from_iter on a
        white background; and every boundary_interval iterations."""
        o = self.cfg.optim
        b = {iters}
        b.update(i for i in eval_iters if i <= iters)
        b.update(range(1000, iters + 1, 1000))
        b.update(i for i in range(o.densification_interval, iters + 1, o.densification_interval)
                 if o.densify_from_iter < i < o.densify_until_iter)
        b.update(i for i in range(o.opacity_reset_interval, iters + 1, o.opacity_reset_interval)
                 if i < o.densify_until_iter)
        if self.cfg.model.white_background and o.densify_from_iter < o.densify_until_iter:
            b.add(o.densify_from_iter)
        b.update(range(self.boundary_interval, iters + 1, self.boundary_interval))
        return sorted(x for x in b if x >= 1)

    def train(self, iterations: Optional[int] = None, eval_iters=None,
              fused_dispatch: bool = True, dispatch_engine: str = "queued", save_fn=None,
              save_iters=None, ckpt_fn=None) -> List[Dict]:
        """Train to `iterations` (default cfg.optim.iterations), continuing
        from ts.step. eval_iters / save_iters default to cfg.pipe's
        test_iterations / save_iterations; save_fn(i) and each eval run on
        iteration i's pre-step state, ckpt_fn(i) at the eval iterations on
        its post-step state. dispatch_engine: "queued", "scan" or "eager"
        (module docstring); fused_dispatch=False is "eager", as in moss_tpu.
        With a mesh "scan" runs "queued". Returns metrics_history."""
        cfg = self.cfg
        if not fused_dispatch:
            dispatch_engine = "eager"
        if dispatch_engine not in ENGINES:
            raise ValueError(f"dispatch_engine must be one of {ENGINES}, got {dispatch_engine!r}")
        if dispatch_engine == "scan" and self.mesh is not None:
            print(SCAN_ON_A_MESH)
            dispatch_engine = "queued"
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
        fire_bounds = set(eval_at) | set(save_at) | ckpt_at
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

        def check_finite(flat, first):
            for i, logs in enumerate(flat):
                if not math.isfinite(logs["loss"]):
                    # the params are poisoned: dump the frame's raster inputs, then abort
                    it = first + i
                    frame = self.train_frames[order[(it - 1) * n_data]]
                    path = self._dump_failure_snapshot(it, frame, logs, "non-finite loss")
                    raise FloatingPointError(f"non-finite loss {logs['loss']} at iteration {it}"
                                             + (f" — snapshot at {path}" if path else ""))

        def host_work(it, logs, fire_log_fn=True):
            o = cfg.optim
            if o.densify_from_iter < it < o.densify_until_iter and \
                    it % o.densification_interval == 0:
                self.densify(it)
                self._resize_pair_buffer()
            if it < o.densify_until_iter and (
                    it % o.opacity_reset_interval == 0
                    or (cfg.model.white_background and it == o.densify_from_iter)):
                self.reset_opacity()
            if fire_log_fn and self.log_fn is not None and logs is not None:
                self.log_fn(it, logs)
            if logs is not None and logs.get("raster_overflow", 0) > 0:
                # the self-heal: re-probe every frame, grow past the budget that dropped
                cur = self._capacity_of(self._pair_budget, self._max_tiles)
                print(f"[trainer] raster_overflow={logs['raster_overflow']} at iter {it} under "
                      f"pair budget {cur}: re-probing all {len(self.train_frames)} frames and "
                      "regrowing")
                self._resize_pair_buffer(full=True, grow_from=cur)
                if self._overflow_persists:
                    self._overflow_persists = False
                    self._dump_failure_snapshot(it, self.train_frames[order[(it - 1) * n_data]],
                                                logs, "overflow persists at worst-case budget")
            fire_eval_save(it)
            if ckpt_fn is not None and it in ckpt_at:
                ckpt_fn(it)
            if self.gui is not None:
                self.gui.poll(self._gui_render, self.source_path, training_done=it >= iters)

        if start in eval_at or start in save_at:
            fire_eval_save(start)

        # the engines: one device-state step, staged frames and order
        tables = optim.step_tables(cfg.optim, cfg.model.white_background,
                                   optim.param_groups(self.ts.params), self.extent, self.device)
        self._tables = self._train_step.tables = tables
        frames = stage_frames(self.train_frames)
        stacked = None if feats is None else [torch.stack(level) for level in zip(*feats)]
        order_dev = torch.tensor(order, dtype=torch.int64, device=self.device)
        dev = device_state(self.ts)
        counters = (dev.step, {g: s.count for g, s in dev.opt_state.items()})
        if self.mesh is None and self._many is None:
            self._many = make_train_many(self.step_fn, cfg.model.sh_degree, per_step_logs=True)

        def run(first, last, graph):
            """Steps first..last on the device; the host state follows."""
            ts = device_state(self.ts, *counters)
            if self.mesh is None:
                self._many.step_fn, self._many.graph = self.step_fn, graph
                _, logs = self._many(ts, frames, order_dev[first - 1:last], stacked)
            else:
                logs = self._mesh_steps(ts, frames, order_dev, stacked, first, last)
            self.ts = TrainState(self.ts.params,
                                 optim.advance_counts(self.ts.opt_state, tables, first, last),
                                 self.ts.gstate, last)
            return logs

        if dispatch_engine == "eager":
            for it in range(start + 1, iters + 1):
                logs = run(it, it, graph=False)
                logs = self._log_segment(it - 1, it, [logs], fire_log_fn=False) \
                    if it % 10 == 0 else None
                if logs is not None:
                    check_finite([logs], it)
                host_work(it, logs)
            return self.metrics_history

        if dispatch_engine == "scan":
            # blocks of the gcd of the label schedule's gaps, cut at each
            # segment's end (moss_tpu's trainer.py:1048-1068)
            labels = [b for b in self._host_boundaries(iters, eval_iters | save_iters)
                      if b > start]
            gaps = [b - a for a, b in zip([start] + labels, labels) if b > a]
            block = math.gcd(*gaps) if gaps else iters
        else:
            block = iters
        prev = start
        for bound in self._host_boundaries(iters, fire_bounds):
            if bound <= prev:
                continue
            with self._segment_guard():
                seg = [run(s + 1, min(s + block, bound), graph=dispatch_engine == "scan")
                       for s in range(prev, bound, block)]
            logs, flat = self._log_segment(prev, bound, seg, with_flat=True)
            check_finite(flat, prev + 1)
            host_work(bound, logs, fire_log_fn=False)
            prev = bound
        return self.metrics_history

    def _mesh_steps(self, ts: TrainState, frames: Frame, order, stacked, first: int,
                    last: int) -> Dict:
        """Mesh steps first..last of a device_state ts, each launched with no
        host read: step it trains on order[(it - 1) n_data : it n_data], its
        SH degree from the device step count. The logs as make_train_many's
        per-step logs, a dict of (K,) tensors."""
        n = self.mesh.n_data
        rows = []
        for it in range(first, last + 1):
            deg = active_sh_degree(ts.step + 1, self.cfg.model.sh_degree)
            _, logs = self.step_fn(ts, frames, order[(it - 1) * n:it * n], deg, stacked)
            rows.append(logs)
        return {k: torch.stack([torch.as_tensor(r[k]).reshape(()) for r in rows])
                for k in rows[0]}

    def _segment_guard(self):
        """torch.cuda's sync debug mode set to segment_sync_mode for a segment
        (a no-op when it is None)."""
        mode = self.segment_sync_mode
        if mode is None or self.device.type != "cuda":
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def guard():
            old = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(mode)
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(old)
        return guard()

    def _log_segment(self, prev: int, bound: int, seg, fire_log_fn: bool = True,
                     with_flat: bool = False):
        """One host read of a segment's per-step logs (seg: make_train_many's
        stacked logs, one dict a call), moss_tpu's _log_segment: log_fn gets
        every iteration prev + 1..bound in order; returns the boundary's logs
        with raster_overflow summed over the segment (a mid-segment step can
        drop pairs where the boundary's does not), and with with_flat the
        per-iteration list too."""
        keys = list(seg[0])
        host = torch.cat([torch.stack([s[k].to(torch.float64) for k in keys], 1)
                          for s in seg]).tolist()
        ints = {k for k in keys if not torch.is_floating_point(seg[0][k])}
        flat = [{k: (int(v) if k in ints else v) for k, v in zip(keys, row)} for row in host]
        if len(flat) != bound - prev:
            raise AssertionError(f"segment log misalignment: {len(flat)} step logs for "
                                 f"iterations ({prev}, {bound}]")
        if fire_log_fn and self.log_fn is not None:
            for i, h in enumerate(flat):
                self.log_fn(prev + 1 + i, h)
        logs = dict(flat[-1])
        if "raster_overflow" in logs:
            logs["raster_overflow"] = sum(h["raster_overflow"] for h in flat)
        return (logs, flat) if with_flat else logs

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
                           self.bg, self.cfg.model.sh_degree, rasterize_fn=self._eval_raster,
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
                            frame.camera, self.bg, deg, rasterize_fn=self._eval_raster,
                            motion_offset=self.cfg.model.motion_offset,
                            static_scene=self.cfg.model.static_scene, device=self.device)

    @torch.no_grad()
    def evaluate(self, frames=None, tb_step: Optional[int] = None,
                 sh_it: Optional[int] = None, _healed_retry: bool = False) -> Dict:
        """Mean PSNR, SSIM and LPIPS (f32) over `frames` (default the test
        split; Frames, or FrameSpecs decoded on a prefetch thread) on the
        full image, the render and ground truth clipped to [0, 1]; SH at the
        degree of iteration sh_it (default ts.step). raster_overflow is the
        pairs the installed budgets dropped, summed over the frames; when it
        is above 0 the budgets are regrown (the train path's self-heal; with a
        mesh the eval budgets) and, if one grew, the eval runs once more and
        reports the first count as raster_overflow_healed_from (moss_tpu's
        evaluate, its trainer.py:1302-1330). With tb_step and a TBWriter:
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
                               rasterize_fn=self._eval_raster, device=self.device)
            img = torch.clamp(out["render"], 0.0, 1.0)
            gt = torch.clamp(frame.image, 0.0, 1.0)
            if log_tb and i < 5:
                self.tb.image(f"test/view_{i}/render", img, tb_step)
                if not self._tb_gt_logged:
                    self.tb.image(f"test/view_{i}/ground_truth", frame.image, tb_step)
            per_frame.append(torch.stack([psnr_fn(img, gt), ssim_fn(img, gt),
                                          lpips.lpips(self.lpips_params, img, gt),
                                          out["overflow"].to(torch.float32)]))
        if log_tb:
            valid = self.ts.gstate.valid
            opacity = torch.sigmoid(self.ts.params["gauss"].opacity[:, 0])
            self.tb.histogram("scene/opacity_histogram", opacity[valid], tb_step)
            self.tb.scalar("scene/total_points", int(valid.sum()), tb_step)
            self._tb_gt_logged = True
        n = max(len(per_frame), 1)
        sums = [0.0, 0.0, 0.0, 0.0]
        for row in (torch.stack(per_frame).tolist() if per_frame else []):
            sums = [s + v for s, v in zip(sums, row)]
        out = {"psnr": sums[0] / n, "ssim": sums[1] / n, "lpips": sums[2] / n,
               "raster_overflow": int(sums[3])}
        if out["raster_overflow"] > 0 and self.train_frames and not _healed_retry:
            before = self._budget_version
            if self.mesh is None:
                cur = self._capacity_of(self._pair_budget, self._max_tiles)
                print(f"[trainer] eval raster_overflow={out['raster_overflow']} under pair "
                      f"budget {cur}: re-probing and regrowing")
                self._resize_pair_buffer(full=True, grow_from=cur)
            else:
                cur = self._capacity_of(self._eval_pair, self._eval_max_tiles, full_image=True)
                print(f"[trainer] eval raster_overflow={out['raster_overflow']} under eval pair "
                      f"budget {cur}: regrowing the eval budgets")
                self._resize_eval_budgets(full=True, grow_from=cur)
            self._overflow_persists = False  # the train boundary's snapshot signal
            if self._budget_version != before:
                retried = self.evaluate(frames=frames, tb_step=tb_step, sh_it=sh_it,
                                        _healed_retry=True)
                retried["raster_overflow_healed_from"] = out["raster_overflow"]
                return retried
        # provenance: random-backbone LPIPS is not comparable to the reference's
        out["lpips_backbone"] = self.lpips_backbone
        return out

