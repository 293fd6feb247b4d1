"""The program side of a run: moss_torch's Trainer, as the drivers build it,
driven from the cell's inputs through its first steps and then the window.

Set-up builds one Trainer (moss_torch/cli/train_zju.py::train_scene's: the
configuration's Config, the capacity, the configuration's crop, the static pair
budgets probed and installed by the Trainer), hands it the inputs' state
(set_state), and runs Trainer.train under the cell's dispatch engine (its
workload file's `engine`) twice, on the same Trainer, step function and state:

  1. the checked steps: three iterations from the state, their save labels
     making host boundaries after each, so that the save hook reads the
     optimizer's first moments after the first (the first gradient) and the
     parameters after the third; the hook then raises and ends the call.
     They are a call of their own because the scan engine cuts a whole call
     into blocks of the gcd of its labels' gaps: labels one step apart in the
     run's call would make every block of the window one step long;
  2. the run: one call to the run's length, every segment a block of 100
     iterations (the Trainer's host boundaries), each a CUDA graph of the step
     replayed. Its first segment takes the run's capture; the window opens at
     the first boundary after a segment that dropped no pairs (a segment that
     drops pairs makes the Trainer's self-heal grow the budgets, with a
     capture, at its boundary: a trained state's budgets, probed on every
     frame after set_state, have no history of heals); it closes at the
     first boundary after `seconds`, where the log hook raises. Everything
     between is timed: the replays and the log reads.

The window reads only what the Trainer's hooks give (log_fn, save_fn) and
what its counters hold (make_train_many's pool). With `trace` the first
segment of the window runs under torch.profiler.
"""
from __future__ import annotations

import gc
import math
import os
import time
from typing import Dict, List, Optional

import torch

from moss_torch.config import Config, ModelConfig, OptimConfig, PipelineConfig
from moss_torch.data.frames import Frame
from moss_torch.models import gaussians as G
from moss_torch.models import smpl as S
from moss_torch.render.camera import Camera
from moss_torch.render.render import SceneContext
from moss_torch.train import optim
from moss_torch.train.train_step import TrainState
from moss_torch.train.trainer import Trainer

from .inputs import Inputs
from .reference.lpips import gt_feature_bytes

B1 = 0.9  # AdamW's first-moment decay (moss_torch/train/optim.py)
CHECKED_STEPS = 3


class _FirstSteps(Exception):
    """Raised by the save hook once the checked steps are read."""


class _WindowEnd(Exception):
    """Raised by the log hook at the window's closing boundary."""


def program_config(inp: Inputs) -> Config:
    c = inp.config
    return Config(model=ModelConfig(**c["model"]),
                  optim=OptimConfig(**c["optim"], iterations=inp.workload["run_iterations"]),
                  pipe=PipelineConfig(max_tiles_per_gaussian=c["pipe"]["max_tiles_per_gaussian"],
                                      rasterizer=c["pipe"]["rasterizer"], test_iterations=(),
                                      save_iterations=()),
                  seed=c["seed"], model_path="")


def program_scene(inp: Inputs, device) -> SceneContext:
    r = inp.rig
    model = S.SMPLModel(v_template=r.v_template, shapedirs=r.shapedirs, posedirs=r.posedirs,
                        J_regressor=r.J_regressor, weights=r.weights, faces=r.faces,
                        parents=tuple(r.parents))
    big = S.big_pose_params(inp.config["smpl"]["n_shapes"], device=device)
    verts, _ = S.lbs_vertices(model, big["poses"][0], big["shapes"][0])
    return SceneContext(smpl=model, big_pose_params=big, big_pose_vertices=verts)


def program_frames(inp: Inputs, device) -> List[Frame]:
    return [Frame(camera=Camera.from_KRT(f.K, f.R_w2c.T, f.T_w2c, f.height, f.width,
                                         device=device),
                  image=f.image, bkgd_mask=f.bkgd_mask, bound_mask=f.bound_mask, poses=f.poses,
                  shapes=f.shapes, R=f.R, Th=f.Th, pose_rotmats=f.pose_rotmats,
                  crop_y0=f.crop_y0, crop_x0=f.crop_x0, pose_id=f.pose_id) for f in inp.frames]


def leaves(params: Dict) -> Dict[str, torch.Tensor]:
    """{"group/name": tensor} of every trained tensor."""
    return {f"{g}/{n}": t for g, ts in optim.param_groups(params).items() for n, t in ts.items()}


class Run:
    """One run of a cell on the program; run() fills the readings."""

    def __init__(self, inp: Inputs, device, seconds: float, trace: bool = False):
        self.inp, self.device, self.seconds, self.trace = inp, device, seconds, trace
        self.S = inp.start
        self.logs: Dict[int, Dict] = {}
        self.phase = "setup"
        self.t_start = self.t_end = None
        self.it_start = self.it_end = None
        self.prof = None
        self.profiled: Optional[Dict] = None
        self.first_grad: Dict[str, float] = {}
        self.first_change: Dict[str, float] = {}
        self.setup_segments = 0
        self.marks: Dict[str, float] = {}  # perf_counter at each set-up stage's end
        self.pool_mb = None

    # ---- the Trainer's hooks ------------------------------------------------

    def log(self, it: int, logs: Dict):
        self.logs[it] = {**logs, "raster_overflow": logs.get("raster_overflow", 0)}
        if self.phase != "run" or it % 100:
            return
        now = time.perf_counter()
        if self.t_start is None:
            # the Trainer's self-heal grows the budgets after a segment that
            # dropped pairs (a capture follows): set-up lasts until one did not
            dropped = sum(self.logs[i]["raster_overflow"] for i in range(it - 99, it + 1))
            self.setup_segments += 1
            if dropped:
                return
            self.t_start, self.it_start = now, it
            if self.trace:
                self._profile_start()
            return
        if self.prof is not None and it == self.it_start + 100:
            self._profile_stop(now)
        if now - self.t_start >= self.seconds:
            self.t_end, self.it_end = now, it
            raise _WindowEnd

    def snap(self, label: int):
        """The save hook: label i fires on the state after step i - 1."""
        ts = self.trainer.ts
        if label == self.S + 2:  # after the first step: the gradient from AdamW's first moment
            for g, s in ts.opt_state.items():
                for n, mu in s.mu.items():
                    self.first_grad[f"{g}/{n}"] = float(torch.linalg.vector_norm(mu)) / (1 - B1)
        if label == self.S + CHECKED_STEPS + 1:
            init = self.init_leaves
            for k, t in leaves(ts.params).items():
                self.first_change[k] = float(torch.linalg.vector_norm(t.detach() - init[k]))
            raise _FirstSteps

    # ---- profiling ----------------------------------------------------------

    def _profile_start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.prof_t0 = time.perf_counter()

    def _profile_stop(self, now: float):
        torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self.prof_t0
        self.prof.__exit__(None, None, None)
        ts = self.trainer.ts
        self.profiled = {"prof": self.prof, "wall_s": wall, "steps": 100,
                         "first": self.it_start + 1,
                         "gauss": {f: getattr(ts.params["gauss"], f).detach().clone()
                                   for f in G.FIELDS},
                         "valid": ts.gstate.valid.clone(),
                         "mlps": {k: {n: t.detach().clone() for n, t in m.state_dict().items()}
                                  for k, m in (ts.params["mlps"] or {}).items()}}
        self.prof = None

    # ---- the run ------------------------------------------------------------

    def run(self, window: bool = True):
        """Set-up, the checked steps and (with `window`) the run's window."""
        inp, device = self.inp, self.device
        os.environ["MOSS_LPIPS_GT_CACHE"] = str(inp.config["lpips_gt_cache_bytes"])
        cfg = program_config(inp)
        self.trainer = tr = Trainer(program_scene(inp, device), program_frames(inp, device), [],
                                    cfg, inp.lpips, crop_hw=inp.crop_hw, log_fn=self.log,
                                    device=device)
        mlps = tr.ts.params["mlps"]
        for k, m in mlps.items():
            m.load_state_dict(inp.mlp_weights[k])
        params = {"gauss": G.GaussianParams(**{k: v.clone() for k, v in inp.gauss.items()}),
                  "mlps": mlps}
        self.init_leaves = {k: v.detach().clone() for k, v in leaves(params).items()}
        opt = {g: optim.AdamState(0, {n: torch.zeros_like(t) for n, t in ts.items()},
                                  {n: torch.zeros_like(t) for n, t in ts.items()})
               for g, ts in optim.param_groups(params).items()}
        tr.set_state(TrainState(params, opt, G.initial_state(inp.valid.clone()), self.S))
        # set_state probes eight frames; a run that reached this state has
        # budgets its heals grew over every frame: probe them all, as a heal does
        tr._resize_pair_buffer(full=True)
        # the Trainer's rule for its ground-truth LPIPS towers (trainer.py)
        need = gt_feature_bytes(*inp.crop_hw) * len(inp.frames)
        self.gt_cached = 0 < need <= inp.config["lpips_gt_cache_bytes"]
        self.marks["trainer"] = time.perf_counter()
        E = cfg.optim.iterations
        engine = inp.workload["engine"]
        try:
            tr.train(E, eval_iters=[], save_iters=[self.S + k for k in range(2, CHECKED_STEPS + 2)],
                     save_fn=self.snap, dispatch_engine=engine)
        except _FirstSteps:
            pass
        self.marks["checked_steps"] = time.perf_counter()
        if not window:
            return
        self.phase = "run"
        try:
            tr.train(E, eval_iters=[], save_iters=[], dispatch_engine=engine)
        except _WindowEnd:
            pass
        if self.prof is not None:  # a window shorter than one segment
            self._profile_stop(time.perf_counter())
        self.pool_mb = tr._many.pool_mb
        self.budgets_final = dict(tr.budgets)
        self.live_final = int(tr.ts.gstate.valid.sum())
        if self.t_end is None:
            raise RuntimeError(f"the run ended at iteration {tr.ts.step} before the window closed")

    def traced_work(self) -> List[Dict]:
        """Each traced step's blend work, bounds and counted seconds at the
        peaks (work.py), from the Gaussians as they stood when the trace
        closed, projected by the program for each step's frame."""
        from moss_torch.models.lbs_field import LBSField
        from moss_torch.models.pose_refine import PoseRefine
        from moss_torch.render.render import render_frame

        from . import work as W
        from .inputs import frame_order

        p = self.profiled
        if p is None:
            return []
        tr = self.trainer
        mlps = None
        if p["mlps"]:
            mlps = {"pose": PoseRefine(None, self.device), "lbs": LBSField(None, self.device)}
            for k, m in mlps.items():
                m.load_state_dict(p["mlps"][k])
        gauss = G.GaussianParams(**p["gauss"])
        order = frame_order(self.inp.config["seed"], len(tr.train_frames), p["first"] + p["steps"])
        live = int(p["valid"].sum())
        cached = self.gt_cached
        per_frame, out = {}, []
        for it in range(p["first"], p["first"] + p["steps"]):
            i = order[it - 1]
            if i not in per_frame:
                f = tr.train_frames[i]
                got = {}

                def capture(proj, bg, h, w):
                    got["proj"] = proj
                    z = torch.zeros((h, w), device=bg.device)
                    return {"color": torch.zeros((h, w, 3), device=bg.device), "depth": z,
                            "alpha": z, "final_T": z}

                with torch.no_grad():
                    render_frame(gauss, p["valid"], mlps, tr.scene, f.smpl_params, f.camera, tr.bg,
                                 tr.cfg.model.sh_degree, rasterize_fn=capture, device=self.device)
                w = W.blend_work(got["proj"], f.camera.height, f.camera.width)
                per_frame[i] = {"work": w, "bounds": W.blend_bounds(w, f.camera.height,
                                                                    f.camera.width),
                                "at_peak": W.step_seconds_at_peak(w, tr.crop_hw, live, cached)}
            out.append(per_frame[i])
        return out

    def free(self):
        """Drop the program's state: the reference runs after it."""
        self.trainer = None
        gc.collect()
        torch.cuda.empty_cache() if torch.cuda.is_available() else None

    # ---- readings -----------------------------------------------------------

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def iterations(self) -> int:
        return self.it_end - self.it_start

    def failed(self) -> int:
        """The window's iterations whose loss is not finite or that dropped pairs."""
        return sum(1 for it in range(self.it_start + 1, self.it_end + 1)
                   if not math.isfinite(self.logs[it]["loss"]) or self.logs[it]["raster_overflow"] > 0)

    def checked_logs(self) -> List[Dict]:
        """The checked steps' logs: the loss and its six terms."""
        return [self.logs[self.S + k] for k in range(1, CHECKED_STEPS + 1)]

    def checked_overflow(self) -> int:
        return sum(self.logs[self.S + k]["raster_overflow"] for k in range(1, CHECKED_STEPS + 1))
