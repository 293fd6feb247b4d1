"""The reference schedule (3000 iterations, the default OptimConfig and
PipelineConfig) in the port's Trainer against moss_tpu's, on the CPU:

  * the structure of the run, integer for integer: the host boundaries the
    loop stops at (moss_tpu/train/trainer.py:764-801), the scan engine's
    blocks (:1048-1068, :1075-1090), the densify rounds, the iterations of the
    evals, saves and checkpoints, the SH degree of every step and the absence
    of an opacity reset, fresh and resumed from the second eval. Both
    Trainers' loops run with the step, the rounds and the evals stubbed out,
    so the 3000 iterations take a second;
  * make_train_many's captures warming up on one stream (a new stream each
    left a cuBLAS workspace behind on the card);
  * a small run (48 x 48 frames, a 1,024 capacity) from step 995 to 1004 that
    crosses the SH step-up at 1000 and three densify rounds, one of which grows
    the cloud, under scan and under queued, bitwise equal, the degree-1
    coefficients zero at the boundary before step 1000 and nonzero at 1000.
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

import moss_tpu.parallel.sharded as jsharded
import moss_tpu.train.train_step as jtrain_step
from moss_tpu.config import Config as JConfig
from moss_tpu.train.train_step import active_sh_degree as jax_active_sh_degree
from moss_tpu.train.trainer import Trainer as JTrainer
from moss_torch import config
from moss_torch.data.synthetic import make_frames, make_scene
from moss_torch.ops import lpips
from moss_torch.train.train_step import TrainMany, device_state, make_train_many, stage_frames
from moss_torch.train.trainer import Trainer
from test_torch_engines import assert_same_state
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"
CHECKS = (2500, 2700, 3000)  # the drivers' test and save iterations (train_zju.py)


def record(trace):
    """The hooks both loops call, each appending to trace[name]."""
    def hook(name, ret=None):
        def go(*a, **kw):
            trace.setdefault(name, []).append(a[0] if a else None)
            return ret
        return go
    return hook


def jax_schedule(engine, start):
    """moss_tpu's Trainer.train at the reference schedule from `start`, its
    step, rounds, evals and budgets stubbed: what it calls, at which
    iteration. moss_tpu's queued engine passes each step its SH degree, its
    scan engine each block its length."""
    trace = {}
    hook = record(trace)
    jt = object.__new__(JTrainer)
    jt.cfg, jt.mesh, jt.gui, jt._autosize, jt._step_version = JConfig(), None, None, True, 0
    jt.ts = types.SimpleNamespace(step=start)
    jt.train_frames = list(range(12))
    jt.metrics_history, jt.boundary_interval = [], 100
    jt._stage_gt_lpips_feats = lambda stacked: None
    jt.densify, jt.reset_opacity = hook("densify"), hook("reset")
    jt._resize_pair_buffer = lambda *a, **kw: None
    jt.evaluate = lambda tb_step=None, sh_it=None: trace.setdefault("eval", []).append(
        tb_step) or {}
    jt.log_fn = lambda it, logs: trace.setdefault("logged", []).append(it)
    log_segment = jt._log_segment
    jt._log_segment = lambda prev, bound, seg, stacked: trace.setdefault(
        "boundaries", []).append(bound) or log_segment(prev, bound, seg, stacked)

    def step_fn(ts, frame, deg, feats):
        trace.setdefault("sh", []).append(int(deg))
        return ts, {"loss": np.float32(0.0), "raster_overflow": np.int32(0)}

    def many(ts, frames, chunk, deg, feats):
        K = len(chunk)
        trace.setdefault("blocks", []).append(K)
        return ts, {"loss": np.zeros(K, np.float32), "raster_overflow": np.zeros(K, np.int32)}

    jt.step_fn = step_fn
    patches = [(jtrain_step, "make_train_many", lambda *a, **kw: many),
               (jsharded, "stack_frames", lambda frames: None)]
    saved = [(m, k, getattr(m, k)) for m, k, _ in patches]
    for m, k, v in patches:
        setattr(m, k, v)
    try:
        jt.train(dispatch_engine=engine, save_fn=hook("save"), ckpt_fn=hook("ckpt"))
    finally:
        for m, k, v in saved:
            setattr(m, k, v)
    return trace


class RecordingMany(TrainMany):
    """make_train_many's engine, each call's length recorded."""

    def __call__(self, ts, frames, order, gt_lpips_feats=None):
        self.blocks.append(int(order.shape[0]))
        return super().__call__(ts, frames, order, gt_lpips_feats)


@pytest.fixture(scope="module")
def tiny_trainer():
    """A port Trainer at the default OptimConfig and PipelineConfig (3000
    iterations, SH degree 3), on a 150-vertex scene."""
    scene = make_scene(n_verts=150, device=CPU)
    frames, _ = make_frames(scene, n_frames=3, H=32, W=32, crop=24, opacity=0.5)
    cfg = config.Config(model=config.ModelConfig(capacity=256, n_init_points=150))
    return Trainer(scene, frames[:2], frames[2:], cfg, lpips.init_random(3407, CPU),
                   crop_hw=(24, 24), device=CPU)


def port_schedule(tr, engine, start):
    """The port's Trainer.train at the reference schedule from `start`, its
    step (inside make_train_many's engine, which takes the degree from the
    device step count), rounds, evals and budgets stubbed, as jax_schedule."""
    trace = {}
    hook = record(trace)
    capacity = tr.ts.params["gauss"].capacity

    def step_fn(ts, frame, deg, feats):
        trace.setdefault("sh", []).append(int(deg))
        ts.step.add_(1)
        return ts, {"loss": torch.zeros(()), "raster_overflow": torch.zeros((), dtype=torch.int32),
                    "num_points": torch.tensor(capacity)}

    ts0 = tr.ts._replace(step=start, opt_state={g: s._replace(count=start)
                                                for g, s in tr.ts.opt_state.items()})
    run = types.SimpleNamespace(**{k: getattr(tr, k) for k in (
        "cfg", "mesh", "gui", "train_frames", "extent", "device", "_train_step", "_autosize",
        "boundary_interval", "_segment_guard", "_host_boundaries")})
    run.ts, run.step_fn, run.metrics_history, run._tables = ts0, step_fn, [], None
    run._many = RecordingMany(step_fn, tr.cfg.model.sh_degree, per_step_logs=True)
    run._many.blocks = trace["blocks"] = []
    run._gt_lpips_features = lambda: None
    run.densify, run.reset_opacity = hook("densify"), hook("reset")
    run._resize_pair_buffer = lambda *a, **kw: None
    run.evaluate = lambda tb_step=None, sh_it=None: trace.setdefault("eval", []).append(
        tb_step) or {}
    run.log_fn = lambda it, logs: trace.setdefault("logged", []).append(it)
    run._log_segment = lambda prev, bound, seg, **kw: trace.setdefault(
        "boundaries", []).append(bound) or Trainer._log_segment(run, prev, bound, seg, **kw)
    Trainer.train(run, dispatch_engine=engine, save_fn=hook("save"), ckpt_fn=hook("ckpt"))
    return trace


@pytest.mark.parametrize("start", [0, 2700], ids=["fresh", "resumed"])
def test_reference_schedule_is_moss_tpus(tiny_trainer, start):
    """Host boundaries, scan blocks, rounds, evals, saves, checkpoints and
    the SH degree of every step, integer for integer against moss_tpu's
    Trainer at the default schedule, from the start and from 2700."""
    tr = tiny_trainer
    assert tr.cfg.optim == config.OptimConfig() and tr.cfg.pipe == config.PipelineConfig()
    assert tr.cfg.pipe.test_iterations == tr.cfg.pipe.save_iterations == CHECKS
    ref = {e: jax_schedule(e, start) for e in ("queued", "scan")}
    port = {e: port_schedule(tr, e, start) for e in ("queued", "scan")}
    iters = tr.cfg.optim.iterations
    for e in ("queued", "scan"):
        for k in ("boundaries", "densify", "eval", "save", "ckpt", "logged"):
            assert port[e].get(k) == ref[e].get(k), (e, k)
        assert "reset" not in port[e] and "reset" not in ref[e], e
        assert port[e]["logged"] == list(range(start + 1, iters + 1)), e
        # every step's degree: moss_tpu's queued engine passes active_sh_degree(it)
        assert port[e]["sh"] == ref["queued"]["sh"], e
    assert port["scan"]["blocks"] == ref["scan"]["blocks"]
    sh = ref["queued"]["sh"]
    assert sh == [jax_active_sh_degree(it, 3) for it in range(start + 1, iters + 1)]
    if start == 0:
        assert ref["scan"]["densify"] == list(range(500, 2000, 100))
        assert ref["scan"]["eval"] == list(CHECKS) and ref["scan"]["ckpt"] == list(CHECKS)
        # the degree steps up at the first step of each thousand
        assert [i + 1 for i in range(1, len(sh)) if sh[i] != sh[i - 1]] == [1000, 2000, 3000]
        assert set(port["scan"]["blocks"]) == {1, 99, 100}
        assert sum(port["scan"]["blocks"]) == iters
    else:
        assert "densify" not in port["scan"] and port["scan"]["eval"] == [3000]
        assert port["scan"]["blocks"] == [100, 100, 100]


SMALL = dict(iterations=1004, densify_from_iter=900, densify_until_iter=1004,
             densification_interval=3, densify_grad_threshold=1e-7)


@pytest.fixture(scope="module")
def small_inputs():
    scene = make_scene(n_verts=150, device=CPU)
    frames, _ = make_frames(scene, n_frames=3, H=48, W=48, crop=32, opacity=0.5)
    return scene, frames, lpips.init_random(3407, CPU)


def small_run(inputs, engine):
    """Steps 996-1004 of a 1,004-iteration run from a fresh cloud whose step
    and Adam counts are set to 995: rounds at 996, 999 and 1002, the SH
    degree 0 -> 1 at step 1000. (trainer, live count before each round and
    after it, degree-1 coefficients nonzero at each host boundary). A
    round's step skips the Gaussians' update, so no round falls on 1000."""
    scene, frames, lp = inputs
    cfg = config.Config(model=config.ModelConfig(sh_degree=1, capacity=1024, n_init_points=150),
                        optim=config.OptimConfig(**SMALL))
    tr = Trainer(scene, frames[:2], frames[2:], cfg, lp, crop_hw=(32, 32), device=CPU)
    tr.ts = tr.ts._replace(step=995, opt_state={g: s._replace(count=995)
                                                for g, s in tr.ts.opt_state.items()})
    live, bands = [], {}
    densify, log_segment = tr.densify, tr._log_segment

    def counted(it):
        before = int(tr.ts.gstate.valid.sum())
        out = densify(it)
        live.append((it, before, int(tr.ts.gstate.valid.sum())))
        return out

    def logged(prev, bound, seg, **kw):
        bands[bound] = bool(tr.ts.params["gauss"].f_rest.ne(0).any())
        return log_segment(prev, bound, seg, **kw)

    tr.densify, tr._log_segment = counted, logged
    tr.train(eval_iters=[1004], dispatch_engine=engine)
    return tr, live, bands


def test_sh_step_up_and_growing_rounds_scan_equals_queued(small_inputs):
    runs = {e: small_run(small_inputs, e) for e in ("queued", "scan")}
    (q, q_live, q_bands), (s, s_live, s_bands) = runs["queued"], runs["scan"]
    assert [it for it, _, _ in s_live] == [996, 999, 1002] and s_live == q_live
    assert any(after > before for _, before, after in s_live), s_live
    assert s_bands == q_bands == {996: False, 999: False, 1000: True, 1002: True, 1004: True}
    assert_same_state(s.ts, q.ts)
    assert s.ts.step == 1004
    strip = [{k: v for k, v in m.items() if k != "elapsed_s"} for m in s.metrics_history]
    assert strip == [{k: v for k, v in m.items() if k != "elapsed_s"} for m in q.metrics_history]


def test_captures_share_one_warm_up_stream(tiny_trainer, monkeypatch):
    """make_train_many warms every capture up on one stream: cuBLAS keeps a
    workspace for each stream its handle runs on until the process ends (on
    the card, about 65 MB more allocated a re-capture over the reference
    schedule's 16). torch.cuda's stream and graph calls are faked so that
    _run_graph runs here; three state changes make three captures."""
    made = []

    class Stream:
        def __init__(self, device=None):
            made.append(device)

        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            pass

    for name, fake in (("Stream", Stream), ("CUDAGraph", Graph),
                       ("current_stream", lambda device=None: Stream.__new__(Stream)),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("graph", lambda g, **kw: contextlib.nullcontext()),
                       ("empty_cache", lambda: None), ("synchronize", lambda device=None: None),
                       ("memory_reserved", lambda device=None: 0)):
        monkeypatch.setattr(torch.cuda, name, fake)
    tr = tiny_trainer

    def step_fn(ts, frame, deg, feats):
        ts.step.add_(1)
        return ts, {"loss": torch.zeros(())}

    many = make_train_many(step_fn, 3, per_step_logs=True)
    frames = stage_frames(tr.train_frames)
    order = torch.zeros(4, dtype=torch.int64)
    ts = device_state(tr.ts)
    for _ in range(3):
        ts = ts._replace(params={**ts.params, "gauss": dataclasses.replace(
            ts.params["gauss"], xyz=ts.params["gauss"].xyz.clone())})  # a round's new tensors
        many._buffers(order)
        many._run_graph(ts, frames, None, 4)
    assert many.captures == 3 and many.replays == 9
    assert len(made) == 1
