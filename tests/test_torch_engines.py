"""The trainer's static budgets and its three dispatch engines (moss_torch/train/trainer.py,
train_step.make_train_many) on the CPU, the counterparts of moss_tpu's tests:

  * _host_boundaries equal to moss_tpu's list for the reference schedule and
    for short ones (tests/test_host_boundaries.py);
  * queued, scan and eager bitwise equal over 26 iterations with two densify
    rounds and an opacity reset: parameters, Adam moments and counts, the
    densify statistics, the metrics (tests/test_train_many.py::
    test_fused_equals_stepwise, tests/test_train_e2e.py::test_scan_matches_queued);
  * make_train_many takes the SH degree per step across a 1000-multiple
    (test_scan_sh_degree_is_per_step), bitwise the step-at-a-time API;
  * log_fn sees every iteration in order (test_every_iteration_logged_queued_and_scan);
  * a resume under each engine equals the uninterrupted run (tests/test_resume.py);
  * the overflow self-heal under queued and scan (test_overflow_self_heals,
    test_scan_overflow_self_heals), and the failure snapshot when it cannot grow;
  * load re-probes the budgets from scratch (test_load_reprobes_budgets_from_scratch);
  * the rect cap is lowered on the first probe only (test_rect_cap_lowering_only_on_first_probe);
  * a mesh runs queued, and scan as queued with moss_tpu's line;
  * the device-table AdamW bitwise the host one, with skips;
  * a queued run with budgets that never bind against moss_tpu's queued run,
    within tests/test_torch_trainer.py::test_run_matches_moss_tpu's tolerances.
"""
import dataclasses
import math
import types

import jax
import numpy as np
import pytest
import torch

from moss_tpu.config import Config as JConfig
from moss_tpu.config import ModelConfig as JModelConfig
from moss_tpu.config import OptimConfig as JOptimConfig
from moss_tpu.config import PipelineConfig as JPipelineConfig
from moss_tpu.data.synthetic import make_frames as jax_make_frames
from moss_tpu.data.synthetic import make_scene as jax_make_scene
from moss_tpu.ops import lpips_jax
from moss_tpu.train.trainer import Trainer as JTrainer
from moss_torch import config, convert
from moss_torch.data.synthetic import make_frames, make_scene
from moss_torch.models import gaussians as G
from moss_torch.ops import lpips
from moss_torch.train import densify as D
from moss_torch.train import optim
from moss_torch.train.train_step import (active_sh_degree, device_state, make_train_many,
                                         stage_frames)
from moss_torch.parallel.distributed import Mesh
from moss_torch.train.trainer import SCAN_ON_A_MESH, Trainer
from test_torch_densify import jax_densify_noise
from test_torch_trainer import jax_pca_normals
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"
ENGINES = ("queued", "scan", "eager")
STATS = ("valid", "xyz_grad_accum", "denom", "max_radii2d", "joint_F", "lbs_weight_sum")


def port_trainer(n_verts=150, hw=(48, 48), crop=32, capacity=256, log_fn=None, n_frames=3,
                 model_path="", **optim_kw):
    scene = make_scene(n_verts=n_verts, device=CPU)
    frames, _ = make_frames(scene, n_frames=n_frames, H=hw[0], W=hw[1], crop=crop, opacity=0.5)
    cfg = config.Config(model=config.ModelConfig(sh_degree=1, capacity=capacity,
                                                 n_init_points=n_verts),
                        optim=config.OptimConfig(**optim_kw), model_path=model_path)
    return Trainer(scene, frames[:-1], frames[-1:], cfg, lpips.init_random(3407, CPU),
                   crop_hw=(crop, crop), log_fn=log_fn, device=CPU)


def assert_same_state(a, b):
    """Two TrainStates bitwise equal: params, MLPs, moments, counts, stats, step."""
    for f in G.FIELDS:
        assert torch.equal(getattr(a.params["gauss"], f), getattr(b.params["gauss"], f)), f
    for k in ("pose", "lbs"):
        for (n, x), (_, y) in zip(a.params["mlps"][k].named_parameters(),
                                  b.params["mlps"][k].named_parameters()):
            assert torch.equal(x, y), (k, n)
    for g in a.opt_state:
        assert a.opt_state[g].count == b.opt_state[g].count, g
        for n in a.opt_state[g].mu:
            assert torch.equal(a.opt_state[g].mu[n], b.opt_state[g].mu[n]), (g, n)
            assert torch.equal(a.opt_state[g].nu[n], b.opt_state[g].nu[n]), (g, n)
    for f in STATS:
        assert torch.equal(getattr(a.gstate, f), getattr(b.gstate, f)), f
    assert a.step == b.step


def boundaries(cfg, iters, eval_iters, interval=100):
    """(port's, moss_tpu's) _host_boundaries for one config."""
    port = Trainer._host_boundaries(types.SimpleNamespace(cfg=cfg, boundary_interval=interval),
                                    iters, eval_iters)
    jcfg = JConfig(model=JModelConfig(white_background=cfg.model.white_background),
                   optim=JOptimConfig(**dataclasses.asdict(cfg.optim)))
    ref = JTrainer._host_boundaries(types.SimpleNamespace(cfg=jcfg, boundary_interval=interval),
                                    iters, eval_iters)
    return port, ref


@pytest.mark.parametrize("iters,evals,optim_kw,white,interval", [
    (3000, {2500, 2700, 3000}, {}, False, 100),
    (3000, {2500, 2700, 3000}, {}, True, 100),
    (30000, {7000, 30000}, dict(iterations=30000, densify_until_iter=15000,
                                opacity_reset_interval=3000), False, 100),
    (25, set(), dict(iterations=25, densify_from_iter=100, densify_until_iter=100), False, 100),
    (26, {1, 12, 26}, dict(iterations=26, densify_from_iter=5, densify_until_iter=22,
                           densification_interval=8, opacity_reset_interval=12), True, 10),
    (7, {3}, dict(iterations=7, densify_from_iter=1, densify_until_iter=6,
                  densification_interval=2, opacity_reset_interval=4), False, 3),
], ids=["reference", "reference_white", "long", "no_densify", "short", "tiny"])
def test_host_boundaries_are_moss_tpus(iters, evals, optim_kw, white, interval):
    cfg = config.Config(model=config.ModelConfig(white_background=white),
                        optim=config.OptimConfig(**optim_kw))
    port, ref = boundaries(cfg, iters, evals, interval)
    assert port == ref
    assert port[-1] == iters and max(b - a for a, b in zip([0] + port, port)) <= interval


SCHEDULE = dict(iterations=26, densify_from_iter=5, densify_until_iter=22,
                densification_interval=8, opacity_reset_interval=12)


@pytest.fixture(scope="module")
def engine_runs():
    """One 26-iteration run per engine: (trainer, rounds, per-iteration logs)."""
    out = {}
    for engine in ENGINES:
        logs = {}
        tr = port_trainer(log_fn=lambda it, lg, logs=logs: logs.__setitem__(it, lg), **SCHEDULE)
        rounds = []
        densify = tr.densify
        tr.densify = lambda it, d=densify, r=rounds: r.append(it) or d(it)
        tr.train(eval_iters=[1, 12, 26], dispatch_engine=engine)
        out[engine] = (tr, rounds, logs)
    return out


def test_engines_are_bitwise_equal(engine_runs):
    ref, rounds, _ = engine_runs["eager"]
    assert rounds == [8, 16]
    for engine in ("queued", "scan"):
        tr, r, _ = engine_runs[engine]
        assert r == rounds, engine
        assert_same_state(tr.ts, ref.ts)
        assert [{k: v for k, v in m.items() if k != "elapsed_s"} for m in tr.metrics_history] \
            == [{k: v for k, v in m.items() if k != "elapsed_s"} for m in ref.metrics_history]
    assert ref.ts.step == 26 and ref.budgets["installs"] >= 1


def test_every_iteration_logged_queued_and_scan(engine_runs):
    traces = {}
    for engine in ("queued", "scan"):
        _, _, logs = engine_runs[engine]
        assert list(logs) == list(range(1, 27)), engine
        assert all(math.isfinite(lg["loss"]) and lg["raster_overflow"] == 0
                   for lg in logs.values()), engine
        traces[engine] = [logs[i]["l1"] for i in range(1, 27)]
    assert traces["queued"] == traces["scan"]
    assert len(set(np.round(traces["queued"], 8))) > 5
    # eager reads the logs every 10 iterations, the same numbers
    _, _, eager = engine_runs["eager"]
    assert list(eager) == [10, 20] and all(eager[i] == engine_runs["queued"][2][i]
                                           for i in (10, 20))


def test_scan_sh_degree_is_per_step():
    """Four steps across iteration 1000 in one make_train_many call are the
    step-at-a-time API's with active_sh_degree(it) per step, bitwise; the same
    four at degree 0 differ."""
    runs = {}
    for mode in ("many", "stepwise", "fixed"):
        tr = port_trainer(iterations=1002, densify_from_iter=5000, densify_until_iter=5000)
        ts = tr.ts._replace(step=998, opt_state={g: s._replace(count=998)
                                                 for g, s in tr.ts.opt_state.items()})
        tables = optim.step_tables(tr.cfg.optim, False, optim.param_groups(ts.params), 1.0, CPU)
        tr._train_step.tables = tables
        order = [0, 1, 0, 1]
        if mode == "stepwise":
            for k, it in enumerate(range(999, 1003)):
                ts, _ = tr.step_fn(ts, tr.train_frames[order[k]],
                                   active_sh_degree(it, tr.cfg.model.sh_degree))
        else:
            many = make_train_many(tr.step_fn, tr.cfg.model.sh_degree if mode == "many" else None,
                                   per_step_logs=True)
            dev = device_state(ts)
            many(dev, stage_frames(tr.train_frames), torch.tensor(order))
            ts = ts._replace(step=1002, opt_state=optim.advance_counts(ts.opt_state, tables,
                                                                       999, 1002))
        runs[mode] = ts
    assert_same_state(runs["many"], runs["stepwise"])
    assert not torch.equal(runs["many"].params["gauss"].f_rest,
                           runs["fixed"].params["gauss"].f_rest)


@pytest.mark.parametrize("engine", ENGINES)
def test_resume_equals_the_uninterrupted_run(engine_runs, engine, tmp_path):
    ref = engine_runs[engine][0]
    tr = port_trainer(**SCHEDULE)
    tr.train(eval_iters=[1, 12, 26], dispatch_engine=engine,
             ckpt_fn=lambda it: tr.save(str(tmp_path / f"chkpnt{it}.npz")) if it == 12 else None)
    again = port_trainer(**SCHEDULE)
    assert again.resume_latest(str(tmp_path)) == 12
    again.train(eval_iters=[1, 12, 26], dispatch_engine=engine)
    assert_same_state(again.ts, ref.ts)
    assert [m["iteration"] for m in again.metrics_history] == [26]
    assert again.metrics_history[0]["psnr"] == ref.metrics_history[-1]["psnr"]


HEAL = dict(iterations=20, densify_from_iter=100, densify_until_iter=0,
            densification_interval=100, opacity_reset_interval=10_000)


@pytest.mark.parametrize("engine", ["queued", "scan"])
def test_overflow_self_heals(engine):
    overflows = {}
    tr = port_trainer(n_verts=200, hw=(64, 128), crop=48, n_frames=3,
                      log_fn=lambda it, lg: overflows.__setitem__(it, lg["raster_overflow"]),
                      **HEAL)
    need = tr.budgets["npb"]
    sabotage = 512  # far below the live pairs of a frame
    tr._install_budgets(sabotage, tr._max_tiles)
    tr.train(iterations=20, eval_iters=[4, 20], dispatch_engine=engine)
    # the first heal fires at the eval-at-4 pre-step boundary (iteration 3)
    assert list(overflows) == list(range(1, 21))
    assert all(overflows[i] > 0 for i in (1, 2, 3)), overflows
    assert tr._pair_budget > sabotage and tr._heal_events >= 1
    assert all(overflows[i] == 0 for i in range(4, 21)), overflows
    assert tr.budgets["npb"] <= max(need, tr._pair_budget)


def test_overflow_that_persists_writes_the_snapshot(tmp_path):
    """Drops the largest budget cannot heal: the snapshot, budgets unchanged."""
    tr = port_trainer(n_verts=200, hw=(64, 128), crop=48, model_path=str(tmp_path), **HEAL)
    B = tr._max_tiles
    full = tr.cfg.model.capacity * B
    tr._install_budgets(full, B)
    tr._probe_pair_need = lambda frames, max_tiles: np.array([10, 2])
    tr._heal_events = 10
    tr._resize_pair_buffer(full=True, grow_from=full)
    assert tr._overflow_persists and tr._pair_budget == full


def test_load_reprobes_budgets_from_scratch(tmp_path):
    tr = port_trainer(iterations=4)
    B0 = tr.cfg.pipe.max_tiles_per_gaussian
    fresh = dict(tr.budgets)
    tr._install_budgets(50_000, 64)  # a stale escalation
    tr.save(str(tmp_path / "chkpnt0.npz"))
    installs = tr.budgets["installs"]
    tr.load(str(tmp_path / "chkpnt0.npz"))
    assert tr._max_tiles <= B0 and tr._pair_budget < 50_000
    assert tr.budgets["installs"] > installs
    assert {k: v for k, v in tr.budgets.items() if k != "installs"} == \
        {k: v for k, v in fresh.items() if k != "installs"}
    tr._install_budgets(50_000, 64)
    tr.set_state(tr.ts)
    assert tr._max_tiles <= B0 and tr._pair_budget < 50_000


def test_rect_cap_lowering_only_on_first_probe():
    tr = port_trainer(iterations=4)
    assert tr._init_probe_done
    # the first probe of a small-splat cloud lowers the cap (at least 8)
    assert 8 <= tr._max_tiles <= tr.cfg.pipe.max_tiles_per_gaussian
    tr._pair_budget, tr._max_tiles = 0, 16
    tr._probe_pair_need = lambda frames, max_tiles: np.array([100, 4])
    tr._resize_pair_buffer()
    assert tr._max_tiles == 16  # a later probe never lowers it
    # a heal revokes a lowered cap
    tr._max_tiles = 8
    tr._resize_pair_buffer(full=True, grow_from=tr.budgets["npb"])
    assert tr._max_tiles == 16


@pytest.mark.parametrize("engine", ["queued", "scan"])
def test_a_mesh_runs_queued(engine, capsys):
    """On a 1 x 1 mesh both run the queued engine (log_fn sees every
    iteration, eager only every tenth), scan after moss_tpu's line, and end
    where the single-card queued run ends, bit for bit."""
    runs = {}
    for mesh in (None, Mesh(1, 1, 0, 0, 0, None, None, torch.device(CPU))):
        logged = []
        tr = port_trainer(iterations=4, log_fn=lambda it, lg, logged=logged: logged.append(it))
        if mesh is not None:
            tr = Trainer(tr.scene, tr.train_frames, tr.test_frames, tr.cfg, tr.lpips_params,
                         crop_hw=tr.crop_hw, log_fn=tr.log_fn, mesh=mesh, device=CPU)
        capsys.readouterr()
        tr.train(4, eval_iters=[], dispatch_engine=engine if mesh is not None else "queued")
        assert logged == [1, 2, 3, 4]
        assert (SCAN_ON_A_MESH in capsys.readouterr().out) == (mesh is not None and
                                                               engine == "scan")
        runs[mesh is None] = tr
    assert_same_state(runs[False].ts, runs[True].ts)
    with pytest.raises(ValueError, match="dispatch_engine"):
        runs[False].train(4, eval_iters=[], dispatch_engine="fast")


def test_device_adamw_is_the_host_adamw():
    """adamw_step_device with the tables, bitwise adamw_step with Python
    scalars, over 30 iterations with densify, reset and final skips."""
    cfg = config.OptimConfig(iterations=30, densify_from_iter=3, densify_until_iter=25,
                             densification_interval=5, opacity_reset_interval=7)
    g = torch.Generator().manual_seed(0)
    params = {"gauss": G.GaussianParams(**{f: torch.randn((50, 3), generator=g)
                                           for f in G.FIELDS}), "mlps": None}
    dev = {"gauss": G.GaussianParams(**{f: getattr(params["gauss"], f).clone()
                                        for f in G.FIELDS}), "mlps": None}
    host_state = optim.init_state(params)
    dev_state = {k: optim.AdamState(torch.tensor(0), s.mu, s.nu)
                 for k, s in optim.init_state(dev).items()}
    tables = optim.step_tables(cfg, True, optim.param_groups(params), 2.0, CPU)
    for step in range(30):
        grads = {f: {f: torch.randn((50, 3), generator=g)} for f in G.FIELDS}
        skip = optim.skipped_groups(cfg, True, step + 1)
        host_state = optim.adamw_step(cfg, params, grads, host_state, skip, 2.0)
        optim.adamw_step_device(cfg, dev, grads, dev_state, tables, torch.tensor(step), 2.0)
    for f in G.FIELDS:
        assert torch.equal(getattr(params["gauss"], f), getattr(dev["gauss"], f)), f
        assert host_state[f].count == int(dev_state[f].count)
        assert torch.equal(host_state[f].mu[f], dev_state[f].mu[f])
        assert torch.equal(host_state[f].nu[f], dev_state[f].nu[f])
    counted = optim.advance_counts(optim.init_state(params), tables, 1, 30)
    assert {k: s.count for k, s in counted.items()} == {k: s.count for k, s in host_state.items()}


def test_queued_run_with_budgets_matches_moss_tpus_queued_run(monkeypatch):
    jscene = jax_make_scene(n_verts=300)
    jframes, _ = jax_make_frames(jscene, n_frames=3, H=48, W=48, crop=32)
    jcfg = JConfig(
        model=JModelConfig(sh_degree=1, capacity=512, n_init_points=300),
        optim=JOptimConfig(iterations=24, densify_from_iter=5, densify_until_iter=20,
                           densification_interval=8, opacity_reset_interval=12),
        pipe=JPipelineConfig(rasterizer="reference", test_iterations=(12, 24),
                             save_iterations=()))
    jl1 = {}
    jtr = JTrainer(jscene, jframes, jframes[:1], jcfg, crop_hw=(32, 32),
                   log_fn=lambda it, logs: jl1.__setitem__(it, float(logs["l1"])))
    ts0 = convert.train_state_from_jax(jtr.ts, CPU)
    jtr.train(24, dispatch_engine="queued")

    scene = convert.scene_from_jax(jscene.smpl, jscene.big_pose_params,
                                   jscene.big_pose_vertices, device=CPU)
    frames = [convert.frame_from_jax(f, CPU) for f in jframes]
    l1, over = {}, {}
    tr = Trainer(scene, frames, frames[:1], convert.config_from_jax(jcfg),
                 convert.lpips_params_from_jax(lpips_jax.get_default_params(), CPU),
                 crop_hw=(32, 32), device=CPU,
                 log_fn=lambda it, logs: (l1.__setitem__(it, logs["l1"]),
                                          over.__setitem__(it, logs["raster_overflow"])))
    tr.set_state(ts0)
    monkeypatch.setattr(tr, "densify_noise", lambda it: torch.as_tensor(
        jax_densify_noise(jax.random.fold_in(jtr.key, it), 512)))
    monkeypatch.setattr(D, "pca_normals", jax_pca_normals)
    tr.train(24, dispatch_engine="queued")
    assert tr.budgets["npb"] is not None and set(over.values()) == {0}
    assert sorted(l1) == sorted(jl1) == list(range(1, 25))
    np.testing.assert_allclose([l1[i] for i in range(1, 25)], [jl1[i] for i in range(1, 25)],
                               rtol=2e-3)
    for m, jm in zip(tr.metrics_history, jtr.metrics_history):
        assert m["iteration"] == jm["iteration"] and m["raster_overflow"] == 0
        for k in ("psnr", "ssim", "lpips"):
            np.testing.assert_allclose(m[k], jm[k], rtol=2e-3, err_msg=f"{k} at {m['iteration']}")
    np.testing.assert_array_equal(tr.ts.gstate.valid.numpy(), np.asarray(jtr.ts.gstate.valid))
