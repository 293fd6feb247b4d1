"""The three dispatch engines on the scene families other than SMPL (queued,
scan and eager, moss_torch/train/trainer.py), on the CPU: the SMPL-X body
(J=55, no pose MLPs) and the static scene on a black and on a white
background, each at its existing test's size (tests/_family_runs.py: 48x48
and 48x64 frames, 512 capacity) over the schedule those tests run (24
iterations, rounds at 8 and 16, the opacity reset at 12, and at 5 on the
white background; evals at 1, 12, 24). For each family and engine:

  * the run against moss_tpu's queued run on the same inputs (one a family,
    shared with test_torch_smplx.py and test_torch_colmap.py through the
    helper), within those tests' RTOL: l1 at every iteration the engine
    logs, the evals, each round's live count, the valid mask, and every Adam
    count but the empty MLP groups', which the port writes as 0 under every
    engine (train/checkpoint.py; ROADMAP Q3);
  * scan and eager bitwise queued's: parameters, moments and counts, valid,
    the densify statistics (train/checkpoint.flatten), the metrics history,
    each logged iteration, the rounds and the resets;
  * under scan, make_train_many's graph signature (the step and every
    tensor it reads or writes) changes exactly at the host boundaries where
    a round, an opacity reset or a budget install replaced something, so on
    a card a CUDA graph is captured there and nowhere else.
"""
import numpy as np
import pytest

from moss_tpu.models import smpl as JS
from moss_tpu.train import checkpoint as jckpt
from moss_torch.train import checkpoint as ckpt
from moss_torch.train.train_step import TrainMany
import _family_runs as FR
from _torch_threads import two_torch_threads  # noqa: F401

RTOL = 2e-3  # tests/test_torch_smplx.py's and tests/test_torch_colmap.py's
FAMILIES = ("smplx", "static", "static_white")
ENGINES = ("queued", "scan", "eager")
EMPTY_GROUP_COUNTS = tuple(f".opt_state.inner_states['{g}'].inner_state[0].count"
                           for g in ("pose", "lbs"))


class Runs:
    """Each family's world and moss_tpu run, and each (family, engine)
    run of the port's Trainer, made when a test first asks for it."""

    def __init__(self, tmp_path_factory):
        self.tmp, self.worlds, self.runs = tmp_path_factory, {}, {}

    def world(self, family):
        if family not in self.worlds:
            if family == "smplx":
                self.worlds[family] = FR.dna_world(self.tmp.mktemp("dna"),
                                                   JS.synthetic_smplx(n_verts=500))
            else:
                self.worlds[family] = FR.static_world(white=family == "static_white")
            FR.start_jax_run(self.worlds[family])  # built and trained on a thread
        return self.worlds[family]

    def __call__(self, family, engine):
        key = (family, engine)
        if key not in self.runs:
            world = self.world(family)
            jrun = FR.jax_started(world)
            logs, events, signatures = {}, [], []
            tr = FR.port_trainer(world, jrun,
                                 log_fn=lambda it, lg: logs.__setitem__(it, dict(lg)))
            mp = pytest.MonkeyPatch()
            FR.jax_normals_patched(mp)
            densify, reset = tr.densify, tr.reset_opacity
            install = tr._install_budgets
            mp.setattr(tr, "densify", lambda it: events.append(
                ("round", it, int(densify(it)["count_after"]))))
            mp.setattr(tr, "reset_opacity", lambda: events.append(
                ("reset", int(tr.ts.step))) or reset())
            mp.setattr(tr, "_install_budgets", lambda *a: events.append(
                ("install", int(tr.ts.step))) or install(*a))
            call = TrainMany.__call__

            def many(self, ts, frames, order, feats=None):
                out = call(self, ts, frames, order, feats)
                signatures.append((int(ts.step), self.signature(ts, frames, feats)))
                return out

            mp.setattr(TrainMany, "__call__", many)
            try:
                tr.train(world.jcfg.optim.iterations, dispatch_engine=engine)
            finally:
                mp.undo()
            self.runs[key] = (tr, jrun, logs, events, signatures)
        return self.runs[key]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = Runs(tmp_path_factory)
    for family in FAMILIES:  # moss_tpu's runs start now, beside the port's
        out.world(family)
    return out


def strip(history):
    return [{k: v for k, v in m.items() if k != "elapsed_s"} for m in history]


@pytest.mark.parametrize("engine", ENGINES[1:])
@pytest.mark.parametrize("family", FAMILIES)
def test_engine_is_bitwise_queued(runs, family, engine):
    tr, _, logs, events, _ = runs(family, engine)
    ref, _, ref_logs, ref_events, _ = runs(family, "queued")
    a, b = ckpt.flatten(tr.ts), ckpt.flatten(ref.ts)
    assert sorted(a) == sorted(b)
    differ = [k for k in a if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
    assert not differ, differ
    assert strip(tr.metrics_history) == strip(ref.metrics_history)
    assert all(logs[i] == ref_logs[i] for i in logs)
    assert events == ref_events
    resets = [ev[1] for ev in events if ev[0] == "reset"]
    assert resets == ([5, 12] if family == "static_white" else [12])
    assert tr.budgets == ref.budgets


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("family", FAMILIES)
def test_engine_matches_moss_tpus_queued_run(runs, family, engine):
    tr, _, logs, events, _ = runs(family, engine)
    jrun = FR.jax_run(runs.world(family))
    jtr = jrun.jtr
    iters = tr.cfg.optim.iterations
    # queued and scan log every iteration, eager every tenth (its host reads)
    logged = list(range(1, iters + 1)) if engine != "eager" else [10, 20]
    assert sorted(logs) == logged and sorted(jrun.l1) == list(range(1, iters + 1))
    np.testing.assert_allclose([logs[i]["l1"] for i in logged], [jrun.l1[i] for i in logged],
                               rtol=RTOL)
    assert all(lg["raster_overflow"] == 0 for lg in logs.values())
    rounds = [(ev[1], ev[2]) for ev in events if ev[0] == "round"]
    assert rounds == jrun.counts and [it for it, _ in rounds] == [8, 16]
    assert [m["iteration"] for m in tr.metrics_history] == [1, 12, 24]
    for m, jm in zip(tr.metrics_history, jtr.metrics_history):
        for k in ("psnr", "ssim", "lpips"):
            np.testing.assert_allclose(m[k], jm[k], rtol=RTOL, err_msg=f"{k} at {m['iteration']}")
    np.testing.assert_array_equal(tr.ts.gstate.valid.numpy(), np.asarray(jtr.ts.gstate.valid))
    # the Adam counts: moss_tpu's, but the empty MLP groups' written as 0
    port, ref = ckpt.flatten(tr.ts), jckpt._flatten(jtr.ts)
    counts = sorted(k for k in ref if k.endswith(".count"))
    assert counts == sorted(k for k in port if k.endswith(".count"))
    for k in counts:
        if k in EMPTY_GROUP_COUNTS:
            assert port[k] == 0 and ref[k] > 0, k
        else:
            assert port[k] == ref[k], k
    assert tr.ts.params["mlps"] is None and tr.ts.step == iters


@pytest.mark.parametrize("family", FAMILIES)
def test_scan_recaptures_where_the_state_changed(runs, family):
    """Each call of make_train_many under scan, by the step it ended at: its
    graph signature is new exactly where a round, a reset or an install ran
    at the host boundary before it, and at the first call."""
    tr, _, _, events, signatures = runs(family, "scan")
    changed_at = {ev[1] for ev in events}  # the boundaries that replaced something
    prev, prev_step, captures = None, 0, 0
    for step, sig in signatures:
        new = not TrainMany.same_signature(prev, sig)
        assert new == (prev is None or prev_step in changed_at), (step, prev_step, events)
        captures += new
        prev, prev_step = sig, step
    assert prev_step == tr.cfg.optim.iterations and captures == 1 + len(changed_at)
    assert changed_at >= {8, 12, 16} | ({5} if family == "static_white" else set())
