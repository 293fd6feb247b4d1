"""The port's Trainer against moss_tpu's, on the CPU.

  * A 24-iteration run at 48x48 (two densify rounds, at 8 and 16, one
    opacity reset at 12, evals at 1, 12 and 24) of the port's
    Trainer(device="cpu") started by set_state from the JAX Trainer's state
    (convert.train_state_from_jax), against the JAX Trainer with the plain
    rasterizer (PipelineConfig(rasterizer="reference"), as
    tests/test_train_e2e.py:21-31). The port's densify noise and pca_normals
    are monkeypatched to moss_tpu's (the two eigensolvers pick opposite
    normal signs on some patches, tests/test_torch_densify.py). Per-iteration
    l1 and the eval metrics within the 10-step trajectory's rtol 2e-3
    (tests/test_torch_train_step.py: the LPIPS term runs in bf16); the live
    count after each round exact.
  * Counterparts of tests/test_reset_opacity.py:53 (the opacity moments
    zeroed, the count and the other groups kept) and :116 (the reset nested
    under densify_until), and of tests/test_train_e2e.py:702 (an eval at an
    intermediate iteration sees the state after the step before) and :760
    (save_fn pre-step, ckpt_fn post-step).
  * Two port runs bitwise equal: params, valid, moments, metrics_history.
"""

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
from moss_tpu.train import densify as JD
from moss_tpu.train.trainer import Trainer as JTrainer
from moss_torch import config, convert
from moss_torch.data.synthetic import make_frames, make_scene
from moss_torch.models import gaussians as G
from moss_torch.ops import lpips
from moss_torch.train import densify as D
from moss_torch.train.train_step import active_sh_degree
from moss_torch.train.trainer import Trainer
from test_torch_densify import jax_densify_noise
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"
RTOL = 2e-3
METRICS = ("psnr", "ssim", "lpips", "iteration")


def jax_pca_normals(xyz, nbr_idx):
    """moss_tpu's pca_normals on the port's tensors."""
    return torch.as_tensor(np.array(JD.pca_normals(np.asarray(xyz), np.asarray(nbr_idx))))


@pytest.fixture(scope="module")
def jax_world():
    jscene = jax_make_scene(n_verts=300)
    jframes, _ = jax_make_frames(jscene, n_frames=3, H=48, W=48, crop=32)
    jcfg = JConfig(
        model=JModelConfig(sh_degree=1, capacity=512, n_init_points=300),
        optim=JOptimConfig(iterations=24, densify_from_iter=5, densify_until_iter=20,
                           densification_interval=8, opacity_reset_interval=12),
        pipe=JPipelineConfig(rasterizer="reference", test_iterations=(1, 12, 24),
                             save_iterations=()))
    return jscene, jframes, jcfg


def test_run_matches_moss_tpu(jax_world, monkeypatch):
    jscene, jframes, jcfg = jax_world
    jl1 = {}
    jtr = JTrainer(jscene, jframes, jframes[:1], jcfg, crop_hw=(32, 32),
                   log_fn=lambda it, logs: jl1.__setitem__(it, float(logs["l1"])))
    ts0 = convert.train_state_from_jax(jtr.ts, CPU)
    jcounts = []
    jdensify = jtr.densify
    monkeypatch.setattr(jtr, "densify", lambda it: jcounts.append(
        (it, int(jdensify(it)["count_after"]))))
    jtr.train(24)

    scene = convert.scene_from_jax(jscene.smpl, jscene.big_pose_params,
                                   jscene.big_pose_vertices, device=CPU)
    frames = [convert.frame_from_jax(f, CPU) for f in jframes]
    l1 = {}
    tr = Trainer(scene, frames, frames[:1], convert.config_from_jax(jcfg),
                 convert.lpips_params_from_jax(lpips_jax.get_default_params(), CPU),
                 crop_hw=(32, 32), log_fn=lambda it, logs: l1.__setitem__(it, logs["l1"]),
                 device=CPU)
    tr.set_state(ts0)
    P = jcfg.model.capacity
    monkeypatch.setattr(tr, "densify_noise", lambda it: torch.as_tensor(
        jax_densify_noise(jax.random.fold_in(jtr.key, it), P)))
    monkeypatch.setattr(D, "pca_normals", jax_pca_normals)
    counts = []
    densify = tr.densify
    monkeypatch.setattr(tr, "densify", lambda it: counts.append(
        (it, int(densify(it)["count_after"]))))
    tr.train(24)

    assert sorted(l1) == sorted(jl1) == list(range(1, 25))
    np.testing.assert_allclose([l1[i] for i in sorted(l1)], [jl1[i] for i in sorted(jl1)],
                               rtol=RTOL)
    assert counts == jcounts and [c[0] for c in counts] == [8, 16]
    assert counts[0][1] != 300, "the first round changed nothing"
    assert [m["iteration"] for m in tr.metrics_history] == [1, 12, 24]
    for m, jm in zip(tr.metrics_history, jtr.metrics_history):
        assert m["iteration"] == jm["iteration"]
        for k in ("psnr", "ssim", "lpips"):
            np.testing.assert_allclose(m[k], jm[k], rtol=RTOL, err_msg=f"{k} at {m['iteration']}")
    np.testing.assert_array_equal(tr.ts.gstate.valid.numpy(), np.asarray(jtr.ts.gstate.valid))
    assert tr.ts.step == int(jtr.ts.step) == 24


# ---- the loop's order, on the port alone ----------------------------------------

def port_trainer(n_verts=150, hw=48, crop=32, target_opacity=None, **optim):
    scene = make_scene(n_verts=n_verts, device=CPU)
    frames, _ = make_frames(scene, n_frames=2, H=hw, W=hw, crop=crop, opacity=target_opacity)
    cfg = config.Config(model=config.ModelConfig(sh_degree=1, capacity=256,
                                                 n_init_points=n_verts),
                        optim=config.OptimConfig(**optim))
    return Trainer(scene, frames, frames[:1], cfg, lpips.init_random(3407, CPU),
                   crop_hw=(crop, crop), device=CPU)


def test_reset_opacity_zeroes_the_opacity_moments_only():
    tr = port_trainer(iterations=12, densify_from_iter=100, densify_until_iter=100)
    tr.train(12, eval_iters=[])
    st = tr.ts.opt_state
    assert float(st["opacity"].mu["opacity"].abs().max()) > 0
    assert float(st["opacity"].nu["opacity"].abs().max()) > 0
    xyz_mu = st["xyz"].mu["xyz"].clone()
    count = st["opacity"].count
    tr.reset_opacity()
    st = tr.ts.opt_state
    assert float(st["opacity"].mu["opacity"].abs().max()) == 0.0
    assert float(st["opacity"].nu["opacity"].abs().max()) == 0.0
    assert st["opacity"].count == count
    assert torch.equal(st["xyz"].mu["xyz"], xyz_mu)
    op = G.get_opacity(tr.ts.params["gauss"])[tr.ts.gstate.valid]
    assert float(op.max()) <= 0.01 + 1e-6


def test_reset_nested_under_densify_until(monkeypatch):
    tr = port_trainer(iterations=12, densify_from_iter=2, densify_until_iter=6,
                      densification_interval=3, opacity_reset_interval=4)
    fired, densified = [], []
    reset, densify = tr.reset_opacity, tr.densify
    monkeypatch.setattr(tr, "reset_opacity", lambda: fired.append(tr.ts.step) or reset())
    monkeypatch.setattr(tr, "densify", lambda it: densified.append(it) or densify(it))
    tr.train(12, eval_iters=[])
    # interval multiples are 4, 8, 12: only 4 lies inside the densify window
    assert fired == [4]
    assert densified == [3]


def test_eval_at_an_intermediate_iteration_sees_the_state_before_its_step():
    k = 7
    kw = dict(iterations=12, densify_from_iter=100, densify_until_iter=100, w_lpips=0.0)
    ref = port_trainer(**kw)
    cfg = ref.cfg
    rng = np.random.default_rng(cfg.seed)
    order = []
    while len(order) < cfg.optim.iterations:
        order.extend(rng.permutation(len(ref.train_frames)).tolist())
    for it in range(1, k):
        ref.ts, _ = ref.step_fn(ref.ts, ref.train_frames[order[it - 1]],
                                active_sh_degree(it, cfg.model.sh_degree))
    expected = ref.evaluate(sh_it=k)
    ref.ts, _ = ref.step_fn(ref.ts, ref.train_frames[order[k - 1]],
                            active_sh_degree(k, cfg.model.sh_degree))
    assert ref.evaluate(sh_it=k)["psnr"] != expected["psnr"], "step k moved nothing"

    tr = port_trainer(**kw)
    tr.train(12, eval_iters=[k])
    got = tr.metrics_history[0]
    assert got["iteration"] == k
    assert got["psnr"] == expected["psnr"] and got["ssim"] == expected["ssim"]


def test_save_and_ckpt_hooks_fire_around_the_step():
    tr = port_trainer(iterations=20)
    saved, ckpts = {}, {}

    def save_fn(it):
        saved[it] = (tr.ts.step, tr.ts.params["gauss"].xyz.clone())

    tr.train(20, eval_iters=[10, 20], save_fn=save_fn, save_iters=[6, 10, 20],
             ckpt_fn=lambda it: ckpts.__setitem__(it, tr.ts.step))
    assert sorted(saved) == [6, 10, 20]
    assert saved[6][0] == 5 and saved[10][0] == 9 and saved[20][0] == 20
    assert ckpts == {10: 10, 20: 20}
    assert not torch.allclose(saved[10][1], saved[20][1])
    assert [m["iteration"] for m in tr.metrics_history] == [10, 20]


def test_two_runs_are_bitwise_equal():
    kw = dict(iterations=14, densify_from_iter=3, densify_until_iter=12,
              densification_interval=5, opacity_reset_interval=7)
    runs = []
    for _ in range(2):
        tr = port_trainer(**kw)
        tr.train(14, eval_iters=[1, 8, 14])
        runs.append(tr)
    a, b = (r.ts for r in runs)
    assert torch.equal(a.gstate.valid, b.gstate.valid)
    for f in G.FIELDS:
        assert torch.equal(getattr(a.params["gauss"], f), getattr(b.params["gauss"], f)), f
    for g in a.opt_state:
        assert a.opt_state[g].count == b.opt_state[g].count
        for n in a.opt_state[g].mu:
            assert torch.equal(a.opt_state[g].mu[n], b.opt_state[g].mu[n]), (g, n)
            assert torch.equal(a.opt_state[g].nu[n], b.opt_state[g].nu[n]), (g, n)
    for name, p in a.params["mlps"]["pose"].named_parameters():
        assert torch.equal(p, dict(b.params["mlps"]["pose"].named_parameters())[name])
    ma, mb = ([{k: m[k] for k in METRICS} for m in r.metrics_history] for r in runs)
    assert ma == mb and len(ma) == 3


def test_a_non_finite_loss_raises():
    tr = port_trainer(iterations=4, densify_from_iter=100, densify_until_iter=100)
    tr.ts.params["gauss"].f_dc[:] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        tr.train(4, eval_iters=[])


def test_make_frames_target_opacity():
    scene = make_scene(n_verts=150, device=CPU)
    default, _ = make_frames(scene, n_frames=1, H=48, W=48, crop=32)
    same, _ = make_frames(scene, n_frames=1, H=48, W=48, crop=32, opacity=0.1)
    dense, _ = make_frames(scene, n_frames=1, H=48, W=48, crop=32, opacity=0.5)
    # create_from_points' 0.1 is the default target
    assert torch.allclose(same[0].image, default[0].image, atol=1e-6)
    covered = default[0].bkgd_mask > 1e-3
    assert bool((dense[0].bkgd_mask[covered] > default[0].bkgd_mask[covered]).all())


def test_training_towards_a_denser_target_raises_the_psnr():
    """The initial cloud (opacity 0.1, other colours) does not reproduce an
    opacity-0.5 target, so 16 steps before any round or reset must gain."""
    tr = port_trainer(target_opacity=0.5, iterations=16, densify_from_iter=100,
                      densify_until_iter=100)
    tr.train(16, eval_iters=[1, 16])
    first, last = (m["psnr"] for m in tr.metrics_history)
    assert last > first + 0.5, (first, last)
