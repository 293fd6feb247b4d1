"""The port's Trainer where it closed its last gaps to moss_tpu's, on the CPU.

  * The failure snapshot (moss_tpu/train/trainer.py:629-683, held by
    tests/test_failure_snapshot.py): a poisoned step raises
    FloatingPointError naming <model_path>/snapshot_iter{N}.npz; the file's
    Projected fields and bg, for one state given to both trainers
    (convert.train_state_from_jax), match moss_tpu's (exact for radius,
    radius_xy and valid; the rest within tests/test_torch_ops.py's 1e-5 of
    their scale, as the projection's parity test holds them), and its keys
    are moss_tpu's but the pair-budget ones.
  * evaluate's lpips_backbone (moss_tpu's :1339-1340), in every
    metrics_history entry; the ground-truth LPIPS towers cached or, past
    MOSS_LPIPS_GT_CACHE (:722-760), recomputed each step: the same steps.
"""
import math

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
from moss_torch.train.trainer import Trainer
from test_torch_ops import close
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"
PROJECTED = ("mean2d", "depth", "conic", "radius", "color", "opacity", "valid", "radius_xy")
EXACT = ("radius", "radius_xy", "valid")


def port_trainer(model_path="", iterations=5, n_verts=100, **kw):
    scene = make_scene(n_verts=n_verts, device=CPU)
    frames, _ = make_frames(scene, n_frames=2, H=32, W=32, crop=16)
    cfg = config.Config(model=config.ModelConfig(sh_degree=1, capacity=128,
                                                 n_init_points=n_verts),
                        optim=config.OptimConfig(iterations=iterations), model_path=model_path)
    return Trainer(scene, frames, frames[:1], cfg, lpips.init_random(3407, CPU),
                   crop_hw=(16, 16), device=CPU, **kw)


def test_snapshot_matches_moss_tpu(tmp_path):
    jscene = jax_make_scene(n_verts=100)
    jframes, _ = jax_make_frames(jscene, n_frames=1, H=32, W=32, crop=16)
    jcfg = JConfig(model=JModelConfig(sh_degree=1, capacity=128, n_init_points=100),
                   optim=JOptimConfig(iterations=5), pipe=JPipelineConfig(rasterizer="reference"),
                   model_path=str(tmp_path / "jax"))
    jtr = JTrainer(jscene, jframes, jframes[:1], jcfg, crop_hw=(16, 16))
    scene = convert.scene_from_jax(jscene.smpl, jscene.big_pose_params,
                                   jscene.big_pose_vertices, device=CPU)
    frames = [convert.frame_from_jax(f, CPU) for f in jframes]
    cfg = convert.config_from_jax(jcfg)
    cfg = type(cfg)(**{**cfg.__dict__, "model_path": str(tmp_path / "port")})
    tr = Trainer(scene, frames, frames[:1], cfg,
                 convert.lpips_params_from_jax(lpips_jax.get_default_params(), CPU),
                 crop_hw=(16, 16), device=CPU)
    tr.set_state(convert.train_state_from_jax(jtr.ts, CPU))
    logs = {"loss": float("nan"), "l1": 0.25}
    jpath = jtr._dump_failure_snapshot(5, jframes[0], logs, "non-finite loss")
    path = tr._dump_failure_snapshot(5, frames[0], logs, "non-finite loss")
    assert path == str(tmp_path / "port" / "snapshot_iter5.npz")
    with np.load(jpath) as jd, np.load(path) as d:
        # the port has the pair budget and the rect cap, not the slot budget
        assert set(d.files) == set(jd.files) - {"slot_budget"}
        assert int(d["max_tiles"]) == tr.budgets["max_tiles"] > 0
        assert int(d["pair_budget"]) == tr.budgets["pair_budget"]
        for k in ("reason", "iteration", "height", "width"):
            assert d[k] == jd[k], k
        assert np.isnan(d["log_loss"]) and d["log_l1"] == 0.25
        valid = jd["valid"]
        assert 0 < valid.sum() and d["mean2d"].shape == (128, 2)
        for k in PROJECTED:
            if k in EXACT:
                np.testing.assert_array_equal(d[k], jd[k], err_msg=k)
            else:
                close(d[k][valid], jd[k][valid])
        np.testing.assert_array_equal(d["bg"], jd["bg"])


def test_poisoned_step_raises_and_leaves_the_snapshot(tmp_path):
    tr = port_trainer(str(tmp_path / "out"))
    step = tr.step_fn

    def poisoned(ts, frame, deg, gt=None):
        ts2, logs = step(ts, frame, deg, gt)
        return ts2, {**logs, "loss": torch.tensor(float("nan"))}

    tr.step_fn = poisoned
    # the port reads every step's loss, so the first poisoned step raises
    # (moss_tpu's queued engine finds it at its next boundary)
    snap = tmp_path / "out" / "snapshot_iter1.npz"
    with pytest.raises(FloatingPointError, match=f"non-finite loss nan at iteration 1 — "
                                                 f"snapshot at {snap}"):
        tr.train(iterations=5, eval_iters=[])
    with np.load(snap) as d:
        assert int(d["iteration"]) == 1 and str(d["reason"]) == "non-finite loss"
        assert np.isnan(d["log_loss"]) and d["conic"].shape == (128, 3)
        assert np.isfinite(d["mean2d"][d["valid"]]).all()
    # a run without a model_path writes nothing and still raises
    tr = port_trainer("")
    tr.step_fn = poisoned
    with pytest.raises(FloatingPointError, match="non-finite loss nan at iteration 1$"):
        tr.train(iterations=5, eval_iters=[])


def test_gt_lpips_cache_budget_gives_the_same_steps(monkeypatch, capsys):
    """The towers cached (default budget), or recomputed every step (0, and a
    budget they do not fit): three runs, the same params and metrics."""
    runs = []
    for budget in (None, "0", "1000"):
        if budget is None:
            monkeypatch.delenv("MOSS_LPIPS_GT_CACHE", raising=False)
        else:
            monkeypatch.setenv("MOSS_LPIPS_GT_CACHE", budget)
        tr = port_trainer(iterations=3)
        feats = tr._gt_lpips_features()
        assert (feats is None) == (budget is not None)
        tr.train(3, eval_iters=[3])
        runs.append(tr)
    assert "gt-LPIPS tower cache disabled" in capsys.readouterr().out
    per_frame = lpips.gt_feature_bytes(16, 16)
    assert per_frame == lpips_jax.gt_feature_bytes(16, 16) > 1000
    for other in runs[1:]:
        for f in G.FIELDS:
            torch.testing.assert_close(getattr(other.ts.params["gauss"], f),
                                       getattr(runs[0].ts.params["gauss"], f),
                                       rtol=1e-5, atol=1e-6)
        assert other.metrics_history[0]["psnr"] == pytest.approx(
            runs[0].metrics_history[0]["psnr"], rel=1e-5)


def test_evaluate_reports_the_lpips_backbone():
    """Every metrics_history entry says which LPIPS backbone made it, as
    moss_tpu's evaluate does ("random" without pretrained weights)."""
    tr = port_trainer(iterations=2)
    tr.train(2, eval_iters=[1, 2])
    assert [m["lpips_backbone"] for m in tr.metrics_history] == ["random", "random"]
    assert lpips_jax.backbone_info()[0] == "random"
    m = port_trainer(iterations=2, lpips_backbone="pretrained").evaluate()
    assert m["lpips_backbone"] == "pretrained" and math.isfinite(m["lpips"])
