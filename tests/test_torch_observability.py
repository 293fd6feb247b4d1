"""The port's observability (moss_torch/train/observability.py) and the
Trainer's TensorBoard dump, on the CPU.

  * TBWriter: scalars, an image and a histogram read back from the event
    file where tensorboardX imports; where it does not (or no logdir is
    given), no file and no error (moss_tpu's rule).
  * Timer: sections add up; a section waits for its sync value's device.
  * profile_trace: a Chrome trace written under the logdir on the CPU,
    naming the operators run inside; nothing without a logdir.
  * Trainer.evaluate(tb_step=...) against moss_tpu's Trainer.evaluate on
    the same state and six test frames: the same calls in the same order
    (the first five renders, their ground truth at the first dumping eval
    only, the live opacities' histogram, scene/total_points), the live
    count equal, the renders and opacities close.
"""
import glob
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from moss_tpu.config import Config as JConfig
from moss_tpu.config import ModelConfig as JModelConfig
from moss_tpu.config import PipelineConfig as JPipelineConfig
from moss_tpu.data.synthetic import make_frames as jax_make_frames
from moss_tpu.data.synthetic import make_scene as jax_make_scene
from moss_tpu.ops import lpips_jax
from moss_tpu.train.trainer import Trainer as JTrainer
from moss_torch import convert
from moss_torch.train import observability as obs
from moss_torch.train.trainer import Trainer
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"


def _events(logdir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(logdir), size_guidance={"images": 0, "histograms": 0})
    acc.Reload()
    return acc


def test_tbwriter_writes_what_it_is_given(tmp_path):
    pytest.importorskip("tensorboardX")
    tb = obs.TBWriter(str(tmp_path / "tb"))
    tb.scalars({"loss": torch.tensor(0.25), "l1": 0.5, "name": "not a number"}, 3)
    tb.scalar("scene/total_points", 123, 3)
    tb.image("test/view_0/render", torch.full((4, 6, 3), 2.0), 3)  # clipped to 1
    tb.histogram("scene/opacity_histogram", torch.linspace(0, 1, 50), 3)
    tb.close()
    acc = _events(tmp_path / "tb")
    tags = acc.Tags()
    assert set(tags["scalars"]) == {"train/loss", "train/l1", "scene/total_points"}
    assert [(e.step, e.value) for e in acc.Scalars("train/loss")] == [(3, 0.25)]
    assert acc.Scalars("scene/total_points")[0].value == 123
    img = acc.Images("test/view_0/render")[0]
    assert (img.step, img.width, img.height) == (3, 6, 4)
    assert acc.Histograms("scene/opacity_histogram")[0].histogram_value.num == 50


def test_tbwriter_is_silent_without_tensorboardx_or_logdir(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # the import raises ImportError
    for logdir in (str(tmp_path / "tb"), None, ""):
        tb = obs.TBWriter(logdir)
        assert tb.writer is None
        tb.scalars({"loss": 1.0}, 1)
        tb.image("x", np.zeros((2, 2, 3)), 1)
        tb.histogram("h", np.zeros(3), 1)
        tb.close()
    assert not os.path.exists(tmp_path / "tb")


def test_timer_sections_add_up():
    timer = obs.Timer()
    for _ in range(2):
        with timer.section("a", sync_value={"x": torch.ones(3), "y": [torch.zeros(2)]}):
            time.sleep(0.01)
    with timer.section("b"):
        pass
    assert set(timer.sections) == {"a", "b"}
    assert 0.02 <= timer.sections["a"] < 1.0 and timer.sections["b"] < timer.sections["a"]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "prof"
    with obs.profile_trace(str(logdir)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    (path,) = glob.glob(str(logdir / "trace_*.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::mm" in names
    with obs.profile_trace(None) as prof:
        pass
    assert prof is None


class RecordingTB:
    """Stands in for a TBWriter: records each call."""

    def __init__(self):
        self.calls = []

    def image(self, tag, img, step):
        self.calls.append(("image", tag, step, np.asarray(
            img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else img)))

    def histogram(self, tag, values, step):
        self.calls.append(("histogram", tag, step, np.sort(np.asarray(
            values.detach().cpu().numpy() if isinstance(values, torch.Tensor) else values))))

    def scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, step, float(value)))


def test_eval_dump_matches_moss_tpus():
    jscene = jax_make_scene(n_verts=200)
    jframes, _ = jax_make_frames(jscene, n_frames=7, H=48, W=48, crop=32)
    jcfg = JConfig(model=JModelConfig(sh_degree=1, capacity=256, n_init_points=200),
                   pipe=JPipelineConfig(rasterizer="reference"))
    jtb = RecordingTB()
    jtr = JTrainer(jscene, jframes[:1], jframes[1:], jcfg, crop_hw=(32, 32), tb=jtb)
    scene = convert.scene_from_jax(jscene.smpl, jscene.big_pose_params,
                                   jscene.big_pose_vertices, device=CPU)
    frames = [convert.frame_from_jax(f, CPU) for f in jframes]
    tb = RecordingTB()
    tr = Trainer(scene, frames[:1], frames[1:], convert.config_from_jax(jcfg),
                 convert.lpips_params_from_jax(lpips_jax.get_default_params(), CPU),
                 crop_hw=(32, 32), tb=tb, device=CPU)
    tr.set_state(convert.train_state_from_jax(jtr.ts, CPU))
    for step in (1, 2):
        jtr.evaluate(tb_step=step)
        tr.evaluate(tb_step=step)
    tr.evaluate()  # no tb_step: no dump
    keys = [c[:3] for c in tb.calls]
    assert keys == [c[:3] for c in jtb.calls]
    assert keys[:10] == [("image", f"test/view_{i}/{k}", 1) for i in range(5)
                         for k in ("render", "ground_truth")]
    assert ("image", "test/view_0/ground_truth", 2) not in keys
    assert keys.count(("scalar", "scene/total_points", 2)) == 1 and len(keys) == 10 + 2 + 5 + 2
    for (kind, tag, _, v), (_, _, _, jv) in zip(tb.calls, jtb.calls):
        if kind == "scalar":
            assert v == jv == 200, tag
        else:
            np.testing.assert_allclose(v, np.asarray(jv), atol=2e-3, err_msg=tag)
