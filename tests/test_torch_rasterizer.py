"""The rasterizer choice (cfg.pipe.rasterizer, Trainer(rasterize_fn=...),
the drivers' --rasterizer) against moss_tpu's, on the CPU.

  * The port's Trainer with rasterizer "reference", and with a caller's
    rasterize_fn (the plain blend at 16 x 16 tiles), each against moss_tpu's
    Trainer built the same way (its "reference", its caller's
    rasterize_reference): 6 iterations at 32 x 32 from the same state, an
    eval at 6, per-iteration l1 and the eval's metrics within
    tests/test_torch_trainer.py's rtol; the budgets off on both sides (no
    probe, no install, the step's logs without raster_overflow, as
    moss_tpu's).
  * No heal with a caller's rasterizer: an overflowing rasterize_fn leaves
    the budgets alone, as moss_tpu's _autosize gate does.
  * The queued, scan and eager engines under "reference" end bitwise equal.
  * A mesh refuses a caller's rasterizer and "reference", as moss_tpu
    asserts; an unknown rasterizer is refused.
  * cfg.json with pipe.rasterizer both ways: the port writes moss_tpu's
    "pallas" for "cuda" and reads either word; moss_tpu reads the port's.
  * --rasterizer {cuda,reference} parses in train_zju, train_monocap and
    render_zju, cuda by default, and reaches the Trainer; render_zju
    --rasterizer reference on the CPU gives the default's PSNR exactly (on
    CPU tensors both blend with the plain version).
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from moss_tpu import config as jconfig
from moss_tpu.config import Config as JConfig
from moss_tpu.config import ModelConfig as JModelConfig
from moss_tpu.config import OptimConfig as JOptimConfig
from moss_tpu.config import PipelineConfig as JPipelineConfig
from moss_tpu.data.synthetic import make_frames as jax_make_frames
from moss_tpu.data.synthetic import make_scene as jax_make_scene
from moss_tpu.ops import lpips_jax
from moss_tpu.ops.rasterize_ref import rasterize_reference as jax_rasterize_reference
from moss_tpu.train.trainer import Trainer as JTrainer
from moss_torch import config, convert
from moss_torch.cli import render_zju, train_monocap, train_zju
from moss_torch.ops import lpips
from moss_torch.ops.rasterize_cuda import rasterize_cuda
from moss_torch.ops.rasterize_ref import rasterize_reference
from moss_torch.parallel.distributed import Mesh
from moss_torch.train import trainer as trainer_mod
from moss_torch.train.trainer import Trainer
from test_readers import _write_zju_fixture
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"
RTOL = 2e-3
ITERS = 6


@pytest.fixture(scope="module")
def jax_world():
    jscene = jax_make_scene(n_verts=150)
    jframes, _ = jax_make_frames(jscene, n_frames=3, H=32, W=32, crop=24)
    jcfg = JConfig(model=JModelConfig(sh_degree=1, capacity=256, n_init_points=150),
                   optim=JOptimConfig(iterations=ITERS, densify_from_iter=100,
                                      densify_until_iter=100),
                   pipe=JPipelineConfig(test_iterations=(ITERS,), save_iterations=()))
    return jscene, jframes, jcfg


def port_world(jscene, jframes):
    scene = convert.scene_from_jax(jscene.smpl, jscene.big_pose_params,
                                   jscene.big_pose_vertices, device=CPU)
    return scene, [convert.frame_from_jax(f, CPU) for f in jframes]


@pytest.mark.parametrize("how", ["reference", "rasterize_fn"])
def test_trainer_matches_moss_tpus_built_the_same_way(jax_world, how):
    jscene, jframes, jcfg = jax_world
    if how == "reference":
        jcfg = dataclasses.replace(jcfg, pipe=dataclasses.replace(jcfg.pipe,
                                                                  rasterizer="reference"))
        jkw, kw = {}, {}
    else:
        jkw = {"rasterize_fn": functools.partial(jax_rasterize_reference, tile_h=16, tile_w=16)}
        kw = {"rasterize_fn": functools.partial(rasterize_reference, tile_h=16, tile_w=16)}
    jl1, jkeys = {}, set()

    def jlog(it, logs):
        jl1[it] = float(logs["l1"])
        jkeys.update(logs)

    jtr = JTrainer(jscene, jframes, jframes[:1], jcfg, crop_hw=(24, 24), log_fn=jlog, **jkw)
    assert not jtr._autosize
    ts0 = convert.train_state_from_jax(jtr.ts, CPU)
    jtr.train(ITERS)

    scene, frames = port_world(jscene, jframes)
    cfg = convert.config_from_jax(jcfg)
    if how == "reference":
        cfg = dataclasses.replace(cfg, pipe=dataclasses.replace(cfg.pipe, rasterizer="reference"))
    l1, keys = {}, set()

    def log(it, logs):
        l1[it] = logs["l1"]
        keys.update(logs)

    tr = Trainer(scene, frames, frames[:1], cfg,
                 convert.lpips_params_from_jax(lpips_jax.get_default_params(), CPU),
                 crop_hw=(24, 24), log_fn=log, device=CPU, **kw)
    tr.set_state(ts0)
    assert not tr._autosize and tr.budgets["npb"] is None and tr.budgets["installs"] == 0
    assert tr._eval_raster is tr.rasterize_fn and tr.step_fn.rasterize_fn is tr.rasterize_fn
    if how == "reference":
        assert tr.rasterize_fn.func is rasterize_reference and tr.rasterize_fn.keywords["remat"]
    tr.train(ITERS)

    assert sorted(l1) == sorted(jl1) == list(range(1, ITERS + 1))
    np.testing.assert_allclose([l1[i] for i in sorted(l1)], [jl1[i] for i in sorted(jl1)],
                               rtol=RTOL)
    assert "raster_overflow" not in keys and "raster_overflow" not in jkeys
    (m,), (jm,) = tr.metrics_history, jtr.metrics_history
    assert m["iteration"] == jm["iteration"] == ITERS
    for k in ("psnr", "ssim", "lpips"):
        np.testing.assert_allclose(m[k], jm[k], rtol=RTOL, err_msg=k)
    assert m["raster_overflow"] == jm["raster_overflow"] == 0
    assert tr.budgets["installs"] == 0


def small_trainer(**kw):
    from moss_torch.data.synthetic import make_frames, make_scene

    scene = make_scene(n_verts=150, device=CPU)
    frames, _ = make_frames(scene, n_frames=3, H=32, W=32, crop=24)
    pipe = kw.pop("pipe", config.PipelineConfig())
    cfg = config.Config(model=config.ModelConfig(sh_degree=1, capacity=256, n_init_points=150),
                        optim=config.OptimConfig(iterations=ITERS, densify_from_iter=2,
                                                 densify_until_iter=5,
                                                 densification_interval=2,
                                                 opacity_reset_interval=4),
                        pipe=pipe)
    return Trainer(scene, frames, frames[:1], cfg, lpips.init_random(3407, CPU),
                   crop_hw=(24, 24), device=CPU, **kw)


def test_a_callers_overflowing_rasterizer_is_not_healed():
    """A caller's rasterize_cuda with a pair budget that drops pairs: the
    overflow reaches the logs and the eval, and no budget is probed or
    grown (moss_tpu's heal runs only under _autosize)."""
    fn = functools.partial(rasterize_cuda, pair_budget=64, max_tiles_per_gaussian=1)
    seen = []
    tr = small_trainer(rasterize_fn=fn)
    tr.log_fn = lambda it, logs: seen.append(logs.get("raster_overflow", 0))
    probes = []
    tr._probe_pair_need = lambda *a, **k: probes.append(a)
    tr.train(ITERS, eval_iters=[ITERS])
    assert max(seen) > 0 and tr.metrics_history[-1]["raster_overflow"] > 0
    assert "raster_overflow_healed_from" not in tr.metrics_history[-1]
    assert not probes and tr.budgets["installs"] == 0 and tr._eval_raster is fn


def flat(tr):
    g = tr.ts.params["gauss"]
    out = [getattr(g, f) for f in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")]
    out += [p for m in tr.ts.params["mlps"].values() for p in m.parameters()]
    out += [tr.ts.gstate.valid]
    for s in tr.ts.opt_state.values():
        out += list(s.mu.values()) + list(s.nu.values())
    return out


def test_the_engines_agree_under_the_reference():
    """Queued, scan (no graph on the CPU) and eager through the plain blend,
    with two densify rounds and a reset between: bitwise the same state."""
    runs = {}
    for engine in trainer_mod.ENGINES:
        tr = small_trainer(pipe=config.PipelineConfig(rasterizer="reference"))
        tr.train(ITERS, eval_iters=[3, ITERS], dispatch_engine=engine)
        runs[engine] = (flat(tr), [m["psnr"] for m in tr.metrics_history])
    for engine in ("scan", "eager"):
        assert runs[engine][1] == runs["queued"][1], engine
        assert all(torch.equal(a, b) for a, b in zip(runs[engine][0], runs["queued"][0])), engine


@pytest.mark.parametrize("kw", [{"rasterize_fn": rasterize_cuda},
                                {"pipe": config.PipelineConfig(rasterizer="reference")}],
                         ids=["rasterize_fn", "reference"])
def test_a_mesh_refuses_a_callers_rasterizer(kw):
    mesh = Mesh(1, 2, 0, 0, 0, None, None, torch.device(CPU))
    with pytest.raises(ValueError, match="mesh drives the band-sharded"):
        small_trainer(mesh=mesh, **kw)


def test_an_unknown_rasterizer_is_refused():
    with pytest.raises(ValueError, match="rasterizer must be one of"):
        small_trainer(pipe=config.PipelineConfig(rasterizer="pallas"))


@pytest.mark.parametrize("port,jax", [("cuda", "pallas"), ("reference", "reference")])
def test_cfg_json_rasterizer_both_ways(tmp_path, port, jax):
    cfg = dataclasses.replace(config.zju_preset("377"),
                              pipe=config.PipelineConfig(rasterizer=port, test_iterations=(5,)))
    path = str(tmp_path / "port.json")
    config.save_json(cfg, path)
    assert json.load(open(path))["pipe"]["rasterizer"] == jax
    assert jconfig.load_json(path).pipe.rasterizer == jax
    assert config.load_json(path) == cfg

    jcfg = dataclasses.replace(jconfig.zju_preset("377"),
                               pipe=jconfig.PipelineConfig(rasterizer=jax, test_iterations=(5,)))
    jpath = str(tmp_path / "jax.json")
    jconfig.save_json(jcfg, jpath)
    assert config.load_json(jpath).pipe.rasterizer == port
    raw = json.load(open(path))
    raw["pipe"]["rasterizer"] = "triton"
    json.dump(raw, open(path, "w"))
    with pytest.raises(ValueError, match="unknown rasterizer"):
        config.load_json(path)


def test_rasterizer_parses_in_the_drivers():
    for parse in (train_zju.parse_args, train_monocap.parse_args, render_zju.parse_args):
        assert parse(["--data_root", "d"]).rasterizer == "cuda"
        for r in ("cuda", "reference"):
            assert parse(["--data_root", "d", "--rasterizer", r]).rasterizer == r
        with pytest.raises(SystemExit) as e:
            parse(["--data_root", "d", "--rasterizer", "pallas"])
        assert e.value.code == 2


def test_rasterizer_reaches_the_trainer_and_render_zju(tmp_path, capsys, monkeypatch):
    """train_zju --rasterizer reference builds its Trainer on the plain blend
    and writes "reference" to cfg.json; render_zju serves a checkpoint both
    ways with the same PSNR (bitwise the same images on CPU tensors)."""
    data_root, out = tmp_path / "zju", tmp_path / "out"
    _write_zju_fixture(str(data_root / "my_377"), n_frames=60)
    built = []
    init = Trainer.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(Trainer, "__init__", spy)
    common = ["--data_root", str(data_root), "--subjects", "377", "--output", str(out),
              "--device", "cpu"]
    train_zju.main(common + ["--iterations", "2", "--test_iterations", "2",
                             "--save_iterations", "2", "--crop", "32", "--capacity", "512",
                             "--n_init", "100", "--result_file", str(tmp_path / "r.txt"),
                             "--rasterizer", "reference"])
    tr = built[-1]
    assert tr.cfg.pipe.rasterizer == "reference" and tr.rasterize_fn.func is rasterize_reference
    assert json.load(open(out / "my_377" / "cfg.json"))["pipe"]["rasterizer"] == "reference"
    results = {}
    for r in ("cuda", "reference"):
        capsys.readouterr()
        render_zju.main(common + ["--iterations", "-1", "--rasterizer", r])
        line = [s for s in capsys.readouterr().out.splitlines() if s.startswith("{")][-1]
        results[r] = json.loads(line)
        assert built[-1].cfg.pipe.rasterizer == r
    assert built[-1]._eval_raster.func is rasterize_reference
    assert results["cuda"]["psnr"] == results["reference"]["psnr"]
    assert results["cuda"]["raster_overflow"] == results["reference"]["raster_overflow"] == 0
