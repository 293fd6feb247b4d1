"""The port's checkpoints against moss_tpu's, on the CPU.

  * Key schema: the npz the port's save_checkpoint writes has exactly the
    keys, dtypes and shapes of moss_tpu.train.checkpoint._flatten for the
    same state, with MLPs and for a static scene (motion_offset=False).
  * Port -> moss_tpu: moss_tpu's restore_checkpoint loads the port's file
    into a JAX TrainState template, every leaf bitwise equal to the state the
    port's came from (convert.train_state_from_jax).
  * moss_tpu -> port: the port's Trainer.load reads a file written by
    moss_tpu's Trainer.save (its method, called on a stand-in that holds the
    state: the JAX Trainer's budget probe is not what is tested), bitwise,
    and its state renders the JAX state's image under render_frame (the
    image rule of tests/test_rasterize_tpu.py:50-59).
  * Training continues across packages: a JAX state after one step, saved
    by moss_tpu and restored by the port, takes its next steps in both with
    the tolerances of test_torch_train_step.py.
  * PLY: the same arrays give byte-identical files, each load_ply reads the
    other's.
  * The reference layout round-trips both ways; convert_torch_mlp_state on
    state dicts named as the reference names them equals moss_tpu's leaf for
    leaf, and a ckpt.pth tree loads.
  * compact_for_eval: the capacity, slot order and state of moss_tpu's
    Trainer.compact_for_eval (again its method on a stand-in) on the same
    state.
  * Resume: a 24-iteration Trainer(device="cpu") run with two densify rounds
    is bitwise equal to 12 iterations, resume_latest, then 12 more; the eval
    whose pre-step boundary is the resume point fires again with the same
    value (tests/test_resume.py:48, :134).
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.config import Config as JConfig
from moss_tpu.config import ModelConfig as JModelConfig
from moss_tpu.data import ply as jply
from moss_tpu.data.synthetic import make_camera as jax_make_camera
from moss_tpu.data.synthetic import make_scene as jax_make_scene
from moss_tpu.data.synthetic import random_pose
from moss_tpu.models import pose_refine as jpose
from moss_tpu.render.render import render_frame as jax_render_frame
from moss_tpu.train import checkpoint as jckpt
from moss_tpu.train.optim import make_optimizer
from moss_tpu.train.train_step import TrainState as JTrainState
from moss_tpu.train.trainer import Trainer as JTrainer
from moss_tpu.train.trainer import init_gaussians_and_mlps as jax_init
from moss_torch import config, convert
from moss_torch.data import ply
from moss_torch.data.synthetic import make_camera, make_frames
from moss_torch.ops import lpips
from moss_torch.render.render import render_frame
from moss_torch.train import checkpoint as ckpt
from moss_torch.train import optim
from moss_torch.train.trainer import Trainer
from test_rasterize_tpu import assert_images_match
from test_torch_raster_bwd import assert_grad_close
from test_torch_render import jax_raster
from test_torch_train_step import world  # noqa: F401  (the one-step fixture)
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"
CAP = 512
H = W = 48


def jax_cfg(motion_offset=True):
    return JConfig(model=JModelConfig(sh_degree=1, capacity=CAP, n_init_points=300,
                                      motion_offset=motion_offset))


def jax_state(jscene, motion_offset=True, seed=0):
    """A moss_tpu TrainState with every leaf drawn at random: 300 seeded
    slots of 512 with 40 killed, moments and statistics from a seed, every
    Adam count 7, step 7."""
    rng = np.random.default_rng(seed)
    cfg = jax_cfg(motion_offset)
    params, gstate, mlps = jax_init(jscene, cfg, jax.random.PRNGKey(seed))
    p = {"gauss": params, "mlps": mlps} if mlps is not None else {"gauss": params}

    def noisy(x):
        return jnp.asarray(np.asarray(x) + rng.normal(0, 0.01, x.shape).astype(np.float32))

    p = jax.tree.map(noisy, p)
    opt = make_optimizer(cfg.optim).init(p)
    opt = jax.tree.map(
        lambda x: (jnp.asarray(7, x.dtype) if x.dtype == jnp.int32 else
                   jnp.asarray(np.abs(rng.normal(size=x.shape)).astype(np.float32))), opt)
    valid = np.asarray(gstate.valid).copy()
    valid[rng.choice(300, 40, replace=False)] = False
    gstate = dataclasses.replace(
        gstate, valid=jnp.asarray(valid),
        **{f: jnp.asarray(rng.uniform(size=np.shape(getattr(gstate, f))).astype(np.float32))
           for f in ("max_radii2d", "xyz_grad_accum", "denom", "joint_F", "lbs_weight_sum")})
    return JTrainState(p, opt, gstate, jnp.int32(7))


@pytest.fixture(scope="module")
def jscene():
    return jax_make_scene(n_verts=300)


def assert_flat_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("motion_offset", [True, False], ids=["mlps", "static"])
def test_key_schema_matches_moss_tpu(jscene, tmp_path, motion_offset):
    jts = jax_state(jscene, motion_offset)
    path = str(tmp_path / "chkpnt7.npz")
    ckpt.save_checkpoint(path, convert.train_state_from_jax(jts, CPU))
    ref = jckpt._flatten(jts)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(ref)
        for k in ref:
            assert data[k].dtype == ref[k].dtype and data[k].shape == ref[k].shape, k
    assert len(ref) == (106 if motion_offset else 34)


def test_port_file_loads_in_moss_tpu(jscene, tmp_path):
    jts = jax_state(jscene)
    path = str(tmp_path / "chkpnt7.npz")
    ckpt.save_checkpoint(path, convert.train_state_from_jax(jts, CPU))
    assert_flat_equal(jckpt._flatten(jckpt.restore_checkpoint(path, jts)), jckpt._flatten(jts))


def test_moss_tpu_file_loads_in_the_port_and_renders_the_same(jscene, tmp_path):
    jts = jax_state(jscene)
    path = str(tmp_path / "chkpnt7.npz")
    JTrainer.save(types.SimpleNamespace(ts=jts), path)
    scene = convert.scene_from_jax(jscene.smpl, jscene.big_pose_params,
                                   jscene.big_pose_vertices, device=CPU)
    frames, _ = make_frames(scene, n_frames=1, H=H, W=W, crop=32)
    tr = Trainer(scene, frames, frames, convert.config_from_jax(jax_cfg()),
                 lpips.init_random(3407, CPU), crop_hw=(32, 32), device=CPU)
    tr.load(path)
    assert_flat_equal(ckpt.flatten(tr.ts), jckpt._flatten(jts))
    assert tr.ts.step == 7 and tr.ts.opt_state["xyz"].count == 7

    rng = np.random.default_rng(5)
    sp = {"poses": random_pose(rng)[None], "shapes": np.zeros((1, 10), np.float32),
          "R": np.eye(3, dtype=np.float32), "Th": np.zeros((1, 3), np.float32)}
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    ref = jax_render_frame(jts.params["gauss"], jts.gstate.valid, jts.params["mlps"], jscene,
                           {k: jnp.asarray(v) for k, v in sp.items()}, jax_make_camera(H, W),
                           jnp.asarray(bg), 1, rasterize_fn=jax_raster)
    with torch.no_grad():
        out = render_frame(tr.ts.params["gauss"], tr.ts.gstate.valid, tr.ts.params["mlps"],
                           scene, {k: torch.as_tensor(v) for k, v in sp.items()},
                           make_camera(H, W, device=CPU), torch.as_tensor(bg), 1, device=CPU)
    assert float(out["render_alpha"].max()) > 0.1
    for key in ("render", "render_alpha", "final_T"):
        assert_images_match(out[key].numpy(), np.asarray(ref[key]))
    assert_images_match(out["render_depth"].numpy(), np.asarray(ref["render_depth"]), atol=1e-4)


def test_training_continues_across_packages(world, tmp_path):  # noqa: F811
    """JAX's step 1, saved by moss_tpu and restored by the port; step 2 from
    it in both, then a 4-step loss trajectory. Step 2 is a step of
    test_torch_train_step.py's trajectory: its loss terms at that file's
    trajectory rtol 2e-3 (LPIPS at its 2e-2; the 1 - SSIM terms of two
    renders of the same state differ by a few f32 ulps of SSIM, 3e-6), and
    its grads, read from the moments (g2 = (mu2 - b1 mu1) / (1 - b1)), at the
    grad rule of its one-step test."""
    jts1, _ = world["step_fn"](world["jts"], world["jframes"][0], 0)
    path = str(tmp_path / "chkpnt1.npz")
    JTrainer.save(types.SimpleNamespace(ts=jts1), path)
    ts1 = ckpt.restore_checkpoint(path, CPU)
    assert_flat_equal(ckpt.flatten(ts1), jckpt._flatten(jts1))
    mu1 = {g: {n: t.clone() for n, t in st.mu.items()} for g, st in ts1.opt_state.items()}

    jts2, jlogs = world["step_fn"](jts1, world["jframes"][1], 0)
    ts2, logs = world["step"](ts1, world["frames"][1], 0)
    for key in ("l1", "mask", "ssim", "nll", "s3im", "loss"):
        np.testing.assert_allclose(float(logs[key]), float(jlogs[key]), rtol=2e-3, err_msg=key)
    assert abs(float(logs["lpips"]) - float(jlogs["lpips"])) < 2e-2 * float(jlogs["lpips"])
    ref = convert.adam_states_from_jax(jts2.opt_state, CPU)
    for g, st in ts2.opt_state.items():
        assert st.count == ref[g].count == 2

        def grad(mu, n, g=g):
            return (mu[n].numpy() - optim.B1 * mu1[g][n].numpy()) / (1 - optim.B1)

        g_ref = {n: grad(ref[g].mu, n) for n in ref[g].mu}
        scale = (None if g in optim.GAUSS_GROUPS
                 else max(float(np.abs(v).max()) for v in g_ref.values()))
        for n in g_ref:
            assert_grad_close(grad(st.mu, n), g_ref[n], f"{g}.{n}", scale=scale)

    losses, jlosses = [], []
    ts, jts = ts2, jts2
    for i in range(4):
        k = i % len(world["frames"])
        jts, jl = world["step_fn"](jts, world["jframes"][k], 0)
        ts, lg = world["step"](ts, world["frames"][k], 0)
        losses.append(float(lg["loss"]))
        jlosses.append(float(jl["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=2e-3)


@pytest.mark.parametrize("sh_degree", [1, 3])
def test_ply_byte_identical_and_cross_readable(tmp_path, sh_degree):
    rng = np.random.default_rng(sh_degree)
    P, K = 37, (sh_degree + 1) ** 2 - 1
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((P, 3), (P, 1, 3), (P, K, 3), (P, 1), (P, 3), (P, 4))]
    ours, theirs = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    ply.save_ply(ours, *(torch.as_tensor(a) for a in arrays))
    jply.save_ply(theirs, *arrays)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    a, b = ply.load_ply(theirs), jply.load_ply(ours)
    assert sorted(a) == sorted(b)
    for (k, v), arr in zip(sorted(a.items()), [arrays[i] for i in (1, 2, 3, 5, 4, 0)]):
        np.testing.assert_array_equal(v, b[k], err_msg=k)
        np.testing.assert_array_equal(v, arr, err_msg=k)


def reference_state_dicts(rng):
    """Random Autoregression / CrossAttention_lbs state dicts, keyed and
    shaped as the reference's modules (nets/mlp_delta_body_pose.py,
    nets/mlp_delta_weight_lbs.py), unused out_layer / gate_proj included."""
    def r(*s):
        return torch.as_tensor(rng.normal(size=s).astype(np.float32))

    auto = {}
    for li, (o, i) in zip((0, 2, 4), ((128, 69), (128, 128), (69, 128))):
        auto[f"block_mlps.{li}.weight"], auto[f"block_mlps.{li}.bias"] = r(o, i), r(o)
    for j, anc in enumerate(jpose.ANCESTORS):
        auto[f"fc_pose.{j}.0.weight"], auto[f"fc_pose.{j}.0.bias"] = r(3, 3 * (1 + len(anc))), r(3)
    lbs = {}
    for name, (o, i) in zip(["bw_linears.0", "bw_linears.1", "bw_linears.2", "bw_linears.3",
                             "bw_fc"], ((128, 63), (128, 128), (128, 128), (128, 191),
                                        (24, 128))):
        lbs[f"{name}.weight"], lbs[f"{name}.bias"] = r(o, i, 1), r(o)
    for name, n in (("query", 24), ("key", 9), ("value", 9)):
        lbs[f"{name}.weight"], lbs[f"{name}.bias"] = r(n, n), r(n)
    lbs["out_layer.weight"], lbs["gate_proj.weight"] = r(24, 24), r(24, 24)
    return auto, lbs


def port_mlp_leaves(mlps):
    out = {}
    for group in optim.MLP_GROUPS:
        out.update(ckpt.mlp_leaves(dict(mlps[group].named_parameters()), group, f"['{group}']"))
    return out


def test_reference_layout_round_trips_both_ways(jscene, tmp_path):
    jts = jax_state(jscene)
    ts = convert.train_state_from_jax(jts, CPU)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    ckpt.save_reference_layout(ours, 7, ts)
    jckpt.save_reference_layout(theirs, 7, jts)
    for rel in ("point_cloud/iteration_7/point_cloud.ply",):
        assert open(os.path.join(ours, rel), "rb").read() == \
            open(os.path.join(theirs, rel), "rb").read()
    with np.load(os.path.join(ours, "mlp_ckpt/iteration_7/ckpt.npz")) as a, \
            np.load(os.path.join(theirs, "mlp_ckpt/iteration_7/ckpt.npz")) as b:
        assert_flat_equal(dict(a), dict(b))

    # each package loads the other's tree into its own template
    got = ckpt.load_reference_layout(theirs, 7, ts)
    want = jckpt.load_reference_layout(ours, 7, jts)
    assert got.step == int(want.step) == 7
    flat, jflat = ckpt.flatten(got), jckpt._flatten(want)
    for k in jflat:
        if k.startswith((".params", ".gstate")):
            np.testing.assert_array_equal(flat[k], jflat[k], err_msg=k)
    n = int(np.asarray(jts.gstate.valid).sum())
    assert int(got.gstate.valid.sum()) == n and bool(got.gstate.valid[:n].all())
    assert float(got.params["gauss"].xyz[n:, 2].max()) == -1e6


def test_convert_torch_mlp_state_matches_moss_tpu(jscene, tmp_path):
    auto, lbs = reference_state_dicts(np.random.default_rng(3))
    mlps = ckpt.convert_torch_mlp_state(auto, lbs, CPU)
    assert_flat_equal(port_mlp_leaves(mlps), jckpt._flatten(jckpt.convert_torch_mlp_state(auto, lbs)))

    # a reference tree: its PLY and ckpt.pth
    jts = jax_state(jscene)
    ts = convert.train_state_from_jax(jts, CPU)
    ckpt.save_reference_layout(str(tmp_path), 9, ts)
    mlp_dir = tmp_path / "mlp_ckpt" / "iteration_9"
    os.remove(mlp_dir / "ckpt.npz")
    torch.save({"Autoregression": auto, "CrossAttention_lbs": lbs, "iter": 9},
               mlp_dir / "ckpt.pth")
    got = ckpt.load_reference_layout(str(tmp_path), 9, ts)
    assert_flat_equal(port_mlp_leaves(got.params["mlps"]), port_mlp_leaves(mlps))


def test_compact_for_eval_matches_moss_tpu(jscene):
    jts = jax_state(jscene)
    jcfg = jax_cfg()
    stand_in = types.SimpleNamespace(ts=jts, cfg=jcfg, extent=1.0,
                                     _reprobe_from_scratch=lambda: None)
    scene = convert.scene_from_jax(jscene.smpl, jscene.big_pose_params,
                                   jscene.big_pose_vertices, device=CPU)
    frames, _ = make_frames(scene, n_frames=1, H=32, W=32, crop=32)
    tr = Trainer(scene, frames, frames, convert.config_from_jax(jcfg),
                 lpips.init_random(3407, CPU), device=CPU)
    tr.set_state(convert.train_state_from_jax(jts, CPU))
    cap = tr.compact_for_eval(granularity=128)
    assert cap == JTrainer.compact_for_eval(stand_in, granularity=128) == 384
    assert tr.cfg.model.capacity == stand_in.cfg.model.capacity == 384
    assert_flat_equal(ckpt.flatten(tr.ts), jckpt._flatten(stand_in.ts))
    assert tr.compact_for_eval(granularity=128) == 384  # already fits


def resume_trainer(test_iterations=(12, 13, 24)):
    from test_torch_trainer import port_trainer

    tr = port_trainer(iterations=24, densify_from_iter=5, densify_until_iter=20,
                      densification_interval=8, opacity_reset_interval=12)
    tr.cfg = dataclasses.replace(tr.cfg, pipe=config.PipelineConfig(
        test_iterations=test_iterations, save_iterations=()))
    return tr


def test_resume_is_bitwise_equal_to_the_uninterrupted_run(tmp_path):
    tr = resume_trainer()
    rounds = []
    densify = tr.densify
    tr.densify = lambda it: rounds.append(it) or densify(it)
    tr.train(ckpt_fn=lambda it: tr.save(str(tmp_path / f"chkpnt{it}.npz")) if it == 12 else None)
    assert rounds == [8, 16] and sorted(os.listdir(tmp_path)) == ["chkpnt12.npz"]
    full = ckpt.flatten(tr.ts)

    again = resume_trainer()
    assert again.resume_latest(str(tmp_path)) == 12
    assert again.resume_latest(str(tmp_path / "none")) == 0 and again.ts.step == 12
    rounds.clear()
    densify = again.densify
    again.densify = lambda it: rounds.append(it) or densify(it)
    again.train()
    assert rounds == [16]
    assert_flat_equal(ckpt.flatten(again.ts), full)
    # the eval labelled 13 runs on the state after step 12: it fires again
    assert [m["iteration"] for m in again.metrics_history] == [13, 24]
    strip = [{k: v for k, v in m.items() if k != "elapsed_s"} for m in tr.metrics_history[1:]]
    assert [{k: v for k, v in m.items() if k != "elapsed_s"}
            for m in again.metrics_history] == strip
