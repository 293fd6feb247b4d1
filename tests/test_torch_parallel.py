"""The port's multi-rank training (moss_torch/parallel/) against its
single-process step and moss_tpu's single-chip step, on the CPU.

  * The band rasterizer: the bands of a frame, each rendered by the plain
    blend with mean2d shifted into band-local rows and written into zeros at
    its rows, sum to the full frame's render (the gather's all-reduce
    replaced by that sum).
  * The sharded step on 1x2, 2x1 and 2x2 meshes of gloo ranks, four CPU
    processes launched once for the module, at 64x128 as
    tests/test_parallel.py:28-36: the loss (the mean of the frames' for two
    data rows), the all-reduced grads and the params after the update
    against the port's single-process step, and the loss, grads and params
    against moss_tpu's single-chip step (the plain blend at 16x16 tiles, its
    grads read back from its first-step moments, mu = (1 - b1) g): loss
    rtol 1e-4 / atol 1e-5, params atol 2e-5, grads rtol 1e-3 / atol 1e-5,
    the densify denom exact. The LPIPS weight is 0 in those runs (the
    bf16 towers round at other places in the two frameworks,
    tests/test_torch_train_step.py); one 2x2 run with it on is held to the
    port's single-process step. Every rank ends with the same state, bit for
    bit.
  * The densify statistics per frame: the same frame on both data rows
    gives twice the single step's denom, exactly, and accum (the
    counterpart of tests/test_parallel.py::test_densify_stats_per_frame_scale).
  * Trainer(mesh=...) on the 2x2 mesh: 8 iterations (two frames a step,
    densify rounds at 2, 4 and 6, an eval at 8) end in the same state on
    every rank, bit for bit, with the same eval; resume_latest agrees on
    every rank.
  * A 2-process bootstrap: initialize_distributed, global_mesh's
    auto-factoring, assert_uniform_across_processes passing on equal values
    and raising on every rank on divergent ones
    (tests/test_multiprocess.py:88-99).
"""
import copy
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moss_tpu import config as jconfig
from moss_tpu.data.synthetic import make_frames as jax_make_frames
from moss_tpu.data.synthetic import make_scene as jax_make_scene
from moss_tpu.ops import lpips_jax
from moss_tpu.ops.rasterize_ref import rasterize_reference as jax_rasterize_reference
from moss_tpu.train import optim as joptim
from moss_tpu.train.train_step import TrainState as JTrainState
from moss_tpu.train.train_step import make_train_step as jax_make_train_step
from moss_tpu.train.trainer import init_gaussians_and_mlps as jax_init
from moss_torch import convert
from moss_torch.models import gaussians as G
from moss_torch.ops import rasterize_cuda as rc
from moss_torch.ops.rasterize_ref import rasterize_reference
from moss_torch.render.render import render_frame
from moss_torch.parallel import sharded
from moss_torch.parallel.distributed import Mesh
from moss_torch.train import optim
from moss_torch.train.train_step import make_train_step
from _torch_threads import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_mesh_child.py")
H, W, CROP, CAP, SH = 64, 128, 48, 256, 1
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
PARAM_ATOL = 2e-5
CPU = "cpu"
# name, (n_data, n_tile), its ranks of the four, the frames of its data rows, config
CASES = [
    dict(name="1x2", n_data=1, n_tile=2, ranks=[0, 1], idx=[0], cfg="a"),
    dict(name="2x1", n_data=2, n_tile=1, ranks=[2, 3], idx=[0, 1], cfg="a"),
    dict(name="2x2", n_data=2, n_tile=2, ranks=[0, 1, 2, 3], idx=[0, 1], cfg="a"),
    dict(name="2x2_lpips", n_data=2, n_tile=2, ranks=[0, 1, 2, 3], idx=[0, 1], cfg="b"),
    dict(name="2x2_same_frame", n_data=2, n_tile=2, ranks=[0, 1, 2, 3], idx=[0, 0], cfg="a"),
]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(args_list, timeout):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable] + a, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO)
             for a in args_list]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{o[-4000:]}"
    return outs


def _jax_cfg(w_lpips):
    return jconfig.Config(model=jconfig.ModelConfig(sh_degree=1, capacity=CAP, n_init_points=200),
                          optim=jconfig.OptimConfig(w_lpips=w_lpips))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jscene = jax_make_scene(n_verts=200)
    jframes, _ = jax_make_frames(jscene, n_frames=2, H=H, W=W, crop=CROP)
    jcfg = _jax_cfg(0.0)
    params, gstate, mlps = jax_init(jscene, jcfg, jax.random.PRNGKey(0))
    jlp = lpips_jax.init_random(3407)
    raster = lambda *a, **k: jax_rasterize_reference(*a, tile_h=16, tile_w=16, **k)  # noqa: E731
    init_fn, jstep = jax_make_train_step(jscene, jcfg, raster, jlp, CROP, CROP)
    p = {"gauss": params, "mlps": mlps}
    jts = JTrainState(p, init_fn(p), gstate, jnp.int32(0))
    jax_out = []
    for f in jframes:
        jts1, jlogs = jstep(jts, f, SH)
        jax_out.append((jts1, jlogs))
    scene = convert.scene_from_jax(jscene.smpl, jscene.big_pose_params,
                                   jscene.big_pose_vertices, device=CPU)
    frames = [convert.frame_from_jax(f, CPU) for f in jframes]
    ts = convert.train_state_from_jax(jts, CPU)
    lp = convert.lpips_params_from_jax(jlp, CPU)
    cfg = {"a": convert.config_from_jax(jcfg), "b": convert.config_from_jax(_jax_cfg(0.5))}

    # the port's single-process step, frame by frame
    single = {}
    for key, c in cfg.items():
        _, step = make_train_step(scene, c, None, lp, CROP, CROP, device=CPU)
        for i, f in enumerate(frames):
            _, logs, _, grads, _ = step.grads(copy.deepcopy(ts), f, SH)
            ts1, logs1 = step(copy.deepcopy(ts), f, SH)
            single[key, i] = dict(logs=logs1, grads=grads, ts=ts1, step=step)

    tmp = tmp_path_factory.mktemp("mesh")
    inputs = str(tmp / "inputs.pt")
    trainer = dict(iterations=8, cfg=dataclasses.replace(cfg["a"], optim=dataclasses.replace(
        cfg["a"].optim, iterations=8, densify_from_iter=1, densify_until_iter=7,
        densification_interval=2, opacity_reset_interval=100)))
    torch.save(dict(cases=CASES, scene=scene, frames=frames, ts=ts, lp=lp, cfg=cfg, crop=CROP,
                    sh=SH, trainer=trainer), inputs)
    port = _free_port()
    outs = _launch([[CHILD, str(r), "4", str(port), inputs, str(tmp)] for r in range(4)],
                   timeout=240)
    assert all(f"MESH_CHILD_OK {r}" in o for r, o in enumerate(outs)), outs
    results = {c["name"]: {r: dict(np.load(tmp / f"{c['name']}_{r}.npz")) for r in c["ranks"]}
               for c in CASES}
    results["trainer"] = {r: dict(np.load(tmp / f"trainer_{r}.npz")) for r in range(4)}
    return dict(scene=scene, frames=frames, ts=ts, lp=lp, cfg=cfg, single=single,
                jax=jax_out, jts=jts, jcfg=jcfg, results=results)


def _case(name):
    return next(c for c in CASES if c["name"] == name)


def _single_mean(world, case):
    """The port's single-process numbers for the case's data rows: the mean
    loss and grads, and the params after AdamW on the mean grads."""
    runs = [world["single"][case["cfg"], i] for i in case["idx"]]
    loss = np.mean([float(r["logs"]["loss"]) for r in runs])
    grads = {g: {n: sum(r["grads"][g][n] for r in runs) / len(runs) for n in runs[0]["grads"][g]}
             for g in runs[0]["grads"]}
    ts = copy.deepcopy(world["ts"])
    cfg = world["cfg"][case["cfg"]]
    optim.adamw_step(cfg.optim, ts.params, grads, ts.opt_state,
                     optim.skipped_groups(cfg.optim, cfg.model.white_background, 1))
    return loss, grads, ts.params


def _assert_params_close(res, ref, grads, cfg):
    """The params after the update within PARAM_ATOL, but in slots whose
    reference grad lies within the grad rule's atol of zero: there the two
    may differ by up to 2 lr (at eps 1e-15 the first Adam step is lr sign(g),
    and such a grad's sign is within the rule either way;
    tests/test_torch_train_step.py)."""
    for k, v in ref.items():
        group, name = k.split(".", 1)
        if group == "gauss":
            group = name
        g = np.asarray(grads[group][name])
        lr = optim.group_lr(cfg.optim, group, 0)
        diff = np.abs(res[f"param.{k}"] - v)
        undecided = np.abs(g) <= GRAD_TOL["atol"]
        bad = (diff > PARAM_ATOL) & ~(undecided & (diff <= 2 * lr + PARAM_ATOL))
        assert not bad.any(), (k, int(bad.sum()), float(diff.max()))


def _params_flat(params):
    out = {f"gauss.{f}": getattr(params["gauss"], f).detach().numpy() for f in G.FIELDS}
    out.update({f"{k}.{n}": t.detach().numpy() for k, m in params["mlps"].items()
                for n, t in m.named_parameters()})
    return out


@pytest.mark.parametrize("n_tile", [2, 4])
def test_band_rasterize_gathers_the_full_frame(world, n_tile):
    """The bands under the plain blend, summed in place of the all-reduce,
    against the full frame: bitwise."""
    _, step = make_train_step(world["scene"], world["cfg"]["a"], None, world["lp"], CROP, CROP,
                              device=CPU)
    seen = []
    step.rasterize_fn = lambda proj, *a: seen.append(proj) or rc.rasterize_cuda(proj, *a)
    with torch.no_grad():
        ts, f = world["ts"], world["frames"][0]
        render_frame(ts.params["gauss"], ts.gstate.valid, ts.params["mlps"], world["scene"],
                     f.smpl_params, f.camera, step.bg, 1, rasterize_fn=step.rasterize_fn,
                     device=CPU)
    proj, bg = seen[0], step.bg
    full = rasterize_reference(proj, bg, H, W, tile_h=rc.TILE, tile_w=rc.TILE)
    assert float(full["alpha"].max()) > 0.5
    total = {k: torch.zeros_like(full[k]) for k in sharded.IMAGE_KEYS}
    for t in range(n_tile):
        mesh = _LocalMesh(1, n_tile, t, 0, t, None, None, torch.device(CPU))
        out = sharded.band_rasterize_fn(mesh)(proj, bg, H, W)
        hb = H // n_tile
        for k in sharded.IMAGE_KEYS:
            rest = torch.cat([out[k][:t * hb], out[k][(t + 1) * hb:]])
            assert not rest.any(), (k, t)  # zeros outside the band
            total[k] += out[k]
    for k in sharded.IMAGE_KEYS:
        assert torch.equal(total[k], full[k]), k


class _LocalMesh(Mesh):
    """One tile rank's mesh with the all-reduce left out."""

    def all_reduce(self, t, axis):
        return t


def test_stack_frames_and_back(world):
    frames = world["frames"]
    stacked = sharded.stack_frames(frames)
    assert stacked.image.shape == (2, H, W, 3) and stacked.pose_id == (0, 1)
    for i, f in enumerate(frames):
        back = sharded.frame_at(stacked, i)
        for field in ("image", "bkgd_mask", "bound_mask", "poses", "shapes", "R", "Th",
                      "pose_rotmats"):
            assert torch.equal(getattr(back, field), getattr(f, field)), field
        for field in ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy"):
            assert torch.equal(getattr(back.camera, field), getattr(f.camera, field)), field
        assert (back.crop_y0, back.crop_x0, back.pose_id) == (f.crop_y0, f.crop_x0, f.pose_id)
        assert sharded.frame_at(frames, i) is f


def test_band_rasterize_needs_whole_tiles(world):
    mesh = _LocalMesh(1, 3, 0, 0, 0, None, None, torch.device(CPU))
    with pytest.raises(ValueError, match="whole 16-row tiles"):
        sharded.band_rasterize_fn(mesh)(None, None, H, W)


@pytest.mark.parametrize("name", ["1x2", "2x1", "2x2", "2x2_lpips"])
def test_sharded_step_matches_the_port_single_step(world, name):
    case = _case(name)
    loss, grads, params = _single_mean(world, case)
    res = world["results"][name][case["ranks"][0]]
    np.testing.assert_allclose(float(res["log.loss"]), loss, **LOSS_TOL)
    for g, gr in grads.items():
        for n, t in gr.items():
            np.testing.assert_allclose(res[f"grad.{g}.{n}"], t.numpy(), **GRAD_TOL,
                                       err_msg=f"{g}.{n}")
    _assert_params_close(res, _params_flat(params), {g: {n: t.numpy() for n, t in gr.items()}
                                                     for g, gr in grads.items()},
                         world["cfg"][case["cfg"]])
    if case["n_data"] == 1:
        single = world["single"][case["cfg"], 0]["ts"].gstate
        np.testing.assert_array_equal(res["gstate.denom"], single.denom.numpy())
        np.testing.assert_allclose(res["gstate.xyz_grad_accum"], single.xyz_grad_accum.numpy(),
                                   **GRAD_TOL)
        np.testing.assert_array_equal(res["gstate.max_radii2d"], single.max_radii2d.numpy())


def _jax_grads(jts1):
    """moss_tpu's grads of a first step, from its moments: mu = (1 - b1) g."""
    ref = convert.adam_states_from_jax(jts1.opt_state, CPU)
    return {g: {n: (m / (1 - optim.B1)).numpy() for n, m in st.mu.items()} for g, st in ref.items()}


@pytest.mark.parametrize("name", ["1x2", "2x1", "2x2"])
def test_sharded_step_matches_moss_tpu_single_chip_step(world, name):
    case = _case(name)
    runs = [world["jax"][i] for i in case["idx"]]
    res = world["results"][name][case["ranks"][0]]
    np.testing.assert_allclose(float(res["log.loss"]),
                               np.mean([float(lg["loss"]) for _, lg in runs]), **LOSS_TOL)
    jgrads = [_jax_grads(jts1) for jts1, _ in runs]
    mean = {g: {n: sum(j[g][n] for j in jgrads) / len(jgrads) for n in jgrads[0][g]}
            for g in jgrads[0]}
    for g, gr in mean.items():
        for n, ref in gr.items():
            np.testing.assert_allclose(res[f"grad.{g}.{n}"], ref, **GRAD_TOL, err_msg=f"{g}.{n}")
    # moss_tpu's params after its AdamW on the mean grads (one frame: its own step)
    jts = world["jts"]
    if len(runs) == 1:
        jparams = runs[0][0].params
    else:
        jg = jax.tree.map(lambda *xs: sum(xs) / len(xs), *[_jax_grad_tree(jts1) for jts1, _ in runs])
        optimizer = joptim.make_optimizer(world["jcfg"].optim)
        upd, _ = optimizer.update(jg, jts.opt_state, jts.params)
        jparams = optax.apply_updates(jts.params, upd)
    ref = _params_flat({"gauss": convert.gaussians_from_jax(jparams["gauss"], CPU),
                        "mlps": convert.mlps_from_jax(jparams["mlps"], CPU)})
    _assert_params_close(res, ref, mean, world["cfg"]["a"])
    if case["n_data"] == 1:
        jgs = runs[0][0].gstate
        np.testing.assert_array_equal(res["gstate.denom"], np.asarray(jgs.denom))
        np.testing.assert_allclose(res["gstate.xyz_grad_accum"], np.asarray(jgs.xyz_grad_accum),
                                   **GRAD_TOL)


def _jax_grad_tree(jts1):
    """moss_tpu's first-step grads as its params' tree, from mu = (1 - b1) g."""
    mus = [masked.inner_state[0].mu for masked in jts1.opt_state.inner_states.values()]
    tree = jax.tree.map(lambda *xs: next((x for x in xs if not isinstance(x, optax.MaskedNode)),
                                         None), *mus, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    return jax.tree.map(lambda m: m / (1 - optim.B1), tree)


def test_densify_stats_are_per_frame(world):
    """The same frame on both data rows: denom exactly twice the single
    step's, xyz_grad_accum twice within the grad rule."""
    res = world["results"]["2x2_same_frame"][0]
    single = world["single"]["a", 0]["ts"].gstate
    np.testing.assert_array_equal(res["gstate.denom"], 2.0 * single.denom.numpy())
    np.testing.assert_allclose(res["gstate.xyz_grad_accum"],
                               2.0 * single.xyz_grad_accum.numpy(), **GRAD_TOL)
    assert float(single.denom.sum()) > 0


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_every_rank_holds_the_same_state(world, name):
    ranks = world["results"][name]
    first = ranks[min(ranks)]
    for r, res in ranks.items():
        for k, v in res.items():
            if k.startswith(("param.", "gstate.", "log.")):
                np.testing.assert_array_equal(v, first[k], err_msg=f"rank {r} {k}")


def test_mesh_trainer_runs_alike_on_every_rank(world):
    ranks = world["results"]["trainer"]
    first = ranks[0]
    assert int(first["step"]) == 8 and list(first["rounds"]) == [2, 4, 6]
    assert np.isfinite(first["psnr"]) and float(first["psnr"]) > 10
    for r, res in ranks.items():
        for k, v in res.items():
            np.testing.assert_array_equal(v, first[k], err_msg=f"rank {r} {k}")


BOOTSTRAP = r"""
import sys
import torch
from moss_torch.parallel.distributed import (assert_uniform_across_processes, global_mesh,
                                             initialize_distributed, process_count)
rank, port = int(sys.argv[1]), sys.argv[2]
assert not initialize_distributed()  # no coordinator, no launcher environment
assert initialize_distributed(f"127.0.0.1:{port}", 2, rank)
assert process_count() == 2
mesh = global_mesh(device="cpu")  # auto-factoring: tile takes both ranks
assert mesh.shape == {"data": 1, "tile": 2} and mesh.tile_index == rank, mesh
t = mesh.all_reduce(torch.tensor([1.0 + rank]), "tile")
assert float(t) == 3.0, t
assert_uniform_across_processes(2500, what="resume checkpoint step")
try:
    assert_uniform_across_processes(2500 if rank == 0 else 0)
except RuntimeError as e:
    assert "differs across processes" in str(e)
else:
    raise AssertionError("divergent values must raise")
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()  # a gloo group left to the interpreter's exit can abort it
print(f"BOOTSTRAP_OK {rank}", flush=True)
"""


def test_two_process_bootstrap(tmp_path):
    script = tmp_path / "bootstrap.py"
    script.write_text(BOOTSTRAP)
    env_keys = ("MASTER_ADDR", "RANK", "WORLD_SIZE")
    assert not any(k in os.environ for k in env_keys)
    port = _free_port()
    outs = _launch([[str(script), str(r), str(port)] for r in range(2)], timeout=120)
    for r, o in enumerate(outs):
        assert f"BOOTSTRAP_OK {r}" in o, o[-2000:]
