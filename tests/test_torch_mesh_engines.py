"""The port's mesh trainer (moss_torch/train/trainer.py with a parallel Mesh,
moss_torch/parallel/sharded.py's step in its device form) on the CPU, the
counterparts of moss_tpu's mesh tests:

  * the band probe: _probe_pair_need(n_tile=...)'s [live pairs, largest rect]
    equal to moss_tpu's _probe_slot_need(frame, max_tiles, n_tile=...)[1:]
    on the same cloud and frame, integer for integer (moss_tpu's probe run
    at the port's 16 x 16 tiles and one lane group, as
    tests/test_torch_budget_binning.py holds the binning;
    tests/test_parallel.py::test_band_probe_covers_every_band);
  * the first installed budgets, per band and the full-image eval pair,
    equal to a moss_tpu mesh trainer's built on the same scene, frames and
    cloud (tests/test_eval_overflow.py::test_mesh_eval_budgets_cover_full_image);
  * a forced eval overflow regrows the eval budgets, runs the eval once
    more and reports raster_overflow_healed_from, the metrics then those of
    a trainer with the budgets it probed
    (tests/test_eval_overflow.py::test_mesh_eval_overflow_surfaces_heals_and_retries);
  * four gloo CPU processes (tests/_torch_mesh_child.py, engines mode): on
    the 1x2, 2x1 and 2x2 meshes (64 x 64 frames, the LPIPS term on the 2x2)
    a 10-iteration run (densify rounds at 2, 4 and 6, an opacity reset at 4,
    evals at 4 and 10) under queued, scan (run
    as queued, with moss_tpu's line) and eager ends in the same state, bit
    for bit, on every rank: params, moments, counts, statistics, evals and
    the budgets; queued and scan log every iteration, eager every tenth; and
    one step of the sharded step's eager form bitwise its device form.
"""
import copy

import numpy as np
import pytest
import torch

from moss_tpu.config import Config as JConfig
from moss_tpu.config import ModelConfig as JModelConfig
from moss_tpu.config import OptimConfig as JOptimConfig
from moss_tpu.data.synthetic import make_frames as jax_make_frames
from moss_tpu.data.synthetic import make_scene as jax_make_scene
from moss_tpu.ops import lpips_jax
from moss_tpu.ops import rasterize_tpu as rt
from moss_tpu.parallel.sharded import make_mesh as jax_make_mesh
from moss_tpu.train.trainer import Trainer as JTrainer
from moss_torch import convert
from moss_torch.ops import lpips
from moss_torch.parallel.distributed import Mesh
from moss_torch.train.trainer import SCAN_ON_A_MESH, Trainer
from test_torch_parallel import CHILD, _free_port, _launch
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"
H, W, CROP, CAP, N_VERTS = 64, 64, 32, 256, 200
ENGINES = ("eager", "queued", "scan")
SCHEDULE = dict(iterations=10, densify_from_iter=1, densify_until_iter=7,
                densification_interval=2, opacity_reset_interval=4)
EVALS = [4, 10]
# the LPIPS term (its staged towers gathered by index on the device) on the
# 2 x 2 mesh only: it takes half of a CPU step
MESHES = [dict(name="1x2", n_data=1, n_tile=2, ranks=[0, 1], idx=[0], w_lpips=0.0),
          dict(name="2x1", n_data=2, n_tile=1, ranks=[2, 3], idx=[0, 1], w_lpips=0.0),
          dict(name="2x2", n_data=2, n_tile=2, ranks=[0, 1, 2, 3], idx=[0, 1], w_lpips=0.5)]


def local_mesh(n_data, n_tile):
    """Rank 0 of an n_data x n_tile mesh with no process group: the budgets
    are probed and the evals rendered on one process, no collective runs."""
    return Mesh(n_data, n_tile, 0, 0, 0, None, None, torch.device(CPU))


@pytest.fixture(scope="module")
def pair(request):
    """(moss_tpu's mesh trainer, its frames, the port's mesh trainer on its
    cloud, the port's frames, the port's config, the LPIPS params). moss_tpu
    runs at the port's tile geometry: 16 x 16 tiles, one lane group."""
    saved = (rt.TILE_H, rt.TILE_W, rt.DEFAULT_GROUPS)
    rt.TILE_H, rt.TILE_W, rt.DEFAULT_GROUPS = 16, 16, 1
    request.addfinalizer(lambda: setattr(rt, "TILE_H", saved[0]) or setattr(
        rt, "TILE_W", saved[1]) or setattr(rt, "DEFAULT_GROUPS", saved[2]))
    jscene = jax_make_scene(n_verts=N_VERTS)
    jframes, _ = jax_make_frames(jscene, n_frames=3, H=H, W=W, crop=CROP)
    jcfg = JConfig(model=JModelConfig(sh_degree=1, capacity=CAP, n_init_points=N_VERTS),
                   optim=JOptimConfig(**SCHEDULE))
    jtr = JTrainer(jscene, jframes[:2], jframes[2:], jcfg, crop_hw=(CROP, CROP),
                   mesh=jax_make_mesh(1, 2))
    scene = convert.scene_from_jax(jscene.smpl, jscene.big_pose_params,
                                   jscene.big_pose_vertices, device=CPU)
    frames = [convert.frame_from_jax(f, CPU) for f in jframes]
    cfg = convert.config_from_jax(jcfg)
    lp = convert.lpips_params_from_jax(lpips_jax.get_default_params(), CPU)
    tr = Trainer(scene, frames[:2], frames[2:], cfg, lp, crop_hw=(CROP, CROP),
                 mesh=local_mesh(1, 2), device=CPU)
    tr.set_state(convert.train_state_from_jax(jtr.ts, CPU))
    return jtr, jframes, tr, frames, cfg, lp


@pytest.mark.parametrize("n_tile", [1, 2, 4])
def test_band_probe_is_moss_tpus(pair, n_tile):
    jtr, jframes, tr, frames, _, _ = pair
    for jf, f in zip(jframes[:2], frames[:2]):
        ref = jtr._probe_slot_need(jf, 16, n_tile=n_tile)[1:]
        got = tr._probe_pair_need([f], 16, n_tile=n_tile)
        np.testing.assert_array_equal(got, ref)
        assert got[0] > 0
    # the band probe is the densest band's: at most the full frame's pairs
    if n_tile > 1:
        assert tr._probe_pair_need(frames[:1], 16, n_tile=n_tile)[0] <= \
            tr._probe_pair_need(frames[:1], 16, n_tile=1)[0]


def test_first_installed_budgets_are_moss_tpus(pair):
    jtr, _, tr, _, _, _ = pair
    b = tr.budgets
    assert (b["pair_budget"], b["max_tiles"]) == (jtr._pair_budget, jtr._max_tiles)
    B0 = tr.cfg.pipe.max_tiles_per_gaussian
    assert (tr._eval_pair, tr._eval_max_tiles) == (jtr._eval_pair, jtr._eval_max_tiles)
    assert b["eval"] == {"pair_budget": jtr._eval_pair, "max_tiles": max(B0, jtr._eval_max_tiles),
                         "npb": tr._capacity_of(jtr._eval_pair, max(B0, jtr._eval_max_tiles),
                                                full_image=True)}
    # a band's capacity covers the band probe's need, the eval's the full frame's
    assert b["npb"] >= tr._probe_pair_need(tr.train_frames, tr._max_tiles)[0]
    assert b["eval"]["npb"] >= tr._probe_pair_need(tr.train_frames, b["eval"]["max_tiles"],
                                                   n_tile=1)[0]
    assert b["npb"] == tr._capacity_of(b["pair_budget"], b["max_tiles"]) and \
        tr._num_tiles() == tr._num_tiles(full_image=True) // 2


def test_forced_eval_overflow_regrows_the_eval_budgets(pair):
    _, _, base, frames, cfg, lp = pair
    tr = Trainer(base.scene, frames[:2], frames[2:], cfg, lp, crop_hw=(CROP, CROP),
                 mesh=local_mesh(1, 2), device=CPU)
    tr.set_state(copy.deepcopy(base.ts))
    fresh = tr.evaluate(frames)
    assert fresh["raster_overflow"] == 0
    train_budgets = (tr._pair_budget, tr._max_tiles)
    tr._install_eval_budgets(64, 16)  # far below a frame's pairs
    healed = tr.evaluate(frames)
    assert healed["raster_overflow"] == 0 and healed["raster_overflow_healed_from"] > 0
    assert tr._eval_heal_events == 1 and tr.budgets["eval"]["npb"] > 64
    assert (tr._pair_budget, tr._max_tiles) == train_budgets  # the train budgets stay
    again = tr.evaluate(frames)
    assert again["raster_overflow"] == 0 and "raster_overflow_healed_from" not in again
    for m in (healed, again):
        for k in ("psnr", "ssim", "lpips"):
            assert m[k] == fresh[k], k


@pytest.fixture(scope="module")
def engine_runs(pair, tmp_path_factory):
    """The four gloo ranks' engines runs: {mesh: {rank: arrays}}."""
    _, _, tr, frames, cfg, lp = pair
    tmp = tmp_path_factory.mktemp("mesh_engines")
    inputs = str(tmp / "inputs.pt")
    torch.save(dict(scene=tr.scene, frames=frames[:2], lp=lp, crop=CROP,
                    engines=dict(cases=MESHES, cfg=cfg, evals=EVALS)), inputs)
    port = _free_port()
    outs = _launch([[CHILD, str(r), "4", str(port), inputs, str(tmp)] for r in range(4)],
                   timeout=300)
    assert all(f"MESH_CHILD_OK {r}" in o for r, o in enumerate(outs)), outs
    assert all(SCAN_ON_A_MESH in o for o in outs)
    return {m["name"]: {r: dict(np.load(tmp / f"engines_{m['name']}_{r}.npz"))
                        for r in m["ranks"]} for m in MESHES}


def _state_keys(res, prefix):
    return sorted(k for k in res if k.startswith(prefix + "."))


@pytest.mark.parametrize("name", [m["name"] for m in MESHES])
def test_engines_are_bitwise_equal_on_the_mesh(engine_runs, name):
    ranks = engine_runs[name]
    first = ranks[min(ranks)]
    ref = {k[len("eager."):]: v for k, v in first.items() if k.startswith("eager.")}
    assert list(ref["rounds"]) == [2, 4, 6] and int(ref["step"]) == 10
    assert [int(i) for i in ref["metrics"][:, 0]] == EVALS
    assert np.isfinite(ref["metrics"][:, 1]).all() and not ref["metrics"][:, 4].any()
    for r, res in ranks.items():
        for engine in ENGINES:
            got = {k[len(engine) + 1:]: v for k, v in res.items()
                   if k.startswith(engine + ".")}
            skip = ("logged", "l1", "overflow")
            assert sorted(got) == sorted(ref)
            for k in ref:
                if k not in skip:
                    np.testing.assert_array_equal(got[k], ref[k],
                                                  err_msg=f"rank {r} {engine} {k}")
        # queued and scan read every iteration's logs, the same numbers; eager every tenth
        for engine in ("queued", "scan"):
            assert list(res[f"{engine}.logged"]) == list(range(1, 11))
            assert not res[f"{engine}.overflow"].any()
        np.testing.assert_array_equal(res["scan.l1"], res["queued.l1"])
        assert list(res["eager.logged"]) == [10] and res["eager.l1"][0] == res["queued.l1"][-1]


@pytest.mark.parametrize("name", [m["name"] for m in MESHES])
def test_band_budgets_on_the_mesh(engine_runs, name):
    """Every rank installs the same budgets: the band's capacity for the
    mesh's band height, the eval's for the full frame."""
    case = next(m for m in MESHES if m["name"] == name)
    ranks = engine_runs[name]
    budgets = {tuple(res["queued.budgets"]) for res in ranks.values()}
    assert len(budgets) == 1
    pair_budget, max_tiles, npb, e_pair, e_tiles, e_npb = budgets.pop()
    band_tiles = (H // case["n_tile"] // 16) * (W // 16)
    from moss_torch.ops import binning
    assert npb == binning.npb(CAP, pair_budget, band_tiles, max_tiles)
    assert e_npb == binning.npb(CAP, e_pair, (H // 16) * (W // 16), e_tiles)


@pytest.mark.parametrize("name", [m["name"] for m in MESHES])
def test_eager_form_is_the_device_form(engine_runs, name):
    for r, res in engine_runs[name].items():
        keys = _state_keys(res, "eager_form")
        assert keys and keys == [k.replace("device_form", "eager_form")
                                 for k in _state_keys(res, "device_form")]
        for k in keys:
            np.testing.assert_array_equal(res[k], res[k.replace("eager_form", "device_form")],
                                          err_msg=f"rank {r} {k}")
        assert int(res["eager_form.step"]) == 1
