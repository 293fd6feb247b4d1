"""The SMPL-X (J=55) body, its deform and render path, one training step and
the Trainer, the port against moss_tpu on the CPU.

  * The counterparts of tests/test_smplx_dna.py::TestSMPLX55 on the port:
    the rig (synthetic_smplx arrays equal to moss_tpu's for the same seed),
    the template at zero pose and shape, the big pose's layout, a right-hand
    rotation that moves only right-hand vertices, the big -> target round
    trip of coarse_deform_c2source (and the cached-transform path), and
    render_frame at J=55 with motion_offset=False (pose_out None, (P, 55)
    weights) against moss_tpu's under the image rule
    (tests/test_rasterize_tpu.py:50-73); posed vertices at a random 165-dim
    pose within 1e-5 of moss_tpu's.
  * load_smplx_npz of a written 400-column asset (betas in columns [:10],
    expressions in [300:310], parents from kintree_table) equal to moss_tpu's.
  * One training step at J=55 (smpl_type "smplx", motion_offset=False) from
    one TrainState against moss_tpu's make_train_step: loss terms, grads at
    5e-4 of the max (from the first-step moments), the densify statistics,
    joint_F and lbs_weight_sum untouched (pose_out is None).
  * A 24-iteration J=55 Trainer run (rounds at 8 and 16 whose k=1 kNN runs
    to the SMPL-X big-pose vertices and whose Fisher fields are SVDs of zero
    matrices, a reset at 12, evals at 1, 12, 24) started by set_state from
    moss_tpu's Trainer's state, its noise and normals moss_tpu's: l1 per
    iteration and the evals at rtol 2e-3, live counts exact. make_frames is
    SMPL-only in both packages, so the frames come from the DNA-Rendering
    fixture of tests/test_smplx_dna.py, read by moss_tpu's reader and carried
    over by convert.frame_from_jax (h5py and cv2 needed, as there).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.models import gaussians as JG
from moss_tpu.models import smpl as JS
from moss_tpu.models.deform import coarse_deform_c2source as jax_deform
from moss_tpu.ops import lpips_jax
from moss_tpu.ops.rasterize_ref import rasterize_reference as jax_rasterize_reference
from moss_tpu.render.camera import Camera as JCamera
from moss_tpu.render.render import SceneContext as JSceneContext
from moss_tpu.render.render import render_frame as jax_render_frame
from moss_tpu.train.train_step import TrainState as JTrainState
from moss_tpu.train.train_step import make_train_step as jax_make_train_step
from moss_torch import convert
from moss_torch.models import smpl as S
from moss_torch.models.deform import apply_cached_transform, coarse_deform_c2source
from moss_torch.render.camera import Camera
from moss_torch.render.render import SceneContext, render_frame
from moss_torch.train import densify as D
from moss_torch.train import optim
from moss_torch.train.train_step import make_train_step
from test_rasterize_tpu import assert_images_match
from test_torch_raster_bwd import assert_grad_close
import _family_runs as FR
from _family_runs import write_dna_capture, write_smplx_npz  # noqa: F401 (test_torch_dna)
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"
N_VERTS = 500
RTOL = 2e-3
SMPL_FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor", "weights", "faces")


@pytest.fixture(scope="module")
def model():
    return S.synthetic_smplx(n_verts=N_VERTS, device=CPU)


@pytest.fixture(scope="module")
def jmodel():
    return JS.synthetic_smplx(n_verts=N_VERTS)


def t(x):
    return torch.as_tensor(np.array(x))


# ---- the rig: counterparts of TestSMPLX55 -----------------------------------------

def test_rig_matches_moss_tpu(model, jmodel):
    assert model.num_joints == 55 == S.NUM_JOINTS_SMPLX
    assert S.SMPLX_PARENTS == JS.SMPLX_PARENTS and model.parents == jmodel.parents
    assert all(0 <= S.SMPLX_PARENTS[j] < j for j in range(1, 55)) and S.SMPLX_PARENTS[0] == -1
    assert model.posedirs.shape[-1] == 9 * 54 and model.shapedirs.shape[-1] == 20
    for f in SMPL_FIELDS:
        np.testing.assert_array_equal(getattr(model, f).numpy(), np.asarray(getattr(jmodel, f)),
                                      err_msg=f)


def test_zero_pose_zero_shape_is_template(model):
    v, _ = S.lbs_vertices(model, torch.zeros(165), torch.zeros(20))
    np.testing.assert_allclose(v.numpy(), model.v_template.numpy(), atol=1e-5)


def test_big_pose_smplx_layout():
    big = S.big_pose_params_smplx(device=CPU)
    jbig = JS.big_pose_params_smplx()
    assert big["poses"].shape == (1, 165) and big["shapes"].shape == (1, 20)
    for k in ("poses", "shapes", "R", "Th"):
        np.testing.assert_array_equal(big[k].numpy(), np.asarray(jbig[k]), err_msg=k)
    p = big["poses"][0].numpy()
    assert np.count_nonzero(p) == 4 and p[5] == np.float32(np.deg2rad(45.0))


def test_posed_vertices_match_moss_tpu(model, jmodel, rng):
    pose = rng.normal(0, 0.2, 165).astype(np.float32)
    shapes = rng.normal(0, 0.5, 20).astype(np.float32)
    v, joints = S.lbs_vertices(model, t(pose), t(shapes))
    jv, jjoints = JS.lbs_vertices(jmodel, jnp.asarray(pose), jnp.asarray(shapes))
    assert joints.shape == (55, 3)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(joints.numpy(), np.asarray(jjoints), atol=1e-5)


def test_hand_pose_moves_hand_vertices_only(model):
    v0, _ = S.lbs_vertices(model, torch.zeros(165), torch.zeros(20))
    pose = torch.zeros(165)
    pose[3 * 40: 3 * 40 + 3] = torch.tensor([0.0, 0.0, 1.2])  # right_index1 (joint 40)
    v1, _ = S.lbs_vertices(model, pose, torch.zeros(20))
    moved = torch.linalg.norm(v1 - v0, dim=-1).numpy()
    sub = [j for j in range(55) if j == 40 or S.SMPLX_PARENTS[j] in (40, 41)]
    w_sub = model.weights.numpy()[:, sub].sum(-1)
    i_hand, i_far = int(w_sub.argmax()), int(w_sub.argmin())
    assert moved[i_hand] > 1e-3
    assert moved[i_far] < 0.2 * moved[i_hand]


def test_big_to_target_roundtrip_on_vertices(model, jmodel, rng):
    from scipy.spatial.transform import Rotation

    big = S.big_pose_params_smplx(device=CPU)
    v_big, _ = S.lbs_vertices(model, big["poses"][0], big["shapes"][0])
    Rw = Rotation.from_rotvec([0.1, -0.2, 0.3]).as_matrix().astype(np.float32)
    Th = np.array([[0.2, 0.1, -0.3]], np.float32)
    pose_t = rng.normal(0, 0.2, 165).astype(np.float32)
    shapes_t = rng.normal(0, 0.5, 20).astype(np.float32)
    target = {"poses": t(pose_t)[None], "shapes": t(shapes_t)[None], "R": t(Rw), "Th": t(Th)}
    out = coarse_deform_c2source(model, v_big, target, big, v_big)
    v_target, _ = S.lbs_vertices(model, t(pose_t), t(shapes_t))
    expect_world = v_target.numpy() @ np.linalg.inv(Rw) + Th
    np.testing.assert_allclose(out.smpl_pts.numpy(), v_target.numpy(), atol=3e-3)
    np.testing.assert_allclose(out.world_pts.numpy(), expect_world, atol=3e-3)
    assert out.bweights.shape == (N_VERTS, 55)
    re_applied = apply_cached_transform(v_big, out.transforms, out.translation)
    np.testing.assert_allclose(re_applied.numpy(), out.world_pts.numpy(), atol=1e-4)

    jbig = JS.big_pose_params_smplx()
    jv_big, _ = JS.lbs_vertices(jmodel, jbig["poses"][0], jbig["shapes"][0])
    jout = jax_deform(jmodel, jv_big, {k: jnp.asarray(v.numpy()) for k, v in target.items()},
                      jbig, jv_big)
    for f in ("smpl_pts", "world_pts", "bweights", "transforms", "translation"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(jout, f)),
                                   atol=1e-5, err_msg=f)


def test_render_frame_smplx_matches_moss_tpu(model, jmodel, rng):
    big = S.big_pose_params_smplx(device=CPU)
    v_big, _ = S.lbs_vertices(model, big["poses"][0], big["shapes"][0])
    scene = SceneContext(smpl=model, big_pose_params=big, big_pose_vertices=v_big)
    jbig = JS.big_pose_params_smplx()
    jv_big, _ = JS.lbs_vertices(jmodel, jbig["poses"][0], jbig["shapes"][0])
    jscene = JSceneContext(smpl=jmodel, big_pose_params=jbig, big_pose_vertices=jv_big)
    pts = np.asarray(jv_big)[::2]
    colors = rng.uniform(size=(pts.shape[0], 3)).astype(np.float32)
    jparams, jgstate = JG.create_from_points(pts, colors, capacity=256, sh_degree=1)
    params = convert.gaussians_from_jax(jparams, CPU)
    K = np.array([[60.0, 0, 32], [0, 60.0, 16], [0, 0, 1.0]])
    cam = Camera.from_KRT(K, np.eye(3), np.array([0, 0, 2.0]), 32, 64, device=CPU)
    jcam = JCamera.from_KRT(K, np.eye(3), np.array([0, 0, 2.0]), 32, 64)
    sp = {"poses": rng.normal(0, 0.2, (1, 165)).astype(np.float32),
          "shapes": np.zeros((1, 20), np.float32), "R": np.eye(3, dtype=np.float32),
          "Th": np.zeros((1, 3), np.float32)}
    with torch.no_grad():
        out = render_frame(params, t(jgstate.valid), None, scene,
                           {k: t(v) for k, v in sp.items()}, cam, torch.zeros(3), 1,
                           motion_offset=False, device=CPU)
    ref = jax_render_frame(jparams, jgstate.valid, None, jscene,
                           {k: jnp.asarray(v) for k, v in sp.items()}, jcam, jnp.zeros(3), 1,
                           rasterize_fn=functools.partial(jax_rasterize_reference, tile_h=16,
                                                          tile_w=16),
                           motion_offset=False)
    assert out["render"].shape == (32, 64, 3) and bool(torch.isfinite(out["render"]).all())
    assert out["pose_out"] is None and ref["pose_out"] is None
    assert out["lbs_weights"].shape == (256, 55)
    assert float(out["render_alpha"].max()) > 0.1
    for key in ("render", "render_alpha", "final_T"):
        assert_images_match(out[key].numpy(), np.asarray(ref[key]))
    assert_images_match(out["render_depth"].numpy(), np.asarray(ref["render_depth"]), atol=1e-4)
    live = np.asarray(jgstate.valid)
    np.testing.assert_allclose(out["means3D"].numpy()[live], np.asarray(ref["means3D"])[live],
                               atol=1e-5)


# ---- the asset --------------------------------------------------------------------

def test_load_smplx_npz_matches_moss_tpu(jmodel, tmp_path):
    path = write_smplx_npz(str(tmp_path / "SMPLX_NEUTRAL.npz"), jmodel)
    model = S.load_smplx_npz(path, device=CPU)
    ref = JS.load_smplx_npz(path)
    assert model.parents == ref.parents == JS.SMPLX_PARENTS and model.num_joints == 55
    for f in SMPL_FIELDS:
        np.testing.assert_array_equal(getattr(model, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(model.shapedirs.numpy(), np.asarray(jmodel.shapedirs))


# ---- one step and the Trainer, on DNA-Rendering frames ----------------------------

@pytest.fixture(scope="module")
def dna_world(jmodel, tmp_path_factory):
    """moss_tpu's reader on the DNA capture (128x128, 48x48 frames) with the
    500-vertex SMPL-X asset: its scene and 3 train frames (view 26)
    (tests/_family_runs.py)."""
    return FR.dna_world(tmp_path_factory.mktemp("dna"), jmodel)


jax_cfg = FR.smplx_jax_cfg


def test_one_step_at_j55_matches_moss_tpu(dna_world):
    from moss_tpu.train.trainer import init_gaussians_and_mlps as jax_init

    jscene, jframes, scene, frames = (dna_world.jscene, dna_world.jframes, dna_world.scene,
                                      dna_world.frames)
    jcfg = jax_cfg()
    rng = np.random.default_rng(17)
    params, gstate, mlps = jax_init(jscene, jcfg, jax.random.PRNGKey(0))
    assert mlps is None
    params = dataclasses.replace(
        params, scaling=params.scaling + jnp.asarray(rng.normal(0, 0.3, (512, 3)), jnp.float32),
        rotation=jnp.asarray(rng.normal(size=(512, 4)).astype(np.float32)))
    lp = lpips_jax.init_random(3407)
    raster = functools.partial(jax_rasterize_reference, tile_h=16, tile_w=16)
    init_fn, step_fn = jax_make_train_step(jscene, jcfg, raster, lp, 48, 48)
    p = {"gauss": params}
    jts0 = JTrainState(p, init_fn(p), gstate, jnp.int32(0))
    jts1, jlogs = step_fn(jts0, jframes[0], 0)

    _, step = make_train_step(scene, convert.config_from_jax(jcfg), None,
                              convert.lpips_params_from_jax(lp, CPU), 48, 48, device=CPU)
    ts0 = convert.train_state_from_jax(jts0, CPU)
    assert ts0.params["mlps"] is None
    _, _, out, grads, _ = step.grads(ts0, frames[0], 0)
    assert out["pose_out"] is None and out["lbs_weights"].shape == (512, 55)
    ts1, logs = step(ts0, frames[0], 0)
    for key in ("l1", "mask", "ssim", "s3im"):
        np.testing.assert_allclose(float(logs[key]), float(jlogs[key]), rtol=1e-5, atol=2e-6,
                                   err_msg=key)
    assert float(logs["nll"]) == float(jlogs["nll"]) == 0.0
    assert abs(float(logs["lpips"]) - float(jlogs["lpips"])) < 2e-2 * float(jlogs["lpips"])
    ref = convert.adam_states_from_jax(jts1.opt_state, CPU)
    assert sorted(ref) == sorted(ts1.opt_state) == sorted(optim.GAUSS_GROUPS)
    for g in ref:
        assert ts1.opt_state[g].count == ref[g].count == 1
        g_ref = ref[g].mu[g].numpy() / (1 - optim.B1)
        assert g == "f_rest" or np.abs(g_ref).max() > 0, g  # f_rest: SH degree 0 is active
        assert_grad_close(grads[g][g].numpy(), g_ref, g)
    gs, gs_ref = ts1.gstate, convert.gstate_from_jax(jts1.gstate, CPU)
    assert float(gs.xyz_grad_accum.max()) > 0
    assert_grad_close(gs.xyz_grad_accum.numpy(), gs_ref.xyz_grad_accum.numpy(), "xyz_grad_accum")
    for f in ("valid", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(gs, f).numpy(), getattr(gs_ref, f).numpy(),
                                      err_msg=f)
    for f in ("joint_F", "lbs_weight_sum"):
        assert float(getattr(gs, f).abs().max()) == float(getattr(gs_ref, f).abs().max()) == 0.0


def test_trainer_at_j55_matches_moss_tpu(dna_world, monkeypatch):
    jscene, jcfg = dna_world.jscene, dna_world.jcfg
    run = FR.jax_run(dna_world)  # moss_tpu's queued run (tests/_family_runs.py)
    jtr, jl1, jcounts = run.jtr, run.l1, run.counts
    assert "mlps" not in jtr.ts.params

    l1, counts, fields = {}, [], []
    tr = FR.port_trainer(dna_world, run, log_fn=lambda it, logs: l1.__setitem__(it, logs["l1"]),
                         start=False)
    # init_gaussians_and_mlps on the SMPL-X scene: 400 of the 500 big-pose
    # vertices, evenly, and no MLPs
    assert tr.ts.params["mlps"] is None
    np.testing.assert_array_equal(tr.ts.params["gauss"].xyz.numpy(),
                                  np.asarray(jtr_initial_xyz(jscene, jcfg)))
    FR.start_from(tr, run)
    FR.jax_normals_patched(monkeypatch)
    densify, fisher = tr.densify, D.fisher_fields
    monkeypatch.setattr(D, "fisher_fields", lambda gs: fields.append(fisher(gs)) or fields[-1])
    monkeypatch.setattr(tr, "densify", lambda it: counts.append(
        (it, int(densify(it)["count_after"]))))
    tr.train(24)

    assert sorted(l1) == sorted(jl1) == list(range(1, 25))
    np.testing.assert_allclose([l1[i] for i in sorted(l1)], [jl1[i] for i in sorted(jl1)],
                               rtol=RTOL)
    assert counts == jcounts and [c[0] for c in counts] == [8, 16]
    assert counts[0][1] != 400, "the first round changed nothing"
    # the Fisher fields at J=55: SVDs of zero matrices times zero LBS sums
    assert len(fields) == 2
    for rot, scl in fields:
        assert bool(torch.isfinite(rot).all() and torch.isfinite(scl).all())
        assert float(rot.abs().max()) == float(scl.abs().max()) == 0.0
    assert [m["iteration"] for m in tr.metrics_history] == [1, 12, 24]
    for m, jm in zip(tr.metrics_history, jtr.metrics_history):
        for k in ("psnr", "ssim", "lpips"):
            np.testing.assert_allclose(m[k], jm[k], rtol=RTOL, err_msg=f"{k} at {m['iteration']}")
    np.testing.assert_array_equal(tr.ts.gstate.valid.numpy(), np.asarray(jtr.ts.gstate.valid))
    assert float(tr.ts.gstate.joint_F.abs().max()) == 0.0 and tr.ts.step == 24


def jtr_initial_xyz(jscene, jcfg):
    from moss_tpu.train.trainer import init_gaussians_and_mlps as jax_init

    return jax_init(jscene, jcfg, jax.random.PRNGKey(0))[0].xyz
