"""The port's COLMAP/Blender readers and static-scene training against moss_tpu's, on the CPU.

  * The counterparts of tests/test_colmap.py on moss_torch/data/colmap.py:
    text and binary models parse to the same scene, an empty points3D.txt,
    nerfpp_norm's two goldens, the Blender reader's axis flip.
  * Model files (cameras, images, points3D) written by either package are
    byte-identical, and each package reads the other's.
  * read_colmap_scene (binary, and the text fallback) and read_blender_scene
    give moss_tpu's specs; qvec2rotmat and nerfpp_norm agree.
  * frame_from_spec on an RGB PNG (COLMAP K) and on RGBA PNGs composited
    over white and black (Blender fov): image and masks bitwise moss_tpu's,
    the camera within 1e-6.
  * scene_from_jax carries a static scene (no body) as static_scene_context
    builds it.
  * A 24-iteration static Trainer run (static_scene=True,
    motion_offset=False, extent 2, rounds of densify_and_prune_static at 8
    and 16, the opacity reset at 12, evals at 1, 12, 24) started by set_state
    from moss_tpu's Trainer's state, its densify noise moss_tpu's: l1 per
    iteration and the evals at rtol 2e-3 (tests/test_torch_trainer.py), live
    counts exact; then its state saved by the port and restored by moss_tpu,
    and the other way, key for key and leaf for leaf but the empty MLP
    groups' Adam counts, which the port writes as 0; and compact_for_eval of
    it against moss_tpu's.
"""
import dataclasses
import json
import os
import types

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.data import colmap as JC
from moss_tpu.train import checkpoint as jckpt
from moss_tpu.train.trainer import Trainer as JTrainer
from moss_torch import convert
from moss_torch.data import colmap as C
from moss_torch.train import checkpoint as ckpt
from moss_torch.train.trainer import Trainer
from test_colmap import _make_model
from test_torch_checkpoint import assert_flat_equal
import _family_runs as FR
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"
RTOL = 2e-3
CAMERA_FIELDS = ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy")


def assert_same_specs(specs, jspecs):
    assert len(specs) == len(jspecs) > 0
    for s, js in zip(specs, jspecs):
        assert sorted(s) == sorted(js)
        for k in s:
            if isinstance(s[k], np.ndarray):
                np.testing.assert_array_equal(s[k], js[k], err_msg=k)
            else:
                assert s[k] == js[k], k


# ---- counterparts of tests/test_colmap.py ----------------------------------------

def test_text_binary_parity(tmp_path):
    _make_model(str(tmp_path / "bin"), binary=True)
    _make_model(str(tmp_path / "txt"), binary=False)
    spec_b, xyz_b, rgb_b = C.read_colmap_scene(str(tmp_path / "bin"))
    spec_t, xyz_t, rgb_t = C.read_colmap_scene(str(tmp_path / "txt"))
    np.testing.assert_allclose(xyz_b, xyz_t, atol=1e-6)
    np.testing.assert_allclose(rgb_b, rgb_t, atol=1e-6)
    assert len(spec_b) == len(spec_t) == 3
    for sb, st in zip(spec_b, spec_t):
        np.testing.assert_allclose(sb["K"], st["K"], atol=1e-9)
        np.testing.assert_allclose(sb["R_w2c"], st["R_w2c"], atol=1e-12)
        np.testing.assert_allclose(sb["T_w2c"], st["T_w2c"], atol=1e-12)
        assert sb["name"] == st["name"]
        assert (sb["width"], sb["height"]) == (st["width"], st["height"])


def test_points3d_text_empty(tmp_path):
    p = tmp_path / "points3D.txt"
    p.write_text("# only comments\n")
    xyz, rgb = C.read_points3d_text(str(p))
    assert xyz.shape == (0, 3) and rgb.shape == (0, 3)
    assert xyz.dtype == rgb.dtype == np.float32


def test_nerfpp_norm_golden():
    R = np.eye(3)
    specs = [{"R_w2c": R, "T_w2c": np.array([1.0, 0, 0]).reshape(3, 1)},
             {"R_w2c": R, "T_w2c": np.array([-1.0, 0, 0]).reshape(3, 1)},
             {"R_w2c": R, "T_w2c": np.array([0, 2.0, 0]).reshape(3, 1)}]
    out = C.nerfpp_norm(specs)
    mean = np.array([0, -2.0 / 3.0, 0])
    np.testing.assert_allclose(out["translate"], -mean, atol=1e-12)
    dists = [np.linalg.norm(c - mean) for c in
             [np.array([-1.0, 0, 0]), np.array([1.0, 0, 0]), np.array([0, -2.0, 0])]]
    np.testing.assert_allclose(out["radius"], 1.1 * max(dists), rtol=1e-12)
    ref = JC.nerfpp_norm(specs)
    assert out["radius"] == ref["radius"]
    np.testing.assert_array_equal(out["translate"], ref["translate"])


def test_nerfpp_norm_nontrivial_rotation():
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    c_true = np.array([3.0, -1.0, 2.0])
    specs = [{"R_w2c": R, "T_w2c": (-R @ c_true).reshape(3, 1)},
             {"R_w2c": np.eye(3), "T_w2c": np.zeros((3, 1))}]
    out = C.nerfpp_norm(specs)
    np.testing.assert_allclose(out["translate"], -c_true / 2.0, atol=1e-9)
    assert out["radius"] == JC.nerfpp_norm(specs)["radius"]


def test_blender_reader(tmp_path):
    c2w = np.eye(4)
    c2w[:3, 3] = [0, 0, 3.0]
    meta = {"camera_angle_x": 0.8,
            "frames": [{"file_path": "./train/r_0", "transform_matrix": c2w.tolist()}]}
    with open(tmp_path / "transforms_train.json", "w") as f:
        json.dump(meta, f)
    specs = C.read_blender_scene(str(tmp_path), "train")
    assert len(specs) == 1 and specs[0]["fovx"] == 0.8
    flip = np.diag([1.0, -1.0, -1.0])
    np.testing.assert_allclose(specs[0]["R_w2c"], flip, atol=1e-12)
    np.testing.assert_allclose(specs[0]["T_w2c"].reshape(3), flip @ np.array([0, 0, -3.0]),
                               atol=1e-12)
    assert_same_specs(specs, JC.read_blender_scene(str(tmp_path), "train"))


# ---- files both ways, scene readers -----------------------------------------------

def _model_arrays(seed=11, n_images=4, n_points=9):
    rng = np.random.default_rng(seed)
    cams = {1: (1, "PINHOLE", 64, 48, np.array([70.0, 72.0, 32.0, 24.0])),
            2: (2, "SIMPLE_PINHOLE", 40, 30, np.array([50.0, 20.0, 15.0])),
            3: (3, "OPENCV", 64, 48, rng.normal(size=8))}
    images = {}
    for i in range(1, n_images + 1):
        q = rng.normal(size=4)
        images[i] = (i, q / np.linalg.norm(q), rng.normal(size=3), 1 + i % 3, f"im_{5 - i}.png")
    xyz = rng.normal(size=(n_points, 3))
    rgb = rng.integers(0, 256, size=(n_points, 3)).astype(np.uint8)
    return cams, images, xyz, rgb


def _write_model(mod, sparse, cams, images, xyz, rgb):
    os.makedirs(sparse, exist_ok=True)
    mod.write_cameras_binary(os.path.join(sparse, "cameras.bin"),
                             {k: mod.ColmapCamera(*v) for k, v in cams.items()})
    mod.write_images_binary(os.path.join(sparse, "images.bin"),
                            {k: mod.ColmapImage(*v) for k, v in images.items()})
    mod.write_points3d_binary(os.path.join(sparse, "points3D.bin"), xyz, rgb)


def test_model_files_byte_identical_and_read_by_the_other(tmp_path):
    arrays = _model_arrays()
    port, ref = str(tmp_path / "port" / "sparse" / "0"), str(tmp_path / "ref" / "sparse" / "0")
    _write_model(C, port, *arrays)
    _write_model(JC, ref, *arrays)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(port, name), "rb") as a, open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    for reader, other in ((C, ref), (JC, port)):
        cams = reader.read_cameras_binary(os.path.join(other, "cameras.bin"))
        images = reader.read_images_binary(os.path.join(other, "images.bin"))
        xyz, rgb = reader.read_points3d_binary(os.path.join(other, "points3D.bin"))
        for k, v in arrays[0].items():
            assert cams[k][:4] == v[:4]
            np.testing.assert_array_equal(cams[k].params, v[4])
        for k, v in arrays[1].items():
            assert images[k].camera_id == v[3] and images[k].name == v[4]
            np.testing.assert_array_equal(images[k].qvec, v[1])
            np.testing.assert_array_equal(images[k].tvec, v[2])
        np.testing.assert_array_equal(xyz, arrays[2].astype(np.float32))
        np.testing.assert_array_equal(rgb, arrays[3].astype(np.float32) / 255.0)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "text"])
def test_read_colmap_scene_matches_moss_tpu(tmp_path, binary):
    _make_model(str(tmp_path), binary=binary)
    specs, xyz, rgb = C.read_colmap_scene(str(tmp_path))
    jspecs, jxyz, jrgb = JC.read_colmap_scene(str(tmp_path))
    assert_same_specs(specs, jspecs)
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(rgb, jrgb)
    assert C.nerfpp_norm(specs)["radius"] == JC.nerfpp_norm(jspecs)["radius"]
    for s in specs:
        R = s["R_w2c"]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)


def test_qvec2rotmat_matches_moss_tpu():
    rng = np.random.default_rng(3)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        np.testing.assert_array_equal(C.qvec2rotmat(q), JC.qvec2rotmat(q))


def _blender_scene(root, n=3, hw=(24, 32), seed=4):
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        ang = 0.4 * i
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
        c2w[:3, 3] = [4.0 * np.sin(ang), 0.3, 4.0 * np.cos(ang)]
        os.makedirs(os.path.join(root, "train"), exist_ok=True)
        rgba = rng.integers(0, 256, (*hw, 4)).astype(np.uint8)
        imageio.imwrite(os.path.join(root, "train", f"r_{i}.png"), rgba)
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)


def test_read_blender_scene_matches_moss_tpu(tmp_path):
    _blender_scene(str(tmp_path))
    for white in (False, True):
        specs = C.read_blender_scene(str(tmp_path), "train", white)
        assert_same_specs(specs, JC.read_blender_scene(str(tmp_path), "train", white))
    assert C.nerfpp_norm(specs)["radius"] == JC.nerfpp_norm(specs)["radius"]


def assert_same_frame(frame, jframe):
    for f in ("image", "bkgd_mask", "bound_mask", "poses", "shapes", "R", "Th", "pose_rotmats"):
        np.testing.assert_array_equal(getattr(frame, f).numpy(), np.asarray(getattr(jframe, f)),
                                      err_msg=f)
    for f in CAMERA_FIELDS:
        np.testing.assert_allclose(getattr(frame.camera, f).numpy(),
                                   np.asarray(getattr(jframe.camera, f)), rtol=1e-6, atol=1e-6)
    assert (frame.camera.height, frame.camera.width) == (jframe.camera.height,
                                                        jframe.camera.width)
    assert (frame.crop_y0, frame.crop_x0, frame.pose_id) == (
        int(jframe.crop_y0), int(jframe.crop_x0), int(jframe.pose_id))


@pytest.mark.parametrize("white", [False, True], ids=["black", "white"])
def test_frame_from_blender_spec_matches_moss_tpu(tmp_path, white):
    _blender_scene(str(tmp_path))
    spec = C.read_blender_scene(str(tmp_path), "train", white)[1]
    frame = C.frame_from_spec(spec, device=CPU)
    assert_same_frame(frame, JC.frame_from_spec(spec))
    assert frame.image.shape == (24, 32, 3) and float(frame.bound_mask.min()) == 1.0
    alpha = imageio.imread(spec["image_path"])[..., 3]
    clear = torch.as_tensor(alpha == 0)
    if clear.any():
        assert float(frame.image[clear].min()) == float(frame.image[clear].max()) == float(white)


def test_frame_from_colmap_spec_matches_moss_tpu(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (32, 48, 3)).astype(np.uint8)
    imageio.imwrite(tmp_path / "img.png", img)
    spec = {"K": np.array([[50.0, 0, 24], [0, 50.0, 16], [0, 0, 1]]), "R_w2c": np.eye(3),
            "T_w2c": np.zeros((3, 1)), "image_path": str(tmp_path / "img.png"), "width": 48,
            "height": 32}
    frame = C.frame_from_spec(spec, device=CPU)
    assert_same_frame(frame, JC.frame_from_spec(spec))
    np.testing.assert_array_equal(frame.image.numpy(), img.astype(np.float32) / 255.0)


def test_scene_from_jax_carries_a_static_scene():
    pts = np.random.default_rng(1).normal(size=(20, 3)).astype(np.float32)
    jscene = JC.static_scene_context(pts)
    scene = convert.scene_from_jax(jscene.smpl, jscene.big_pose_params,
                                   jscene.big_pose_vertices, device=CPU)
    own = C.static_scene_context(pts, device=CPU)
    assert scene.smpl is None and scene.big_pose_params is None and own.smpl is None
    assert torch.equal(scene.big_pose_vertices, own.big_pose_vertices)
    np.testing.assert_array_equal(scene.big_pose_vertices.numpy(), pts)


# ---- the static trainer and its checkpoint ---------------------------------------

@pytest.fixture(scope="module")
def static_runs():
    """(port trainer, moss_tpu trainer, their l1 by iteration, their rounds)
    on moss_tpu's static fixture at 48x64 (tests/_family_runs.py)."""
    world = FR.static_world()
    run = FR.jax_run(world)
    l1, counts = {}, []
    tr = FR.port_trainer(world, run, log_fn=lambda it, logs: l1.__setitem__(it, logs["l1"]))
    mp = pytest.MonkeyPatch()
    densify = tr.densify
    mp.setattr(tr, "densify", lambda it: counts.append((it, int(densify(it)["count_after"]))))
    tr.train(24)
    mp.undo()
    return tr, run.jtr, (l1, run.l1), (counts, run.counts)


def test_static_trainer_matches_moss_tpu(static_runs):
    tr, jtr, (l1, jl1), (counts, jcounts) = static_runs
    assert sorted(l1) == sorted(jl1) == list(range(1, 25))
    np.testing.assert_allclose([l1[i] for i in sorted(l1)], [jl1[i] for i in sorted(jl1)],
                               rtol=RTOL)
    assert counts == jcounts and [c[0] for c in counts] == [8, 16]
    assert counts[-1][1] != 160, "the rounds changed nothing"
    assert [m["iteration"] for m in tr.metrics_history] == [1, 12, 24]
    for m, jm in zip(tr.metrics_history, jtr.metrics_history):
        for k in ("psnr", "ssim", "lpips"):
            np.testing.assert_allclose(m[k], jm[k], rtol=RTOL, err_msg=f"{k} at {m['iteration']}")
    np.testing.assert_array_equal(tr.ts.gstate.valid.numpy(), np.asarray(jtr.ts.gstate.valid))
    assert tr.ts.params["mlps"] is None and tr.ts.step == 24


# moss_tpu's masked Adam chains count steps for the static scene's empty
# MLP groups; the port keeps no state for a group without leaves and writes
# count 0 there (train/checkpoint.py)
EMPTY_GROUP_COUNTS = tuple(f".opt_state.inner_states['{g}'].inner_state[0].count"
                           for g in ("pose", "lbs"))


def assert_same_but_empty_counts(port_flat, jax_flat):
    assert sorted(port_flat) == sorted(jax_flat)
    for k in EMPTY_GROUP_COUNTS:
        assert port_flat[k] == 0 and port_flat[k].dtype == jax_flat[k].dtype == np.int32
    assert_flat_equal({k: v for k, v in port_flat.items() if k not in EMPTY_GROUP_COUNTS},
                      {k: v for k, v in jax_flat.items() if k not in EMPTY_GROUP_COUNTS})


def test_static_checkpoint_both_ways(static_runs, tmp_path):
    tr, jtr, _, _ = static_runs
    path = str(tmp_path / "chkpnt24.npz")
    tr.save(path)
    with np.load(path) as data:
        assert_same_but_empty_counts(dict(data), ckpt.flatten(tr.ts))
        assert sorted(data.files) == sorted(jckpt._flatten(jtr.ts))
    restored = jckpt.restore_checkpoint(path, jtr.ts)
    assert_same_but_empty_counts(ckpt.flatten(tr.ts), jckpt._flatten(restored))

    jpath = str(tmp_path / "jax" / "chkpnt24.npz")
    os.makedirs(os.path.dirname(jpath))
    JTrainer.save(types.SimpleNamespace(ts=jtr.ts), jpath)
    other = Trainer(tr.scene, tr.train_frames, tr.test_frames, tr.cfg, tr.lpips_params,
                    crop_hw=tr.crop_hw, extent=2.0, device=CPU)
    assert other.resume_latest(os.path.dirname(jpath)) == 24
    assert other.ts.params["mlps"] is None
    assert_same_but_empty_counts(ckpt.flatten(other.ts), jckpt._flatten(jtr.ts))


def test_static_compact_for_eval_matches_moss_tpu(static_runs):
    """On moss_tpu's trained state with 150 of its live slots killed (the run
    ends with its arena nearly full)."""
    tr, jtr, _, _ = static_runs
    valid = np.asarray(jtr.ts.gstate.valid).copy()
    valid[np.random.default_rng(2).choice(np.flatnonzero(valid), 150, replace=False)] = False
    jts = jtr.ts._replace(gstate=dataclasses.replace(jtr.ts.gstate, valid=jnp.asarray(valid)))
    stand_in = types.SimpleNamespace(ts=jts, cfg=jtr.cfg, extent=2.0,
                                     _reprobe_from_scratch=lambda: None)
    port = Trainer(tr.scene, tr.train_frames, tr.test_frames, tr.cfg, tr.lpips_params,
                   crop_hw=tr.crop_hw, extent=2.0, device=CPU)
    port.set_state(convert.train_state_from_jax(jts, CPU))
    before = port.evaluate()
    cap = port.compact_for_eval(granularity=128)
    assert cap == JTrainer.compact_for_eval(stand_in, granularity=128) < 512
    assert_same_but_empty_counts(ckpt.flatten(port.ts), jckpt._flatten(stand_in.ts))
    assert port.evaluate()["psnr"] == pytest.approx(before["psnr"], rel=1e-6)
