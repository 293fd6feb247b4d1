"""The port's DNA-Rendering reader against moss_tpu's, on the CPU.

  * SMCReader: tests/test_smplx_dna.py's contract (calibration, SMPL-X
    block, mask, colour frame) on the port's copy, and every read equal to
    moss_tpu's SMCReader bit for bit (both decode with cv2.imdecode).
  * read_dna_rendering: the train split (view 26, 100 poses at stride 1) and
    the test split (views 24, 25, 27, 28, 20 poses at stride 5) of a
    100-frame capture, and a 3-frame capture clamped: views, frame ids,
    paths, SMPL-X params bitwise, the world bounds within 1e-6 (the body is
    posed by each package's own lbs_vertices), the big-pose scene (the J=55
    stand-in rig bitwise, its vertices within 1e-5); with an SMPL-X asset,
    the asset's rig.
  * DNAFrameSpec.load against moss_tpu's frame, train and test views, black
    and white backgrounds, with and without a crop: image, masks and SMPL-X
    fields bitwise, the 54 target rotations within 1e-6, the camera within
    1e-6, the crop origin exact.
  * One training step from a DNA frame, the counterpart of
    tests/test_smplx_dna.py::test_dna_frame_trains_one_step: the port's
    reader, frame and init_gaussians_and_mlps against moss_tpu's, one step
    of each (the plain blend on both sides): the initial cloud within 1e-6,
    loss terms within 1e-4, the Gaussian grads at 5e-4 of the max.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

from moss_tpu.config import Config as JConfig
from moss_tpu.config import ModelConfig as JModelConfig
from moss_tpu.data import dna as jdna
from moss_tpu.data.smc import SMCReader as JSMCReader
from moss_tpu.ops import lpips_jax
from moss_tpu.ops.rasterize_ref import rasterize_reference as jax_rasterize_reference
from moss_tpu.train.train_step import TrainState as JTrainState
from moss_tpu.train.train_step import make_train_step as jax_make_train_step
from moss_tpu.train.trainer import init_gaussians_and_mlps as jax_init
from moss_torch import convert
from moss_torch.data import dna
from moss_torch.data.smc import SMCReader
from moss_torch.train import optim
from moss_torch.train.train_step import TrainState, make_train_step
from moss_torch.train.trainer import init_gaussians_and_mlps
from test_smplx_dna import _write_smc_fixture
from test_torch_colmap import CAMERA_FIELDS
from test_torch_raster_bwd import assert_grad_close
from test_torch_smplx import SMPL_FIELDS, write_dna_capture, write_smplx_npz
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"


def annots_of(main):
    return main.replace("main", "annotations").split(".")[0] + "_annots.smc"


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A 3-frame capture, every frame decodable (128x128)."""
    return write_dna_capture(str(tmp_path_factory.mktemp("dna3")))


def test_smc_reader_contract(tmp_path):
    main = _write_smc_fixture(str(tmp_path), n_frames=4)
    r = SMCReader(annots_of(main))
    cal = r.get_Calibration(26)
    assert cal["K"].shape == (3, 3) and cal["RT"].shape == (4, 4)
    sp = r.get_SMPLx(2)
    assert sp["fullpose"].shape == (165,)
    assert sp["betas"].shape == (10,) and sp["expression"].shape == (10,)
    mask = r.get_mask(26, 0)
    assert mask.shape == (64, 64) and mask.max() == 255
    r.release()
    m = SMCReader(main)
    assert m.get_img("Camera_5mp", 26, "color", 0).shape == (64, 64, 3)
    assert m.get_mask(26) is None  # the main file has no Mask group
    m.release()


def test_smc_reader_matches_moss_tpu(capture):
    for path in (capture, annots_of(capture)):
        r, jr = SMCReader(path), JSMCReader(path)
        try:
            assert r.actor_info == jr.actor_info
            if path == capture:
                for frame in range(3):
                    np.testing.assert_array_equal(r.get_img("Camera_5mp", 24, "color", frame),
                                                  jr.get_img("Camera_5mp", 24, "color", frame))
                continue
            for view in (24, 26):
                cal, jcal = r.get_Calibration(view), jr.get_Calibration(view)
                assert sorted(cal) == sorted(jcal)
                for k in cal:
                    np.testing.assert_array_equal(cal[k], jcal[k], err_msg=k)
                for frame in range(3):
                    np.testing.assert_array_equal(r.get_mask(view, frame),
                                                  jr.get_mask(view, frame))
            for frame in (None, 1):
                sx, jsx = r.get_SMPLx(frame), jr.get_SMPLx(frame)
                assert sorted(sx) == sorted(jsx)
                for k in sx:
                    np.testing.assert_array_equal(sx[k], jsx[k], err_msg=k)
        finally:
            r.release()
            jr.release()


def assert_same_specs(specs, jspecs):
    assert len(specs) == len(jspecs) > 0
    for s, js in zip(specs, jspecs):
        for f in ("main_smc_path", "annot_smc_path", "camera_id", "frame_id", "image_scaling",
                  "white_background"):
            assert getattr(s, f) == getattr(js, f), f
        assert sorted(s.smpl_param) == sorted(js.smpl_param)
        for k, v in s.smpl_param.items():
            assert v.dtype == js.smpl_param[k].dtype
            np.testing.assert_array_equal(v, js.smpl_param[k], err_msg=k)
        np.testing.assert_allclose(s.world_bound, js.world_bound, rtol=0, atol=1e-6)


def assert_same_scene(scene, jscene):
    assert scene.smpl.parents == jscene.smpl.parents and scene.smpl.num_joints == 55
    for f in SMPL_FIELDS:
        np.testing.assert_array_equal(getattr(scene.smpl, f).numpy(),
                                      np.asarray(getattr(jscene.smpl, f)), err_msg=f)
    for k in ("poses", "shapes", "R", "Th"):
        np.testing.assert_array_equal(scene.big_pose_params[k].numpy(),
                                      np.asarray(jscene.big_pose_params[k]), err_msg=k)
    np.testing.assert_allclose(scene.big_pose_vertices.numpy(),
                               np.asarray(jscene.big_pose_vertices), atol=1e-5)


@pytest.fixture(scope="module")
def long_capture(tmp_path_factory):
    """A 100-frame capture (frame 0 decodable): the full splits."""
    return _write_smc_fixture(str(tmp_path_factory.mktemp("dna100")), n_frames=100)


@pytest.mark.parametrize("split", ["train", "test"])
def test_read_dna_rendering_matches_moss_tpu(long_capture, split):
    scene, specs = dna.read_dna_rendering(long_capture, split=split, device=CPU)
    jscene, jspecs = jdna.read_dna_rendering(long_capture, split=split)
    assert_same_specs(specs, jspecs)
    assert_same_scene(scene, jscene)
    if split == "train":
        assert len(specs) == 100 and {s.camera_id for s in specs} == {26}
        assert [s.frame_id for s in specs] == list(range(100))
    else:
        assert len(specs) == 80 and [s.camera_id for s in specs[:4]] == [24, 25, 27, 28]
        assert sorted({s.frame_id for s in specs}) == list(range(0, 100, 5))


def test_short_capture_clamps_and_reads_the_asset(capture, tmp_path):
    from moss_tpu.models import smpl as JS

    asset = write_smplx_npz(str(tmp_path / "SMPLX_NEUTRAL.npz"), JS.synthetic_smplx(n_verts=500))
    for split, n in (("train", 3), ("test", 4)):
        scene, specs = dna.read_dna_rendering(capture, split=split, smplx_path=asset, device=CPU)
        jscene, jspecs = jdna.read_dna_rendering(capture, split=split, smplx_path=asset)
        assert len(specs) == n
        assert_same_specs(specs, jspecs)
        assert_same_scene(scene, jscene)
        assert scene.smpl.v_template.shape == (500, 3)


def assert_same_frame(frame, jframe):
    for f in ("image", "bkgd_mask", "bound_mask", "poses", "shapes", "R", "Th"):
        a, b = getattr(frame, f).numpy(), np.asarray(getattr(jframe, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_allclose(frame.pose_rotmats.numpy(), np.asarray(jframe.pose_rotmats),
                               rtol=0, atol=1e-6)
    for f in CAMERA_FIELDS:
        np.testing.assert_allclose(getattr(frame.camera, f).numpy(),
                                   np.asarray(getattr(jframe.camera, f)), rtol=1e-6, atol=1e-6)
    assert (frame.camera.height, frame.camera.width) == (jframe.camera.height,
                                                        jframe.camera.width)
    assert (frame.crop_y0, frame.crop_x0, frame.pose_id) == (
        int(jframe.crop_y0), int(jframe.crop_x0), int(jframe.pose_id))


@pytest.mark.parametrize("white", [False, True], ids=["black", "white"])
@pytest.mark.parametrize("crop", [None, (24, 40)], ids=["full", "crop"])
def test_frame_matches_moss_tpu(capture, white, crop):
    for split in ("train", "test"):
        _, specs = dna.read_dna_rendering(capture, split=split, white_background=white,
                                          device=CPU)
        _, jspecs = jdna.read_dna_rendering(capture, split=split, white_background=white)
        for s, js in list(zip(specs, jspecs))[:2]:
            frame = s.load(crop, device=CPU)
            assert_same_frame(frame, js.load(crop))
            assert frame.image.shape == (64, 64, 3) and frame.poses.shape == (1, 165)
            assert frame.shapes.shape == (1, 20) and frame.pose_rotmats.shape == (54, 3, 3)
            assert float(frame.bound_mask.sum()) > 0
            # filled before the INTER_AREA resize: all but the mask's rim
            outside = frame.bkgd_mask == 0
            assert float((frame.image[outside] == float(white)).float().mean()) > 0.8


def test_dna_frame_trains_one_step(capture):
    jcfg = JConfig(model=JModelConfig(sh_degree=1, capacity=256, n_init_points=200,
                                      smpl_type="smplx", motion_offset=False))
    jscene, jspecs = jdna.read_dna_rendering(capture, split="train")
    jframe = jspecs[1].load((32, 32))
    jparams, jgstate, jmlps = jax_init(jscene, jcfg, jax.random.PRNGKey(0))
    assert jmlps is None
    lp = lpips_jax.init_random(3407)
    raster = functools.partial(jax_rasterize_reference, tile_h=16, tile_w=16)
    init_fn, step_fn = jax_make_train_step(jscene, jcfg, raster, lp, 32, 32)
    p = {"gauss": jparams}
    jts1, jlogs = step_fn(JTrainState(p, init_fn(p), jgstate, jnp.int32(0)), jframe, 1)

    cfg = convert.config_from_jax(jcfg)
    assert cfg.model.smpl_type == "smplx"
    scene, specs = dna.read_dna_rendering(capture, split="train", device=CPU)
    frame = specs[1].load((32, 32), device=CPU)
    params, gstate, mlps = init_gaussians_and_mlps(scene, cfg, device=CPU)
    assert mlps is None
    np.testing.assert_allclose(params.xyz.numpy(), np.asarray(jparams.xyz), atol=1e-6)
    np.testing.assert_array_equal(gstate.valid.numpy(), np.asarray(jgstate.valid))
    init, step = make_train_step(scene, cfg, None, convert.lpips_params_from_jax(lp, CPU), 32, 32,
                                 device=CPU)
    state = {"gauss": params, "mlps": None}
    ts0 = TrainState(state, init(state), gstate, 0)
    _, _, _, grads, _ = step.grads(ts0, frame, 1)
    ts1, logs = step(ts0, frame, 1)

    assert np.isfinite(float(logs["loss"])) and bool(torch.isfinite(params.xyz).all())
    for key in ("l1", "mask", "ssim", "s3im"):
        np.testing.assert_allclose(float(logs[key]), float(jlogs[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    assert float(logs["nll"]) == 0.0
    ref = convert.adam_states_from_jax(jts1.opt_state, CPU)
    for g in ("xyz", "f_dc", "opacity", "scaling", "rotation"):
        assert_grad_close(grads[g][g].numpy(), ref[g].mu[g].numpy() / (1 - optim.B1), g)
