"""The port's readers and loaders against moss_tpu's, on the CPU.

  * ZJU-MoCap-Refine on tests/test_readers.py's fixture (64x64, scaled to
    32x32) and MonoCap on fixtures written here in the layout
    moss_tpu/data/readers.py:321-394 reads (olek_images0812's soft masks and
    view numbers, and the generic layout of lan_images620): the split lists,
    the cameras, the SMPL params and target rotmats, the big-pose scene,
    bound rects and autosize_crop against moss_tpu's, then decoded frames:
    images, masks and bound masks exact, the rest within 1e-6 relative.
    moss_tpu's MonoCap reader poses the body once per view through the eager
    lbs_vertices; here it runs that same function under jax.jit (170 eager
    calls take 15 s of the test split's 18).
  * cameras.json: the same JSON as moss_tpu's dump_cameras_json.
  * load_smpl_pickle on a pickle of synthetic_smpl's arrays with a
    scipy-sparse J_regressor and a uint32 kintree_table (root 2^32 - 1),
    against moss_tpu's loader, and the posed vertices on it.
  * load_json reads a cfg.json that moss_tpu's save_json wrote (SMPL,
    SMPL-X and static configs), its rasterizer "reference" kept, and
    rejects any unknown key; config_from_jax agrees on the model.
  * detect_and_read sends a .smc path to the DNA-Rendering reader.
  * iter_frames, the counterparts of tests/test_prefetch.py's: loaded frames
    pass through, specs decode in order onto the given device, an early
    break stops the decoding, a decode error reaches the consumer.
"""
import dataclasses
import json
import os
import pickle
import time

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import scipy.sparse
import torch

from moss_tpu import config as jconfig
from moss_tpu.data import readers as jreaders
from moss_tpu.models import smpl as jsmpl
from moss_tpu.render.camera import dump_cameras_json as jax_dump_cameras_json
from moss_torch import config, convert
from moss_torch.data import readers
from moss_torch.data.prefetch import iter_frames
from moss_torch.models import smpl
from moss_torch.render.camera import dump_cameras_json
from test_readers import _write_zju_fixture
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"
SPEC_ARRAYS = ("K", "D", "R_w2c", "T_w2c")
SPEC_SCALARS = ("image_path", "mask_path", "pose_id", "image_scaling", "white_background",
                "mask_style", "mask_multiply")


@pytest.fixture(autouse=True, scope="module")
def _jit_moss_tpu_lbs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreaders.S, "lbs_vertices", jax.jit(jsmpl.lbs_vertices))
        yield


def close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * max(1.0, float(np.abs(b).max())))


def write_monocap_fixture(root, H=48, W=64):
    """The MonoCap layout read_monocap reads: annots.npy (cams K, D, R, T per
    view), images/<view>/<pose>.jpg, mask/<view>/<pose>.(png|jpg) and
    params/<pose>.npy, for the views and poses the two splits use."""
    olek = "olek_images0812" in root
    rng = np.random.default_rng(1)
    train_view, test_view, start = ([44], [45], 1) if olek else ([0], list(range(1, 11)), 0)
    n_views = max(train_view + test_view) + 1
    K = np.array([[55.0, 0, W / 2], [0, 55.0, H / 2], [0, 0, 1]])
    cams = {"K": [K * [[1 + 0.01 * v], [1 + 0.01 * v], [1]] for v in range(n_views)],
            "D": [np.array([0.01, -0.01, 0.0, 0.0, 0.0]) for _ in range(n_views)],
            "R": [np.eye(3) for _ in range(n_views)],
            "T": [np.array([[0.05 * (v % 3)], [0.0], [2500.0]]) for v in range(n_views)]}
    needed = [(v, p) for v in train_view for p in range(start, start + 500, 5)]
    needed += [(v, p) for v in test_view for p in range(start, start + 510, 30)]
    os.makedirs(os.path.join(root, "params"), exist_ok=True)
    for v, p in needed:
        vz, pz = (str(v).zfill(2), str(p).zfill(6)) if olek else (str(v).zfill(2), str(p).zfill(4))
        for d in ("images", "mask"):
            os.makedirs(os.path.join(root, d, vz), exist_ok=True)
        imageio.imwrite(os.path.join(root, "images", vz, pz + ".jpg"),
                        rng.uniform(0, 255, (H, W, 3)).astype(np.uint8))
        msk = np.zeros((H, W), np.uint8)
        msk[10:40, 16:48] = 255
        msk[20:30, 20:30] = 128  # soft edge values
        imageio.imwrite(os.path.join(root, "mask", vz, pz + ".png"), msk)
        params = os.path.join(root, "params", f"{p}.npy")
        if not os.path.exists(params):
            np.save(params, {"poses": rng.normal(0, 0.1, (1, 72)).astype(np.float32),
                             "shapes": rng.normal(0, 0.5, (1, 10)).astype(np.float32),
                             "Rh": rng.normal(0, 0.1, (1, 3)).astype(np.float64),
                             "Th": rng.normal(0, 0.1, (1, 3)).astype(np.float32)})
    np.save(os.path.join(root, "annots.npy"), {"cams": cams})


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    zju = str(base / "zju" / "my_377")
    _write_zju_fixture(zju)
    olek = str(base / "monocap" / "olek_images0812")
    write_monocap_fixture(olek)
    lan = str(base / "lan_images620")
    write_monocap_fixture(lan)
    return {"zju": zju, "olek": olek, "lan": lan}


def assert_camera_equal(cam, jcam):
    for f in ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy"):
        np.testing.assert_array_equal(getattr(cam, f).numpy(), np.asarray(getattr(jcam, f)),
                                      err_msg=f)
    assert (cam.height, cam.width) == (jcam.height, jcam.width)


@pytest.mark.parametrize("name", ["zju", "olek", "lan"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_reader_matches_moss_tpu(datasets, name, split):
    path = datasets[name]
    scene, specs = readers.detect_and_read(path, split, device=CPU)
    jscene, jspecs = jreaders.detect_and_read(path, split)
    assert len(specs) == len(jspecs) == {("zju", "train"): 100, ("zju", "test"): 68,
                                         ("olek", "train"): 100, ("olek", "test"): 17,
                                         ("lan", "train"): 100, ("lan", "test"): 170}[name, split]
    close(scene.big_pose_vertices.numpy(), jscene.big_pose_vertices)
    for s, js in zip(specs, jspecs):
        for f in SPEC_SCALARS:
            assert getattr(s, f) == getattr(js, f), f
        for f in SPEC_ARRAYS:
            np.testing.assert_array_equal(getattr(s, f), getattr(js, f), err_msg=f)
        for k in ("poses", "shapes", "R", "Th"):
            np.testing.assert_array_equal(s.smpl_param[k], js.smpl_param[k], err_msg=k)
        close(s.world_bound, js.world_bound)
    hw = specs[0].image_size()
    assert hw == jspecs[0].image_size()
    assert [s.bound_rect_hw(*hw) for s in specs] == [s.bound_rect_hw(*hw) for s in jspecs]
    assert readers.autosize_crop(specs, bucket=16, min_crop=16) == \
        jreaders.autosize_crop(jspecs, bucket=16, min_crop=16)
    for s, js in zip(specs, jspecs):
        assert_camera_equal(s.make_camera(hw, device=CPU), js.make_camera(hw))

    crop = readers.autosize_crop(specs, bucket=16, min_crop=16)
    for s, js in list(zip(specs, jspecs))[::7]:
        fr, jf = s.load(crop, CPU), js.load(crop)
        for f in ("image", "bkgd_mask", "bound_mask", "poses", "shapes", "R", "Th"):
            np.testing.assert_array_equal(getattr(fr, f).numpy(), np.asarray(getattr(jf, f)),
                                          err_msg=f)
        close(fr.pose_rotmats.numpy(), jf.pose_rotmats)
        assert (fr.crop_y0, fr.crop_x0, fr.pose_id) == \
            (int(jf.crop_y0), int(jf.crop_x0), int(jf.pose_id))
        assert_camera_equal(fr.camera, jf.camera)
        assert float(fr.bound_mask.sum()) > 0 and fr.image.device.type == "cpu"


def test_cameras_json_matches_moss_tpu(datasets, tmp_path):
    path = datasets["zju"]
    _, specs = readers.read_zju_mocap_refine(path, "test", device=CPU)
    _, jspecs = jreaders.read_zju_mocap_refine(path, "test")
    hw = specs[0].image_size()
    dump_cameras_json(str(tmp_path / "port.json"), [s.make_camera(hw, CPU) for s in specs])
    jax_dump_cameras_json(str(tmp_path / "jax.json"), [s.make_camera(hw) for s in jspecs])
    assert open(tmp_path / "port.json").read() == open(tmp_path / "jax.json").read()
    assert len(json.load(open(tmp_path / "port.json"))) == 68


def test_detect_and_read_refuses_dna_rendering(tmp_path):
    """Once a refusal, now the dispatch: detect_and_read sends a .smc path
    (and a path naming dna_rendering) to the DNA-Rendering reader, as
    moss_tpu's does (moss_tpu/data/readers.py:395-411)."""
    pytest.importorskip("h5py")
    from moss_torch.data.dna import DNAFrameSpec
    from test_smplx_dna import _write_smc_fixture

    main = _write_smc_fixture(str(tmp_path), n_frames=2)
    for split, views in (("train", [26, 26]), ("test", [24, 25, 27, 28])):
        scene, specs = readers.detect_and_read(main, split, device=CPU)
        _, jspecs = jreaders.detect_and_read(main, split)
        assert all(isinstance(s, DNAFrameSpec) for s in specs)
        assert [s.camera_id for s in specs] == [s.camera_id for s in jspecs] == views
        assert scene.smpl.num_joints == 55
    assert readers.READERS["dna_rendering"](main, "train", device=CPU)[1][1].frame_id == 1
    with pytest.raises(ValueError, match="cannot detect"):
        readers.detect_and_read("/data/subject.h5", device=CPU)


def test_load_smpl_pickle_matches_moss_tpu(tmp_path):
    model = jsmpl.synthetic_smpl(n_verts=500)
    kintree = np.stack([np.array([2**32 - 1] + list(model.parents[1:]), np.int64),
                        np.arange(len(model.parents))]).astype(np.uint32)
    raw = {"v_template": np.asarray(model.v_template, np.float64),
           "shapedirs": np.asarray(model.shapedirs, np.float64),
           "posedirs": np.asarray(model.posedirs, np.float64),
           "J_regressor": scipy.sparse.csc_matrix(np.asarray(model.J_regressor, np.float64)),
           "weights": np.asarray(model.weights, np.float64),
           "kintree_table": kintree, "f": np.asarray(model.faces).astype(np.uint32)}
    path = str(tmp_path / "SMPL_TEST.pkl")
    with open(path, "wb") as f:
        pickle.dump(raw, f, protocol=2)
    ours, theirs = smpl.load_smpl_pickle(path, device=CPU), jsmpl.load_smpl_pickle(path)
    assert ours.parents == theirs.parents == model.parents and ours.parents[0] == -1
    for f in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights", "faces"):
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(theirs, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)

    rng = np.random.default_rng(4)
    poses = np.zeros(72, np.float32)
    poses[3:] = rng.normal(0, 0.3, 69)
    shapes = rng.normal(0, 0.5, 10).astype(np.float32)
    v, j = smpl.lbs_vertices(ours, torch.as_tensor(poses), torch.as_tensor(shapes))
    jv, jj = jsmpl.lbs_vertices(theirs, poses, shapes)
    close(v.numpy(), jv)
    close(j.numpy(), jj)


def test_load_json_reads_moss_tpus_cfg(tmp_path):
    jcfg = dataclasses.replace(
        jconfig.zju_preset("386"), seed=7, model_path="out/my_386",
        model=jconfig.ModelConfig(capacity=512, sh_degree=2, white_background=True),
        optim=jconfig.OptimConfig(iterations=20, densify_from_iter=5),
        pipe=jconfig.PipelineConfig(rasterizer="reference", max_tiles_per_gaussian=8,
                                    test_iterations=(10, 20), save_iterations=(20,)))
    path = str(tmp_path / "cfg.json")
    jconfig.save_json(jcfg, path)
    cfg = config.load_json(path)
    assert cfg == dataclasses.replace(
        config.zju_preset("386"), seed=7, model_path="out/my_386",
        model=config.ModelConfig(capacity=512, sh_degree=2, white_background=True),
        optim=config.OptimConfig(iterations=20, densify_from_iter=5),
        pipe=config.PipelineConfig(rasterizer="reference", max_tiles_per_gaussian=8,
                                   test_iterations=(10, 20), save_iterations=(20,)))
    config.save_json(cfg, str(tmp_path / "port.json"))
    assert config.load_json(str(tmp_path / "port.json")) == cfg
    assert jconfig.load_json(str(tmp_path / "port.json")).model == jcfg.model
    assert jconfig.load_json(str(tmp_path / "port.json")).pipe == jcfg.pipe
    assert config.monocap_preset("lan").exp_name == jconfig.monocap_preset("lan").exp_name

    # an SMPL-X config (DNA-Rendering) and a static one (COLMAP/Blender)
    for model in (jconfig.ModelConfig(smpl_type="smplx", motion_offset=False),
                  jconfig.ModelConfig(static_scene=True, motion_offset=False)):
        jcfg2 = dataclasses.replace(jcfg, model=model)
        jconfig.save_json(jcfg2, path)
        cfg2 = config.load_json(path)
        assert dataclasses.asdict(cfg2.model) == dataclasses.asdict(model)
        assert convert.config_from_jax(jcfg2).model == cfg2.model

    raw = json.load(open(path))
    raw["model"]["tile_budget"] = 3
    json.dump(raw, open(path, "w"))
    with pytest.raises(TypeError, match="tile_budget"):
        config.load_json(path)


class LazySpec:
    """A FrameSpec stand-in: returns its object, counts decodes, records the device."""

    def __init__(self, frame, counter):
        self.frame, self.counter = frame, counter

    def load(self, crop_hw=None, device=None):
        self.counter.append(device)
        return self.frame


def test_iter_frames_passes_loaded_frames_through():
    items = [object(), object()]
    assert list(iter_frames(items)) == items


def test_iter_frames_decodes_in_order_onto_the_device():
    frames, counter = [object() for _ in range(3)], []
    out = list(iter_frames([LazySpec(f, counter) for f in frames], depth=1, device=CPU))
    assert out == frames and counter == [CPU] * 3


def test_iter_frames_early_break_stops_decoding():
    counter = []
    for i, _ in enumerate(iter_frames([LazySpec(object(), counter) for _ in range(50)], depth=1)):
        if i == 2:
            break
    time.sleep(0.5)  # time for the worker to misbehave if it would
    assert len(counter) <= 6  # 3 consumed and a bounded lookahead, not all 50


def test_iter_frames_raises_the_decode_error():
    class Boom:
        def load(self, crop_hw=None, device=None):
            raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(iter_frames([Boom()]))
