"""The serving slice as a whole: moss_torch's render_frame against moss_tpu's.

moss_tpu builds the scene, the cloud and the MLPs; a chkpnt.npz written by
moss_tpu's checkpoint code carries the cloud and the MLPs across
(moss_torch.convert.load_jax_checkpoint), the scene goes through
convert.scene_from_jax. Both sides rasterize with the plain blend at 16x16
tiles, the port through its default rasterizer (rasterize_cuda takes the plain
version for CPU tensors).

Images use the kernel-vs-oracle image rule (tests/test_rasterize_tpu.py:50-59).
radii and visibility_filter are integer/boolean and must be equal. The deform
outputs (transforms, translation, means3D, lbs_weights, pose_out Rs) agree to
atol 1e-5 relative to scale: both chains run the same f32 arithmetic, but the
frameworks round matmuls and transcendental functions a few ulp apart.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.data.synthetic import make_camera as jax_make_camera
from moss_tpu.data.synthetic import make_scene as jax_make_scene
from moss_tpu.data.synthetic import random_pose
from moss_tpu.models import gaussians as JG
from moss_tpu.models import lbs_field as jlbs
from moss_tpu.models import pose_refine as jpose
from moss_tpu.ops.rasterize_ref import rasterize_reference as jax_rasterize_reference
from moss_tpu.render.render import render_frame as jax_render_frame
from moss_tpu.train.checkpoint import save_checkpoint
from moss_tpu.train.train_step import TrainState
from moss_torch import convert
from moss_torch.data.synthetic import make_camera
from moss_torch.models import gaussians as G
from moss_torch.ops import rasterize_cuda as rc
from moss_torch.render.render import render_frame
from test_rasterize_tpu import assert_images_match

H = W = 64
CPU = torch.device("cpu")
jax_raster = functools.partial(jax_rasterize_reference, tile_h=16, tile_w=16)


def close(a, b, atol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=atol * max(1.0, float(np.abs(b).max())))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(11)
    jscene = jax_make_scene(n_verts=300)
    verts = np.asarray(jscene.big_pose_vertices)
    n, cap = 600, 640
    pts = verts[rng.integers(0, verts.shape[0], n)] + rng.normal(0, 0.01, (n, 3))
    p, st = JG.create_from_points(pts.astype(np.float32), rng.uniform(size=(n, 3)), cap)
    live = np.arange(cap) < n
    op = rng.uniform(0.3, 0.95, (cap, 1)).astype(np.float32)
    p = JG.GaussianParams(
        xyz=p.xyz, f_dc=p.f_dc,
        f_rest=jnp.asarray(rng.normal(0, 0.05, p.f_rest.shape).astype(np.float32) * live[:, None, None]),
        scaling=jnp.minimum(p.scaling, np.log(0.03)),
        rotation=jnp.asarray(rng.normal(size=(cap, 4)).astype(np.float32)),
        opacity=jnp.where(live[:, None], jnp.log(op / (1 - op)), p.opacity),
    )
    mlps = {"pose": jpose.init(jax.random.PRNGKey(3)), "lbs": jlbs.init(jax.random.PRNGKey(4))}
    mlps["pose"]["heads_w"] = mlps["pose"]["heads_w"] * 1e4
    path = str(tmp_path_factory.mktemp("ckpt") / "chkpnt100.npz")
    save_checkpoint(path, TrainState({"gauss": p, "mlps": mlps}, None, st, jnp.int32(100)))
    poses = random_pose(rng)
    smpl_params = {"poses": poses[None], "shapes": np.zeros((1, 10), np.float32),
                   "R": np.eye(3, dtype=np.float32), "Th": np.zeros((1, 3), np.float32)}
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    return dict(jscene=jscene, jparams=p, jvalid=st.valid, jmlps=mlps, path=path,
                smpl_params=smpl_params, bg=bg, jcam=jax_make_camera(H, W))


def port_inputs(s):
    params, valid, mlps = convert.load_jax_checkpoint(s["path"], device="cpu")
    scene = convert.scene_from_jax(s["jscene"].smpl, s["jscene"].big_pose_params,
                                   s["jscene"].big_pose_vertices, device="cpu")
    sp = {k: torch.as_tensor(v) for k, v in s["smpl_params"].items()}
    return params, valid, mlps, scene, sp, make_camera(H, W, device="cpu"), torch.as_tensor(s["bg"])


def jax_render(s, mlps=True, **kw):
    sp = {k: jnp.asarray(v) for k, v in s["smpl_params"].items()}
    return jax_render_frame(s["jparams"], s["jvalid"], s["jmlps"] if mlps else None, s["jscene"],
                            sp, s["jcam"], jnp.asarray(s["bg"]), 3, rasterize_fn=jax_raster, **kw)


def assert_frames_match(out, ref, keep=None):
    """Images by the image rule; radii / visibility exactly (on slots `keep`)."""
    for ours, theirs in (("render", "render"), ("render_alpha", "render_alpha"),
                         ("final_T", "final_T")):
        assert_images_match(out[ours].numpy(), np.asarray(ref[theirs]))
    assert_images_match(out["render_depth"].numpy(), np.asarray(ref["render_depth"]), atol=1e-4)
    keep = slice(None) if keep is None else keep
    for key in ("radii", "visibility_filter"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key])[keep], err_msg=key)
    assert int(out["overflow"]) == 0
    assert out["visibility_filter"].sum() > 100  # the frame shows the body


def test_checkpoint_round_trip(setup):
    params, valid, mlps, *_ = port_inputs(setup)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(setup["jvalid"]))
    for f in G.FIELDS:
        np.testing.assert_array_equal(getattr(params, f).numpy(), np.asarray(getattr(setup["jparams"], f)))
    np.testing.assert_array_equal(mlps["pose"].trunk1.weight.detach().numpy(),
                                  np.asarray(setup["jmlps"]["pose"]["trunk1"]["w"]).T)
    np.testing.assert_array_equal(mlps["lbs"].l3.bias.detach().numpy(),
                                  np.asarray(setup["jmlps"]["lbs"]["l3"]["b"]))


def test_full_path_matches_jax(setup):
    params, valid, mlps, scene, sp, cam, bg = port_inputs(setup)
    seen = []

    def raster(proj, *a):
        seen.append(proj)
        return rc.rasterize_cuda(proj, *a)

    before = rc.launches
    with torch.inference_mode():
        out = render_frame(params, valid, mlps, scene, sp, cam, bg, 3, rasterize_fn=raster,
                           device="cpu")
    ref = jax_render(setup)
    assert rc.launches == before  # CPU tensors take the plain blend
    assert_frames_match(out, ref)
    for key in ("transforms", "translation", "means3D", "lbs_weights"):
        close(out[key][valid], np.asarray(ref[key])[np.asarray(setup["jvalid"])])
    close(out["pose_out"]["Rs"], ref["pose_out"]["Rs"])
    # the tensors the CUDA kernel would read are laid out as it indexes them
    rc.check_kernel_inputs(seen[0], CPU)


def test_cached_path_after_compact_matches_jax(setup):
    params, valid, mlps, scene, sp, cam, bg = port_inputs(setup)
    jfull = jax_render(setup)
    ref = jax_render(setup, mlps=False, cached_transforms=jfull["transforms"],
                     cached_translation=jfull["translation"])
    with torch.inference_mode():
        pc, vc = G.compact(params, valid)
        cache = render_frame(pc, vc, mlps, scene, sp, cam, bg, 3, device="cpu")
        out = render_frame(pc, vc, None, scene, sp, cam, bg, 3, device="cpu",
                           cached_transforms=cache["transforms"],
                           cached_translation=cache["translation"])
    keep = np.asarray(setup["jvalid"])
    assert_frames_match(out, ref, keep)
    close(out["means3D"], np.asarray(ref["means3D"])[keep])


@pytest.mark.parametrize("path", ["no_mlp", "static_scene"])
def test_other_paths_match_jax(setup, path):
    params, valid, mlps, scene, sp, cam, bg = port_inputs(setup)
    kw = {"motion_offset": False} if path == "no_mlp" else {"static_scene": True}
    with torch.inference_mode():
        out = render_frame(params, valid, None, scene, sp, cam, bg, 3, device="cpu", **kw)
    ref = jax_render(setup, mlps=False, **kw)
    assert_frames_match(out, ref)
    if path == "no_mlp":
        close(out["lbs_weights"][valid], np.asarray(ref["lbs_weights"])[np.asarray(setup["jvalid"])])
