"""moss_torch's ops and models against moss_tpu's, on the CPU in f32.

Inputs are drawn with numpy and fed to both packages. Integer outputs
(radius, radius_xy, valid, knn ids) must be equal; float outputs agree to
atol 1e-5 relative to their scale (the two frameworks round f32 expressions
in different orders, a few ulp apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.models import gaussians as JG
from moss_tpu.models import deform as jdeform
from moss_tpu.models import lbs_field as jlbs
from moss_tpu.models import pose_refine as jpose
from moss_tpu.models import smpl as jsmpl
from moss_tpu.ops import knn as jknn
from moss_tpu.ops import projection as jproj
from moss_tpu.ops import sh as jsh
from moss_tpu.ops import transforms as jtf
from moss_tpu.config import ModelConfig as JModelConfig
from moss_tpu.render.camera import Camera as JCamera
from moss_torch import convert
from moss_torch.config import ModelConfig
from moss_torch.models import deform, gaussians as G, smpl
from moss_torch.ops import knn, projection, sh
from moss_torch.ops import transforms as tf
from moss_torch.render.camera import Camera

CPU = "cpu"


def close(a, b, atol=1e-5):
    """|a - b| <= atol * max(1, max|b|), elementwise."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=atol * scale)


def t(x):
    return torch.as_tensor(np.array(x))


def test_model_config_copy_keeps_moss_tpu_defaults():
    ours = dataclasses.asdict(ModelConfig())
    theirs = dataclasses.asdict(JModelConfig())
    assert ours == {k: theirs[k] for k in ours}


def test_transforms(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    v = rng.normal(0, 0.7, size=(64, 3)).astype(np.float32)
    s = rng.uniform(0.01, 0.2, size=(64, 3)).astype(np.float32)
    T = rng.normal(size=(64, 3, 3)).astype(np.float32)
    x = rng.uniform(0.01, 0.99, size=(64,)).astype(np.float32)
    close(tf.inverse_sigmoid(t(x)), jtf.inverse_sigmoid(jnp.asarray(x)))
    close(tf.quat_normalize(t(q)), jtf.quat_normalize(jnp.asarray(q)))
    close(tf.quat_to_rotmat(t(q)), jtf.quat_to_rotmat(jnp.asarray(q)))
    close(tf.rodrigues(t(v)), jtf.rodrigues(jnp.asarray(v)))
    close(tf.rodrigues_guarded(t(v)), jtf.rodrigues_guarded(jnp.asarray(v)))
    close(tf.build_covariance(t(s), t(q)), jtf.build_covariance(jnp.asarray(s), jnp.asarray(q)))
    close(tf.build_covariance(t(s), t(q), t(T), 1.3),
          jtf.build_covariance(jnp.asarray(s), jnp.asarray(q), jnp.asarray(T), 1.3))
    c6 = rng.normal(size=(64, 6)).astype(np.float32)
    close(tf.fold_cov6(t(c6), t(T)), jtf.fold_cov6(jnp.asarray(c6), jnp.asarray(T)))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh(rng, deg):
    coeffs = rng.normal(0, 0.3, size=(50, 25, 3)).astype(np.float32)
    means = rng.normal(size=(50, 3)).astype(np.float32)
    campos = np.array([0.1, -0.2, -2.5], np.float32)
    dirs = means / np.linalg.norm(means, axis=-1, keepdims=True)
    close(sh.eval_sh(deg, t(coeffs), t(dirs)), jsh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs)))
    close(sh.sh_to_color(deg, t(coeffs), t(means), t(campos)),
          jsh.sh_to_color(deg, jnp.asarray(coeffs), jnp.asarray(means), jnp.asarray(campos)))
    rgb = rng.uniform(size=(5, 3)).astype(np.float32)
    close(sh.rgb_to_sh(t(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))


def test_camera(rng):
    K = np.array([[70.0, 0.3, 31.0], [0, 72.0, 33.5], [0, 0, 1.0]])
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    T = rng.normal(size=3)
    a = Camera.from_KRT(K, R, T, 64, 80, device=CPU)
    b = JCamera.from_KRT(K, R, T, 64, 80)
    for f in ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))
    assert (a.height, a.width) == (b.height, b.width)
    close(a.focal_x, b.focal_x)  # width / (2 tan_fovx): one f32 division, rounded alike or 1 ulp apart


def test_knn(rng):
    q = rng.normal(size=(700, 3)).astype(np.float32)
    r = rng.normal(size=(300, 3)).astype(np.float32)
    valid = rng.uniform(size=300) > 0.2
    d, i = knn.knn(t(q), t(r), k=1, chunk=256)
    jd, ji = jknn.knn(jnp.asarray(q), jnp.asarray(r), k=1, chunk=256)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    close(d, jd)
    d, i = knn.knn(t(q), t(r), k=1, ref_valid=t(valid))
    np.testing.assert_array_equal(
        i.numpy(), np.asarray(jknn.knn(jnp.asarray(q), jnp.asarray(r), k=1,
                                       ref_valid=jnp.asarray(valid))[1]))
    close(knn.mean_knn_dist2(t(q)), jknn.mean_knn_dist2(jnp.asarray(q)))


def projected_inputs(rng, n=300):
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(-0.5, 3.0, n)], -1).astype(np.float32)
    cov6 = np.asarray(jtf.build_covariance(
        jnp.asarray(rng.uniform(0.005, 0.15, (n, 3)).astype(np.float32)),
        jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32))))
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opacity = rng.uniform(0.001, 0.99, n).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    return means, cov6, colors, opacity, mask


def test_preprocess(rng):
    K = np.array([[90.0, 0, 40.0], [0, 90.0, 30.0], [0, 0, 1.0]])
    R = np.eye(3)
    args = projected_inputs(rng)
    out = projection.preprocess(*map(t, args[:4]), Camera.from_KRT(K, R, np.zeros(3), 60, 80, device=CPU),
                                valid_mask=t(args[4]))
    ref = jproj.preprocess(*map(jnp.asarray, args[:4]), JCamera.from_KRT(K, R, np.zeros(3), 60, 80),
                           valid_mask=jnp.asarray(args[4]))
    for f in ("radius", "radius_xy", "valid"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    v = out.valid.numpy()
    assert 0 < v.sum() < v.size  # both culled and live splats exercised
    for f in ("mean2d", "depth", "conic", "color", "opacity"):
        close(getattr(out, f).numpy()[v], np.asarray(getattr(ref, f))[v])


def test_synthetic_smpl_and_lbs(rng):
    m = smpl.synthetic_smpl(n_verts=400, device=CPU)
    jm = jsmpl.synthetic_smpl(n_verts=400)
    for f in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights", "faces"):
        np.testing.assert_array_equal(getattr(m, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    big, jbig = smpl.big_pose_params(device=CPU), jsmpl.big_pose_params()
    for k in big:
        np.testing.assert_array_equal(big[k].numpy(), np.asarray(jbig[k]))
    poses = rng.normal(0, 0.3, 72).astype(np.float32)
    shapes = rng.normal(0, 1, 10).astype(np.float32)
    v, j = smpl.lbs_vertices(m, t(poses), t(shapes))
    jv, jj = jsmpl.lbs_vertices(jm, jnp.asarray(poses), jnp.asarray(shapes))
    close(v, jv)
    close(j, jj)
    params = {"poses": t(poses)[None], "shapes": t(shapes)[None], "R": torch.eye(3),
              "Th": torch.zeros(1, 3)}
    jparams = {k: jnp.asarray(x.numpy()) for k, x in params.items()}
    Rs = rng.normal(0, 0.1, (1, 23, 3)).astype(np.float32)
    A = smpl.transform_params(m, params, correct_Rs=tf.rodrigues(t(Rs)))[0]
    jA = jsmpl.transform_params(jm, jparams, correct_Rs=jtf.rodrigues(jnp.asarray(Rs)))[0]
    close(A, jA)


def test_inv3x3_sign_preserving_clamp():
    M = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0], [0, 0, -1e-14]]])
    inv = deform.inv3x3(M)
    jinv = jdeform.inv3x3(jnp.asarray(M.numpy()))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert inv[0, 2, 2] < 0  # the clamp keeps the sign, it does not mirror


DEFORM_FIELDS = ("smpl_pts", "world_pts", "bweights", "transforms", "translation")


def test_deform_and_mlps(rng):
    """coarse_deform_c2source with both correction MLPs, weights carried
    across by convert.py, on the same synthetic rig."""
    jm = jsmpl.synthetic_smpl(n_verts=500)
    jbig = jsmpl.big_pose_params()
    jv_big = jsmpl.lbs_vertices(jm, jbig["poses"][0], jbig["shapes"][0])[0]
    scene = convert.scene_from_jax(jm, jbig, jv_big, device=CPU)
    close(scene.big_pose_vertices, jv_big)
    jmlps = {"pose": jpose.init(jax.random.PRNGKey(1)), "lbs": jlbs.init(jax.random.PRNGKey(2))}
    # heads at init are U(+-1e-5): widen them so the ancestor gather matters
    jmlps["pose"]["heads_w"] = jmlps["pose"]["heads_w"] * 1e4
    mlps = convert.mlps_from_jax(jmlps, device=CPU)

    pts = np.asarray(jv_big)[rng.integers(0, 500, 800)] + rng.normal(0, 0.02, (800, 3))
    pts = pts.astype(np.float32)
    poses = np.zeros((1, 72), np.float32)
    poses[0, 3:] = rng.normal(0, 0.3, 69)
    params = {"poses": t(poses), "shapes": t(rng.normal(0, 0.5, (1, 10)).astype(np.float32)),
              "R": t(jtf.quat_to_rotmat(jnp.asarray([[0.9, 0.1, -0.2, 0.3]]))[0]),
              "Th": t(np.array([[0.1, -0.3, 0.5]], np.float32))}
    jparams = {k: jnp.asarray(x.numpy()) for k, x in params.items()}

    pose_out = mlps["pose"](params["poses"])
    jpose_out = jpose.apply(jmlps["pose"], jparams["poses"])
    close(pose_out["joint_feat"].detach(), jpose_out["joint_feat"])
    close(pose_out["Rs"].detach(), jpose_out["Rs"])
    delta = mlps["lbs"](t(pts), pose_out["Rs"])
    jdelta = jlbs.apply(jmlps["lbs"], jnp.asarray(pts), jpose_out["Rs"])
    close(delta.detach(), jdelta)

    with torch.no_grad():
        out = deform.coarse_deform_c2source(
            scene.smpl, t(pts), params, scene.big_pose_params, scene.big_pose_vertices,
            lbs_weight_delta=delta, correct_Rs=pose_out["Rs"])
    jout = jdeform.coarse_deform_c2source(
        jm, jnp.asarray(pts), jparams, jbig, jv_big,
        lbs_weight_delta=jdelta, correct_Rs=jpose_out["Rs"])
    for f in DEFORM_FIELDS:
        close(getattr(out, f), getattr(jout, f))
    Tr, tr = out.transforms, out.translation
    close(deform.apply_cached_transform(t(pts), Tr, tr), jdeform.apply_cached_transform(
        jnp.asarray(pts), jnp.asarray(Tr.numpy()), jnp.asarray(tr.numpy())))


def test_create_from_points_and_compact(rng):
    pts = rng.normal(0, 0.3, (200, 3)).astype(np.float32)
    cols = rng.uniform(size=(200, 3)).astype(np.float32)
    p, valid = G.create_from_points(pts, cols, capacity=256, sh_degree=3, device=CPU)
    jp, js = JG.create_from_points(pts, cols, capacity=256, sh_degree=3)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(js.valid))
    for f in G.FIELDS:
        close(getattr(p, f), getattr(jp, f))
    close(G.get_covariance(p), JG.get_covariance(jp))
    close(G.get_opacity(p), JG.get_opacity(jp))
    close(G.get_features(p), JG.get_features(jp))

    valid = valid.clone()
    valid[::3] = False
    pc, vc = G.compact(p, valid)
    assert pc.capacity == int(valid.sum()) and bool(vc.all())
    np.testing.assert_array_equal(pc.xyz.numpy(), p.xyz.numpy()[valid.numpy()])
