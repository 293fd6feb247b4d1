"""The public helpers of moss_tpu that nothing in it calls, ported for the
users who do, against moss_tpu's on the same numpy inputs on the CPU:
transforms quat_multiply, pack_cov3d, unpack_cov3d; sh sh_to_rgb; ssim
l1_loss, l2_loss; gaussians num_sh_coeffs; projection mark_visible;
rasterize_ref render_reference; fisher proper_svd3.

Tolerances: tests/test_torch_ops.py's 1e-5 of the value's scale for the
elementwise helpers and the SVD (its grads too, by tests/test_rasterize_tpu.py
:150's 5e-4 after scaling); visibility exact; render_reference's images by
tests/test_rasterize_tpu.py:50-59 (atol 3e-5, at most 2e-3 of the pixels as
termination flips, depth 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.models import gaussians as jG
from moss_tpu.ops import fisher as jfisher
from moss_tpu.ops import projection as jprojection
from moss_tpu.ops import rasterize_ref as jrasterize_ref
from moss_tpu.ops import sh as jsh
from moss_tpu.ops import ssim as jssim
from moss_tpu.ops import transforms as jtf
from moss_tpu.render.camera import Camera as JCamera
from moss_torch.models import gaussians as G
from moss_torch.ops import fisher, projection, rasterize_ref, sh, ssim
from moss_torch.ops import transforms as tf
from moss_torch.render.camera import Camera
from test_rasterize_tpu import assert_images_match, random_scene
from test_torch_ops import close
from _torch_threads import two_torch_threads  # noqa: F401

CPU = "cpu"


def _draw(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


# name: (port function, moss_tpu function, input shapes)
ELEMENTWISE = {
    "quat_multiply": (tf.quat_multiply, jtf.quat_multiply, [(7, 4), (7, 4)]),
    "quat_multiply_broadcast": (tf.quat_multiply, jtf.quat_multiply, [(5, 1, 4), (3, 4)]),
    "pack_cov3d": (tf.pack_cov3d, jtf.pack_cov3d, [(6, 2, 3, 3)]),
    "unpack_cov3d": (tf.unpack_cov3d, jtf.unpack_cov3d, [(9, 6)]),
    "sh_to_rgb": (sh.sh_to_rgb, jsh.sh_to_rgb, [(11, 1, 3)]),
    "l1_loss": (ssim.l1_loss, jssim.l1_loss, [(16, 12, 3), (16, 12, 3)]),
    "l2_loss": (ssim.l2_loss, jssim.l2_loss, [(16, 12, 3), (16, 12, 3)]),
}


@pytest.mark.parametrize("name", list(ELEMENTWISE))
def test_helper_matches_moss_tpu(rng, name):
    fn, jfn, shapes = ELEMENTWISE[name]
    args = [_draw(rng, s) for s in shapes]
    close(fn(*map(torch.as_tensor, args)).numpy(), np.asarray(jfn(*map(jnp.asarray, args))))


def test_pack_and_unpack_are_inverse(rng):
    cov = _draw(rng, (8, 3, 3))
    cov = cov + np.swapaxes(cov, -1, -2)
    t = torch.as_tensor(cov)
    assert torch.equal(tf.unpack_cov3d(tf.pack_cov3d(t)), t)
    rgb = torch.as_tensor(rng.uniform(size=(5, 3)).astype(np.float32))
    close(sh.sh_to_rgb(sh.rgb_to_sh(rgb)).numpy(), rgb.numpy())


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_num_sh_coeffs(degree):
    assert G.num_sh_coeffs(degree) == jG.num_sh_coeffs(degree) == (degree + 1) ** 2


def _cameras(H=48, W=64):
    K = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1.0]])
    R = np.eye(3)
    return (Camera.from_KRT(K, R, np.zeros(3), H, W, device=CPU),
            JCamera.from_KRT(K, R, np.zeros(3), H, W))


def test_mark_visible(rng):
    means = np.stack([rng.uniform(-1, 1, 200), rng.uniform(-1, 1, 200),
                      rng.uniform(-0.5, 2.0, 200)], -1).astype(np.float32)
    cam, jcam = _cameras()
    got = projection.mark_visible(torch.as_tensor(means), cam.world_view, cam.full_proj)
    want = np.asarray(jprojection.mark_visible(jnp.asarray(means), jcam.world_view,
                                               jcam.full_proj))
    assert got.dtype == torch.bool and 0 < want.sum() < want.size
    np.testing.assert_array_equal(got.numpy(), want)


def test_render_reference(rng):
    means, scales, quats, colors, opacity = random_scene(rng, 80)
    cov = np.array(jtf.build_covariance(jnp.asarray(scales), jnp.asarray(quats)))
    valid = rng.uniform(size=80) > 0.1
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    cam, jcam = _cameras()
    out, proj = rasterize_ref.render_reference(
        *map(torch.as_tensor, (means, cov, colors, opacity)), cam, torch.as_tensor(bg),
        valid_mask=torch.as_tensor(valid))
    ref, jproj = jrasterize_ref.render_reference(
        *map(jnp.asarray, (means, cov, colors, opacity)), jcam, jnp.asarray(bg),
        valid_mask=jnp.asarray(valid))
    np.testing.assert_array_equal(proj.valid.numpy(), np.asarray(jproj.valid))
    assert float(out["alpha"].max()) > 0.5
    for key in ("color", "alpha", "final_T"):
        assert_images_match(out[key].numpy(), np.asarray(ref[key]))
    assert_images_match(out["depth"].numpy(), np.asarray(ref["depth"]), atol=1e-4)


def test_proper_svd3(rng):
    """U, S, V as moss_tpu's (a column of U and of V up to a shared sign, the
    solvers' choice), S_proper equal, and the grads through S_proper alone
    equal to jax.grad's."""
    F = _draw(rng, (16, 3, 3))
    F[:4] = -np.abs(F[:4])  # some with det < 0, so S_proper flips s3
    w = _draw(rng, (16, 3))
    Ft = torch.as_tensor(F).requires_grad_(True)
    U, S, V, Sp = fisher.proper_svd3(Ft)
    jU, jS, jV, jSp = jfisher.proper_svd3(jnp.asarray(F))
    close(S.detach().numpy(), np.asarray(jS))
    close(Sp.detach().numpy(), np.asarray(jSp))
    assert (np.asarray(jSp)[:, 2] < 0).any()
    sign = np.sign(np.sum(U.numpy() * np.asarray(jU), axis=-2, keepdims=True))
    close(U.numpy() * sign, np.asarray(jU))
    close(V.numpy() * sign, np.asarray(jV))
    assert not (U.requires_grad or S.requires_grad or V.requires_grad)
    (Sp * torch.as_tensor(w)).sum().backward()
    jg = jax.grad(lambda f: jnp.sum(jfisher.proper_svd3(f)[3] * w))(jnp.asarray(F))
    close(Ft.grad.numpy(), np.asarray(jg), atol=5e-4)


def test_config_keeps_the_rect_cap(tmp_path):
    """A moss_tpu cfg.json with max_tiles_per_gaussian loads in the port with the
    value kept, goes back to moss_tpu with it, and convert keeps it too."""
    import dataclasses

    from moss_tpu import config as jconfig
    from moss_torch import config, convert

    jcfg = dataclasses.replace(jconfig.Config(), pipe=jconfig.PipelineConfig(
        max_tiles_per_gaussian=12, rasterizer="reference"))
    path = str(tmp_path / "cfg.json")
    jconfig.save_json(jcfg, path)
    cfg = config.load_json(path)
    assert cfg.pipe.max_tiles_per_gaussian == 12
    assert config.PipelineConfig().max_tiles_per_gaussian == \
        jconfig.PipelineConfig().max_tiles_per_gaussian == 16
    assert convert.config_from_jax(jcfg).pipe.max_tiles_per_gaussian == 12
    config.save_json(cfg, str(tmp_path / "port.json"))
    assert jconfig.load_json(str(tmp_path / "port.json")).pipe.max_tiles_per_gaussian == 12
