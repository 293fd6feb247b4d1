"""moss_torch's plain blend (ops/rasterize_ref.py) against moss_tpu's oracle and
its Pallas kernel (interpret mode).

Both sides get the same projected Gaussians: the scene is drawn with numpy,
projected by moss_tpu's preprocess, and handed to the port as tensors, so only
the blend is compared. Tolerances are moss_tpu's own kernel-vs-oracle image
rule (tests/test_rasterize_tpu.py:50-59, depth atol 1e-4 as at :73). The CUDA
kernel's own tests are in test_torch_cuda.py.
"""
import os

os.environ["MOSS_PALLAS_INTERPRET"] = "1"

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.ops import transforms as jtf
from moss_tpu.ops.projection import preprocess as jax_preprocess
from moss_tpu.ops.rasterize_ref import rasterize_reference as jax_rasterize_reference
from moss_tpu.ops.rasterize_tpu import TILE_H, TILE_W, rasterize_tpu
from moss_torch.ops import rasterize_cuda as rc
from moss_torch.ops.projection import Projected
from moss_torch.ops.rasterize_ref import rasterize_reference
from test_rasterize_tpu import assert_images_match, make_camera, random_scene
from _torch_threads import two_torch_threads  # noqa: F401


def to_torch(jproj, device="cpu"):
    """A moss_tpu Projected as the port's, field for field."""
    return Projected(*(torch.as_tensor(np.array(f), device=device) for f in jproj))


def jax_projected(rng, cam, n=60, opacity_max=0.95, dense=False):
    means, scales, quats, colors, opacity = random_scene(rng, n, opacity_max=opacity_max)
    if dense:  # tests/test_rasterize_tpu.py:76-90
        means[:, :2] *= 0.15
        scales = scales * 1.5
        opacity = np.full((n,), 0.97, np.float32)
    cov3d = jtf.build_covariance(jnp.asarray(scales), jnp.asarray(quats))
    return jax_preprocess(
        jnp.asarray(means), cov3d, jnp.asarray(colors), jnp.asarray(opacity), cam)


def assert_all_match(out, ref, outlier_frac=2e-3):
    for key in ("color", "alpha", "final_T"):
        assert_images_match(np.asarray(out[key]), np.asarray(ref[key]),
                            outlier_frac=outlier_frac)
    assert_images_match(np.asarray(out["depth"]), np.asarray(ref["depth"]), atol=1e-4,
                        outlier_frac=outlier_frac)


@pytest.mark.parametrize("tile", [(16, 16), (TILE_H, TILE_W)], ids=["16x16", "8x128"])
def test_plain_matches_jax_oracle(rng, tile):
    H = W = 64
    cam = make_camera(H, W)
    jproj = jax_projected(rng, cam)
    bg = np.array([0.9, 0.4, 0.1], np.float32)
    ref = jax_rasterize_reference(jproj, jnp.asarray(bg), H, W, tile_h=tile[0], tile_w=tile[1])
    out = rasterize_reference(to_torch(jproj), torch.as_tensor(bg), H, W,
                              tile_h=tile[0], tile_w=tile[1])
    assert out["color"].shape == (H, W, 3)
    assert_all_match(out, ref)


def test_plain_matches_pallas_kernel(rng):
    """At the TPU kernel's 8x128 tiles the plain blend matches rasterize_tpu
    (groups=1), run in interpret mode as moss_tpu's own tests run it."""
    H = W = 64
    cam = make_camera(H, W)
    jproj = jax_projected(rng, cam)
    bg = np.array([0.9, 0.4, 0.1], np.float32)
    tpu = rasterize_tpu(jproj, jnp.asarray(bg), H, W, groups=1)
    assert int(tpu["overflow"]) == 0
    out = rasterize_reference(to_torch(jproj), torch.as_tensor(bg), H, W,
                              tile_h=TILE_H, tile_w=TILE_W)
    assert_all_match(out, tpu)


def test_dense_termination(rng):
    H = W = 32
    cam = make_camera(H, W, fx=60.0)
    jproj = jax_projected(rng, cam, n=128, dense=True)
    bg = np.zeros(3, np.float32)
    ref = jax_rasterize_reference(jproj, jnp.asarray(bg), H, W)
    out = rasterize_reference(to_torch(jproj), torch.as_tensor(bg), H, W)
    assert float(out["final_T"].min()) < 1e-3  # termination exercised
    assert_all_match(out, ref)


def test_all_invalid_is_background(rng):
    H = W = 32
    cam = make_camera(H, W)
    proj = to_torch(jax_projected(rng, cam, n=20))
    proj = proj._replace(valid=torch.zeros_like(proj.valid))
    bg = torch.tensor([0.3, 0.6, 0.9])
    out = rc.rasterize_cuda(proj, bg, H, W)
    np.testing.assert_array_equal(out["color"].numpy(), np.broadcast_to(bg.numpy(), (H, W, 3)))
    assert float(out["alpha"].abs().max()) == 0.0
    assert float(out["final_T"].min()) == 1.0
    assert int(out["overflow"]) == 0


def test_odd_image_size(rng):
    H, W = 45, 77  # ragged against both the 16x16 and the 8x128 tiles
    cam = make_camera(H, W)
    jproj = jax_projected(rng, cam, n=40)
    bg = np.full(3, 0.2, np.float32)
    ref = jax_rasterize_reference(jproj, jnp.asarray(bg), H, W)
    out = rasterize_reference(to_torch(jproj), torch.as_tensor(bg), H, W)
    assert out["color"].shape == (H, W, 3)
    assert_all_match(out, ref)
