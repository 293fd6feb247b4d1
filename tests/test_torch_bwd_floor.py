"""The backward-stage tool's inputs and plain versions on the CPU.

  * its scene (moss_torch.data.synthetic.bench_scene) at 64x64 / 1,000
    Gaussians against the same construction in moss_tpu (bench.py:92-105 and
    tools/bwd_kernel_floor.py:64-77: the same numpy draws);
  * the per-Gaussian grads of the plain full stage under the tool's
    cotangent (dL/d rgb = 1, depth 0.01, alpha 1, final_T 0) against JAX's
    gradient through moss_tpu's blend at the port's 16x16 tiles (divide by
    max|g_ref|, atol 5e-4: tests/test_rasterize_tpu.py:150). That is
    rasterize_tpu's plain reference, which tests/test_rasterize_tpu.py holds
    to the Pallas kernel at its own 8x128 tiles. rasterize_tpu itself cannot
    be the oracle here: a Gaussian reaches only the pixels of the tiles in
    its rect, so at 8x128 tiles it also reaches pixels that 16x16 tiles cut
    off, and on this scene mean2d grads differ by up to 7e-3 of the max;
  * the plain full and full_soa rows against sequential_blend_bwd, the
    numpy walk of csrc/rasterize_bwd.cu (tests/test_torch_raster_bwd.py);
  * the recompute stage's observer, the pixel's gradient sum plus its sum of
    w, against the plain forward blend's alpha plane.
"""
import os

os.environ["MOSS_PALLAS_INTERPRET"] = "1"

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.ops import transforms as jtf
from moss_tpu.ops.projection import preprocess as jax_preprocess
from moss_tpu.ops.rasterize_ref import rasterize_reference as jax_rasterize_reference
from moss_tpu.render.camera import Camera as JCamera
from moss_torch.data.synthetic import bench_scene
from moss_torch.ops import bwd_stages
from moss_torch.ops import rasterize_cuda as rc
from moss_torch.ops.rasterize_ref import rasterize_reference
from moss_torch.tools import bwd_kernel_floor as bf
from test_torch_ops import close
from test_torch_raster_bwd import assert_grad_close, sequential_blend_bwd
from test_torch_rasterize import to_torch

H, P = 64, 1000


@pytest.fixture(scope="module")
def jax_scene():
    """bench.py's draws in moss_tpu at H x H, P splats, f = 550 H / 512."""
    rng = np.random.default_rng(0)
    f = 550.0 * H / 512.0
    cam = JCamera.from_KRT(np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1.0]]), np.eye(3),
                           np.zeros(3), H, H)
    means = np.stack([rng.uniform(-0.4, 0.4, P), rng.uniform(-0.7, 0.7, P),
                      rng.uniform(1.5, 2.5, P)], -1).astype(np.float32)
    cov3d = jtf.build_covariance(jnp.asarray(rng.uniform(0.004, 0.012, (P, 3)).astype(np.float32)),
                                 jnp.asarray(rng.normal(size=(P, 4)).astype(np.float32)))
    colors = jnp.asarray(rng.uniform(size=(P, 3)).astype(np.float32))
    opacity = jnp.asarray(rng.uniform(0.3, 0.95, P).astype(np.float32))
    return jax_preprocess(jnp.asarray(means), cov3d, colors, opacity, cam)


def test_floor_scene_matches_moss_tpu(jax_scene):
    proj, cam = bench_scene("cpu", H=H, P=P)
    assert (cam.height, cam.width) == (H, H)
    for f in ("radius", "valid"):
        np.testing.assert_array_equal(getattr(proj, f).numpy(), np.asarray(getattr(jax_scene, f)))
    v = proj.valid.numpy()
    assert v.sum() > 0.9 * P
    for f in ("mean2d", "depth", "conic", "color", "opacity"):
        close(getattr(proj, f).numpy()[v], np.asarray(getattr(jax_scene, f))[v])


def test_plain_stage_grads_match_jax(jax_scene):
    proj = to_torch(jax_scene)
    pairs, gimg = bf.floor_inputs(proj, H, H)
    rows, _ = bwd_stages.rasterize_bwd_stage(pairs, proj, gimg, H, H, "full")
    # (P, 10): d(mean_x, mean_y, conic a, b, c, opacity, r, g, b, depth)
    got = rc.segment_sum(rows, pairs).numpy()
    cot = bf.COTANGENT

    def loss(mean2d, conic, opacity, color, depth):
        proj = jax_scene._replace(mean2d=mean2d, conic=conic, opacity=opacity, color=color,
                                  depth=depth)
        out = jax_rasterize_reference(proj, jnp.zeros(3), H, H, tile_h=rc.TILE, tile_w=rc.TILE)
        return (jnp.sum(out["color"] * jnp.asarray(cot[:3])) + cot[3] * jnp.sum(out["depth"])
                + cot[4] * jnp.sum(out["alpha"]))

    fields = ("mean2d", "conic", "opacity", "color", "depth")
    want = jax.grad(loss, argnums=tuple(range(5)))(*(getattr(jax_scene, f) for f in fields))
    cols = (slice(0, 2), slice(2, 5), 5, slice(6, 9), 9)
    for name, sl, w in zip(fields, cols, want):
        assert np.abs(np.asarray(w)).max() > 0, name
        assert_grad_close(got[:, sl], np.asarray(w), name)


@pytest.fixture(scope="module")
def floor_inputs():
    proj, _ = bench_scene("cpu", H=H, P=P)
    pairs, gimg = bf.floor_inputs(proj, H, H)
    return proj, pairs, gimg


def test_plain_full_rows_match_the_kernel_walk(floor_inputs):
    proj, pairs, gimg = floor_inputs
    rows, _ = sequential_blend_bwd(pairs, proj, H, H, gimg.numpy())
    full, obs = bwd_stages.rasterize_bwd_stage(pairs, proj, gimg, H, H, "full")
    soa, _ = bwd_stages.rasterize_bwd_stage(pairs, proj, gimg, H, H, "full_soa")
    assert obs is None and tuple(soa.shape) == (rc.GRAD_COLS, pairs.num_pairs)
    assert_grad_close(full.numpy(), rows, "full rows", atol=1e-5)
    np.testing.assert_array_equal(soa.T.numpy(), full.numpy())


def test_ablated_stages_stage_the_pairs_and_observe(floor_inputs):
    proj, pairs, gimg = floor_inputs
    ref = rasterize_reference(proj, torch.zeros(3), H, H, tile_h=rc.TILE, tile_w=rc.TILE)
    gsum = gimg.sum(0)
    g = pairs.pair_gaussian.long()
    staged = torch.cat([proj.mean2d[g], proj.conic[g], proj.opacity[g, None], proj.color[g],
                        proj.depth[g, None]], 1)
    for stage in bwd_stages.ABLATED:
        rows, obs = bwd_stages.rasterize_bwd_stage(pairs, proj, gimg, H, H, stage)
        # no tile of this scene stops every pixel, so every batch is staged
        torch.testing.assert_close(rows, staged, rtol=0, atol=0)
        assert tuple(obs.shape) == (H, H) and torch.isfinite(obs).all()
        if stage == "recompute":  # sum of w = the forward's alpha plane
            torch.testing.assert_close(obs - gsum, ref["alpha"], rtol=0, atol=1e-5)
