"""Gradients of the port's blend: the plain version against moss_tpu's, remat
against no remat, and the backward kernel's algorithm against autograd.

  * plain-blend grads (means, log-scales, quats, colours, raw opacity through
    preprocess) and the bg grad against jax.grad through moss_tpu's plain
    blend at the same 16x16 tiles: the cases of tests/test_rasterize_tpu.py:
    117-166 with its tolerance (divide by max|g_ref|, atol 5e-4; bg rtol 1e-4);
  * remat=True gives the grads of remat=False, and keeps no chunk-sized tensor;
  * sequential_blend_bwd walks each tile's pairs in csrc/rasterize_bwd.cu's
    order (forward-order prefix, per-pair tile sums, then the Gaussian-order
    segment sum through the kept sort permutation) and must give autograd's
    grads of the plain blend: the CPU proof of the kernel's algorithm, as
    sequential_blend (tests/test_torch_binning.py) is of the forward's.
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
from moss_torch.ops import rasterize_cuda as rc
from moss_torch.ops import transforms as tf
from moss_torch.ops.projection import Projected, preprocess
from moss_torch.ops.rasterize_ref import rasterize_reference
from test_rasterize_tpu import make_camera, random_scene
from test_torch_binning import sequential_blend
from test_torch_rasterize import jax_projected, to_torch
from _torch_threads import two_torch_threads  # noqa: F401

GRAD_ATOL = 5e-4  # after dividing by max|g_ref|, tests/test_rasterize_tpu.py:150


def assert_grad_close(g, g_ref, name, atol=GRAD_ATOL, scale=None):
    """g / scale within atol of g_ref / scale; scale defaults to max|g_ref|."""
    g, g_ref = np.asarray(g, np.float64), np.asarray(g_ref, np.float64)
    assert g.shape == g_ref.shape, name
    assert np.all(np.isfinite(g)), name
    scale = (np.abs(g_ref).max() if scale is None else scale) + 1e-8
    np.testing.assert_allclose(g / scale, g_ref / scale, atol=atol, err_msg=name)


def torch_camera(H, W, fx=80.0):
    from moss_torch.render.camera import Camera
    return Camera.from_KRT(np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]]),
                           np.eye(3), np.zeros(3), H, W, device="cpu")


def test_plain_grads_match_jax(rng):
    H = W = 64
    cam, tcam = make_camera(H, W), torch_camera(H, W)
    means, scales, quats, colors, opacity = random_scene(rng, n=40, opacity_max=0.9)
    target = rng.uniform(size=(H, W, 3)).astype(np.float32)
    bg = np.array([0.5, 0.5, 0.5], np.float32)

    def jloss(args):
        m, ls, q, c, raw = args
        proj = jax_preprocess(m, jtf.build_covariance(jnp.exp(ls), q), c, jax.nn.sigmoid(raw), cam)
        out = jax_rasterize_reference(proj, jnp.asarray(bg), H, W, tile_h=16, tile_w=16)
        return (jnp.mean((out["color"] - target) ** 2) + 0.1 * jnp.mean(out["alpha"])
                + 0.01 * jnp.mean(out["depth"]))

    args = (means, np.log(scales), quats, colors, opacity)
    g_ref = jax.grad(jloss)(tuple(jnp.asarray(a) for a in args))

    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    m, ls, q, c, raw = leaves
    proj = preprocess(m, tf.build_covariance(torch.exp(ls), q), c, torch.sigmoid(raw), tcam)
    out = rasterize_reference(proj, torch.as_tensor(bg), H, W)
    loss = (torch.mean((out["color"] - torch.as_tensor(target)) ** 2)
            + 0.1 * torch.mean(out["alpha"]) + 0.01 * torch.mean(out["depth"]))
    g = torch.autograd.grad(loss, leaves)
    for name, gt, gr in zip(["means", "log_scales", "quats", "colors", "raw_op"], g, g_ref):
        assert_grad_close(gt.numpy(), gr, name)


def test_bg_gradient(rng):
    H = W = 32
    proj = to_torch(jax_projected(rng, make_camera(H, W), n=10))
    bg = torch.tensor([0.1, 0.2, 0.3], requires_grad=True)
    out = rc.rasterize_cuda(proj, bg, H, W)
    (g,) = torch.autograd.grad(out["color"].sum(), bg)
    expect = float(out["final_T"].sum())
    np.testing.assert_allclose(g.numpy(), expect, rtol=1e-4)


def _upstream(rng, H, W):
    return {k: torch.as_tensor(rng.normal(size=s).astype(np.float32))
            for k, s in (("color", (H, W, 3)), ("depth", (H, W)), ("alpha", (H, W)),
                         ("final_T", (H, W)))}


def _plain_grads(proj, bg, H, W, up, remat=False):
    leaves = [getattr(proj, f).clone().requires_grad_() for f in rc._KERNEL_FIELDS]
    p = proj._replace(**dict(zip(rc._KERNEL_FIELDS, leaves)))
    out = rasterize_reference(p, bg, H, W, tile_h=rc.TILE, tile_w=rc.TILE, chunk=32, remat=remat)
    loss = sum((out[k] * up[k]).sum() for k in up)
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def test_remat_matches_no_remat(rng):
    H = W = 48
    proj = to_torch(jax_projected(rng, make_camera(H, W), n=100))
    up = _upstream(rng, H, W)
    bg = torch.tensor([0.2, 0.5, 0.7])
    for name, a, b in zip(rc._KERNEL_FIELDS, _plain_grads(proj, bg, H, W, up, remat=True),
                          _plain_grads(proj, bg, H, W, up)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=name)


def test_remat_keeps_no_chunk_sized_tensor(rng):
    """remat=True keeps, per chunk, the chunk's inputs and the carried
    (H*W,) state, never a (chunk, H*W) tensor: the carried stop mask was a
    view of the chunk's whole mask, and 1,024 of them (82 MB each at
    800x800) filled an 80 GB card."""
    H = W = 48
    proj = to_torch(jax_projected(rng, make_camera(H, W), n=100))
    leaves = [getattr(proj, f).clone().requires_grad_() for f in rc._KERNEL_FIELDS]
    p = proj._replace(**dict(zip(rc._KERNEL_FIELDS, leaves)))
    storages = {}

    def pack(t):
        storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        rasterize_reference(p, torch.zeros(3), H, W, tile_h=rc.TILE, tile_w=rc.TILE, chunk=32,
                            remat=True)
    assert storages and max(storages.values()) < 32 * H * W  # a (32, H*W) bool mask is that


def sequential_blend_bwd(pairs, proj: Projected, H, W, gimg):
    """csrc/rasterize_bwd.cu in numpy: per tile, every pixel walks the pairs
    in the forward's order; each pair's ten values are summed over the tile
    and turned into its gradient row; the rows are then summed per Gaussian in
    the order of pairs.gaussian_pairs. gimg: (6, H, W) g_r, g_g, g_b, g_d, g_a,
    Qtail. Returns (rows (num_pairs, 10), per-Gaussian (P, 10))."""
    f32 = np.float32
    m2, con = proj.mean2d.numpy(), proj.conic.numpy()
    op, col, dep = proj.opacity.numpy(), proj.color.numpy(), proj.depth.numpy()
    offs, pg = pairs.tile_offsets.numpy(), pairs.pair_gaussian.numpy()
    grid_w = -(-W // rc.TILE)
    lane = np.arange(rc.TILE * rc.TILE)
    rows = np.zeros((pairs.num_pairs, rc.GRAD_COLS), f32)
    for t in range(len(offs) - 1):
        px = (t % grid_w) * rc.TILE + lane % rc.TILE
        py = (t // grid_w) * rc.TILE + lane // rc.TILE
        inside = (px < W) & (py < H)
        g = np.zeros((6,) + lane.shape, f32)
        g[:, inside] = gimg[:, py[inside], px[inside]]
        done = ~inside
        T = np.ones(lane.shape, f32)
        prefix = np.zeros(lane.shape, f32)
        for k in range(offs[t], offs[t + 1]):
            i = pg[k]
            dx = m2[i, 0] - px.astype(f32)
            dy = m2[i, 1] - py.astype(f32)
            a, b, c = con[i]
            power = f32(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = np.minimum(f32(0.99), op[i] * np.exp(power))
            ok = ~done & (power <= 0) & (alpha >= f32(1.0 / 255.0))
            test_T = T * (f32(1) - alpha)
            stop = ok & (test_T < f32(1e-4))
            done |= stop
            ok &= ~stop
            w = np.where(ok, alpha * T, f32(0))
            dl_dw = col[i, 0] * g[0] + col[i, 1] * g[1] + col[i, 2] * g[2] + dep[i] * g[3] + g[4]
            prefix = prefix + w * dl_dw
            s_after = g[5] - prefix
            dp = np.where(ok & (alpha < f32(0.99)),
                          (dl_dw * T - s_after / (f32(1) - alpha)) * alpha, f32(0))
            s = [(dp * dx).sum(), (dp * dy).sum(), (dp * dx * dx).sum(), (dp * dx * dy).sum(),
                 (dp * dy * dy).sum(), dp.sum(), (w * g[0]).sum(), (w * g[1]).sum(),
                 (w * g[2]).sum(), (w * g[3]).sum()]
            rows[k] = [-(a * s[0] + b * s[1]), -(c * s[1] + b * s[0]), -0.5 * s[2], -s[3],
                       -0.5 * s[4], s[5] / max(op[i], 1e-12), *s[6:]]
            T = np.where(ok, test_T, T)
    gp, go = pairs.gaussian_pairs.numpy(), pairs.gaussian_offsets.numpy()
    per_gaussian = np.stack([rows[gp[go[i]:go[i + 1]]].sum(0) for i in range(len(go) - 1)])
    return rows, per_gaussian


@pytest.mark.parametrize("dense", [False, True], ids=["scene", "dense"])
def test_sequential_bwd_of_pair_list_matches_autograd(rng, dense):
    H, W = 45, 77
    cam = make_camera(H, W, fx=60.0 if dense else 80.0)
    proj = to_torch(jax_projected(rng, cam, n=128, dense=dense))
    bg = np.array([0.2, 0.5, 0.7], np.float32)
    up = _upstream(rng, H, W)
    pairs = rc.bin_projected(proj, H, W)

    fwd = sequential_blend(pairs, proj, H, W, bg)
    if dense:
        assert float(fwd["final_T"].min()) < 1e-3  # termination exercised
    rgb = fwd["color"] - fwd["final_T"][..., None] * bg  # the blend without the background
    planes = [rgb[..., 0], rgb[..., 1], rgb[..., 2], fwd["depth"], fwd["alpha"], fwd["final_T"]]
    gc = up["color"].numpy()
    g_T = up["final_T"].numpy() + (gc * bg).sum(-1)  # final_T also carries the bg term
    gimg = np.stack([gc[..., 0], gc[..., 1], gc[..., 2], up["depth"].numpy(), up["alpha"].numpy()])
    qtail = (gimg * np.stack(planes[:5])).sum(0) + g_T * planes[5]
    rows, per_gaussian = sequential_blend_bwd(pairs, proj, H, W,
                                              np.concatenate([gimg, qtail[None]]).astype(np.float32))

    # the segment sum through the kept permutation, plain version
    np.testing.assert_allclose(rc.segment_sum(torch.as_tensor(rows), pairs).numpy(), per_gaussian,
                               rtol=1e-6, atol=1e-6)
    ref = _plain_grads(proj, torch.as_tensor(bg), H, W, up)
    split = [per_gaussian[:, 0:2], per_gaussian[:, 2:5], per_gaussian[:, 5],
             per_gaussian[:, 6:9], per_gaussian[:, 9]]
    for name, a, b in zip(rc._KERNEL_FIELDS, split, ref):
        assert_grad_close(a, b, name)


def test_gaussian_pairs_invert_the_sort(rng):
    H = W = 64
    proj = to_torch(jax_projected(rng, make_camera(H, W), n=200))
    pairs = rc.bin_projected(proj, H, W)
    gp, go = pairs.gaussian_pairs.numpy(), pairs.gaussian_offsets.numpy()
    pg = pairs.pair_gaussian.numpy()
    assert sorted(gp.tolist()) == list(range(pairs.num_pairs))
    assert go[-1] == pairs.num_pairs
    for i in range(len(go) - 1):
        seg = gp[go[i]:go[i + 1]]
        assert np.all(pg[seg] == i)
        assert np.all(np.diff(seg) > 0)  # tile order within a Gaussian
