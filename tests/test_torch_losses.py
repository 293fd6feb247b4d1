"""The port's loss terms against moss_tpu's, value and input grad.

Inputs are drawn with numpy and fed to both. Tolerances: f32 values rtol
1e-5 (both sides run the same f32 arithmetic; the frameworks round
transcendental functions and reductions a few ulp apart; the 1 - mean terms
also get atol 2e-6, the rounding of a mean near 1), grads at
tests/test_rasterize_tpu.py:150's rule (divide by max|g_ref|, atol 5e-4);
LPIPS f32 at tests/test_lpips_parity.py:100 (rtol 1e-5, grads 2e-5 of the
max); LPIPS bf16 at tests/test_losses_parity.py:108 (2e-2 relative), as
bf16 rounds at other places in the two frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.ops import fisher as jfisher
from moss_tpu.ops import lpips_jax
from moss_tpu.ops import ssim as jssim
from moss_tpu.train.losses import LossWeights as JLossWeights
from moss_tpu.train.losses import compute_losses as jax_compute_losses
from moss_torch import convert
from moss_torch.ops import fisher, lpips, ssim
from moss_torch.train.losses import LossWeights, compute_losses
from test_torch_raster_bwd import assert_grad_close
from _torch_threads import two_torch_threads  # noqa: F401


def value_and_grad_torch(fn, *arrays):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*leaves)
    return out.detach().numpy(), [g.numpy() for g in torch.autograd.grad(out, leaves)]


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(21)
    a = rng.uniform(size=(40, 36, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["ssim", "s3im", "psnr"])
def test_image_metric_matches_jax(images, name):
    a, b = images
    jfn, tfn = getattr(jssim, name), getattr(ssim, name)
    v_ref, g_ref = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(b)))(jnp.asarray(a))
    v, (g,) = value_and_grad_torch(lambda x: tfn(x, torch.as_tensor(b)), a)
    np.testing.assert_allclose(v, float(v_ref), rtol=1e-5)
    assert_grad_close(g, g_ref, name)


def test_bessel_matches_jax():
    x = np.concatenate([np.linspace(-20, 20, 401), [0.0, 3.75, -3.75, 3.7499, 3.7501]])
    x = x.astype(np.float32)
    np.testing.assert_allclose(fisher.bessel0_exp_scaled(torch.as_tensor(x)).numpy(),
                               np.asarray(jfisher.bessel0_exp_scaled(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def _rotation_like(rng, n, noise):
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(rng.normal(0, 0.5, (n, 3))).as_matrix()
    return (R + rng.normal(0, noise, R.shape)).astype(np.float32)


@pytest.mark.parametrize("noise", [1e-3, 0.3], ids=["near_rotation", "generic"])
def test_proper_singular_values_and_log_c_match_jax(noise):
    """S_proper, log c and their grads; never U or V, which differ between
    LAPACK builds for near-degenerate S."""
    rng = np.random.default_rng(4)
    F = _rotation_like(rng, 23, noise) * 3.0
    F[0] = -F[0]  # a negative determinant: the s3 flip
    w = rng.normal(size=(23, 3)).astype(np.float32)
    S_ref = jfisher.proper_singular_values(jnp.asarray(F))
    S = fisher.proper_singular_values(torch.as_tensor(F))
    np.testing.assert_allclose(S.numpy(), np.asarray(S_ref), rtol=1e-5, atol=1e-6)
    assert float(S_ref[0, 2]) < 0

    g_ref = jax.grad(lambda f: jnp.sum(jfisher.proper_singular_values(f) * w))(jnp.asarray(F))
    _, (g,) = value_and_grad_torch(
        lambda f: torch.sum(fisher.proper_singular_values(f) * torch.as_tensor(w)), F)
    assert_grad_close(g, g_ref, "dS/dF")

    Sp = np.asarray(S_ref)
    v_ref, gs_ref = jax.value_and_grad(lambda s: jnp.sum(jfisher.log_mf_norm_constant(s) * w[:, 0]))(
        jnp.asarray(Sp))
    v, (gs,) = value_and_grad_torch(
        lambda s: torch.sum(fisher.log_mf_norm_constant(s) * torch.as_tensor(w[:, 0])), Sp)
    np.testing.assert_allclose(v, float(v_ref), rtol=1e-5)
    assert_grad_close(gs, gs_ref, "dlogc/dS")


def test_matrix_fisher_nll_matches_jax():
    rng = np.random.default_rng(8)
    F = _rotation_like(rng, 23, 0.05) * 2.0
    R = _rotation_like(rng, 23, 0.0)
    v_ref, g_ref = jax.value_and_grad(lambda f: jnp.mean(jfisher.matrix_fisher_nll(f, jnp.asarray(R))))(
        jnp.asarray(F))
    v, (g,) = value_and_grad_torch(
        lambda f: torch.mean(fisher.matrix_fisher_nll(f, torch.as_tensor(R))), F)
    np.testing.assert_allclose(v, float(v_ref), rtol=1e-5)
    assert_grad_close(g, g_ref, "nll")


@pytest.fixture(scope="module")
def lpips_pair():
    jp = lpips_jax.init_random(3407)
    return jp, convert.lpips_params_from_jax(jp, device="cpu")


def test_lpips_random_init_matches_jax(lpips_pair):
    jp, _ = lpips_pair
    ours = lpips.init_random(3407, device="cpu")
    for jb, tb in zip(jp["convs"], ours["convs"]):
        for jl, tl in zip(jb, tb):
            np.testing.assert_array_equal(tl["w"].numpy(), np.transpose(jl["w"], (3, 2, 0, 1)))


def test_lpips_f32_value_and_grad_match_jax(images, lpips_pair):
    jp, tp = lpips_pair
    a, b = (x[:32, :32] for x in images)
    v_ref, g_ref = jax.value_and_grad(lambda x: lpips_jax.lpips(jp, x, jnp.asarray(b)))(jnp.asarray(a))
    v, (g,) = value_and_grad_torch(lambda x: lpips.lpips(tp, x, torch.as_tensor(b)), a)
    np.testing.assert_allclose(v, float(v_ref), rtol=1e-5)
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(g, g_ref, atol=2e-5 * np.abs(g_ref).max(), rtol=1e-4)


def test_lpips_bf16_and_cached_tower(images, lpips_pair):
    jp, tp = lpips_pair
    a, b = (torch.as_tensor(x[:32, :32]) for x in images)
    ref = float(lpips_jax.lpips(jp, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                                dtype=jnp.bfloat16))
    bf16 = float(lpips.lpips(tp, a, b, dtype=torch.bfloat16))
    f32 = float(lpips.lpips(tp, a, b))
    assert abs(bf16 - ref) / ref < 2e-2, (bf16, ref)
    assert abs(bf16 - f32) / f32 < 2e-2, (bf16, f32)
    cached = float(lpips.lpips(tp, a, dtype=torch.bfloat16,
                               cached_f2=lpips.gt_features(tp, b, dtype=torch.bfloat16)))
    assert cached == bf16


@pytest.mark.parametrize("w_lpips", [0.5, 0.0], ids=["six_terms", "lpips_off"])
def test_compute_losses_matches_jax(lpips_pair, w_lpips):
    jp, tp = lpips_pair
    rng = np.random.default_rng(13)
    H = W = 48
    crop = 32
    render = rng.uniform(size=(H, W, 3)).astype(np.float32)
    alpha = rng.uniform(size=(H, W)).astype(np.float32)
    Rs = _rotation_like(rng, 23, 0.01)
    gt = np.clip(render + rng.normal(0, 0.1, render.shape), 0, 1).astype(np.float32)
    bkgd = rng.uniform(size=(H, W)).astype(np.float32)
    bound = (rng.uniform(size=(H, W)) > 0.2).astype(np.float32)
    target_R = _rotation_like(rng, 23, 0.0)
    y0, x0 = 5, 9
    weights = dict(l1=1.0, mask=0.5, ssim=0.2, lpips=w_lpips, nll=0.06, s3im=0.3)

    def jloss(r, a, R):
        out = {"render": r, "render_alpha": a, "pose_out": {"Rs": R}}
        return jax_compute_losses(out, gt, bkgd, bound, target_R, y0, x0, crop, crop,
                                  lpips_params=jp, weights=JLossWeights(**weights))

    (v_ref, logs_ref), g_ref = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(render), jnp.asarray(alpha), jnp.asarray(Rs))
    leaves = [torch.tensor(x, requires_grad=True) for x in (render, alpha, Rs)]
    total, logs = compute_losses(
        {"render": leaves[0], "render_alpha": leaves[1], "pose_out": {"Rs": leaves[2]}},
        *(torch.as_tensor(x) for x in (gt, bkgd, bound, target_R)), y0, x0, crop, crop,
        lpips_params=tp, weights=LossWeights(**weights))
    g = torch.autograd.grad(total, leaves)
    for key in ("l1", "mask", "ssim", "nll", "s3im"):
        np.testing.assert_allclose(float(logs[key]), float(logs_ref[key]), rtol=1e-5, atol=2e-6,
                                   err_msg=key)
    lp, lp_ref = float(logs["lpips"]), float(logs_ref["lpips"])
    assert (lp == lp_ref == 0.0) if w_lpips == 0 else abs(lp - lp_ref) / lp_ref < 2e-2
    np.testing.assert_allclose(float(total), float(v_ref), rtol=2e-2 * w_lpips + 1e-5)
    for name, a, b in zip(("render", "render_alpha", "Rs"), g, g_ref):
        assert_grad_close(a.numpy(), b, name)
