"""Gradients through the port's whole render against moss_tpu's.

The serving slice's scene, cloud and MLPs (tests/test_torch_render.py's
fixture, carried across by a moss_tpu checkpoint) render through the full
path (pose MLPs + LBS field + deform + projection + plain blend at 16x16
tiles) on both sides, with a zero mean2d offset added as render_frame's
mean2d_offset. The fixture's splats are isotropic, where the rotation has
no effect and its grad is rounding noise, so the log-scales get an
anisotropic draw first. The grads of one scalar loss for all six Gaussian fields,
every MLP parameter and the offset must agree with jax.grad at
tests/test_rasterize_tpu.py:150's rule: divide by max|g_ref|, atol 5e-4.
An MLP parameter is scaled by the max over its whole MLP: some have a grad
that is 0 but for rounding (the LBS field's value bias adds the same delta to
all 24 log-weights, which the softmax cancels).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from moss_tpu.render.render import render_frame as jax_render_frame
from moss_torch import convert
from moss_torch.models import gaussians as G
from moss_torch.render.render import render_frame
from test_torch_raster_bwd import assert_grad_close
from test_torch_render import H, W, jax_raster, port_inputs, setup  # noqa: F401  (fixture)
from _torch_threads import two_torch_threads  # noqa: F401


def _loss(out, target, xp):
    return (xp.mean((out["render"] - target) ** 2) + 0.1 * xp.mean(out["render_alpha"])
            + 0.01 * xp.mean(out["render_depth"]))


def test_full_path_grads_match_jax(setup):
    s = setup
    rng = np.random.default_rng(5)
    target = rng.uniform(size=(H, W, 3)).astype(np.float32)
    sp = {k: jnp.asarray(v) for k, v in s["smpl_params"].items()}
    jparams = s["jparams"]
    P = jparams.xyz.shape[0]
    jparams = dataclasses.replace(jparams, scaling=jparams.scaling + jnp.asarray(
        rng.normal(0, 0.4, (P, 3)).astype(np.float32)))

    def jloss(params, mlps, offset):
        out = jax_render_frame(params, s["jvalid"], mlps, s["jscene"], sp, s["jcam"],
                               jnp.asarray(s["bg"]), 3, rasterize_fn=jax_raster,
                               mean2d_offset=offset)
        return _loss(out, target, jnp)

    g_params, g_mlps, g_off = jax.grad(jloss, argnums=(0, 1, 2))(
        jparams, s["jmlps"], jnp.zeros((P, 2), jnp.float32))

    _, valid, mlps, scene, tsp, cam, bg = port_inputs(s)
    params = convert.gaussians_from_jax(jparams, device="cpu")
    leaves = G.GaussianParams(**{f: getattr(params, f).requires_grad_() for f in G.FIELDS})
    offset = torch.zeros((P, 2), requires_grad=True)
    out = render_frame(leaves, valid, mlps, scene, tsp, cam, bg, 3, mean2d_offset=offset,
                       device="cpu")
    mlp_params = {g: dict(m.named_parameters()) for g, m in mlps.items()}
    names = [(g, n) for g in mlp_params for n in mlp_params[g]]
    grads = torch.autograd.grad(
        _loss(out, torch.as_tensor(target), torch),
        [getattr(leaves, f) for f in G.FIELDS] + [mlp_params[g][n] for g, n in names] + [offset])

    for f, g in zip(G.FIELDS, grads):
        assert_grad_close(g.numpy(), getattr(g_params, f), f)
    ref_mlps = {g: convert._mlp_state(g_mlps[g], g, "cpu") for g in mlp_params}
    mlp_scale = {g: max(float(t.abs().max()) for t in ref.values()) for g, ref in ref_mlps.items()}
    for (g, n), gr in zip(names, grads[len(G.FIELDS):-1]):
        assert_grad_close(gr.numpy(), ref_mlps[g][n].numpy(), f"{g}.{n}", scale=mlp_scale[g])
    assert_grad_close(grads[-1].numpy(), g_off, "mean2d_offset")
    assert float(np.abs(np.asarray(g_off)).max()) > 0
