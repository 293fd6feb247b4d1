"""The 3x3 conv's plain version (moss_torch/ops/conv3x3.py) against the JAX
tool's Pallas kernel, tools/conv_pallas_proto.py::conv3x3_fused, run in
interpret mode: at check()'s three f32 shapes and bh = 8 (atol 1e-4,
conv_pallas_proto.py:102), and once with relu off on bf16 inputs (max abs
difference within 2e-2 of the max, the bf16 rule of
tests/test_losses_parity.py:108)."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_torch.ops.conv3x3 import conv3x3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "tools_conv_pallas_proto", os.path.join(REPO, "tools", "conv_pallas_proto.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cp = _jax_tool()


def _inputs(H, W, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(H, W, cin)).astype(np.float32),
            rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32),
            rng.normal(0, 0.1, cout).astype(np.float32))


@pytest.mark.parametrize("shape", [(16, 128, 8, 16), (8, 256, 64, 64), (32, 128, 16, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_f32(shape):
    assert cp.INTERPRET
    x, w, b = _inputs(*shape)
    want = np.asarray(cp.conv3x3_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), bh=8))
    got = conv3x3(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_plain_matches_pallas_bf16_without_relu():
    """conv3x3_fused casts w and the bias to x's bf16 and rounds the output
    to bf16 once; the plain version does the same."""
    x, w, b = _inputs(16, 128, 32, 16, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = cp.conv3x3_fused(xb, jnp.asarray(w), jnp.asarray(b), relu=False, bh=8)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = conv3x3(torch.as_tensor(x).to(torch.bfloat16), torch.as_tensor(w), torch.as_tensor(b),
                  relu=False)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.min() < 0  # relu off
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
