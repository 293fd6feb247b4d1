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

from moss_torch.ops import conv3x3 as conv
from moss_torch.ops.conv3x3 import conv3x3, f32_tile, tc_tile
from _conv_tiles import with_threads
from _torch_threads import two_torch_threads  # noqa: F401

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


VGG_LAYERS = ((512, 64, 64), (256, 64, 128), (256, 128, 128), (128, 128, 256),
              (128, 256, 256), (64, 256, 512), (64, 512, 512), (32, 512, 512))
# the tensor-core kernel's tiles (rows of 16 pixels, output channels), largest
# first: a copy of with_tile's table in csrc/conv3x3.cu, which the C library
# reports only on the card; tests/test_torch_cuda.py holds this copy to it
TILES = ({"rows": 8, "channels": 128}, {"rows": 8, "channels": 64}, {"rows": 4, "channels": 64})


@pytest.mark.parametrize("layer,want", zip(VGG_LAYERS, (1, 0, 0, 0, 0, 0, 0, 2)),
                         ids=["x".join(map(str, l)) for l in VGG_LAYERS])
def test_tensor_core_tile_for_each_vgg_layer(layer, want):
    """On a 132-SM H100: 64 channels where Cout is 64, the 4-row tile where the
    larger ones leave a quarter of the SMs without a tile (32x32x512), else
    the 8 x 16 x 128 tile."""
    H, _, cout = layer
    assert tc_tile(H, H, cout, TILES, 132) == want


@pytest.mark.parametrize("stage", conv.STAGES)
def test_stage_plain_on_the_cpu(stage):
    """A stage of the tensor-core kernel on CPU tensors is its plain version,
    with no launch: the conv for "full", relu(b) at every pixel for the stages
    that sum no products."""
    x, w, b = (torch.as_tensor(a).to(torch.bfloat16) for a in _inputs(5, 7, 16, 24, seed=4))
    before = (conv.launches, conv.tc_launches, conv.stage_launches)
    for relu in (True, False):
        got = conv.conv3x3_tc_stage(x, w, b, stage, relu=relu)
        if stage == "full":
            want = conv.conv3x3_plain(x, w, b, relu, torch.bfloat16)
        else:
            want = b.float().expand(5, 7, 24)
            want = (torch.relu(want) if relu else want).to(torch.bfloat16)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert (conv.launches, conv.tc_launches, conv.stage_launches) == before
    with pytest.raises(ValueError):
        conv.conv3x3_tc_stage(x, w, b, stage + "_")


CHECK_SHAPES = ((16, 128, 8, 16), (8, 256, 64, 64), (32, 128, 16, 8))
# (tile code, cluster split) of the CUDA-core kernel on a 132-SM H100
F32_CHOICE = {(16, 128, 8, 16): (6, 3), (8, 256, 64, 64): (1, 8), (32, 128, 16, 8): (7, 6),
              (13, 29, 48, 72): (1, 6),
              **{(H, H, cin, cout): (0, 1) for H, cin, cout in VGG_LAYERS[:-1]},
              (32, 32, 512, 512): (1, 1)}


@pytest.mark.parametrize("shape", list(F32_CHOICE), ids=["x".join(map(str, s)) for s in F32_CHOICE])
def test_f32_tile_and_split(shape):
    """The CUDA-core kernel's tile fits Cout (16 and 8 channels at check()'s
    small shapes, so no FMA goes to a zero weight); check()'s shapes split K
    over a cluster until the grid covers the 132 SMs, a ragged one as far as
    it can; the VGG16 layers keep the K walk in one CTA, the 32x32 one on the
    4-row tile, which covers 128 SMs unsplit."""
    H, W, cin, cout = shape
    tiles = with_threads()
    code, split = f32_tile(H, W, cin, cout, tiles, 132)
    assert (code, split) == F32_CHOICE[shape]
    t = tiles[code]
    assert t["channels"] == min(c for c in (8, 16, 32, 64) if c >= min(cout, 64))
    assert 1 <= split <= min(8, 3 * -(-cin // 8))
    ctas = -(-H // t["rows"]) * -(-W // 16) * -(-cout // t["channels"]) * split
    if shape in CHECK_SHAPES:
        assert ctas >= 132
