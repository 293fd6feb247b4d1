"""The sort-pass plain versions (moss_torch/ops/sort_pass.py) against the
JAX tool's Pallas kernels, tools/sort_micro.py::_lane_pass_kernel and
_row_pass_kernel, run in interpret mode at their (4096, 128) int32 block with
their R = 64 repeats; the pass counts of the network. Integers: equality is
exact."""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from moss_torch.ops import sort_pass
from _torch_threads import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location("tools_sort_micro",
                                                  os.path.join(REPO, "tools", "sort_micro.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sm = _jax_tool()


@pytest.fixture(scope="module")
def block():
    return np.random.default_rng(0).integers(0, 1 << 30, (sm.ROWS, sm.LANES), np.int32)


def _pallas(kernel, x, **kw):
    call = pl.pallas_call(functools.partial(kernel, **kw),
                          out_shape=jax.ShapeDtypeStruct((sm.ROWS, sm.LANES), jnp.int32),
                          interpret=True)
    return np.asarray(call(jnp.asarray(x)))


def test_the_block_matches_the_jax_tool():
    assert (sort_pass.ROWS, sort_pass.LANES, sort_pass.R) == (sm.ROWS, sm.LANES, sm.R)


@pytest.mark.parametrize("stride", [1, 2, 32, 64])
def test_lane_pass_matches_pallas(block, stride):
    want = _pallas(sm._lane_pass_kernel, block, stride=stride)
    got = sort_pass.lane_pass(torch.as_tensor(block), stride, sm.R)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stride_rows", [1, 64, 2048])
def test_row_pass_matches_pallas(block, stride_rows):
    want = _pallas(sm._row_pass_kernel, block, stride_rows=stride_rows)
    got = sort_pass.row_pass(torch.as_tensor(block), stride_rows, sm.R)
    np.testing.assert_array_equal(got.numpy(), want)


def test_network_pass_counts():
    """tools/sort_micro.py:101-106 at 2^19 keys: 112 lane and 78 row passes,
    19 stages of k passes each."""
    n = sm.ROWS * sm.LANES
    n_stages = int(np.log2(n))
    lane = sum(min(k, 7) for k in range(1, n_stages + 1))
    row = sum(max(k - 7, 0) for k in range(1, n_stages + 1))
    assert sort_pass.network_passes(n) == (lane, row) == (112, 78)
    assert lane + row == n_stages * (n_stages + 1) // 2
