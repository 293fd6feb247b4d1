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


# ---- the lane pass kernel's map of elements to threads ------------------------------
#
# csrc/sort_pass.cu's lane_pass_kernel gives a row one warp; thread `lane` holds
# elements 64 k + 2 lane + c (sort_pass.lane_element) in register (k, c), its
# int2 k. A pass at stride 1 pairs the two registers of an int2, at 64 the two
# int2s of a thread, at 2-32 lane l with l ^ (stride / 2) through a shuffle,
# the lower keeping the min.

LANE_STRIDES = [1, 2, 4, 8, 16, 32, 64]


def _lane_map():
    """(lane, k, c) -> element, as an array (32, 2, 2)."""
    return np.array([[[sort_pass.lane_element(lane, k, c) for c in range(sort_pass.LANE_VEC)]
                      for k in range(sort_pass.LANE_VECS)]
                     for lane in range(32)])


def lane_pass_kernel_model(x, stride, r):
    """The kernel's r repeats of a pass at `stride` on x (rows, 128), in
    numpy: the registers gathered by the map, exchanged as the kernel does,
    scattered back."""
    m = _lane_map()
    v = np.asarray(x)[:, m]                            # (rows, lane, k, c)
    for _ in range(r):
        if stride < sort_pass.LANE_VEC:                # two registers of an int2
            axis, d = 3, stride
        elif stride < 32 * sort_pass.LANE_VEC:         # a shuffle
            axis, d = 1, stride // sort_pass.LANE_VEC
        else:                                          # two int2s of a thread
            axis, d = 2, stride // (32 * sort_pass.LANE_VEC)
        idx = np.arange(v.shape[axis])
        partner = np.take(v, idx ^ d, axis=axis)
        lower = ((idx & d) == 0).reshape([-1 if a == axis else 1 for a in range(4)])
        v = np.where(lower, np.minimum(v, partner), np.maximum(v, partner))
    out = np.empty_like(np.asarray(x))
    out[:, m] = v
    return out


def test_lane_map_constants_are_the_kernels():
    """ops/sort_pass.py's copy of the lane pass's map and CTA is
    csrc/sort_pass.cu's."""
    import re

    src = open(os.path.join(REPO, "moss_torch", "csrc", "sort_pass.cu")).read()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]*);", src).group(1).split("//")[0].strip()

    assert int(const("kLaneVec")) == sort_pass.LANE_VEC
    assert int(const("kLaneWarps")) == sort_pass.LANE_WARPS
    assert const("kLaneVecs") == "kLanes / (32 * kLaneVec)"
    assert "kLanes + kLaneVec * lane" in src and "k * 32 * kLaneVec" in src


def test_one_lane_map_for_every_stride():
    """The map covers a row once, each int2 is 2 adjacent, 8-byte aligned
    elements, and at every stride each pair (e, e ^ s) lies in one thread
    (strides 1 and 64) or in lanes l and l ^ (s / 2) of the warp (2-32), the
    shuffle's distance."""
    m = _lane_map()
    assert sorted(m.reshape(-1).tolist()) == list(range(sort_pass.LANES))
    assert (m[..., 0] % 2 == 0).all() and (np.diff(m, axis=-1) == 1).all()
    where = {int(e): (lane, k, c) for (lane, k, c), e in np.ndenumerate(m)}
    in_thread = set()
    for s in LANE_STRIDES:
        for e in range(sort_pass.LANES):
            (la, ka, ca), (lb, kb, cb) = where[e], where[e ^ s]
            if la == lb:
                in_thread.add(s)
                assert (ka ^ kb, ca ^ cb) in ((0, s), (s // 64, 0))
            else:
                assert la ^ lb == s // sort_pass.LANE_VEC < 32
                assert (ka, ca) == (kb, cb)
    assert in_thread == {1, 64}
    by_stride = sort_pass.lane_passes_by_stride(sm.ROWS * sm.LANES)
    assert sum(by_stride[s] for s in in_thread) == 32 and sum(by_stride.values()) == 112


@pytest.mark.parametrize("stride", LANE_STRIDES)
def test_lane_map_model_matches_pallas(block, stride):
    """Driven through the map, the kernel's exchanges are exactly
    _lane_pass_kernel in interpret mode at every stride, with its R repeats."""
    want = _pallas(sm._lane_pass_kernel, block, stride=stride)
    np.testing.assert_array_equal(lane_pass_kernel_model(block, stride, sm.R), want)


def test_lane_pass_by_stride_counts():
    """Stage k of the 2^19-key network has one pass at each stride below
    2^k: stride 2^j has 19 - j lane passes, 112 in all."""
    by_stride = sort_pass.lane_passes_by_stride(sm.ROWS * sm.LANES)
    assert by_stride == {1 << j: 19 - j for j in range(7)}
    assert sum(by_stride.values()) == sort_pass.network_passes(sm.ROWS * sm.LANES)[0]
    assert sort_pass.lane_passes_by_stride(1 << 5) == {1: 5, 2: 4, 4: 3, 8: 2, 16: 1}


def test_lane_pass_empty_on_the_cpu_does_nothing(block):
    x = torch.as_tensor(block)
    before, copy = sort_pass.empty_launches, x.clone()
    assert sort_pass.lane_pass_empty(x) is None
    assert sort_pass.empty_launches == before and torch.equal(x, copy)
