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


# ---- the row pass kernel's map of elements to threads --------------------------------
#
# csrc/sort_pass.cu's row_pass_kernel gives a pair of rows two warps; thread
# `lane` of warp w holds the int2 at lanes 64 (w % 2) + 2 lane of the pair's
# lower row in one register pair and of its upper row in the other
# (sort_pass.row_elements), and exchanges them lane for lane, the lower row
# keeping the min. CTAs of 8 warps cover the block, the tail warps of the last
# one idle.

ROW_STRIDES = [1 << j for j in range(12)]


def _row_map(rows, stride_rows):
    """(lower, upper) flat elements of each launched (warp, lane, c), as the
    kernel's grid reaches them: arrays (warps, 32, 2)."""
    warps_needed = rows // 2 * sort_pass.ROW_HALVES
    grid = -(-warps_needed // sort_pass.ROW_WARPS)
    warp = np.arange(grid * sort_pass.ROW_WARPS)
    warp = warp[warp < warps_needed]                      # the kernel's early return
    lo, hi = sort_pass.row_elements(warp[:, None, None], np.arange(32)[None, :, None],
                                    np.arange(sort_pass.ROW_VEC)[None, None, :], stride_rows)
    return lo, hi


def row_pass_kernel_model(x, stride_rows, r):
    """The kernel's r repeats of a row pass at stride_rows on x (rows, 128), in
    numpy: the registers gathered by the map, exchanged, scattered back."""
    flat = np.asarray(x).reshape(-1)
    lo_at, hi_at = _row_map(np.asarray(x).shape[0], stride_rows)
    lo, hi = flat[lo_at], flat[hi_at]
    for _ in range(r):
        lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    out = np.empty_like(flat)
    out[lo_at], out[hi_at] = lo, hi
    return out.reshape(np.asarray(x).shape)


@pytest.mark.parametrize("rows,stride_rows", [(sm.ROWS, s) for s in ROW_STRIDES]
                         + [(256, s) for s in ROW_STRIDES[:8]])
def test_row_map_covers_the_block_in_pairs(rows, stride_rows):
    """Every element of the block once, as the (lower, upper) pairs of the
    plain version: the lower in a row r with r % 2S < S, the upper S rows
    below it in the same lane; each int2 two adjacent, 8-byte aligned
    elements; a warp's 32 int2s of one row 256 contiguous bytes."""
    lo, hi = _row_map(rows, stride_rows)
    assert lo.shape == (rows, 32, sort_pass.ROW_VEC)
    both = np.concatenate([lo.reshape(-1), hi.reshape(-1)])
    assert np.array_equal(np.sort(both), np.arange(rows * sort_pass.LANES))
    lo_row, lo_lane = np.divmod(lo, sort_pass.LANES)
    hi_row, hi_lane = np.divmod(hi, sort_pass.LANES)
    assert (lo_row % (2 * stride_rows) < stride_rows).all()
    assert (hi_row == lo_row + stride_rows).all() and (hi_lane == lo_lane).all()
    assert (lo[..., 0] % 2 == 0).all() and (np.diff(lo, axis=-1) == 1).all()
    assert (np.diff(lo[..., 0], axis=1) == sort_pass.ROW_VEC).all()
    assert (lo_row == lo_row[:, :1, :1]).all()             # a warp's lanes lie in one row


@pytest.mark.parametrize("stride_rows", [1, 64, 2048])
def test_row_map_model_matches_pallas(block, stride_rows):
    """Driven through the map, the kernel's exchanges are exactly
    _row_pass_kernel in interpret mode, with its R repeats."""
    want = _pallas(sm._row_pass_kernel, block, stride_rows=stride_rows)
    np.testing.assert_array_equal(row_pass_kernel_model(block, stride_rows, sm.R), want)


def test_row_map_constants_are_the_kernels():
    """ops/sort_pass.py's copy of the row pass's map and CTA is
    csrc/sort_pass.cu's, and the kernel's index arithmetic is row_elements'."""
    import re

    src = open(os.path.join(REPO, "moss_torch", "csrc", "sort_pass.cu")).read()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]*);", src).group(1).split("//")[0].strip()

    assert int(const("kRowVec")) == sort_pass.ROW_VEC
    assert int(const("kRowWarps")) == sort_pass.ROW_WARPS
    assert const("kRowHalves") == "kLanes / (32 * kRowVec)"
    assert sort_pass.ROW_HALVES == 2
    kernel = src[src.index("row_pass_kernel(const int*"):src.index("// The lane pass's grid")]
    for line in ("const int pair = warp >> 1;", "const int row = pair + (pair & -stride_rows);",
                 "(warp & 1) * 32 * kRowVec", "kRowVec * (threadIdx.x & 31)",
                 "lo_at + static_cast<size_t>(stride_rows) * kLanes"):
        assert line in kernel, line
    assert "/" not in kernel.replace("//", "").replace("rows / 2", "")  # no run-time divide


def test_row_pass_by_stride_counts():
    """Stage k of the 2^19-key network has one row pass at each row stride
    below 2^(k - 7): row stride 2^j has 12 - j of them, 78 in all, the row
    passes of network_passes at any size."""
    n = sm.ROWS * sm.LANES
    by_stride = sort_pass.row_passes_by_stride(n)
    assert by_stride == {1 << j: 12 - j for j in range(12)}
    assert sum(by_stride.values()) == 78 == sort_pass.network_passes(n)[1]
    for k in range(1, 21):
        assert sum(sort_pass.row_passes_by_stride(1 << k).values()) == \
            sort_pass.network_passes(1 << k)[1]
    assert sort_pass.row_passes_by_stride(1 << 7) == {}
