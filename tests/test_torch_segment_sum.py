"""The segment sum (the VJP of moss_tpu/ops/binning.py::_gather_rows) on the
CPU: its plain version against jax.vjp of _gather_rows, on pair lists with
short, empty and long segments (atol 1e-5); the wrapper on CPU tensors; and
csrc/segment_sum.cu's order of adds, emulated in numpy float32, against the
plain version: the CPU proof of the kernel's algorithm."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.ops.binning import _gather_rows
from moss_torch.data.synthetic import bench_scene
from moss_torch.ops import rasterize_cuda as rc
from _segment_order import CASES, kernel_order, pair_list
from _torch_threads import two_torch_threads  # noqa: F401

ATOL = 1e-5


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, rc.GRAD_COLS)).astype(np.float32)


def _gather_rows_vjp(rows, pair_gaussian, P, nsplit):
    """d/d table of sum(g * table[pair_gaussian]) at g = rows: the scatter-add."""
    table = jnp.zeros((P, rows.shape[1]), jnp.float32)
    _, vjp = jax.vjp(lambda t: _gather_rows(t, jnp.asarray(pair_gaussian), nsplit), table)
    return np.asarray(vjp(jnp.asarray(rows))[0])


@pytest.mark.parametrize("nsplit", [1, 4])
@pytest.mark.parametrize("name,lengths", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_gather_rows_vjp(name, lengths, nsplit):
    pairs = pair_list(lengths)
    rows = _rows(pairs.num_pairs)
    want = _gather_rows_vjp(rows, pairs.pair_gaussian.numpy(), len(lengths), nsplit)
    got = rc.segment_sum_plain(torch.as_tensor(rows), pairs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert not np.any(got[np.asarray(lengths) == 0])  # a Gaussian with no pair: a zero row


def test_plain_matches_gather_rows_vjp_on_a_binned_scene():
    proj, _ = bench_scene(torch.device("cpu"), H=96, P=600)
    pairs = rc.bin_projected(proj, 96, 96)
    assert pairs.num_pairs > 600
    rows = _rows(pairs.num_pairs, seed=1)
    want = _gather_rows_vjp(rows, pairs.pair_gaussian.numpy(), 600, 1)
    got = rc.segment_sum_plain(torch.as_tensor(rows), pairs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name,lengths", CASES, ids=[c[0] for c in CASES])
def test_wrapper_on_cpu_tensors_takes_the_plain_version(name, lengths):
    pairs = pair_list(lengths, seed=2)
    rows = torch.as_tensor(_rows(pairs.num_pairs, seed=2))
    before = rc.segment_launches
    got = rc.segment_sum(rows, pairs)
    assert rc.segment_launches == before
    assert torch.equal(got, rc.segment_sum_plain(rows, pairs))


@pytest.mark.parametrize("name,lengths", CASES, ids=[c[0] for c in CASES])
def test_kernel_order_matches_plain(name, lengths):
    pairs = pair_list(lengths, seed=3)
    rows = _rows(pairs.num_pairs, seed=3)
    got = kernel_order(rows, pairs.gaussian_pairs.numpy(), pairs.gaussian_offsets.numpy())
    want = rc.segment_sum_plain(torch.as_tensor(rows), pairs).numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-6)
