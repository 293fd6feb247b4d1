"""The reduction and scan plain versions (moss_torch/ops/reduce_scan.py)
against the JAX tool's Pallas kernels, tools/mxu_micro.py's twelve runs, in
interpret mode with no grid (every program of the TPU grid writes the same
output block) at the tool's chunk (128, 8, 128) and REPS = 16.

Tolerances, of max |ref|: 1e-5 for the f32-class forms (CUDA cores, 3xTF32,
split2, the log-space split2 cumprod), which differ from the Pallas kernels
only in the order of their f32 sums (the CUDA-core scans are sequential,
the JAX ones two-level Hillis-Steele). On the CPU, JAX's DEFAULT precision
does not round to bf16, so for the one-pass bf16 forms the Pallas kernel is
an f32 oracle: they are held to it within 1e-2, and within 1e-5 to a numpy
emulation with bf16-rounded operands and f64 sums, which proves the rounding
model."""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from moss_torch.ops import reduce_scan as rs
from moss_torch.tools import mxu_micro

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location("tools_mxu_micro",
                                                  os.path.join(REPO, "tools", "mxu_micro.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


mm = _jax_tool()
HIGHEST, DEFAULT = jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT
# run: (Pallas kernel, output shape, operands after x)
PALLAS = {
    "moments_cuda": (mm.kern_moments_vpu, (mm.K, 8), ()),
    "moments_tf32x3": (functools.partial(mm.kern_moments_mxu, HIGHEST), (mm.K, 8), ("b",)),
    "moments_bf16": (functools.partial(mm.kern_moments_mxu, DEFAULT), (mm.K, 8), ("b",)),
    "reshape_only": (mm.kern_reshape_only, (mm.K, mm.W), ()),
    "acc_cuda": (mm.kern_acc_vpu, (8, mm.H, mm.W), ("s",)),
    "acc_tf32x3": (functools.partial(mm.kern_acc_mxu, HIGHEST), (8, mm.H, mm.W), ("s",)),
    "acc_bf16": (functools.partial(mm.kern_acc_mxu, DEFAULT), (8, mm.H, mm.W), ("s",)),
    "cumsum_cuda": (mm.kern_cumsum_vpu, (mm.K, mm.H, mm.W), ()),
    "cumsum_bf16": (functools.partial(mm.kern_cumsum_mxu, False), (mm.K, mm.H, mm.W), ("L",)),
    "cumsum_split2": (functools.partial(mm.kern_cumsum_mxu, True), (mm.K, mm.H, mm.W), ("L",)),
    "cumprod_cuda": (mm.kern_cumprod_vpu, (mm.K, mm.H, mm.W), ()),
    "cumprod_logsplit2": (mm.kern_cumprod_logmxu, (mm.K, mm.H, mm.W), ("L",)),
}
BF16_RUNS = ("moments_bf16", "acc_bf16", "cumsum_bf16")
F32_RTOL, BF16_VS_F32_RTOL = 1e-5, 1e-2


@pytest.fixture(scope="module")
def data():
    """The JAX tool's inputs (:240-243) and its basis and L."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(mm.K, mm.H, mm.W)).astype(np.float32)
    s = rng.normal(size=(8, mm.K)).astype(np.float32)
    return {"x": x, "s": s, "b": np.asarray(mm._basis()),
            "L": np.tril(np.ones((mm.K, mm.K), np.float32))}


@pytest.fixture(scope="module")
def pallas_out(data):
    """Every run's Pallas kernel once, in interpret mode, with no grid."""
    out = {}
    for name, (kernel, shape, extra) in PALLAS.items():
        call = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                              interpret=True)
        out[name] = np.asarray(call(*(jnp.asarray(data[k]) for k in ("x",) + extra)))
    return out


@pytest.fixture(scope="module")
def plain_out(data):
    x, s = torch.as_tensor(data["x"]), torch.as_tensor(data["s"])
    return {name: rs.run_plain(name, x, s).numpy() for name in PALLAS}


def _err_of_max(a, ref):
    return float(np.abs(np.asarray(a, np.float64) - ref).max() / np.abs(ref).max())


def test_the_shapes_match_the_jax_tool():
    assert (rs.K, rs.H, rs.W, rs.REPS, rs.TILES) == (mm.K, mm.H, mm.W, mm.REPS, mm.TILES)
    assert [r[0] for r in rs.RUNS] == list(PALLAS)
    np.testing.assert_array_equal(rs.basis().numpy(), np.asarray(mm._basis()))
    np.testing.assert_array_equal(rs.tri().numpy(), np.asarray(mm._tri()))


@pytest.mark.parametrize("name", list(PALLAS))
def test_plain_matches_pallas(pallas_out, plain_out, name):
    ref = pallas_out[name].astype(np.float64)
    got = plain_out[name]
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = _err_of_max(got, ref)
    assert err <= (BF16_VS_F32_RTOL if name in BF16_RUNS else F32_RTOL), err


def _bf16(a):
    """Round-to-nearest-even bf16 of f32 values, in numpy, back in f32."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _emulate_bf16(name, data):
    """The one-pass bf16 product with bf16-rounded operands and f64 sums."""
    x, s, b = data["x"].reshape(mm.K, mm.PIX), data["s"], data["b"]
    acc = 0.0
    for i in range(mm.REPS):
        g = _bf16(x + np.float32(i)).astype(np.float64)
        if name == "moments_bf16":
            acc = acc + g @ _bf16(b).astype(np.float64)
        elif name == "acc_bf16":
            acc = acc + _bf16(s).astype(np.float64) @ g
        else:
            acc = acc + np.cumsum(g, axis=0)
    return acc


@pytest.mark.parametrize("name", BF16_RUNS)
def test_bf16_plain_matches_the_rounding_model(data, pallas_out, plain_out, name):
    ref = _emulate_bf16(name, data)
    got = plain_out[name].reshape(ref.shape)
    assert _err_of_max(got, ref) <= F32_RTOL
    # the bf16 rounding is visible: JAX on the CPU computes these in f32
    assert _err_of_max(pallas_out[name].reshape(ref.shape), ref) > 10 * F32_RTOL


def test_round_tf32_ties_away_from_zero():
    ulp = 2.0 ** -10  # tf32 keeps 10 mantissa bits
    a = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 1 + 1.5 * ulp,
                      3.0, 0.0, -2.0 ** -130], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0, -2.0 ** -130],
                        dtype=torch.float32)
    assert torch.equal(rs.round_tf32(a), want)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=4096).astype(np.float32)) * 1e3
    big, small = rs.split_tf32(x)
    bits = torch.cat([big, small]).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    assert float(((big + small - x).abs() / x.abs()).max()) < 2.0 ** -21


def test_wrappers_on_cpu_tensors_launch_nothing(data):
    x, s = torch.as_tensor(data["x"]), torch.as_tensor(data["s"])
    before = rs.launch_counts()
    for name in ("moments_tf32x3", "reshape_only", "acc_bf16", "cumprod_cuda"):
        out, obs = rs.run(name, x, s, reps=2)
        assert obs is None
        assert torch.equal(out, rs.run_plain(name, x, s, reps=2))
    assert rs.launch_counts() == before
    with pytest.raises(ValueError, match="mode"):
        rs.scan(x, 2, "mul", "bf16")
    with pytest.raises(ValueError, match="chunk"):
        rs.moments(x[:64])


@pytest.mark.parametrize("name", list(PALLAS))
def test_plain_on_a_stack_of_chunks(data, plain_out, name):
    """The plain versions on (T, K, 8, 128), as a launch's TILES copies are
    timed, give each chunk's output."""
    x, s = torch.as_tensor(data["x"]), torch.as_tensor(data["s"])
    x2 = torch.stack([x, x + 0.5])
    got = rs.run_plain(name, x2, s).numpy()
    assert got.shape == (2,) + plain_out[name].shape
    np.testing.assert_allclose(got[0], plain_out[name], rtol=0, atol=1e-6 * np.abs(got[0]).max())
    one = rs.run_plain(name, x2[1], s).numpy()
    np.testing.assert_allclose(got[1], one, rtol=0, atol=1e-6 * np.abs(one).max())


@pytest.mark.parametrize("name", list(PALLAS))
def test_library_call_computes_the_function(data, plain_out, name):
    """The library call of each run, over one tile's REPS chunk-ops and
    summed over them, is the run's function: within 1e-5 of the max of the
    f32-class plain versions, within 1e-2 of the one-pass bf16 ones (the
    call rounds its bf16 output, the bf16 cumsum's operands are not rounded).
    Like with like, as numeric_lines compares."""
    x, s = torch.as_tensor(data["x"]), torch.as_tensor(data["s"])
    family = rs.RUN[name][1]
    got = mxu_micro.library_call(name, x, s, tiles=1)().float().sum(0).numpy()
    want = plain_out[name].reshape(got.shape)
    if family == "moments":
        got, want = got[:, :6], want[:, :6]
    elif family == "acc":
        got, want = got[:5], want[:5]
    assert _err_of_max(got, want.astype(np.float64)) <= (
        BF16_VS_F32_RTOL if name in BF16_RUNS else F32_RTOL)


def test_the_tool_on_the_cpu(capsys):
    res = mxu_micro.main("cpu", timing={"n": 1, "reps": 1, "warmup": 0}, tiles=2)
    assert list(res["runs"]) == list(PALLAS)
    for name, row in res["runs"].items():
        assert row["scaled_err"] == 0.0 and row["bound_ms"] > 0, name
        assert row["library_ms"] > 0 and row["plain_ms"] > 0 and row["timed_tiles"] == 2
        # a tensor-core scan is bound by the scan, its triangular product beside it
        tc_scan = name in ("cumsum_bf16", "cumsum_split2", "cumprod_logsplit2")
        assert ("formulation_bound_ms" in row) == tc_scan
        if tc_scan:
            assert row["formulation_bound_ms"] > row["bound_ms"]
    num = res["numeric"]
    assert max(num["moments_err_of_max_vs_f64"][m] for m in ("cuda", "tf32x3")) < 1e-6
    assert 1e-5 < num["moments_err_of_max_vs_f64"]["bf16"] < 1e-3
    assert num["cumsum_split2_vs_cuda"]["of_max"] < 1e-5
    assert num["cumprod_logsplit2_vs_cuda"]["of_max"] < 1e-5
    assert "ns/chunk-op" in capsys.readouterr().out
