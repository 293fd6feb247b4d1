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
from _torch_threads import two_torch_threads  # noqa: F401

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
# the tensor-core scans' (passes, 16x16 blocks multiplied a pass): the bf16
# cumsum the diagonal block of each of the 8 slabs and an all-ones block for
# the carry after the first 7, the split2 cumsum the 8 diagonal blocks (its
# carry is shuffled), the cumprod the 36 on or below L's diagonal
SCAN_BLOCKS = {"cumsum_bf16": (1, 15), "cumsum_split2": (2, 8), "cumprod_logsplit2": (2, 36)}
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
def test_plain_is_bitwise_the_same_at_any_thread_count(data, name):
    """The card test that compares rs.run with rs.run_plain on CPU tensors
    once found two calls unequal: the CPU BLAS orders a long contraction's
    sums by its thread count (moments differed by up to 192 at 2 and 8
    threads against 1). The plain products now run on one thread."""
    x, s = torch.as_tensor(data["x"]), torch.as_tensor(data["s"])
    before = torch.get_num_threads()
    outs = []
    try:
        for n in (1, 2, 3, 8):
            torch.set_num_threads(n)
            outs.append(rs.run_plain(name, x, s, reps=3))
            assert torch.get_num_threads() == n
    finally:
        torch.set_num_threads(before)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


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
        # a tensor-core scan is bound by the scan; beside it, the products of the
        # blocks of L its kernel multiplies, at the bf16 peak
        tc_scan = name in SCAN_BLOCKS
        assert ("formulation_bound_ms" in row) == tc_scan
        if tc_scan:
            passes, blocks = SCAN_BLOCKS[name]
            flops = rs.TILES * rs.REPS * passes * blocks * 2 * 16 * 16 * rs.PIX
            assert row["formulation_tc_flops"] == flops, name
            assert row["formulation_bound_ms"] == pytest.approx(1e3 * flops / mxu_micro.PEAK_BF16)
    # the cumprod's 36-block product takes longer at the bf16 peak than its f32
    # work at the CUDA cores' peak
    cumprod = res["runs"]["cumprod_logsplit2"]
    assert cumprod["formulation_bound_ms"] > cumprod["bound_ms"]
    num = res["numeric"]
    assert max(num["moments_err_of_max_vs_f64"][m] for m in ("cuda", "tf32x3")) < 1e-6
    assert 1e-5 < num["moments_err_of_max_vs_f64"]["bf16"] < 1e-3
    assert num["cumsum_split2_vs_cuda"]["of_max"] < 1e-5
    assert num["cumprod_logsplit2_vs_cuda"]["of_max"] < 1e-5
    # the kernels' stages, each its plain version on the host
    assert list(res["scan_stages"]) == list(rs.SCAN_STAGES)
    assert list(res["cumsum_stages"]) == list(rs.CUMSUM_MODES)
    assert all(list(rows) == list(rs.CUMSUM_STAGES) and
               all(r["scaled_err"] == 0.0 for r in rows.values())
               for rows in res["cumsum_stages"].values())
    assert all(r["scaled_err"] == 0.0 for r in res["scan_stages"].values())
    assert list(res["cuda_stages"]) == ["moments", "acc"]
    assert all(list(rows) == list(rs.CUDA_STAGES) and
               all(r["scaled_err"] == 0.0 for r in rows.values())
               for rows in res["cuda_stages"].values())
    # the CUDA-core moments' bound: the separable form's least work, 48 f32
    # operations (an FMA 2) per 8-row column, at the f32 peak
    moments = res["runs"]["moments_cuda"]
    ops = rs.TILES * rs.REPS * rs.K * (rs.PIX // 8) * (8 + 7 + 2 * 6 * 2 + 3 + 3 * 2)
    assert moments["f32_ops"] == ops and moments["bound_by"] == "operations"
    assert moments["bound_ms"] == pytest.approx(1e3 * ops / mxu_micro.PEAK_F32, rel=1e-12)
    assert 0.048 < moments["bound_ms"] < 0.0482
    # no clock off the card, so no SFU bound; on the card it counts two
    # transcendentals an element and rep
    assert "sfu_bound_ms" not in res["runs"]["cumprod_logsplit2"]
    row = mxu_micro.bound("cumprod_logsplit2", 1.98e9)
    assert row["transcendentals"] == 2 * rs.TILES * rs.REPS * rs.K * rs.PIX
    assert 0.25 < row["sfu_bound_ms"] < 0.26
    assert "ns/chunk-op" in capsys.readouterr().out


# ---- the log-space cumprod kernel's arithmetic, modelled in numpy --------------------
#
# csrc/reduce_scan.cu's scan_tc_kernel<kMul, kSplit2> works in base 2:
# log2(1 - a) by log2_1m_near (a <= 0.5: f = -a, f P(f)) or log2_1m_far (the
# exponent e and mantissa 1 + f of the exact 1 - a: e + f P(f) in one
# rounding), P the degree-7 polynomial LOG2_POLY in Horner form, the split2
# L product, then 2^c by ex2.approx (2 ulp; below 2^-126 flushed to 0). The
# model repeats that arithmetic in float32 (an FMA as a float64 product and
# sum rounded once to float32), the L product in float64, float64 as the
# truth.

CU = os.path.join(REPO, "moss_torch", "csrc", "reduce_scan.cu")
TERM_BUDGET = 8e-8  # ln units: 128 terms within RTOL = 1e-5 of a cumsum of at most 1


def _fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + np.asarray(c, np.float64)).astype(
        np.float32)


def _poly(f):
    p = np.full_like(f, np.float32(rs.LOG2_POLY[-1]))
    for c in rs.LOG2_POLY[-2::-1]:
        p = _fma(p, f, np.float32(c))
    return p


def log2_1m_model(a):
    """The kernel's log2(1 - a), a float32 in [0, 0.9]."""
    a = np.asarray(a, np.float32)
    near = ((-a) * _poly(-a)).astype(np.float32)
    bits = (np.float32(1) - a).astype(np.float32).view(np.int32)
    e = ((0x4B000000 | (bits >> 23)).astype(np.int32).view(np.float32)
         - np.float32(8388734)).astype(np.float32)
    f = (((bits & 0x007FFFFF) | 0x3F000000).astype(np.int32).view(np.float32)
         - np.float32(1)).astype(np.float32)
    return np.where(a > np.float32(0.5), _fma(f, _poly(f), e), near)


def test_log2_poly_is_the_kernels_table():
    import re

    body = re.search(r"kLog2Poly\[8\] = \{([^}]*)\}", open(CU).read()).group(1)
    table = [np.float32(v.strip().rstrip("f")) for v in body.split(",")]
    assert table == [np.float32(c) for c in rs.LOG2_POLY]


def test_log2_model_within_the_per_term_budget():
    """Over a in (0.003, 0.9] (a million points and both sides of 0.5): the
    error of the kernel's log2(1 - a), in natural-log units, times 1 - a
    (a term's largest weight exp(c) in the cumprod, since c holds the term)
    within TERM_BUDGET; at most 2e-7 unweighted."""
    a = np.linspace(0.003, 0.9, 1_000_001).astype(np.float32)
    half = np.float32(0.5)
    a = np.concatenate([a, [np.nextafter(half, np.float32(0)), half,
                            np.nextafter(half, np.float32(1)), np.float32(0.9)]]).astype(np.float32)
    a = a[a > np.float32(0.003)]
    truth = np.log1p(-a.astype(np.float64))
    err = np.abs(log2_1m_model(a).astype(np.float64) * np.log(2.0) - truth)
    assert err.max() < 2e-7, err.max()
    weighted = err * (1.0 - a.astype(np.float64))
    assert weighted.max() <= TERM_BUDGET, (weighted.max(), a[weighted.argmax()])


@pytest.mark.parametrize("ex2_err", [0.0, 2.0 ** -22, -(2.0 ** -22)], ids=["ex2", "ex2_high",
                                                                              "ex2_low"])
def test_modelled_cumprod_within_rtol_of_plain(data, plain_out, ex2_err):
    """At the JAX tool's input and REPS: the modelled kernel (its log2, the
    split2 L product, 2^c with ex2's error at either end of its 2 ulp) lies
    within RTOL of scan_plain, the natural-log cumprod held to JAX."""
    x = torch.as_tensor(data["x"])
    L = np.tril(np.ones((rs.K, rs.K)))
    acc = np.zeros((rs.K, rs.PIX), np.float32)
    g0 = x.reshape(rs.K, rs.PIX)
    for i in range(rs.REPS):
        a = rs.rep_alpha(g0, i).numpy()
        v = np.where(a > np.float32(0.003), log2_1m_model(np.minimum(a, np.float32(0.9))),
                     np.float32(0)).astype(np.float32)
        hi = torch.as_tensor(v).to(torch.bfloat16).float().numpy()
        lo = torch.as_tensor(v - hi).to(torch.bfloat16).float().numpy()
        c = (L @ hi.astype(np.float64) + L @ lo.astype(np.float64)).astype(np.float32)
        e = np.exp2(c.astype(np.float64)) * (1.0 + ex2_err)
        acc = (acc + np.where(c < -126, 0.0, e).astype(np.float32)).astype(np.float32)
    assert _err_of_max(acc.reshape(rs.K, rs.H, rs.W),
                       plain_out["cumprod_logsplit2"]) <= mxu_micro.RTOL


@pytest.mark.parametrize("stage", rs.SCAN_STAGES)
def test_scan_stage_plain_on_the_cpu(data, plain_out, stage):
    """A stage of the log-space cumprod kernel on CPU tensors is its plain
    version, with no launch: "full" the cumprod itself; the others sums of
    split2 products, logs or exps of the masked alphas."""
    x = torch.as_tensor(data["x"])
    before = rs.stage_launches
    out, obs = rs.scan_stage(x, stage, reps=3)
    assert obs is None and rs.stage_launches == before
    assert torch.equal(out, rs.scan_stage_plain(x, stage, reps=3))
    if stage == "full":
        np.testing.assert_array_equal(rs.scan_stage(x, stage)[0].numpy(),
                                      plain_out["cumprod_logsplit2"])
    with pytest.raises(ValueError):
        rs.scan_stage(x, stage + "_")


# ---- the tensor-core cumsums' blocked formulation, modelled in numpy ----------------
#
# csrc/reduce_scan.cu's scan_tc_kernel<kAdd, mode> computes L @ r(x + i) slab
# by slab: for each 16-splat slab s, the product of L's diagonal 16 x 16
# block with the slab (hi, then lo for split2) on the C operand `carry`, the
# total of slabs 0, ..., s - 1. No block below the diagonal is multiplied
# against an m-tile. The carry: "shuffles" (split2's) takes row 15 of slab
# s's result, the total through slab s; "ones" (bf16's) adds each slab's
# all-ones product to a C fragment of its own. The model rounds the operands
# as the kernel does, adds a product's terms to its C operand one at a time
# in float32 in splat order, and adds a rep's result to the sum over reps in
# float32.
CARRIES = ("ones", "shuffles")


def blocked_cumsum_model(x, reps, split, carry_by):
    g0 = np.asarray(x, np.float32).reshape(mm.K, mm.PIX)
    acc = np.zeros((mm.K, mm.PIX), np.float32)
    for i in range(reps):
        v = (g0 + np.float32(i)).astype(np.float32)
        hi = _bf16(v)
        parts = (hi, _bf16((v - hi).astype(np.float32))) if split else (hi,)
        out = np.empty_like(acc)
        carry = np.zeros(mm.PIX, np.float32)
        for s in range(mm.K // 16):
            d = np.repeat(carry[None], 16, 0)
            for part in parts:
                for k in range(16):  # row r adds the slab's splats 0..r in order
                    d[k:] = d[k:] + part[16 * s + k]
                    if carry_by == "ones":  # the all-ones product, every splat
                        carry = carry + part[16 * s + k]
            out[16 * s:16 * s + 16] = d
            if carry_by == "shuffles":
                carry = d[15]
        acc = (acc + out).astype(np.float32)
    return acc.reshape(mm.K, mm.H, mm.W)


def _jax_cumsum(x, reps, split, monkeypatch):
    """kern_cumsum_mxu in interpret mode with no grid, its REPS set to reps."""
    monkeypatch.setattr(mm, "REPS", reps)
    call = pl.pallas_call(functools.partial(mm.kern_cumsum_mxu, split),
                          out_shape=jax.ShapeDtypeStruct((mm.K, mm.H, mm.W), jnp.float32),
                          interpret=True)
    return np.asarray(call(jnp.asarray(x), jnp.asarray(np.tril(np.ones((mm.K, mm.K), np.float32)))))


def triangular_cumsum_model(x, reps, split):
    """The 36-block product L @ r(x + i) as the blocked model sums it: each
    m-tile's C starts at 0 and adds, slab by slab in order, hi before lo, the
    all-ones block's product (every splat of the slab) or, on the diagonal,
    the triangular block's (splats 0..r for row r)."""
    g0 = np.asarray(x, np.float32).reshape(mm.K, mm.PIX)
    acc = np.zeros((mm.K, mm.PIX), np.float32)
    for i in range(reps):
        v = (g0 + np.float32(i)).astype(np.float32)
        hi = _bf16(v)
        parts = (hi, _bf16((v - hi).astype(np.float32))) if split else (hi,)
        out = np.empty_like(acc)
        for m in range(mm.K // 16):
            c = np.zeros((16, mm.PIX), np.float32)
            for s in range(m + 1):
                for part in parts:
                    for k in range(16):
                        rows = slice(k, 16) if s == m else slice(0, 16)
                        c[rows] = c[rows] + part[16 * s + k]
            out[16 * m:16 * m + 16] = c
        acc = (acc + out).astype(np.float32)
    return acc.reshape(mm.K, mm.H, mm.W)


@pytest.mark.parametrize("carry_by", CARRIES)
@pytest.mark.parametrize("split", [False, True], ids=["bf16", "split2"])
def test_blocked_cumsum_model_bitwise_the_triangular_product(data, split, carry_by):
    """Either carry adds the same terms to the same C values in the same
    order as the 36-block product: the all-ones blocks' terms slab by slab
    (row 15 of a diagonal block is all ones), then the diagonal block's. So
    the blocked kernels can give the 36-block kernels' bits, which the card
    shows (moss_torch/tools/compare.py's output digests)."""
    got = blocked_cumsum_model(data["x"], 3, split, carry_by)
    np.testing.assert_array_equal(got, triangular_cumsum_model(data["x"], 3, split))


@pytest.mark.parametrize("reps", [rs.REPS, 3])
@pytest.mark.parametrize("carry_by", CARRIES)
@pytest.mark.parametrize("split", [False, True], ids=["bf16", "split2"])
def test_blocked_cumsum_model_within_rtol_of_plain(data, split, carry_by, reps):
    """At the JAX tool's input: the blocked formulation with either carry
    (the mode's own in "full", the other in the "other_carry" stage), as the
    kernel sums it, lies within RTOL of scan_plain (L @ r(g) in one
    product); bf16 also within RTOL of the rounding model's float64 sums."""
    x = data["x"]
    model = blocked_cumsum_model(x, reps, split, carry_by)
    plain = rs.scan_plain(torch.as_tensor(x), reps, "add", "split2" if split else "bf16").numpy()
    assert _err_of_max(model, plain.astype(np.float64)) <= mxu_micro.RTOL
    if not split:
        g = x.reshape(mm.K, mm.PIX)
        ref = sum(np.cumsum(_bf16(g + np.float32(i)).astype(np.float64), axis=0)
                  for i in range(reps))
        assert _err_of_max(model.reshape(ref.shape), ref) <= mxu_micro.RTOL


@pytest.mark.parametrize("reps", [rs.REPS, 3])
@pytest.mark.parametrize("carry_by", CARRIES)
@pytest.mark.parametrize("split", [False, True], ids=["bf16", "split2"])
def test_blocked_cumsum_model_within_rtol_of_jax(data, split, carry_by, reps, monkeypatch):
    """The blocked formulation against kern_cumsum_mxu in interpret mode.
    split2 at the JAX tool's input. bf16 on an input whose x + i are exact in
    bf16 (multiples of 1/8 within (-8, 8), so x + i < 32 keeps 8 significant
    bits): JAX on the CPU does not round a DEFAULT product's operands to
    bf16, so only where the rounding is exact is its f32 product the bf16
    one; the rounding itself is held to the numpy model above."""
    if split:
        x = data["x"]
    else:
        rng = np.random.default_rng(5)
        x = (rng.integers(-63, 64, size=(mm.K, mm.H, mm.W)) / 8).astype(np.float32)
        assert np.array_equal(_bf16(x + np.float32(rs.REPS - 1)), x + np.float32(rs.REPS - 1))
    ref = _jax_cumsum(x, reps, split, monkeypatch).astype(np.float64)
    assert _err_of_max(blocked_cumsum_model(x, reps, split, carry_by), ref) <= mxu_micro.RTOL


def _pair_np(lo_elem, hi_elem):
    """The bf16 pair register pack_bf16(lo, hi) as an f32, in numpy."""
    hi_bits = np.asarray(hi_elem, np.float32).view(np.uint32)
    lo_bits = np.asarray(lo_elem, np.float32).view(np.uint32) >> 16
    return (hi_bits | lo_bits).view(np.float32)


def _cumsum_stage_np(x, mode, stage, reps):
    """The cumsum stage's function in numpy: float64 sums of the rounded
    operands for the products, the pair registers summed in float32 in rep
    order for the operand stage."""
    g = x.reshape(mm.K, mm.PIX)
    split = mode == "split2"
    if stage in ("full", "other_carry"):
        return sum(np.cumsum(_split_np(g + np.float32(i), split), axis=0) for i in range(reps))
    if stage == "products":
        return reps * np.cumsum(_split_np(g, split), axis=0)
    acc = np.zeros_like(g)
    for i in range(reps):
        v = (g + np.float32(i)).astype(np.float32)
        hi = _bf16(v)
        pairs = np.zeros_like(g)
        pairs[1::2] = _pair_np(hi[0::2], hi[1::2])
        if split:
            lo = _bf16((v - hi).astype(np.float32))
            pairs[0::2] = _pair_np(lo[0::2], lo[1::2])
        acc = (acc + pairs).astype(np.float32)
    return acc


def _split_np(v, split):
    """r(v) in float64: bf16(v), or hi + bf16(v - hi) for split2."""
    v = np.asarray(v, np.float32)
    hi = _bf16(v)
    return hi.astype(np.float64) + (_bf16((v - hi).astype(np.float32)) if split else 0.0)


@pytest.mark.parametrize("reps", [rs.REPS, 3])
@pytest.mark.parametrize("stage", rs.CUMSUM_STAGES)
@pytest.mark.parametrize("mode", rs.CUMSUM_MODES)
def test_cumsum_stage_plain_on_the_cpu(data, plain_out, mode, stage, reps):
    """A stage of the tensor-core cumsums on CPU tensors is its plain version,
    with no launch, and that is the stage's function in numpy: within RTOL for
    the products, bitwise for the operand registers' sums."""
    x = torch.as_tensor(data["x"])
    before = (rs.cumsum_stage_launches, dict(rs.form_launches))
    out, obs = rs.cumsum_stage(x, mode, stage, reps)
    assert obs is None and (rs.cumsum_stage_launches, rs.form_launches) == before
    assert torch.equal(out, rs.cumsum_stage_plain(x, mode, stage, reps))
    want = _cumsum_stage_np(data["x"], mode, stage, reps)
    if stage == "operand":
        np.testing.assert_array_equal(out.numpy().reshape(want.shape), want)
    else:
        assert _err_of_max(out.numpy().reshape(want.shape), want) <= mxu_micro.RTOL
    if stage == "full" and reps == rs.REPS:
        np.testing.assert_array_equal(out.numpy(), plain_out[f"cumsum_{mode}"])
    with pytest.raises(ValueError):
        rs.cumsum_stage(x, mode, stage + "_", reps)


def test_cumsum_stages_are_the_kernels():
    """ops/reduce_scan.py's cumsum stage names are enum CumsumStage's, in
    order."""
    import re

    enum = re.search(r"enum CumsumStage \{([^}]*)\}", open(CU).read()).group(1)
    names = [re.sub(r"(?<!^)(?=[A-Z])", "_", v.split("=")[0].strip()[len("kCs"):]).lower()
             for v in enum.split(",")]
    assert tuple(names) == rs.CUMSUM_STAGES


# ---- the 3xTF32 moments and accumulator kernels: layout, stages, sums ------------
#
# csrc/reduce_scan.cu's moments_tf32x3_kernel and acc_tf32x3_kernel take the
# contraction axis in the order mom_pixel / acc_pixel give (ops/reduce_scan.py
# copies them; a card test holds the copies to the C library's tables), split
# each rep's operand into big and small TF32 parts handed to the tensor cores
# unmasked (tf32_operand), and sum cs = small.B_big then big.B_small and cb =
# big.B_big down 16 k-steps of m16n8k8 products, then c += cb + cs in f32.


def _tf32_np(a):
    """tf32(a), round to nearest with ties away from zero, in numpy."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _operand_np(a):
    """bits(a) + 0x1000 as an f32: the kernels' unmasked operand register."""
    return (np.asarray(a, np.float32).view(np.uint32) + np.uint32(0x1000)).view(np.float32)


def test_tf32x3_constants_are_the_kernels():
    import re

    src = open(CU).read()
    assert int(re.search(r"constexpr int kTf32Steps = (\d+);", src).group(1)) == rs.TF32X3_STEPS
    for threads in ("kMomThreads", "kAccTcThreads"):
        n = int(re.search(rf"constexpr int {threads} = (\d+);", src).group(1))
        assert n // 32 == rs.TF32X3_WARPS, threads
    enum = re.search(r"enum Tf32Stage \{([^}]*)\}", src).group(1)
    names = [v.split("=")[0].strip()[len("kTf32"):].lower() for v in enum.split(",")]
    assert tuple(names) == rs.TF32X3_STAGES
    assert rs.MOM_SLICE * rs.TF32X3_WARPS == rs.PIX
    assert 8 * rs.TF32X3_STEPS == rs.K == rs.MOM_SLICE


def test_tf32x3_layouts_cover_the_chunk_and_load_in_vectors():
    """mom_pixel takes each pixel once, warp w's slice is pixel row w (the
    py of the kernel's basis table), and lane t's columns t and t + 4 over
    the 16 k-steps are 32 adjacent pixels (float4 loads); acc_pixel takes
    each of a CTA's 128 pixels once, rows g and g + 8 adjacent (float2)."""
    mom = rs.tf32x3_order_plain("moments")
    assert mom.shape == (rs.TF32X3_WARPS, rs.TF32X3_STEPS, 8)
    assert sorted(mom.reshape(-1).tolist()) == list(range(rs.PIX))
    assert torch.equal(mom // rs.W, torch.arange(8).view(8, 1, 1).expand_as(mom))
    for t in range(4):
        run = mom[:, :, [t, t + 4]].reshape(rs.TF32X3_WARPS, -1)
        assert torch.equal(run - run[:, :1], torch.arange(32).expand_as(run))
    acc = rs.tf32x3_order_plain("acc")
    assert sorted(acc.reshape(-1).tolist()) == list(range(128))
    assert torch.equal(acc[:, 8:] - acc[:, :8], torch.ones_like(acc[:, :8]))
    assert int(acc[:, 0].remainder(2).max()) == 0


def _tf32x3_stage_np(family, data, stage, reps):
    """The stage's function in numpy, float64 sums, its maps written out
    anew: the split stage sums pixel p of a splat row into moments column
    2 ((p % 128) // 32) + p % 2, and splat k of a pixel into accumulator row
    2 (k % 4) + (k % 8) // 4."""
    x = data["x"].reshape(mm.K, mm.PIX)
    b = data["b"] if family == "moments" else data["s"]
    bb = _tf32_np(b).astype(np.float64)
    bs = _tf32_np(b - _tf32_np(b)).astype(np.float64)
    acc = 0.0
    for i in range(reps):
        v = (x + np.float32(i)).astype(np.float32)
        if stage == "products":
            v = x
        big = _tf32_np(v)
        small = _tf32_np(v - big)
        if stage == "products":
            small = big
        big, small = big.astype(np.float64), small.astype(np.float64)
        if stage == "split":
            g = _operand_np(v - _tf32_np(v)).astype(np.float64)
            if family == "moments":
                p = np.arange(mm.PIX)
                m = np.zeros((mm.PIX, 8))
                m[p, 2 * ((p % 128) // 32) + p % 2] = 1.0
                acc = acc + g @ m
            else:
                k = np.arange(mm.K)
                m = np.zeros((8, mm.K))
                m[2 * (k % 4) + (k % 8) // 4, k] = 1.0
                acc = acc + m @ g
        elif family == "moments":
            acc = acc + small @ bb + big @ bs + big @ bb
        else:
            acc = acc + bb @ small + bs @ big + bb @ big
    return acc


@pytest.mark.parametrize("reps", [rs.REPS, 3])
@pytest.mark.parametrize("stage", rs.TF32X3_STAGES)
@pytest.mark.parametrize("family", ["moments", "acc"])
def test_tf32x3_stage_plain_on_the_cpu(data, plain_out, family, stage, reps):
    """A stage of the 3xTF32 kernels on CPU tensors is its plain version,
    with no launch, and that is the stage's function (numpy, float64 sums)
    within RTOL: "full" the 3xTF32 product itself; "products" the reps'
    products on tf32(x) split once; "split" the small operands' sums."""
    x, s = torch.as_tensor(data["x"]), torch.as_tensor(data["s"])
    before = (rs.tf32x3_stage_launches, dict(rs.form_launches))
    out, obs = rs.tf32x3_stage(family, x, s, stage, reps)
    assert obs is None and (rs.tf32x3_stage_launches, rs.form_launches) == before
    assert torch.equal(out, rs.tf32x3_stage_plain(family, x, s, stage, reps))
    want = _tf32x3_stage_np(family, data, stage, reps)
    assert _err_of_max(out.numpy().reshape(want.shape), want) <= mxu_micro.RTOL
    if stage == "full" and reps == rs.REPS:
        np.testing.assert_array_equal(out.numpy(), plain_out[f"{family}_tf32x3"])
    with pytest.raises(ValueError):
        rs.tf32x3_stage(family, x, s, stage + "_", reps)


def _mma_model(acc, a, b):
    """acc + a @ b with a's 8 columns taken in order, each product exact and
    added in float32: the model of one m16n8k8 product's sum."""
    for c in range(a.shape[-1]):
        acc = acc + a[..., :, c:c + 1] * b[..., c:c + 1, :]
    return acc


def tf32x3_kernel_model(family, x, s, reps):
    """The 3xTF32 kernels' sums in float32: per rep and warp, cs (small.B_big,
    then big.B_small) and cb (big.B_big) down the 16 k-steps in the kernel's
    column order (tf32x3_order_plain), c += cb + cs; the moments' 8 warps' c
    summed in warp order."""
    g0 = x.reshape(rs.K, rs.PIX)
    if family == "moments":
        order = rs.tf32x3_order_plain("moments")              # (warp, step, col)
        b_big, b_small = rs.split_tf32(rs.basis())            # (PIX, 8)
        c = torch.zeros((rs.TF32X3_WARPS, rs.K, 8))
        for i in range(reps):
            big, small = rs.split_tf32(g0 + float(i))
            cb = torch.zeros_like(c)
            cs = torch.zeros_like(c)
            for st in range(rs.TF32X3_STEPS):
                p = order[:, st]                              # (warp, col)
                a_big = big[:, p].permute(1, 0, 2)            # (warp, K, col)
                a_small = small[:, p].permute(1, 0, 2)
                cs = _mma_model(_mma_model(cs, a_small, b_big[p]), a_big, b_small[p])
                cb = _mma_model(cb, a_big, b_big[p])
            c = c + (cb + cs)
        out = c[0]
        for w in range(1, rs.TF32X3_WARPS):
            out = out + c[w]
        return out
    b_big, b_small = rs.split_tf32(s.T.contiguous())          # (K, 8)
    c = torch.zeros((rs.PIX, 8))
    for i in range(reps):
        big, small = rs.split_tf32((g0 + float(i)).T.contiguous())  # (PIX, K)
        cb = torch.zeros_like(c)
        cs = torch.zeros_like(c)
        for st in range(rs.TF32X3_STEPS):
            k = slice(8 * st, 8 * st + 8)
            cs = _mma_model(_mma_model(cs, small[:, k], b_big[k]), big[:, k], b_small[k])
            cb = _mma_model(cb, big[:, k], b_big[k])
        c = c + (cb + cs)
    return c.T.reshape(8, rs.H, rs.W)


@pytest.mark.parametrize("reps", [rs.REPS, 3])
@pytest.mark.parametrize("family", ["moments", "acc"])
def test_tf32x3_kernel_sums_within_rtol_of_plain(data, family, reps):
    """The kernels' order of f32 sums (the model above) lies within RTOL of
    moments_plain / acc_plain at mode tf32x3, the contract they are held to
    on the card."""
    x, s = torch.as_tensor(data["x"]), torch.as_tensor(data["s"])
    got = tf32x3_kernel_model(family, x, s, reps)
    want = rs.tf32x3_stage_plain(family, x, s, "full", reps)
    assert got.shape == want.shape
    assert mxu_micro.scaled_err(got, want) <= mxu_micro.RTOL


# ---- the CUDA-core moments and accumulator kernels' order of sums ----------------
#
# csrc/reduce_scan.cu's moments_cuda_kernel: a warp per splat, lane l the
# columns 4 l + c of the 8 rows; per rep and column the row sums s0 (row
# order), s1 and s2 (FMAs with immediates r and r^2, from row 1's term), then
# the lane sums S0, Sy, Syy (adds) and Sx, Sxx, Sxy (FMAs with px = 4 l + c and
# px^2), across all reps; one xor butterfly (16, 8, 4, 2, 1) at the end.
# acc_cuda_kernel: warp w the splats 16 w + j, a lane's sums a[n][p] =
# fma(s[n][k], x[k][p] + i, a[n][p]) across reps, splats in order within a
# rep; then the 8 warps' partial sums added in warp order. The models repeat
# that arithmetic in float32 (an FMA as a float64 product and sum rounded
# once to float32).


def moments_cuda_model(x, reps):
    xs = np.asarray(x, np.float32).reshape(mm.K, 8, 32, rs.MOM_CUDA_COLS)  # splat, row, lane, col
    px = np.arange(mm.W, dtype=np.float32).reshape(32, rs.MOM_CUDA_COLS)
    px2 = (px * px).astype(np.float32)
    S = np.zeros((6, mm.K, 32), np.float32)  # S0, Sx, Sy, Sxx, Sxy, Syy
    for i in range(reps):
        for c in range(rs.MOM_CUDA_COLS):
            g = (xs[..., c] + np.float32(i)).astype(np.float32)  # (K, 8, 32)
            s0 = g[:, 0]
            for r in range(1, 8):
                s0 = (s0 + g[:, r]).astype(np.float32)
            s1 = s2 = g[:, 1]
            for r in range(2, 8):
                s1 = _fma(np.float32(r), g[:, r], s1)
                s2 = _fma(np.float32(r * r), g[:, r], s2)
            S[0] = S[0] + s0
            S[2] = S[2] + s1
            S[5] = S[5] + s2
            S[1] = _fma(px[:, c], s0, S[1])
            S[3] = _fma(px2[:, c], s0, S[3])
            S[4] = _fma(px[:, c], s1, S[4])
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        S = (S + S[:, :, lanes ^ o]).astype(np.float32)
    lane0 = S[:, :, 0]
    return np.stack([lane0[m] for m in (0, 1, 2, 3, 4, 5, 0, 1)], 1)


def acc_cuda_model(x, s, reps):
    g0 = np.asarray(x, np.float32).reshape(mm.K, mm.PIX)
    s5 = np.asarray(s, np.float32)[:5]
    warps = mm.K // rs.ACC_CUDA_SPLATS
    a = np.zeros((warps, 5, mm.PIX), np.float32)
    first = rs.ACC_CUDA_SPLATS * np.arange(warps)
    for i in range(reps):
        for j in range(rs.ACC_CUDA_SPLATS):
            k = first + j  # each warp's j-th splat
            v = (g0[k] + np.float32(i)).astype(np.float32)  # (warps, PIX)
            a = _fma(s5[:, k].T[:, :, None], v[:, None, :], a)
    out = a[0]
    for w in range(1, warps):
        out = (out + a[w]).astype(np.float32)
    return np.concatenate([out, out[:3]]).reshape(8, mm.H, mm.W)


def _jax_vpu(name, data, reps, monkeypatch):
    """kern_moments_vpu or kern_acc_vpu in interpret mode with no grid, its
    REPS set to reps."""
    kernel, shape, extra = PALLAS[name]
    monkeypatch.setattr(mm, "REPS", reps)
    call = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                          interpret=True)
    return np.asarray(call(*(jnp.asarray(data[k]) for k in ("x",) + extra)))


def test_cuda_constants_are_the_kernels():
    """The CUDA-core kernels' shapes and stages that ops/reduce_scan.py and
    the models above copy are csrc/reduce_scan.cu's."""
    import re

    src = open(CU).read()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]*);", src).group(1).split("//")[0].strip()

    assert int(const("kMomThreads")) // 32 == rs.CUDA_WARPS
    assert int(const("kAccCudaThreads")) // 32 == rs.CUDA_WARPS
    assert int(const("kMomCudaCols")) == rs.MOM_CUDA_COLS == rs.W // 32
    assert const("kAccCudaSplats") == "kK / kAccCudaWarps"
    assert const("kAccCudaPix") == "128 / 32" and rs.ACC_CUDA_PIX == 128 // 32
    assert rs.ACC_CUDA_SPLATS * rs.CUDA_WARPS == rs.K
    enum = re.search(r"enum CudaStage \{([^}]*)\}", src).group(1)
    names = [v.split("=")[0].strip()[len("kCuda"):].lower() for v in enum.split(",")]
    assert tuple(names) == rs.CUDA_STAGES


@pytest.mark.parametrize("reps", [rs.REPS, 3])
@pytest.mark.parametrize("family", ["moments", "acc"])
def test_cuda_kernel_sums_within_rtol(data, pallas_out, family, reps, monkeypatch):
    """The CUDA-core kernels' order of f32 sums (the models above) lies within
    RTOL of the plain version and of the Pallas kernel in interpret mode
    (kern_moments_vpu, kern_acc_vpu), the contract they are held to on the
    card; the moments also within 1e-6 of an f64 sum, as on the card."""
    name = f"{family}_cuda"
    if family == "moments":
        got = moments_cuda_model(data["x"], reps)
    else:
        got = acc_cuda_model(data["x"], data["s"], reps)
    x, s = torch.as_tensor(data["x"]), torch.as_tensor(data["s"])
    plain = rs.run_plain(name, x, s, reps).numpy()
    assert got.shape == plain.shape and np.isfinite(got).all()
    assert _err_of_max(got, plain.astype(np.float64)) <= mxu_micro.RTOL
    pallas = pallas_out[name] if reps == rs.REPS else _jax_vpu(name, data, reps, monkeypatch)
    assert _err_of_max(got, pallas.astype(np.float64)) <= mxu_micro.RTOL
    if family == "moments":
        g = data["x"].reshape(mm.K, mm.PIX).astype(np.float64)
        ref = sum((g + i) @ data["b"].astype(np.float64) for i in range(reps))
        assert _err_of_max(got[:, :6], ref[:, :6]) < 1e-6


@pytest.mark.parametrize("reps", [rs.REPS, 3])
@pytest.mark.parametrize("stage", rs.CUDA_STAGES)
@pytest.mark.parametrize("family", ["moments", "acc"])
def test_cuda_stage_plain_on_the_cpu(data, plain_out, family, stage, reps):
    """A stage of the CUDA-core kernels on CPU tensors is its plain version,
    with no launch: "full" the run's plain version; "loads" x summed over
    the contracted axis into the first output and its repeat, in float64
    within RTOL, whatever reps."""
    x, s = torch.as_tensor(data["x"]), torch.as_tensor(data["s"])
    before = (rs.cuda_stage_launches, dict(rs.form_launches))
    out, obs = rs.cuda_stage(family, x, s, stage, reps)
    assert obs is None and (rs.cuda_stage_launches, rs.form_launches) == before
    assert torch.equal(out, rs.cuda_stage_plain(family, x, s, stage, reps))
    if stage == "full":
        assert torch.equal(out, rs.run_plain(f"{family}_cuda", x, s, reps))
        if reps == rs.REPS:
            np.testing.assert_array_equal(out.numpy(), plain_out[f"{family}_cuda"])
    else:
        g = data["x"].reshape(mm.K, mm.PIX).astype(np.float64)
        if family == "moments":
            want = np.zeros((mm.K, 8))
            want[:, 0] = want[:, 6] = g.sum(1)
        else:
            want = np.zeros((8, mm.PIX))
            want[0] = want[5] = g.sum(0)
        assert _err_of_max(out.numpy().reshape(want.shape), want) <= mxu_micro.RTOL
    with pytest.raises(ValueError):
        rs.cuda_stage(family, x, s, stage + "_", reps)


def test_tc_rate_forms_and_arithmetic():
    """tools/tc_rate.py's form codes are csrc/tc_rate.cu's, its TFLOP/s count
    eight instructions a round for each warp or warpgroup, and it needs a
    card."""
    import re

    from moss_torch.tools import tc_rate

    src = open(os.path.join(REPO, "moss_torch", "csrc", "tc_rate.cu")).read()
    enum = re.search(r"enum Form \{([^}]*)\}", src).group(1)
    codes = [int(v.split("=")[1]) for v in enum.split(",")]
    assert sorted(list(tc_rate.FORMS.values()) + [tc_rate.SPLIT_ALONE]) == codes
    # 132 CTAs of 256 threads, 2048 rounds in 1 ms: 8 warps or 2 warpgroups a CTA
    per_ms = 2 * 8 * 2048 * 132 / 1e-3 / 1e12
    assert tc_rate.tflops("mma_m16n8k8", 1.0, 132) == pytest.approx(1024 * 8 * per_ms)
    assert tc_rate.tflops("wgmma_m64n8k8", 1.0, 132) == pytest.approx(4096 * 2 * per_ms)
    assert tc_rate.tflops("wgmma_m64n16k8", 1.0, 132) == pytest.approx(8192 * 2 * per_ms)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc_rate.main("cpu")


def test_compare_summary_and_modes():
    """tools/compare.py: each entry's median over the turns and each kind's
    sum; a child script per kind of kernel."""
    from moss_torch.tools import compare

    assert sorted(compare.CHILD) == ["conv", "mxu"]
    turns = [{"runs": {"a": 1.0, "b": 4.0}}, {"runs": {"a": 3.0, "b": 2.0}}]
    got = compare.summary(turns)
    assert got == {"runs": {"a": 2.0, "b": 3.0}, "sum_runs": 5.0}
    assert compare.same_outputs(turns) == {}
    # the mxu turns' output digests: the same in every turn, or not
    digests = [{"a": "1", "b": "2"}, {"a": "1", "b": "3"}, {"a": "1", "b": "2"}]
    turns = [{**t, "digests": d} for t, d in zip(turns + turns[:1], digests)]
    assert compare.summary(turns) == {"runs": {"a": 1.0, "b": 4.0}, "sum_runs": 5.0}
    assert compare.same_outputs(turns) == {"a": True, "b": False}
    with pytest.raises(SystemExit):
        compare.main(["root", "--what", "sort"])
