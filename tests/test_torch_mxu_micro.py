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
    assert list(res["cuda_stages"]) == list(rs.CUDA_FAMILIES)
    assert all(list(rows) == list(rs.CUDA_STAGES) and
               all(r["scaled_err"] == 0.0 for r in rows.values())
               for rows in res["cuda_stages"].values())
    assert list(res["bf16_stages"]) == list(rs.BF16_FAMILIES)
    assert all(list(rows) == list(rs.BF16_STAGES) and
               all(r["scaled_err"] == 0.0 for r in rows.values())
               for rows in res["bf16_stages"].values())
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
@pytest.mark.parametrize("family", rs.CUDA_FAMILIES)
def test_cuda_stage_plain_on_the_cpu(data, plain_out, family, stage, reps):
    """A stage of the CUDA-core kernels on CPU tensors is its plain version,
    with no launch: "full" the run's plain version; "loads" x summed over
    the contracted axis into the first output and its repeat, in float64
    within RTOL (the scans': x itself; the reshape's: x summed over the 8
    rows), whatever reps."""
    x, s = torch.as_tensor(data["x"]), torch.as_tensor(data["s"])
    before = (rs.cuda_stage_launches, dict(rs.form_launches))
    out, obs = rs.cuda_stage(family, x, s, stage, reps)
    assert obs is None and (rs.cuda_stage_launches, rs.form_launches) == before
    assert torch.equal(out, rs.cuda_stage_plain(family, x, s, stage, reps))
    if stage == "full":
        assert torch.equal(out, rs.run_plain(rs.CUDA_RUNS[family], x, s, reps))
        if reps == rs.REPS:
            np.testing.assert_array_equal(out.numpy(), plain_out[rs.CUDA_RUNS[family]])
    elif family in ("cumsum", "cumprod"):
        np.testing.assert_array_equal(out.numpy(), data["x"])
    elif family == "reshape":
        assert out.shape == (mm.K, mm.W)
        want = data["x"].astype(np.float64).sum(1)
        assert _err_of_max(out.numpy(), want) <= mxu_micro.RTOL
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
    """tools/tc_rate.py's form and operand-work codes are csrc/tc_rate.cu's,
    its TFLOP/s count eight instructions a round for each warp or
    warpgroup, each form against its own peak, and it needs a card."""
    import re

    from moss_torch.tools import tc_rate

    src = open(os.path.join(REPO, "moss_torch", "csrc", "tc_rate.cu")).read()
    enum = re.search(r"enum Form \{([^}]*)\}", src).group(1)
    codes = [int(v.split("=")[1]) for v in enum.split(",")]
    assert sorted(list(tc_rate.FORMS.values()) + [tc_rate.WORK_ALONE]) == codes
    enum = re.search(r"enum Work \{([^}]*)\}", src).group(1)
    work = {v.split("=")[0].strip(): int(v.split("=")[1]) for v in enum.split(",")}
    assert work == {"kNoWork": 0, "kSplitWork": tc_rate.WORK["split"],
                    "kBf16Work": tc_rate.WORK["bf16"]}
    assert tc_rate.PEAK["mma_bf16_m16n8k16"] == tc_rate.PEAK_BF16
    assert tc_rate.FORM_WORK == {"mma_m16n8k8": "split", "wgmma_m64n8k8": "split",
                                 "wgmma_m64n16k8": "split", "mma_bf16_m16n8k16": "bf16"}
    # 132 CTAs of 256 threads, 2048 rounds in 1 ms: 8 warps or 2 warpgroups a CTA
    per_ms = 2 * 8 * 2048 * 132 / 1e-3 / 1e12
    assert tc_rate.tflops("mma_m16n8k8", 1.0, 132) == pytest.approx(1024 * 8 * per_ms)
    assert tc_rate.tflops("wgmma_m64n8k8", 1.0, 132) == pytest.approx(4096 * 2 * per_ms)
    assert tc_rate.tflops("wgmma_m64n16k8", 1.0, 132) == pytest.approx(8192 * 2 * per_ms)
    assert tc_rate.tflops("mma_bf16_m16n8k16", 1.0, 132) == pytest.approx(2048 * 8 * per_ms)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc_rate.main("cpu")


def test_compare_summary_and_modes():
    """tools/compare.py: each entry's median over the turns and each kind's
    sum; a child script per kind of kernel."""
    from moss_torch.tools import compare

    assert sorted(compare.CHILD) == ["conv", "mxu", "sort"]
    turns = [{"runs": {"a": 1.0, "b": 4.0}}, {"runs": {"a": 3.0, "b": 2.0}}]
    got = compare.summary(turns)
    assert got == {"runs": {"a": 2.0, "b": 3.0}, "sum_runs": 5.0}
    assert compare.same_outputs(turns) == {}
    # the mxu turns' output digests: the same in every turn, or not
    digests = [{"a": "1", "b": "2"}, {"a": "1", "b": "3"}, {"a": "1", "b": "2"}]
    turns = [{**t, "digests": d} for t, d in zip(turns + turns[:1], digests)]
    assert compare.summary(turns) == {"runs": {"a": 1.0, "b": 4.0}, "sum_runs": 5.0}
    assert compare.same_outputs(turns) == {"a": True, "b": False}
    # the sort turns' 4R over R, by pass and stride
    sort = compare.summary([{"lane_R": {"s1": 1.0}, "lane_4R": {"s1": 2.5},
                             "row_R": {"s1": 2.0}, "row_4R": {"s1": 4.0}, "exact": {}}])
    assert compare.fold_ratios(sort) == {"lane": {"s1": 2.5}, "row": {"s1": 2.0}}
    with pytest.raises(SystemExit):
        compare.main(["root", "--what", "scan"])


# ---- the CUDA-core cumprod's walks and the bf16 moments' order of pixels --------------
#
# csrc/reduce_scan.cu's cumprod_cuda_kernel walks a pixel's 128 splats once
# for up to WALK_GROUP reps side by side (reps // 16 walks of 16, then one
# each of 8, 4, 2 and 1 as the rest's bits say): per splat each rep's
# alpha_sat, the mask, the running product, and the product added to the
# splat's sum in rep order, the sum carried from walk to walk. Its
# moments_bf16_kernel takes pixel 16 s + 4 t + e of warp w's row for lane t
# at k-step s (mom_bf16_pixel), and adds per rep and warp a chain of 8
# m16n8k16 products, two reps' chains side by side, into its sum.


def walk_sizes(reps):
    """The reps of each walk of cumprod_cuda_kernel and cumsum_cuda_kernel, in
    order."""
    sizes = [rs.WALK_GROUP] * (reps // rs.WALK_GROUP)
    return sizes + [b for b in (8, 4, 2, 1) if reps % rs.WALK_GROUP & b]


def alpha_sat_model(x, c):
    """csrc/reduce_scan.cu::alpha_sat in float32: mul.sat (the product rounded,
    then clamped to [0, 1], NaN to +0) and the min with 0.9."""
    a = (np.asarray(x, np.float32) * np.float32(c)).astype(np.float32)
    a = np.where(np.isnan(a), np.float32(0), np.clip(a, np.float32(0), np.float32(1)))
    return np.minimum(a, np.float32(0.9)).astype(np.float32)


def cumprod_walk_model(x, reps, fma_last):
    """The cumprod kernel's sums in float32, walk by walk, the reps inside
    the walk over the splats; fma_last: the last splat's product and add in
    one rounding (an FMA), as the kernel does."""
    g0 = np.asarray(x, np.float32).reshape(rs.K, rs.PIX)
    acc = np.zeros((rs.K, rs.PIX), np.float32)
    i0 = 0
    for size in walk_sizes(reps):
        c = [np.float32(0.01 * (i + 1)) for i in range(i0, i0 + size)]
        run = np.ones((size, rs.PIX), np.float32)
        for k in range(rs.K):
            s = acc[k]
            for r in range(size):
                a = alpha_sat_model(g0[k], c[r])
                g = np.where(a > np.float32(0.003), (np.float32(1) - a).astype(np.float32),
                             np.float32(1))
                if fma_last and k == rs.K - 1:
                    s = _fma(run[r], g, s)
                else:
                    run[r] = (run[r] * g).astype(np.float32)
                    s = (s + run[r]).astype(np.float32)
            acc[k] = s
        i0 += size
    return acc.reshape(rs.K, rs.H, rs.W)


@pytest.mark.parametrize("reps", [rs.REPS, rs.REPS // 3, 4 * rs.REPS])
def test_cumprod_walk_order_is_the_plain_order(data, reps):
    """The reps moved inside the walk change no operation of any output:
    each is still ((0 + r_0) + r_1) + ... in rep order with each r_i formed
    splat by splat, so the walks' model is bitwise scan_plain(op="mul") at
    REPS (one walk), REPS / 3 (walks of 4 and 1) and 4 REPS (four walks);
    with the kernel's FMA at the last splat it differs in that splat only,
    within RTOL, and in the Pallas kernel's interpret-mode output's RTOL."""
    x = torch.as_tensor(data["x"])
    plain = rs.scan_plain(x, reps, "mul", "cuda").numpy()
    assert sum(walk_sizes(reps)) == reps
    np.testing.assert_array_equal(cumprod_walk_model(data["x"], reps, fma_last=False), plain)
    fused = cumprod_walk_model(data["x"], reps, fma_last=True)
    differs = np.argwhere(fused != plain)
    assert len(differs) and set(differs[:, 0].tolist()) == {rs.K - 1}
    assert _err_of_max(fused, plain.astype(np.float64)) <= mxu_micro.RTOL


@pytest.mark.parametrize("reps", [rs.REPS, rs.REPS // 3, 4 * rs.REPS])
def test_cumprod_walk_model_within_rtol_of_pallas(data, pallas_out, reps, monkeypatch):
    """The kernel's sums (the walks' model with the last splat's FMA) within
    RTOL of kern_cumprod_vpu in interpret mode, its REPS set to reps."""
    pallas = (pallas_out["cumprod_cuda"] if reps == rs.REPS
              else _jax_vpu("cumprod_cuda", data, reps, monkeypatch))
    got = cumprod_walk_model(data["x"], reps, fma_last=True)
    assert _err_of_max(got, pallas.astype(np.float64)) <= mxu_micro.RTOL


def test_alpha_sat_model_is_rep_alpha(data):
    """The saturating multiply and the min give rep_alpha's alpha on the
    tool's x and at the edges (+-0, a NaN, 0.003 / c_i and its neighbours,
    values past the clip, infinities), for every rep's c_i: equal values
    where rep_alpha is a number, and everywhere the same masked factor
    (a > 0.003 ? 1 - a : 1), bit for bit; a NaN x, whose rep_alpha is NaN,
    gets 0, which the mask sends to 1 as it does the NaN. The kernel forms
    that factor as fma(-a, mask, 1), mask 1.0 or 0.0 (masked_one_minus):
    bitwise the select's."""
    edges = []
    for i in range(4 * rs.REPS):
        t = np.float32(0.003) / np.float32(0.01 * (i + 1))
        edges += [t, np.nextafter(t, np.float32(0)), np.nextafter(t, np.float32(1))]
    x = np.concatenate([data["x"].reshape(-1), np.float32(edges),
                        np.float32([0.0, -0.0, np.nan, 1e30, -1e30, np.inf, -np.inf, 90.0, 91.0,
                                    1e-40, -1e-40])]).astype(np.float32)
    xt = torch.as_tensor(x)
    for i in range(4 * rs.REPS):
        want = rs.rep_alpha(xt, i).numpy()
        got = alpha_sat_model(x, np.float32(0.01 * (i + 1)))
        number = ~np.isnan(want)
        assert np.array_equal(got[number], want[number])
        assert not np.isnan(got).any() and (got[~number] == 0).all()

        def mask(a):
            return np.where(a > np.float32(0.003), (np.float32(1) - a).astype(np.float32),
                            np.float32(1)).astype(np.float32)

        assert np.array_equal(mask(got).view(np.int32), mask(want).view(np.int32))
        # the kernel's form of the masked factor: fma(-a, [a > 0.003], 1)
        fma_form = _fma(-got, (got > np.float32(0.003)).astype(np.float32), np.float32(1))
        assert np.array_equal(fma_form.view(np.int32), mask(got).view(np.int32))


def test_bf16_moments_order_covers_the_chunk_and_loads_in_float4():
    """mom_bf16_pixel takes each pixel once, warp w's slice is pixel row w
    (the py of the kernel's basis table), a k-step's 16 columns are 16
    adjacent pixels, and lane t's columns 2t, 2t + 1, 2t + 8, 2t + 9 are the
    four adjacent pixels of one float4, 16-byte aligned (a multiple of 4)."""
    order = rs.bf16_order_plain()
    assert order.shape == (rs.TF32X3_WARPS, rs.BF16_STEPS, 16)
    assert sorted(order.reshape(-1).tolist()) == list(range(rs.PIX))
    assert torch.equal(order // rs.W, torch.arange(8).view(8, 1, 1).expand_as(order))
    assert torch.equal(order.sort(-1).values - order[..., :1].min(-1, keepdim=True).values,
                       torch.arange(16).expand_as(order))
    for t in range(4):
        quad = order[..., [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]]
        assert torch.equal(quad - quad[..., :1], torch.arange(4).expand_as(quad))
        assert int(quad[..., 0].remainder(4).max()) == 0


def bf16_moments_kernel_model(x, reps):
    """The bf16 moments kernel's sums in float32: per rep and warp, cb down
    its 8 k-steps, each m16n8k16 product's 16 columns in the kernel's order
    (bf16_order_plain) added to it one by one, each product exact; c += cb
    rep after rep; the 8 warps' c summed in warp order."""
    g0 = x.reshape(rs.K, rs.PIX)
    order = rs.bf16_order_plain()                              # (warp, step, col)
    b = rs.round_bf16(rs.basis())                              # (PIX, 8)
    c = torch.zeros((rs.TF32X3_WARPS, rs.K, 8))
    for i in range(reps):
        a = rs.round_bf16(g0 + float(i))
        cb = torch.zeros_like(c)
        for st in range(rs.BF16_STEPS):
            p = order[:, st]                                   # (warp, col)
            cb = _mma_model(cb, a[:, p].permute(1, 0, 2), b[p])
        c = c + cb
    out = c[0]
    for w in range(1, rs.TF32X3_WARPS):
        out = out + c[w]
    return out


@pytest.mark.parametrize("reps", [rs.REPS, rs.REPS // 3, 4 * rs.REPS])
def test_bf16_moments_order_within_rtol(data, pallas_out, reps, monkeypatch):
    """The new order of the bf16 moments' f32 sums (the model above) lies
    within RTOL of moments_plain at mode bf16, the contract the kernel is
    held to on the card, and within BF16_VS_F32_RTOL of kern_moments_mxu at
    DEFAULT in interpret mode (which on the CPU does not round to bf16)."""
    x = torch.as_tensor(data["x"])
    got = bf16_moments_kernel_model(x, reps)
    want = rs.moments_plain(x, reps, "bf16")
    assert got.shape == want.shape
    assert mxu_micro.scaled_err(got, want) <= mxu_micro.RTOL
    pallas = (pallas_out["moments_bf16"] if reps == rs.REPS
              else _jax_vpu("moments_bf16", data, reps, monkeypatch))
    assert _err_of_max(got.numpy()[:, :6], pallas[:, :6].astype(np.float64)) <= BF16_VS_F32_RTOL


def _bf16_stage_np(family, x, s, stage, reps):
    """The bf16 moments' or accumulators' stage in numpy, float64 sums, their
    lane maps written out anew. Moments: lane t of every k-step holds pixels
    p with p % 16 in 4t, ..., 4t + 3; the pairs (p, p + 1) of it, p % 4 = 0,
    feed column 2t, (p + 2, p + 3) column 2t + 1. Accumulators: lane t holds
    the splats k with k % 16 in 2t, 2t + 1 (the pair feeding row 2t) and 2t +
    8, 2t + 9 (row 2t + 1) of every pixel."""
    g = np.asarray(x, np.float32).reshape(mm.K, mm.PIX)
    moments = family == "moments"
    if moments:
        lane_of = (np.arange(mm.PIX) % 16) // 4           # by pixel
        q = np.arange(mm.PIX // 2)                         # the pair of pixels 2q, 2q + 1
        row_of_pair = 2 * ((2 * q % 16) // 4) + (q % 2)
        out = np.zeros((mm.K, 8))
    else:
        lane_of = (np.arange(mm.K) % 8) // 2               # by splat
        j = np.arange(mm.K // 2)                           # the pair of splats 2j, 2j + 1
        row_of_pair = 2 * ((2 * j % 16) % 8 // 2) + (2 * j % 16) // 8
        out = np.zeros((8, mm.PIX))
    if stage == "loads":
        for lane in range(4):
            if moments:
                out[:, 2 * lane] = g[:, lane_of == lane].astype(np.float64).sum(1)
            else:
                out[2 * lane] = g[lane_of == lane].astype(np.float64).sum(0)
        return out
    if stage == "products":
        gb = np.asarray(rs.round_bf16(torch.as_tensor(g)), np.float64)
        if moments:
            return reps * (gb @ np.asarray(rs.round_bf16(rs.basis()), np.float64))
        return reps * (np.asarray(rs.round_bf16(torch.as_tensor(s)), np.float64) @ gb)
    for i in range(reps):
        hi = np.asarray(rs.round_bf16(torch.as_tensor(g + np.float32(i))), np.float32)
        bits = hi.view(np.uint32)
        for n in range(8):
            if moments:  # (K, 512), the low half the lower pixel
                pair = ((bits[:, 1::2] & 0xFFFF0000) | (bits[:, 0::2] >> 16)).view(np.float32)
                out[:, n] += pair[:, row_of_pair == n].astype(np.float64).sum(1)
            else:        # (64, PIX), the low half the lower splat
                pair = ((bits[1::2] & 0xFFFF0000) | (bits[0::2] >> 16)).view(np.float32)
                out[n] += pair[row_of_pair == n].astype(np.float64).sum(0)
    return out


@pytest.mark.parametrize("reps", [rs.REPS, rs.REPS // 3])
@pytest.mark.parametrize("stage", rs.BF16_STAGES)
@pytest.mark.parametrize("family", rs.BF16_FAMILIES)
def test_bf16_stage_plain_on_the_cpu(data, plain_out, family, stage, reps):
    """A stage of the bf16 moments or accumulator kernel on CPU tensors is
    its plain version, with no launch, and that is the stage's function
    (numpy, float64 sums) within RTOL: "full" the bf16 function itself,
    "loads" x summed by lane, "operands" the pair registers summed by slot,
    "products" the reps' products on x rounded once."""
    x, s = torch.as_tensor(data["x"]), torch.as_tensor(data["s"])
    before = (rs.bf16_stage_launches, dict(rs.form_launches))
    out, obs = rs.bf16_stage(family, x, s, stage, reps)
    assert obs is None and (rs.bf16_stage_launches, rs.form_launches) == before
    assert torch.equal(out, rs.bf16_stage_plain(family, x, s, stage, reps))
    name = f"{family}_bf16"
    if stage == "full":
        assert torch.equal(out, rs.run_plain(name, x, s, reps))
        if reps == rs.REPS:
            np.testing.assert_array_equal(out.numpy(), plain_out[name])
    else:
        want = _bf16_stage_np(family, data["x"], data["s"], stage, reps)
        assert _err_of_max(out.numpy().reshape(want.shape), want) <= mxu_micro.RTOL
    with pytest.raises(ValueError):
        rs.bf16_stage(family, x, s, stage + "_", reps)


def test_redesigned_constants_are_the_kernels():
    """The cumprod's, the bf16 moments' and the reshape's shapes, stages and
    the occupancy query's kernels that ops/reduce_scan.py and the models
    above copy are csrc/reduce_scan.cu's."""
    import re

    src = open(CU).read()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]*);", src).group(1).split("//")[0].strip()

    assert int(const("kWalkGroup")) == rs.WALK_GROUP
    assert int(const("kWalkBatch")) == rs.WALK_BATCH and rs.K % rs.WALK_BATCH == 0
    assert const("kBf16Steps") == "128 / 16" and rs.BF16_STEPS == 128 // 16
    assert int(const("kBf16InFlight")) == rs.BF16_IN_FLIGHT
    assert int(const("kAccBf16Threads")) // 32 == rs.ACC_BF16_WARPS
    assert int(const("kReshapeThreads")) == rs.RESHAPE_THREADS
    assert int(const("kReshapeCols")) == rs.RESHAPE_COLS and rs.W % rs.RESHAPE_COLS == 0
    assert int(const("kReshapeTiles")) == rs.RESHAPE_TILES
    assert const("kReshapeParts") == "kK * kW / (kReshapeThreads * kReshapeCols)"
    enum = re.search(r"enum Bf16Stage \{([^}]*)\}", src).group(1)
    names = [v.split("=")[0].strip()[len("kBf16"):].lower() for v in enum.split(",")]
    assert tuple(names) == rs.BF16_STAGES
    body = src[src.index('extern "C" int moss_mxu_ctas_per_sm'):]
    kernels = re.findall(r"kernel == (\d)\)\s*e = cudaOccupancyMaxActiveBlocksPerMultiprocessor"
                         r"\(&n, (\w+)_kernel<", body)
    assert [int(k) for k, _ in kernels] == list(range(len(rs.CTAS_KERNELS)))
    assert tuple(n for _, n in kernels) == rs.CTAS_KERNELS
    # the walks' decomposition: scan_walks' count, the model's sizes
    walks = re.search(r"return reps / kWalkGroup([^;]*);", src).group(1)
    assert walks.count("reps &") == 4
    for reps in range(0, 70):
        assert len(walk_sizes(reps)) == reps // 16 + bin(reps % 16).count("1")


# ---- the CUDA-core cumsum's walks and the bf16 accumulators' order of rows ------------
#
# csrc/reduce_scan.cu's cumsum_cuda_kernel takes the cumprod's walks
# (scan_walk, walk_sizes): per splat each rep's x + i, the running add, and
# the running sum added to the splat's sum in rep order, the sum carried from
# walk to walk; no product, so no FMA. Its acc_bf16_kernel takes pixel
# 16 w + 2 g (+ 1) as row g (g + 8) of warp w's m-tile (acc_pixel), loads a
# splat's two pixels as one float2, and adds per rep a chain of 8 m16n8k16
# products over the splats in order, two reps' chains side by side, into its
# sum.


def cumsum_walk_model(x, reps):
    """The cumsum kernel's sums in float32, walk by walk, the reps inside the
    walk over the splats."""
    g0 = np.asarray(x, np.float32).reshape(rs.K, rs.PIX)
    acc = np.zeros((rs.K, rs.PIX), np.float32)
    i0 = 0
    for size in walk_sizes(reps):
        run = np.zeros((size, rs.PIX), np.float32)
        for k in range(rs.K):
            s = acc[k]
            for r in range(size):
                run[r] = run[r] + (g0[k] + np.float32(i0 + r))
                s = s + run[r]
            acc[k] = s
        i0 += size
    return acc.reshape(rs.K, rs.H, rs.W)


@pytest.mark.parametrize("reps", [rs.REPS, rs.REPS // 3, 4 * rs.REPS])
def test_cumsum_walk_order_is_the_plain_order(data, pallas_out, reps, monkeypatch):
    """The reps moved inside the walk change no operation of any output: each
    is still ((0 + r_0) + r_1) + ... in rep order, each r_i formed splat by
    splat in the same adds, so the walks' model is bitwise
    scan_plain(op="add") at REPS (one walk), REPS / 3 (walks of 4 and 1) and
    4 REPS (four walks), and within RTOL of kern_cumsum_vpu in interpret
    mode, its REPS set to reps."""
    x = torch.as_tensor(data["x"])
    assert sum(walk_sizes(reps)) == reps
    got = cumsum_walk_model(data["x"], reps)
    np.testing.assert_array_equal(got, rs.scan_plain(x, reps, "add", "cuda").numpy())
    pallas = (pallas_out["cumsum_cuda"] if reps == rs.REPS
              else _jax_vpu("cumsum_cuda", data, reps, monkeypatch))
    assert _err_of_max(got, pallas.astype(np.float64)) <= mxu_micro.RTOL


def test_bf16_acc_rows_cover_the_cta_and_load_in_float2():
    """acc_bf16_kernel's loads, its address arithmetic written out: lane (g,
    t) of warp w reads splats 16 s + 2 t + e (e in 0, 1, 8, 9) at pixel p =
    acc_pixel(w, g) and p + 1, its rows g and g + 8, as one float2. Over the
    CTA's ACC_BF16_WARPS warps the rows take each of its 16 ACC_BF16_WARPS
    pixels once, every float2 is 8-byte aligned, and the loads read each
    (splat, pixel) of the CTA's columns of x once."""
    pixels = 16 * rs.ACC_BF16_WARPS
    assert rs.PIX % pixels == 0
    order = rs.tf32x3_order_plain("acc")[:rs.ACC_BF16_WARPS]     # (warp, row), acc_pixel
    assert sorted(order.reshape(-1).tolist()) == list(range(pixels))
    read = np.zeros((rs.K, pixels), int)
    for w in range(rs.ACC_BF16_WARPS):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            p = rs.acc_pixel(w, g)
            assert p + 1 == rs.acc_pixel(w, g + 8) and p % 2 == 0
            for st in range(rs.BF16_STEPS):
                for e in (0, 1, 8, 9):
                    read[16 * st + 2 * t + e, p:p + 2] += 1
    assert (read == 1).all()


def acc_bf16_kernel_model(x, s, reps):
    """The bf16 accumulators kernel's sums in float32: per rep and pixel, cb
    down its 8 k-steps, each m16n8k16 product's 16 splat columns in order
    added to it one by one, each product exact; c += cb rep after rep. Which
    m-tile row a pixel takes enters no sum."""
    g0 = x.reshape(rs.K, rs.PIX)
    b = rs.round_bf16(s.T.contiguous())                          # (K, 8)
    c = torch.zeros((rs.PIX, 8))
    for i in range(reps):
        a = rs.round_bf16((g0 + float(i)).T.contiguous())         # (PIX, K)
        cb = torch.zeros_like(c)
        for st in range(rs.BF16_STEPS):
            k = slice(16 * st, 16 * st + 16)
            cb = _mma_model(cb, a[:, k], b[k])
        c = c + cb
    return c.T.reshape(8, rs.H, rs.W)


@pytest.mark.parametrize("reps", [rs.REPS, rs.REPS // 3, 4 * rs.REPS])
def test_bf16_acc_order_within_rtol(data, pallas_out, reps, monkeypatch):
    """The bf16 accumulators' order of f32 sums (the model above) lies within
    RTOL of acc_plain at mode bf16, the contract the kernel is held to on the
    card, and within BF16_VS_F32_RTOL of kern_acc_mxu at DEFAULT in
    interpret mode (which on the CPU does not round to bf16)."""
    x, s = torch.as_tensor(data["x"]), torch.as_tensor(data["s"])
    got = acc_bf16_kernel_model(x, s, reps)
    want = rs.acc_plain(x, s, reps, "bf16")
    assert got.shape == want.shape
    assert mxu_micro.scaled_err(got, want) <= mxu_micro.RTOL
    pallas = (pallas_out["acc_bf16"] if reps == rs.REPS
              else _jax_vpu("acc_bf16", data, reps, monkeypatch))
    assert _err_of_max(got.numpy(), pallas.astype(np.float64)) <= BF16_VS_F32_RTOL


def test_stage_entry_points_are_the_kernels():
    """Each family of ops/reduce_scan.py's CUDA-core and bf16 stages has its C
    entry point, moss_mxu_<family>_cuda_stage or moss_mxu_<family>_bf16_stage,
    with the signature the wrappers give it."""
    import re

    src = open(CU).read()
    for families, kind in ((rs.CUDA_FAMILIES, "cuda"), (rs.BF16_FAMILIES, "bf16")):
        for family in families:
            symbol = f"moss_mxu_{family}_{kind}_stage"
            sig = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src)
            assert sig, symbol
            params = [a.strip() for a in sig.group(1).split(",")]
            pointers = sum("*" in a for a in params) - 1          # the stream is void*
            ints = sum(a.startswith("int ") for a in params)
            assert rs._SIGNATURES[symbol] == [rs._PTR] * pointers + [rs._INT] * ints, symbol


# ---- the reshape kernel's map and order of adds -----------------------------------
#
# csrc/reduce_scan.cu's reshape_kernel gives thread j of CTA column b the 4
# adjacent outputs e = 4 (256 b + j), ..., e + 3 (e = 128 k + w) and reads
# them as a float4 of each of the 8 rows of splat k; a CTA walks
# RESHAPE_TILES tiles, each tile's 8 loads before its reps. Per output:
# a = a + (x + i) for i = 0, ..., reps - 1, i carried as a float that counts
# up by 1, then the 8 rows summed in row order.


def reshape_parent_model(x, reps):
    """The order of the one-output-a-thread kernel, per element in float32:
    acc_h = ((0 + (x + 0)) + (x + 1)) + ..., i converted to float each rep,
    then ((acc_0 + acc_1) + acc_2) + ... + acc_7."""
    g = np.asarray(x, np.float32)                           # (K, 8, 128)
    acc = np.zeros_like(g)
    for i in range(reps):
        acc = (acc + (g + np.float32(i))).astype(np.float32)
    v = acc[:, 0]
    for h in range(1, rs.H):
        v = (v + acc[:, h]).astype(np.float32)
    return v


def reshape_kernel_model(x, reps):
    """reshape_kernel's sums, thread by thread: each thread's 4 columns of
    its 8 float4 rows, the rep's float counted up by 1.0 (exact below 2^24),
    rows summed in row order."""
    g = np.asarray(x, np.float32).reshape(rs.K, rs.H, rs.W // rs.RESHAPE_COLS, rs.RESHAPE_COLS)
    a = np.zeros_like(g)
    fi = np.float32(0)
    for _ in range(reps):
        a = (a + (g + fi)).astype(np.float32)
        fi = np.float32(fi + np.float32(1))
    v = a[:, 0]
    for h in range(1, rs.H):
        v = (v + a[:, h]).astype(np.float32)
    return v.reshape(rs.K, rs.W)


@pytest.mark.parametrize("reps", [rs.REPS, rs.REPS // 3, 4 * rs.REPS])
def test_reshape_kernel_order_is_the_parent_order(data, pallas_out, reps, monkeypatch):
    """Four columns a thread and a float rep counter change no operation of
    any output: the kernel's model is bitwise the one-element-a-thread
    order at REPS, REPS / 3 and 4 REPS, and within RTOL of reshape_only_plain
    and of kern_reshape_only in interpret mode, its REPS set to reps."""
    got = reshape_kernel_model(data["x"], reps)
    np.testing.assert_array_equal(got, reshape_parent_model(data["x"], reps))
    plain = rs.reshape_only_plain(torch.as_tensor(data["x"]), reps).numpy()
    assert _err_of_max(got, plain.astype(np.float64)) <= mxu_micro.RTOL
    pallas = (pallas_out["reshape_only"] if reps == rs.REPS
              else _jax_vpu("reshape_only", data, reps, monkeypatch))
    assert _err_of_max(got, pallas.astype(np.float64)) <= mxu_micro.RTOL


def test_reshape_map_covers_the_chunk_once_in_float4s():
    """reshape_kernel's loads, its address arithmetic written out: thread j of
    CTA column b reads x[k, h, w:w + 4] for the 8 rows h, w a multiple of 4
    (16-byte aligned), e = 4 (256 b + j) = 128 k + w; over the parts
    (kReshapeParts CTA columns) the reads take each element of the chunk
    once and the outputs each (k, w) once; a warp's float4s of a row are 512
    contiguous bytes; tiles group into CTAs of RESHAPE_TILES."""
    parts = rs.K * rs.W // (rs.RESHAPE_THREADS * rs.RESHAPE_COLS)
    read = np.zeros(rs.K * rs.PIX, int)
    written = np.zeros(rs.K * rs.W, int)
    for b in range(parts):
        for j in range(rs.RESHAPE_THREADS):
            e = (b * rs.RESHAPE_THREADS + j) * rs.RESHAPE_COLS
            k, w = divmod(e, rs.W)
            assert w % rs.RESHAPE_COLS == 0
            written[e:e + rs.RESHAPE_COLS] += 1
            for h in range(rs.H):
                at = k * rs.PIX + h * rs.W + w
                assert at % 4 == 0
                read[at:at + rs.RESHAPE_COLS] += 1
        for warp in range(rs.RESHAPE_THREADS // 32):
            first = (b * rs.RESHAPE_THREADS + 32 * warp) * rs.RESHAPE_COLS
            assert first % rs.W == 0  # a warp's 32 float4s are one row of one splat
    assert (read == 1).all() and (written == 1).all()
    assert rs.TILES % rs.RESHAPE_TILES == 0
