"""The 3x3 SVD behind the Fisher NLL (moss_torch/ops/fisher.py svd3, csrc/svd3.cu).

The kernel runs on the card only (tests/test_torch_cuda.py holds it to
torch.linalg.svd there). Here its algorithm, modelled step for step in
float32 numpy (one-sided Jacobi, fixed sweeps, the descending sort with det V,
u2 by Gram-Schmidt, u3 = u1 x u2 and s3's sign), is held to np.linalg.svd on
random, near-degenerate, rank-deficient, reflected and zero matrices: the
singular values, the proper ones (s3 times sign(det U det V)), the backward's
U diag(g) V^T and the reconstruction, each within 1e-5 of the largest
singular value. The plain version gives NaNs for a non-finite matrix, as
moss_tpu's XLA SVD does.
"""
import numpy as np
import pytest
import torch

from moss_torch.ops import fisher
from _torch_threads import two_torch_threads  # noqa: F401

SWEEPS = 8  # csrc/svd3.cu kSweeps
f32 = np.float32


def svd3_model(a):
    """csrc/svd3.cu for one matrix: (U, S, V, sign). A tiny dot product makes
    zeta^2 overflow to inf and the rotation the identity, in float32 as on
    the card."""
    with np.errstate(over="ignore"):
        return _svd3_model(a)


def _svd3_model(a):
    w = a.astype(f32).copy()
    v = np.eye(3, dtype=f32)
    det_v = f32(1)
    for _ in range(SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            alpha, beta, gamma = (f32(np.dot(w[:, p], w[:, p])), f32(np.dot(w[:, q], w[:, q])),
                                  f32(np.dot(w[:, p], w[:, q])))
            if gamma == 0 or abs(gamma) <= 1e-30:
                continue
            zeta = (beta - alpha) / (f32(2) * gamma)
            t = np.copysign(f32(1), zeta) / (abs(zeta) + np.sqrt(f32(1) + zeta * zeta))
            c = f32(1) / np.sqrt(f32(1) + t * t)
            s = c * t
            for m in (w, v):
                mp, mq = m[:, p].copy(), m[:, q].copy()
                m[:, p], m[:, q] = c * mp - s * mq, s * mp + c * mq
    s = np.sqrt((w * w).sum(0)).astype(f32)
    for pas in range(2):
        for j in range(2 - pas):
            if s[j] < s[j + 1]:
                s[[j, j + 1]] = s[[j + 1, j]]
                w[:, [j, j + 1]] = w[:, [j + 1, j]]
                v[:, [j, j + 1]] = v[:, [j + 1, j]]
                det_v = -det_v
    u = np.zeros((3, 3), f32)
    u[:, 0] = w[:, 0] / s[0] if s[0] > 0 else np.eye(3, dtype=f32)[0]
    x = w[:, 1] - np.dot(u[:, 0], w[:, 1]) * u[:, 0]
    nx = np.sqrt(np.dot(x, x))
    if not nx > 1e-30:
        e = np.eye(3, dtype=f32)[int(np.argmin(np.abs(u[:, 0])))]
        x = np.cross(u[:, 0], e)
        nx = np.sqrt(np.dot(x, x))
    u[:, 1] = x / nx
    u[:, 2] = np.cross(u[:, 0], u[:, 1])
    s3 = np.dot(u[:, 2], w[:, 2])
    flip = f32(-1) if s3 < 0 else f32(1)
    u[:, 2] *= flip
    return u, np.array([s[0], s[1], abs(s3)], f32), v, flip * det_v


def matrices():
    rng = np.random.default_rng(5)
    out = list(rng.normal(size=(40, 3, 3)))
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    out += [rot * 1e-3, np.diag([2.0, 2.0, 1e-4]) @ rot, np.diag([1.0, 1.0, 1.0]) * 0.7]
    out += [np.outer(rng.normal(size=3), rng.normal(size=3)),  # rank 1
            rng.normal(size=(3, 2)) @ rng.normal(size=(2, 3)),  # rank 2
            np.zeros((3, 3)), np.diag([1.0, -2.0, 3.0]), -np.eye(3) * 5.0,
            np.eye(3) + 1e-5 * rng.normal(size=(3, 3))]  # the pose MLPs' init
    return [np.asarray(m, np.float32) for m in out]


@pytest.mark.parametrize("k", range(len(matrices())))
def test_kernel_algorithm_against_lapack(k):
    a = matrices()[k]
    U, S, V, sign = svd3_model(a)
    Ur, Sr, Vhr = np.linalg.svd(a.astype(np.float64))
    Vr = Vhr.T
    sign_r = np.sign(np.linalg.det(Ur) * np.linalg.det(Vr))
    tol = 1e-5 * max(float(Sr[0]), 1.0)
    np.testing.assert_allclose(S, Sr, atol=tol)
    np.testing.assert_allclose(U @ U.T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(V @ V.T, np.eye(3), atol=1e-5)
    assert sign == np.sign(np.linalg.det(U) * np.linalg.det(V))
    np.testing.assert_allclose((U * S) @ V.T, a, atol=tol)
    if Sr[2] > 1e-3 * Sr[0]:  # sign(det F): the proper values agree
        assert sign == sign_r
        np.testing.assert_allclose(S * [1, 1, sign], Sr * [1, 1, sign_r], atol=tol)
    gaps = np.diff(Sr[::-1])
    if np.all(gaps > 1e-3 * max(Sr[0], 1.0)):  # distinct: U diag(g) V^T is unique
        g = np.array([0.3, -1.2, 0.7])
        np.testing.assert_allclose((U * (g * [1, 1, sign])) @ V.T,
                                   (Ur * (g * [1, 1, sign_r])) @ Vr.T, atol=1e-4)


def test_cpu_path_is_the_plain_version():
    a = torch.as_tensor(np.stack(matrices()))
    for x, y in zip(fisher.svd3(a), fisher.svd3_plain(a)):
        assert torch.equal(x, y)
    assert fisher.launches == 0


def test_plain_version_gives_nans_for_non_finite_matrices():
    a = torch.as_tensor(np.stack(matrices()[:3]))
    a[1, 0, 2] = float("nan")
    U, S, V, sign = fisher.svd3_plain(a)
    assert torch.isnan(S[1]).all() and torch.isnan(U[1]).all() and torch.isnan(sign[1])
    assert torch.isfinite(S[[0, 2]]).all()
    ref = fisher.svd3_plain(a[[0, 2]])
    assert torch.equal(S[[0, 2]], ref[1])
