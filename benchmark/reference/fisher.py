"""Matrix-Fisher negative log-likelihood over SMPL joint rotations.

A frozen copy of moss_torch/ops/fisher.py for the benchmark's reference (its
plain path only, imports pointed into benchmark.reference).

Port of moss_tpu/ops/fisher.py:

  * bessel0_exp_scaled: the polynomial I_0(x) / exp(|x|), branch-free;
  * log_mf_norm_constant: log c(S) by 512-trapezoid quadrature, with the
    hand-written backward of fisher.py:91-104 (the dc_bar/ds_k integrals of
    the three cyclic shifts) as a torch.autograd.Function;
  * proper_singular_values: S with s3 flipped by sign(det(U V^T)), with the
    backward dF = U diag(g) V^T of fisher.py:128-139, never differentiating
    through the SVD (stable at the near-degenerate S of the MLPs' init);
  * matrix_fisher_nll = -tr(F^T R) + 1.005 log c(S_proper).

The SVD is torch.linalg.svd on every device (the port runs csrc/svd3.cu on
the card).
"""
from __future__ import annotations

import torch


NUM_TRAPS = 512

_COEFFS_A = (1.0, 3.5156229, 3.0899424, 1.2067492, 0.2659732, 0.360768e-1, 0.45813e-2)
_COEFFS_B = (
    0.39894228, 0.1328592e-1, 0.225319e-2, -0.157565e-2, 0.916281e-2,
    -0.2057706e-1, 0.2635537e-1, -0.1647633e-1, 0.392377e-2,
)


def _horner(coeffs, x):
    z = torch.full_like(x, coeffs[-1])
    for c in coeffs[-2::-1]:
        z = z * x + c
    return z


def bessel0_exp_scaled(x):
    """I_0(x) / exp(|x|), elementwise and branch-free."""
    ax = torch.abs(x)
    small = _horner(_COEFFS_A, (ax / 3.75) ** 2) * torch.exp(-ax)
    ax_safe = torch.clamp_min(ax, 1e-20)  # the large branch is unused at 0
    large = _horner(_COEFFS_B, 3.75 / ax_safe) / torch.sqrt(ax_safe)
    return torch.where(ax <= 3.75, small, large)


def _trapezoid(func, s, num_traps: int = NUM_TRAPS):
    """Integrate func(u, s) over u in [-1, 1]."""
    u = torch.linspace(-1.0, 1.0, num_traps, dtype=s.dtype, device=s.device)[None, :]
    k = torch.arange(num_traps, device=s.device)  # no host value stored: no sync on a card
    w = torch.where((k == 0) | (k == num_traps - 1), 0.5, 1.0).to(s.dtype)
    return torch.sum(func(u, s) * w[None, :], dim=1) * (2.0 / (num_traps - 1))


def _integrand_cbar(u, s):
    f1 = bessel0_exp_scaled((s[:, 1:2] - s[:, 2:3]) * 0.5 * (1 - u))
    f2 = bessel0_exp_scaled((s[:, 1:2] + s[:, 2:3]) * 0.5 * (1 + u))
    f3 = torch.exp((s[:, 2:3] + s[:, 0:1]) * (u - 1))
    return f1 * f2 * f3


def _integrand_dcbar(u, s):
    s_i = torch.amax(s[:, 1:], dim=1, keepdim=True)
    s_j = torch.amin(s[:, 1:], dim=1, keepdim=True)
    s_k = s[:, 0:1]
    f1 = bessel0_exp_scaled((s_i - s_j) * 0.5 * (1 - u))
    f2 = bessel0_exp_scaled((s_i + s_j) * 0.5 * (1 + u))
    f3 = torch.exp((s_j + s_k) * (u - 1))
    return f1 * f2 * f3 * u


class LogMFNormConstant(torch.autograd.Function):
    """log c(S) = log c_bar(S) + tr(S) for proper singular values S (B, 3)."""

    @staticmethod
    def forward(ctx, S):
        c_bar = 0.5 * _trapezoid(_integrand_cbar, S)
        ctx.save_for_backward(S, c_bar)
        return torch.log(c_bar) + torch.sum(S, dim=1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        S, c_bar = ctx.saved_tensors
        parts = [0.5 * _trapezoid(_integrand_dcbar, torch.cat([S[:, i:], S[:, :i]], dim=1))
                 for i in range(3)]
        dc = torch.stack(parts, dim=1)  # (B, 3) = dc_bar/ds_k + c_bar
        return dc / c_bar[:, None] * g[:, None]


def svd3_plain(F_):
    """(U, S, V, sign) of (B, 3, 3): torch.linalg.svd, V = Vh^T, sign =
    sign(det U det V). A matrix with a non-finite entry gives NaNs, as XLA's
    SVD does (LAPACK would raise)."""
    finite = torch.isfinite(F_).all(-1).all(-1)
    U, S, Vh = torch.linalg.svd(torch.where(finite[..., None, None], F_, 0.0),
                                full_matrices=False)
    V = Vh.transpose(-1, -2)
    sign = torch.sign(torch.linalg.det(U) * torch.linalg.det(V))
    nan = float("nan")
    return (torch.where(finite[..., None, None], U, nan), torch.where(finite[..., None], S, nan),
            torch.where(finite[..., None, None], V, nan), torch.where(finite, sign, nan))


def svd3(F_):
    """The plain SVD: svd3_plain on any device (the reference has no kernel)."""
    return svd3_plain(F_)


class ProperSingularValues(torch.autograd.Function):
    """Proper singular values of (B, 3, 3): s3 times sign(det(U) det(V))."""

    @staticmethod
    def forward(ctx, F_):
        U, S, V, sign = svd3(F_)
        ctx.save_for_backward(U, V, sign)
        return torch.cat([S[..., :2], S[..., 2:] * sign[..., None]], dim=-1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        U, V, sign = ctx.saved_tensors
        g = torch.cat([g[..., :2], g[..., 2:] * sign[..., None]], dim=-1)
        return torch.einsum("...ik,...k,...jk->...ij", U, g, V)  # U diag(g) V^T


log_mf_norm_constant = LogMFNormConstant.apply
proper_singular_values = ProperSingularValues.apply


def proper_svd3(F_):
    """(U, S, V, S_proper) of (B, 3, 3): U, S, V detached (svd3); the grads
    flow through S_proper only."""
    U, S, V, _ = svd3(F_.detach())
    return U, S, V, proper_singular_values(F_)


def matrix_fisher_nll(pred_F, target_R, overreg: float = 1.005):
    """NLL of target rotations under MF(pred_F); (..., 3, 3) -> (...,)."""
    shape = pred_F.shape[:-2]
    F_ = pred_F.reshape(-1, 3, 3)
    R = target_R.reshape(-1, 3, 3)
    log_c = log_mf_norm_constant(proper_singular_values(F_))
    log_exponent = -torch.einsum("bij,bij->b", F_, R)
    return (log_exponent + overreg * log_c).reshape(shape)
