"""Arbitrage-free (generalized) Nelson–Siegel models — AFNS3 / AFNS5.

Counterpart of ``yieldfactormodels_jl_tpu/models/afns.py``.  Measurement:
y(τ) = Z(τ)·X + α(τ) + ε with α(τ) = −½∫₀¹ B(uτ)ᵀ Ω B(uτ) du, B(s) the
bond-price factor loadings, evaluated by the same fixed-grid trapezoid (64
intervals).  Every function broadcasts over leading batch (draw) axes of γ
and Ω.
"""

from __future__ import annotations

import torch

from .loadings import LAMBDA_FLOOR


def afns_lambdas(gamma):
    """λᵢ = 1e-2 + exp(γᵢ)."""
    return LAMBDA_FLOOR + torch.exp(gamma)


def afns_loadings(gamma, maturities, M: int):
    """(..., N, M) yield loading matrix; M ∈ {3, 5}; γ of shape (..., n_lam)."""
    lams = afns_lambdas(gamma)
    ones = torch.ones(lams.shape[:-1] + maturities.shape,
                      dtype=maturities.dtype, device=maturities.device)
    cols = [ones]
    for i in range((M - 1) // 2):
        tau = lams[..., i:i + 1] * maturities
        z = torch.exp(-tau)
        slope = (1.0 - z) / tau
        cols.append(slope)
        cols.append(slope - z)
    return torch.stack(cols, dim=-1)


def _price_loadings(s, lams, M: int):
    """B(s): bond-price factor loadings at time-to-maturity ``s`` (N, Q+1)
    for decays ``lams`` (..., n_lam); returns (..., N, Q+1, M)."""
    cols = [(-s).expand(lams.shape[:-1] + s.shape)]
    for i in range((M - 1) // 2):
        lam = lams[..., i, None, None]
        e = torch.exp(-lam * s)
        b_slope = -(1.0 - e) / lam
        b_curv = s * e + b_slope
        cols.append(b_slope)
        cols.append(b_curv)
    return torch.stack(cols, dim=-1)


def yield_adjustment(gamma, Omega_state, maturities, M: int, quad_points: int = 64):
    """α(τ) = −½ ∫₀¹ B(uτ)ᵀ Ω B(uτ) du per maturity, trapezoid in u;
    returns (..., N)."""
    lams = afns_lambdas(gamma)
    u = torch.linspace(0.0, 1.0, quad_points + 1, dtype=maturities.dtype,
                       device=maturities.device)
    s = maturities[:, None] * u[None, :]                    # (N, Q+1)
    B = _price_loadings(s, lams, M)                         # (..., N, Q+1, M)
    f = torch.einsum("...nqi,...ij,...nqj->...nq", B, Omega_state, B)
    w = torch.ones_like(u)
    w[0] = 0.5
    w[-1] = 0.5
    integral = f @ (w / quad_points)                        # (..., N)
    return -0.5 * integral
