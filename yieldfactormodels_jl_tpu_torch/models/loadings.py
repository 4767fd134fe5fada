"""Factor-loading builders for the Kalman DNS family.

Counterpart of the DNS half of ``yieldfactormodels_jl_tpu/models/loadings.py``:

    λ = 1e-2 + exp(γ);  Z1 = 1;  Z2 = (1 - e^{-λτ})/(λτ);  Z3 = Z2 - e^{-λτ}

Every function broadcasts over leading batch (draw) axes of γ.  The neural
loadings of the score-driven families are not ported yet.
"""

from __future__ import annotations

import torch

LAMBDA_FLOOR = 1e-2


def dns_lambda(gamma_scalar):
    """λ = 1e-2 + exp(γ)."""
    return LAMBDA_FLOOR + torch.exp(gamma_scalar)


def dns_slope_curvature(lam, maturities):
    """Columns 2 and 3 of the DNS loading matrix for decay rate(s) ``lam``
    (broadcast against ``maturities``)."""
    tau = lam * maturities
    z = torch.exp(-tau)
    z2 = (1.0 - z) / tau
    z3 = z2 - z
    return z2, z3


def dns_loadings(gamma, maturities):
    """(..., N, 3) DNS loading matrix from the driver γ of shape (..., 1)."""
    lam = dns_lambda(gamma[..., 0:1])  # (..., 1)
    z2, z3 = dns_slope_curvature(lam, maturities)
    return torch.stack([torch.ones_like(z2), z2, z3], dim=-1)
