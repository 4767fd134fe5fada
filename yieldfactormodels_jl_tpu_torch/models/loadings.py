"""Factor-loading builders Z(γ): DNS and neural Nelson–Siegel loadings.

Counterpart of ``yieldfactormodels_jl_tpu/models/loadings.py``:

    λ = 1e-2 + exp(γ);  Z1 = 1;  Z2 = (1 - e^{-λτ})/(λτ);  Z3 = Z2 - e^{-λτ}

and the neural loadings of the score-driven families: two 1→3(tanh)→1 MLPs
maturity → loading, parameters packed as γ[0:9] / γ[9:18] with
W1 = γ[0:3], b1 = γ[3:6], W2 = γ[6:9], pinned to NS shape by
``utils/nn_transform.py``.  Every function broadcasts over leading batch
(draw) axes of γ.
"""

from __future__ import annotations

import torch

from ..utils.nn_transform import transform_net_1, transform_net_2

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


def mlp_curve(p9, maturities):
    """The 1→3(tanh)→1 (no output bias) loading net at each maturity:
    out[n] = Σ_j W2[j]·tanh(W1[j]·τ_n + b1[j]).  ``p9`` (..., 9) → (..., N)."""
    w1 = p9[..., 0:3]
    b1 = p9[..., 3:6]
    w2 = p9[..., 6:9]
    h = torch.tanh(maturities[:, None] * w1[..., None, :] + b1[..., None, :])
    return (h * w2[..., None, :]).sum(-1)


def neural_loadings(gamma18, maturities, transform_bool: bool):
    """(..., N, 3) neural NS loading matrix from the 18-wide γ state."""
    raw2 = mlp_curve(gamma18[..., 0:9], maturities)
    raw3 = mlp_curve(gamma18[..., 9:18], maturities)
    z2 = transform_net_1(raw2, maturities, transform_bool)
    z3 = transform_net_2(raw3, maturities, transform_bool)
    return torch.stack([torch.ones_like(z2), z2, z3], dim=-1)
