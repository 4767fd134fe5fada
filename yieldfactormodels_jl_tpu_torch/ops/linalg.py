"""Small dense linear-algebra helpers shared by the filters.

Counterpart of ``yieldfactormodels_jl_tpu/ops/linalg.py``.
"""

from __future__ import annotations

import torch

RIDGE = 1e-3


def _cholesky_or_nan(G):
    """Lower Cholesky factor of each (.., M, M) matrix, and whether it is
    usable: ``info == 0`` and every entry finite.  ``torch.linalg.cholesky``
    raises where ``jnp.linalg.cholesky`` returns NaN, so the ``_ex`` form
    reports the failure per matrix instead."""
    L, info = torch.linalg.cholesky_ex(G)
    ok = (info == 0) & torch.isfinite(L).flatten(-2).all(-1)
    return L, ok


def _ols_factor(Z):
    """Zᵀ and the Cholesky factor OLS solves with: the plain factor of ZᵀZ
    where it is usable, else the factor of ZᵀZ + 1e-3·I (NaN where that
    fails too, as the JAX package's Cholesky gives)."""
    M = Z.shape[-1]
    Zt = Z.transpose(-1, -2)
    G = Zt @ Z
    L, ok = _cholesky_or_nan(G)
    eye = torch.eye(M, dtype=G.dtype, device=G.device)
    L_r, ok_r = _cholesky_or_nan(G + RIDGE * eye)
    nan = torch.full_like(L_r, float("nan"))
    L_r = torch.where(ok_r[..., None, None], L_r, nan)
    return Zt, torch.where(ok[..., None, None], L, L_r)


def ols_solve(Z, y):
    """β = (ZᵀZ)⁻¹Zᵀy via Cholesky, with the reference's ridge fallback.

    ``Z`` (..., N, M), ``y`` (..., N) → (..., M).  Both factors are taken
    and one is selected per matrix (``_ols_factor``)."""
    Zt, L_sel = _ols_factor(Z)
    return torch.cholesky_solve(Zt @ y.unsqueeze(-1), L_sel).squeeze(-1)


def ols_solve_columns(Z, Y):
    """:func:`ols_solve` of every column of ``Y`` (N, K) at once against
    ``Z`` (..., N, M): one factor a matrix, K right-hand sides → (..., K, M)."""
    Zt, L_sel = _ols_factor(Z)
    return torch.cholesky_solve(Zt @ Y, L_sel).transpose(-1, -2)
