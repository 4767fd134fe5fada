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


def ols_solve(Z, y):
    """β = (ZᵀZ)⁻¹Zᵀy via Cholesky, with the reference's ridge fallback.

    ``Z`` (..., N, M), ``y`` (..., N) → (..., M).  Both factors are taken
    and one is selected per matrix: the plain one where it is usable, else
    the factor of ZᵀZ + 1e-3·I (NaN where that fails too, as the JAX
    package's Cholesky gives)."""
    M = Z.shape[-1]
    Zt = Z.transpose(-1, -2)
    G = Zt @ Z
    b = (Zt @ y.unsqueeze(-1))
    L, ok = _cholesky_or_nan(G)
    eye = torch.eye(M, dtype=G.dtype, device=G.device)
    L_r, ok_r = _cholesky_or_nan(G + RIDGE * eye)
    nan = torch.full_like(L_r, float("nan"))
    L_r = torch.where(ok_r[..., None, None], L_r, nan)
    L_sel = torch.where(ok[..., None, None], L, L_r)
    return torch.cholesky_solve(b, L_sel).squeeze(-1)
