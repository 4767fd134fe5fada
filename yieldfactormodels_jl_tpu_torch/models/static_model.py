"""Static (fixed-loading) filters: OLS cross-sections with a VAR(1) factor
transition, and the random-walk benchmark.

Counterpart of ``yieldfactormodels_jl_tpu/models/static_model.py``, whose
``lax.scan`` runs, per step t,

    β̄_t = OLS(Z, y_t)   on an observed step (else the carried β),
    β_{t+1|t} = μ + Φ β̄_t,   ŷ_{t+1|t} = Z β_{t+1|t},   β₀ = δ,

with Z = Z(γ) constant (γ is a static parameter), a step observed when it
lies in [start, end) and its first entry is finite, and a partially NaN
observed column poisoning β (the loss goes to −Inf).  The recursion is
shallow, so it is written without a loop over time:

- every column's OLS is one batched solve against one factor of ZᵀZ a
  draw (``ops/linalg.ols_solve_columns``), and an observed step's
  prediction is μ + Φβ̄_t, as in the scan;
- an unobserved step (a NaN column, a step outside the window, the
  forecast tail) only carries β through Φ; with μ = (I − Φ)δ, δ is the
  fixed point, so j unobserved steps after the last observed step l give
  δ + Φʲ(β_{l+1|l} − δ), Φʲ applied by the bits of j (a step before any
  observed one keeps β₀ = δ);
- the random walk carries each maturity's last observed value (0 before
  the first), found by an index of the last observed column.

Every function takes constrained parameters with leading draw axes
(..., n_params) against one (N, T) panel; ``start``/``end`` are ints.
"""

from __future__ import annotations

import torch

from ..ops.linalg import ols_solve_columns
from ..robustness import taxonomy as tax
from .common import window_contributions
from .loadings import dns_loadings, neural_loadings
from .params import StaticParams, unpack_static
from .specs import ModelSpec


def loadings_fn(spec: ModelSpec, gamma):
    """Z(γ): (..., N, M) of the static λ or neural family (the random walk
    has no loadings to build: ``predict`` reports all ones)."""
    mats = spec.maturities_array(gamma.device, gamma.dtype)
    if spec.family == "static_lambda":
        return dns_loadings(gamma, mats)
    return neural_loadings(gamma, mats, spec.transform_bool)


def _last_observed(valid):
    """Index of the last True at or before each position of the last axis,
    −1 where there is none."""
    t_idx = torch.arange(valid.shape[-1], device=valid.device)
    return torch.where(valid, t_idx, torch.full_like(t_idx, -1)).cummax(-1).values


def _observed(data, start, end):
    """(T,) steps in [start, end) whose first entry is finite."""
    t_idx = torch.arange(data.shape[1], device=data.device)
    return (t_idx >= start) & (t_idx < end) & torch.isfinite(data[0])


def _static_path(sp: StaticParams, Z, data, start, end):
    """β_{t+1|t} (..., T, M) and ŷ_{t+1|t} (..., T, N) after every step."""
    T = data.shape[1]
    obs = _observed(data, start, end)
    fin = torch.isfinite(data)
    ysafe = torch.where(fin, data, torch.zeros_like(data))
    beta_ols = ols_solve_columns(Z, ysafe)                    # (..., T, M)
    one = torch.ones((), dtype=data.dtype, device=data.device)
    poison = torch.where(obs & ~fin.all(0), torch.full_like(one, float("nan")), one)
    x = beta_ols * poison[:, None]
    Phi_t = sp.Phi.transpose(-1, -2)
    after_obs = sp.mu[..., None, :] + x @ Phi_t               # μ + Φβ̄_t
    last = _last_observed(obs)                                # (T,)
    seen = last >= 0
    delta = sp.delta[..., None, :]
    base = torch.where(seen[:, None], after_obs[..., last.clamp(min=0), :], delta)
    j = torch.where(seen, torch.arange(T, device=data.device) - last,
                    torch.zeros_like(last))
    d = base - delta
    power = Phi_t                                             # Φ^(2^k), transposed
    for k in range(max(1, (T - 1).bit_length())):
        if k:
            power = power @ power
        d = torch.where(((j >> k) & 1).bool()[:, None], d @ power, d)
    beta = torch.where((j > 0)[:, None], delta + d, base)
    return beta, beta @ Z.transpose(-1, -2)


def _rw_preds(spec: ModelSpec, params, data, start, end):
    """(..., T, N): each maturity's last observed value, 0 before its first."""
    valid = _observed(data, start, end)[None, :] & torch.isfinite(data)
    last = _last_observed(valid)                              # (N, T)
    vals = data.gather(1, last.clamp(min=0))
    pred = torch.where(last >= 0, vals, torch.zeros_like(vals)).T
    return pred.expand(params.shape[:-1] + pred.shape)


def _run(spec: ModelSpec, params, data, start, end):
    """(StaticParams, Z, β path, ŷ path); the random walk has no β or Z."""
    if spec.family == "random_walk":
        return None, None, None, _rw_preds(spec, params, data, start, end)
    sp = unpack_static(spec, params)
    Z = loadings_fn(spec, sp.gamma)
    beta, pred = _static_path(sp, Z, data, start, end)
    return sp, Z, beta, pred


def _sentinel(loss):
    return torch.where(torch.isfinite(loss), loss, torch.full_like(loss, -float("inf")))


def get_loss(spec: ModelSpec, params, data, start=0, end=None, K: int = 1):
    """One-step-ahead forecast −MSE normalised by N·nobs·K; −Inf where it is
    not finite.  Shape ``params.shape[:-1]``."""
    if end is None:
        end = data.shape[1]
    nobs = end - start
    total = 0.0
    for _ in range(K):  # static filters have no state across passes
        pred = _run(spec, params, data, start, end)[3]
        total = total + window_contributions(pred, data, start, end).sum(-1)
    return _sentinel(total / spec.N / nobs / K)


def get_loss_coded(spec: ModelSpec, params, data, start=0, end=None):
    """``(loss, code)``: :func:`get_loss` (K=1) and the taxonomy bitmask —
    TRANSFORM_OVERFLOW for non-finite parameters, STATE_EXPLODED for a
    non-finite prediction on an in-window step (the partial-NaN poisoning
    too) or a non-finite loss without another cause, MISSING_ALL_OBS for a
    window with no observed column."""
    T = data.shape[1]
    if end is None:
        end = T
    pred = _run(spec, params, data, start, end)[3]
    loss = _sentinel(window_contributions(pred, data, start, end).sum(-1)
                     / spec.N / (end - start))
    t_idx = torch.arange(T, device=data.device)
    in_win = (t_idx >= start) & (t_idx < end)
    bad_step = in_win & ~torch.isfinite(pred).all(-1)
    code = tax.params_code(params) \
        | tax.bit(bad_step.any(-1), tax.STATE_EXPLODED) \
        | tax.bit(~_observed(data, start, end).any(), tax.MISSING_ALL_OBS)
    code = code | tax.bit(~torch.isfinite(loss) & (code == 0), tax.STATE_EXPLODED)
    return loss, code


def get_loss_array(spec: ModelSpec, params, data, start=0, end=None, K: int = 1):
    """Per-step loss vector (..., T−1)."""
    if end is None:
        end = data.shape[1]
    pred = _run(spec, params, data, start, end)[3]
    return window_contributions(pred, data, start, end) * (1.0 / spec.N)


def predict(spec: ModelSpec, params, data):
    """Filter all T columns; NaN columns give multi-step forecasts.  Each
    entry (..., dim, T).  The random walk never writes β or γ, and its
    loadings stay all ones."""
    T = data.shape[1]
    sp, Z, beta, pred = _run(spec, params, data, 0, T)
    lead = params.shape[:-1]
    if spec.family == "random_walk":
        zeros = params.new_zeros(lead + (spec.M, T))
        ones = params.new_ones(lead + (spec.N, T))
        return {"preds": pred.transpose(-1, -2), "factors": zeros,
                "states": params.new_zeros(lead + (spec.L, T)),
                "factor_loadings_1": ones, "factor_loadings_2": ones}
    return {"preds": pred.transpose(-1, -2),
            "factors": beta.transpose(-1, -2),
            "states": sp.gamma[..., None].expand(lead + (spec.L, T)),
            "factor_loadings_1": Z[..., :, 1, None].expand(lead + (spec.N, T)),
            "factor_loadings_2": Z[..., :, 2, None].expand(lead + (spec.N, T))}
