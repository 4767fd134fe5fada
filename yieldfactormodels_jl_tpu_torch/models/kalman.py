"""Kalman / extended-Kalman filtering in plain PyTorch (joint form).

Counterpart of ``yieldfactormodels_jl_tpu/models/kalman.py``: the same
predicted-state recursion, TVλ EKF Jacobian, NaN/window masks and −Inf
sentinel, with a Python loop over time in place of ``lax.scan`` and leading
batch (draw) axes on the parameters in place of ``vmap``.

Singular or non-PD matrices: ``torch.linalg.solve``/``cholesky`` raise where
JAX returns NaN, and the −Inf sentinel depends on the NaN.  So this module
uses the ``_ex`` forms and maps ``info != 0`` to NaN (``init_state``) or to a
failed step (``_step``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..robustness import taxonomy as tax
from .afns import afns_loadings, yield_adjustment
from .loadings import LAMBDA_FLOOR, dns_lambda, dns_loadings, dns_slope_curvature
from .params import KalmanParams, unpack_kalman
from .specs import ModelSpec

_LOG_2PI = math.log(2.0 * math.pi)


class KalmanState(NamedTuple):
    beta: torch.Tensor  # (..., Ms) predicted state β_{t|t-1}
    P: torch.Tensor     # (..., Ms, Ms) predicted covariance


def _solve_or_nan(A, b):
    """Batched solve A x = b whose failed factorizations give NaN (JAX's
    behaviour) instead of raising."""
    x, info = torch.linalg.solve_ex(A, b[..., None])
    x = x[..., 0]
    return torch.where((info != 0)[..., None], torch.full_like(x, math.nan), x)


def init_state(spec: ModelSpec, kp: KalmanParams) -> KalmanState:
    """Unconditional start: β₀ = (I−Φ)⁻¹δ, vec(P₀) = (I−Φ⊗Φ)⁻¹vec(Ω_state)."""
    Ms = spec.state_dim
    Phi = kp.Phi
    eye = torch.eye(Ms, dtype=Phi.dtype, device=Phi.device)
    beta0 = _solve_or_nan(eye - Phi, kp.delta)
    kron = torch.einsum("...ij,...kl->...ikjl", Phi, Phi).reshape(
        Phi.shape[:-2] + (Ms * Ms, Ms * Ms))
    eye2 = torch.eye(Ms * Ms, dtype=Phi.dtype, device=Phi.device)
    vecP = _solve_or_nan(eye2 - kron,
                         kp.Omega_state.reshape(Phi.shape[:-2] + (Ms * Ms,)))
    return KalmanState(beta0, vecP.reshape(Phi.shape))


def tvl_dz2_dlam(lam, ztau, maturities, exact: bool):
    """dZ₂/dλ for the TVλ EKF Jacobian.  ``exact=False`` reproduces the
    reference's formula, whose second term uses e^{-λτ} where the true
    derivative has (1 − e^{-λτ})."""
    if exact:
        return ztau / lam - (1.0 - ztau) / (lam * lam * maturities)
    return ztau / lam - ztau / (lam * lam * maturities)


def _tvl_measurement(spec: ModelSpec, beta, maturities):
    """Z (..., N, 4) with the analytic EKF Jacobian in column 4, and
    ŷ = Z[..., :3]β[..., :3]."""
    lam = dns_lambda(beta[..., 3:4])                     # (..., 1)
    z2, z3 = dns_slope_curvature(lam, maturities)        # (..., N)
    z = torch.exp(-lam * maturities)
    dlam_db4 = lam - LAMBDA_FLOOR
    dz2_dlam = tvl_dz2_dlam(lam, z, maturities, spec.exact_jacobian)
    b1, b2 = beta[..., 1:2], beta[..., 2:3]
    jac = ((b1 + b2) * dz2_dlam + b2 * (maturities * z)) * dlam_db4
    Z = torch.stack([torch.ones_like(z2), z2, z3, jac], dim=-1)
    y_pred = beta[..., 0:1] + z2 * b1 + z3 * b2
    return Z, y_pred


def state_measurement(spec: ModelSpec):
    """``(beta, maturities) -> (Z, y_pred)`` for a state-dependent
    measurement (TVλ), ``None`` for the constant-measurement families."""
    if spec.family == "kalman_tvl":
        return lambda beta, mats: _tvl_measurement(spec, beta, mats)
    return None


def measurement_setup(spec: ModelSpec, kp: KalmanParams, dtype):
    """(Z_const (..., N, Ms), d_const (..., N) | None) for the constant-
    measurement families; (None, None) when Z depends on the state (TVλ)."""
    mats = spec.maturities_array(kp.Phi.device, kp.Phi.dtype)
    if spec.family == "kalman_dns":
        return dns_loadings(kp.gamma, mats).to(dtype), None
    if spec.family == "kalman_afns":
        Z = afns_loadings(kp.gamma, mats, spec.M).to(dtype)
        d = yield_adjustment(kp.gamma, kp.Omega_state, mats, spec.M)
        return Z, d.to(dtype)
    return None, None


def _bound(x, device):
    """A window bound: a scalar stays a Python int (no host→device copy),
    per-draw bounds get a trailing axis against time."""
    if isinstance(x, torch.Tensor) or np.ndim(x) > 0:
        return torch.as_tensor(x, device=device)[..., None]
    return int(x)


def loglik_contrib_mask(start, end, T, device=None):
    """Contributing steps start+1 .. end−2 (0-based): the recursion runs over
    t = 1..T−1 and skips the first innovation.  ``start``/``end`` may be ints
    or (B,) tensors (per-draw windows, giving a (B, T) mask)."""
    t_idx = torch.arange(T, device=device)
    return (t_idx >= _bound(start, device) + 1) & (t_idx <= _bound(end, device) - 2)


def observed_mask(start, end, T, device=None):
    """In-window steps start <= t < end, shaped like ``loglik_contrib_mask``."""
    t_idx = torch.arange(T, device=device)
    return (t_idx >= _bound(start, device)) & (t_idx < _bound(end, device))


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _step(spec: ModelSpec, kp: KalmanParams, Z_const, d_const,
          state: KalmanState, y, observed):
    """One branchless KF/EKF step.  Returns (next_state, per-step outputs)."""
    beta, P = state
    Ms, N = spec.state_dim, spec.N
    dtype, device = P.dtype, P.device

    mfn = state_measurement(spec)
    if mfn is not None:
        Z, y_pred = mfn(beta, spec.maturities_array(device, dtype))
    else:
        Z = Z_const
        y_pred = _mv(Z, beta)
        if d_const is not None:  # AFNS yield-adjustment intercept
            y_pred = y_pred + d_const

    fin = torch.isfinite(y)
    obs = observed & fin.all(-1)
    obs_f = obs.to(dtype)[..., None]
    ysafe = torch.where(fin, y, y_pred)
    v = (ysafe - y_pred) * obs_f

    eyeN = torch.eye(N, dtype=dtype, device=device)
    F = Z @ P @ Z.transpose(-1, -2) + kp.obs_var[..., None, None] * eyeN
    cho, info = torch.linalg.cholesky_ex(F)
    cho_ok = (info == 0) & torch.isfinite(cho).all(-1).all(-1)
    cho_safe = torch.where(cho_ok[..., None, None], torch.nan_to_num(cho),
                           eyeN.expand_as(cho))

    # K = P Zᵀ F⁻¹ via two triangular solves of F X = Z P  (Kᵀ = F⁻¹ Z Pᵀ)
    Kt = torch.cholesky_solve(Z @ P, cho_safe)                # (..., N, Ms)
    Fi_v = torch.cholesky_solve(v[..., None], cho_safe)[..., 0]

    beta_upd = beta + _mv(Kt.transpose(-1, -2), v) * obs_f
    beta_next = kp.delta + _mv(kp.Phi, beta_upd)

    KZ = Kt.transpose(-1, -2) @ Z * obs_f[..., None]
    P_upd = (torch.eye(Ms, dtype=dtype, device=device) - KZ) @ P
    P_next = kp.Phi @ P_upd @ kp.Phi.transpose(-1, -2) + kp.Omega_state

    logdet_F = 2.0 * torch.log(torch.diagonal(cho_safe, dim1=-2, dim2=-1)).sum(-1)
    ll = -0.5 * (logdet_F + (v * Fi_v).sum(-1) + N * _LOG_2PI)
    # taxonomy bits: a failed innovation Cholesky is the joint form's non-PD
    # failure, a non-finite ll behind a successful one a blown-up state
    code = tax.bit(obs & ~cho_ok, tax.CHOL_BREAKDOWN) \
        | tax.bit(obs & cho_ok & ~torch.isfinite(ll), tax.STATE_EXPLODED)
    ll = torch.where(obs & cho_ok, ll,
                     torch.where(obs, torch.full_like(ll, -math.inf),
                                 torch.zeros_like(ll)))
    outs = {"y_pred": y_pred, "v": v, "ll": ll, "beta_after": beta_next,
            "Z2": Z[..., 1], "Z3": Z[..., 2], "obs": obs.expand(ll.shape),
            "code": code}
    return KalmanState(beta_next, P_next), outs


def _scan_filter(spec: ModelSpec, params, data, start, end,
                 state0: KalmanState | None = None):
    """Run the filter over all T columns of ``data`` (N, T) from ``state0``
    (the unconditional start by default); columns outside [start, end) are
    treated as missing.  Per-step outputs are stacked on a trailing time
    axis."""
    kp = unpack_kalman(spec, params)
    Z_const, d_const = measurement_setup(spec, kp, params.dtype)
    state = init_state(spec, kp) if state0 is None else state0
    T = data.shape[1]
    observed = observed_mask(start, end, T, data.device)
    outs = []
    for t in range(T):
        state, o = _step(spec, kp, Z_const, d_const, state, data[:, t],
                         observed[..., t])
        outs.append(o)
    stacked = {k: torch.stack([o[k] for o in outs], dim=-1) for k in outs[0]}
    return kp, state, stacked


def get_loss(spec: ModelSpec, params, data, start=0, end=None):
    """Gaussian log-likelihood of the joint form; contributing steps
    start+1 .. end−2 (0-based), −Inf for a failed or non-finite sum."""
    T = data.shape[1]
    if end is None:
        end = T
    _, _, outs = _scan_filter(spec, params, data, start, end)
    contrib = loglik_contrib_mask(start, end, T, data.device)
    ll = outs["ll"]
    total = torch.where(contrib, ll, torch.zeros_like(ll)).sum(-1)
    return torch.where(torch.isfinite(total), total,
                       torch.full_like(total, -math.inf))


def get_loss_coded(spec: ModelSpec, params, data, start=0, end=None):
    """``(loss, code)``: :func:`get_loss`'s value and the taxonomy bitmask of
    the contributing steps (CHOL_BREAKDOWN, STATE_EXPLODED), with
    TRANSFORM_OVERFLOW for non-finite parameters, MISSING_ALL_OBS when no
    contributing step is observed, and STATE_EXPLODED for a −Inf loss
    without another cause."""
    T = data.shape[1]
    if end is None:
        end = T
    _, _, outs = _scan_filter(spec, params, data, start, end)
    contrib = loglik_contrib_mask(start, end, T, data.device)
    ll = outs["ll"]
    total = torch.where(contrib, ll, torch.zeros_like(ll)).sum(-1)
    loss = torch.where(torch.isfinite(total), total, torch.full_like(total, -math.inf))
    code = tax.params_code(params) \
        | tax.combine(torch.where(contrib, outs["code"], torch.zeros_like(outs["code"]))) \
        | tax.bit(~(contrib & outs["obs"]).any(-1), tax.MISSING_ALL_OBS)
    code = code | tax.bit(~torch.isfinite(loss) & (code == 0), tax.STATE_EXPLODED)
    return loss, code


def get_loss_array(spec: ModelSpec, params, data, start=0, end=None, K: int = 1):
    """Per-step one-step-ahead MSE diagnostics, (..., T−1): −‖v_t‖²/N over
    the contributing steps, 0 elsewhere.  K > 1 replays the filter from the
    previous pass's end state (the reference's set_params! touches neither
    β nor P), accumulating before the /K."""
    T = data.shape[1]
    if end is None:
        end = T
    contrib = loglik_contrib_mask(start, end, T, data.device)
    acc = torch.zeros(params.shape[:-1] + (T,), dtype=data.dtype, device=data.device)
    state = None
    for _ in range(K):
        _, state, outs = _scan_filter(spec, params, data, start, end, state)
        per_t = -(outs["v"] * outs["v"]).sum(-2)
        acc = acc + torch.where(contrib, per_t, torch.zeros_like(per_t))
    return (acc / spec.N / K)[..., : T - 1]


def predict(spec: ModelSpec, params, data):
    """Filter the full sample plus one trailing NaN step, returning the
    reference's artifact set: preds[..., :, k] is the one-step-ahead
    prediction of y_{k+1}; factors/states/loading columns are the
    post-propagation values.  NaN columns in ``data`` are predict-only steps,
    which is how multi-step forecasts are produced."""
    N, T = data.shape
    nan_col = torch.full((N, 1), math.nan, dtype=data.dtype, device=data.device)
    data_ext = torch.cat([data, nan_col], dim=1)
    kp, _, outs = _scan_filter(spec, params, data_ext, 0, T + 1)
    # columns k = steps k+1 (the reference stores step-t values at t−1);
    # stacked outputs carry time last: y_pred (..., N, T+1) etc.
    preds = outs["y_pred"][..., 1:]
    factors = outs["beta_after"][..., 1:]
    fl1 = outs["Z2"][..., 1:]
    fl2 = outs["Z3"][..., 1:]
    if kp.gamma is not None:
        states = kp.gamma[..., None].expand(kp.gamma.shape + (T,))
    else:
        # TVλ never writes its γ buffer
        states = params.new_zeros(params.shape[:-1] + (spec.L, T))
    return {
        "preds": preds,
        "factors": factors,
        "states": states,
        "factor_loadings_1": fl1,
        "factor_loadings_2": fl2,
    }
