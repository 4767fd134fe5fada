"""Square-root (Potter) Kalman log-likelihood: engine "sqrt".

Counterpart of ``yieldfactormodels_jl_tpu/ops/sqrt_kf.py``.  The filter
propagates a factor S with P = S Sᵀ, so P is positive semi-definite by
construction at every step:

  - measurement update: Potter's rank-1 square-root update per scalar
    observation (Ω_obs = σ²I in every model here):
        φ = Sᵀz,  f = φᵀφ + σ²,  α = 1/(f + √(σ²·f)),
        β ← β + (Sφ) v / f,   S ← S − α (Sφ) φᵀ
  - time update: R of qr([Sᵀ Φᵀ; C]) with Ω_state = CᵀC, S_pred = Rᵀ.

The sign of R's diagonal may differ from LAPACK's through JAX: S is then
S·D with D = diag(±1), and every quantity the loss reads (f, Sφ, S Sᵀ) is
the same.  Windows, NaN columns and the −Inf sentinel follow the other
Kalman engines; a leading draw axis of the parameters runs at once, with
``start``/``end`` ints or per-draw (B,) tensors.
"""

from __future__ import annotations

import math

import torch

from ..models.kalman import (
    init_state,
    loglik_contrib_mask,
    measurement_setup,
    observed_mask,
    state_measurement,
)
from ..models.params import unpack_kalman
from ..models.specs import ModelSpec
from ..robustness import taxonomy as tax

_LOG_2PI = math.log(2.0 * math.pi)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _potter_update(Z, y_eff, beta, S, obs_var):
    """N sequential Potter square-root updates over Z (..., N, Ms) and
    y_eff (..., N).  Returns (β⁺, S⁺, ll, ok, code)."""
    b, Sm = beta, S
    ll = torch.zeros_like(obs_var)
    ok = torch.ones_like(obs_var, dtype=torch.bool)
    code = tax.zero_code(obs_var.shape, obs_var.device)
    ov_pos = torch.clamp_min(obs_var, 0.0)
    for i in range(Z.shape[-2]):
        z = Z[..., i, :]
        phi = _mv(Sm.transpose(-1, -2), z)                 # (..., Ms)
        f = (phi * phi).sum(-1) + obs_var
        f_fin = torch.isfinite(f)
        ok = ok & (f > 0) & f_fin
        code = code | tax.bit(f_fin & (f <= 0), tax.NONPSD_INNOVATION) \
            | tax.bit(~f_fin, tax.STATE_EXPLODED)
        fsafe = torch.where(f > 0, f, torch.ones_like(f))
        v = y_eff[..., i] - (z * b).sum(-1)
        Sphi = _mv(Sm, phi)                                # = P z
        b = b + Sphi * (v / fsafe)[..., None]
        alpha = 1.0 / (fsafe + torch.sqrt(ov_pos * fsafe))
        Sm = Sm - alpha[..., None, None] * (Sphi[..., :, None] * phi[..., None, :])
        ll = ll - 0.5 * (torch.log(fsafe) + v * v / fsafe + _LOG_2PI)
    return b, Sm, ll, ok, code


def _psd_sqrt_factor(M, floor):
    """V·diag(√w̃): a square root of the PSD projection of symmetric M, its
    eigenvalues clipped at ``floor`` (the ladder's recovery mode)."""
    w, V = torch.linalg.eigh(0.5 * (M + M.transpose(-1, -2)))
    w = torch.clamp_min(w, floor)
    return V * torch.sqrt(w)[..., None, :]


def _cholesky_or_nan(A):
    """Lower Cholesky factor, all NaN where the factorization fails (JAX's
    result there)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.full_like(L, math.nan), L)


def _loss_coded(spec: ModelSpec, params, data, start=0, end=None, init_psd_floor=None):
    """Shared square-root forward pass; returns ``(loss, code)`` of shape
    ``params.shape[:-1]``.  ``init_psd_floor=None`` is the parity engine (a
    failed initial factorization is the −Inf sentinel); a float floor
    PSD-projects P₀ and Ω_state instead (the ladder's recovery mode)."""
    kp = unpack_kalman(spec, params)
    dtype, device = kp.Phi.dtype, kp.Phi.device
    Ms = spec.state_dim
    eye = torch.eye(Ms, dtype=dtype, device=device)
    mats = spec.maturities_array(device, dtype)
    Z_const, d_const = measurement_setup(spec, kp, dtype)
    mfn = state_measurement(spec)
    if Z_const is not None and d_const is None:
        d_const = torch.zeros(spec.N, dtype=dtype, device=device)

    state0 = init_state(spec, kp)
    if init_psd_floor is None:
        P0 = 0.5 * (state0.P + state0.P.transpose(-1, -2)) + 1e-9 * eye
        S0 = _cholesky_or_nan(P0)
        Om = 0.5 * (kp.Omega_state + kp.Omega_state.transpose(-1, -2)) + 1e-12 * eye
        C = _cholesky_or_nan(Om).transpose(-1, -2)       # upper: Ω = CᵀC
        fac_ok = torch.isfinite(S0).all(-1).all(-1) & torch.isfinite(C).all(-1).all(-1)
        S0 = torch.where(torch.isfinite(S0), S0, eye * 1e-3)
        C = torch.where(torch.isfinite(C), C, torch.zeros_like(C))
    else:
        S0 = _psd_sqrt_factor(torch.where(torch.isfinite(state0.P), state0.P,
                                          torch.zeros_like(state0.P)), init_psd_floor)
        Om = kp.Omega_state
        C = _psd_sqrt_factor(torch.where(torch.isfinite(Om), Om, torch.zeros_like(Om)),
                             init_psd_floor).transpose(-1, -2)
        fac_ok = torch.isfinite(S0).all(-1).all(-1) & torch.isfinite(C).all(-1).all(-1)

    T = data.shape[1]
    if end is None:
        end = T
    observed = observed_mask(start, end, T, device)
    contrib = loglik_contrib_mask(start, end, T, device)
    beta, S = state0.beta, S0
    Phi_t = kp.Phi.transpose(-1, -2)
    lls, codes, obs_c = [], [], []
    for t in range(T):
        y = data[:, t]
        fin = torch.isfinite(y)
        if mfn is not None:
            Z, y_pred0 = mfn(beta, mats)
            ysafe = torch.where(fin, y, y_pred0)
            y_eff = ysafe - y_pred0 + _mv(Z, beta)
        else:
            Z = Z_const
            ysafe = torch.where(fin, y, _mv(Z, beta) + d_const)
            y_eff = ysafe - d_const
        obs = observed[..., t] & fin.all()
        beta_u, S_u, ll, ok, code = _potter_update(Z, y_eff, beta, S, kp.obs_var)
        obs_f = obs.to(dtype)
        beta_m = beta + (beta_u - beta) * obs_f[..., None]
        S_m = S + (S_u - S) * obs_f[..., None, None]
        beta = kp.delta + _mv(kp.Phi, beta_m)
        pre = torch.cat([S_m.transpose(-1, -2) @ Phi_t, C], dim=-2)   # (..., 2Ms, Ms)
        S = torch.linalg.qr(pre, mode="r")[1].transpose(-1, -2)
        use = obs & contrib[..., t]
        lls.append(torch.where(use, torch.where(ok, ll, torch.full_like(ll, -math.inf)),
                               torch.zeros_like(ll)))
        codes.append(torch.where(use, code, torch.zeros_like(code)))
        obs_c.append(use.expand(ll.shape))
    total = torch.stack(lls, -1).sum(-1)
    loss = torch.where(fac_ok & torch.isfinite(total), total,
                       torch.full_like(total, -math.inf))
    code = tax.params_code(params) | tax.combine(torch.stack(codes, -1)) \
        | tax.bit(~fac_ok, tax.CHOL_BREAKDOWN) \
        | tax.bit(~torch.stack(obs_c, -1).any(-1), tax.MISSING_ALL_OBS)
    code = code | tax.bit(~torch.isfinite(loss) & (code == 0), tax.STATE_EXPLODED)
    return loss, code


def get_loss(spec: ModelSpec, params, data, start=0, end=None, init_psd_floor=None):
    """Gaussian loglik with square-root covariance propagation — the same
    value as ``univariate_kf.get_loss`` in exact arithmetic."""
    loss, _ = _loss_coded(spec, params, data, start, end, init_psd_floor)
    return loss


def get_loss_coded(spec: ModelSpec, params, data, start=0, end=None, init_psd_floor=None):
    """``(loss, code)`` — :func:`get_loss` plus its taxonomy bitmask."""
    return _loss_coded(spec, params, data, start, end, init_psd_floor)
