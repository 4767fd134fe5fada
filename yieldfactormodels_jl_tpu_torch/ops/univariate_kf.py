"""Univariate (sequential-observation) Kalman loglik in plain PyTorch.

Counterpart of ``yieldfactormodels_jl_tpu/ops/univariate_kf.py``.  With the
diagonal measurement error every model here has (Ω_obs = σ²I), the N-dim
update is N scalar updates per step:

    for i = 1..N:   f_i = z_i' P z_i + σ²,   v_i = y_i^eff − z_i'β
                    K = P z_i / f_i,   β += K v_i,   P −= K (z_i'P)
    loglik_t = −½ Σ_i (log f_i + v_i²/f_i + log 2π)

algebraically identical to the joint update.  The TVλ EKF uses the
fixed-linearization observation y_eff = y − h(β_pred) + Z β_pred.

Every function runs a leading batch (draw) axis of the parameters at once,
with Python loops over time and maturities; ``start``/``end`` may be ints or
per-draw (B,) tensors.  This is the sequential ground truth, and the plain
version of the fused kernel (``ops/fused_kf.batched_loglik_reference``).
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

_LOG_2PI = math.log(2.0 * math.pi)


def _sequential_update(Z, y_eff, beta, P, obs_var):
    """N scalar measurement updates over Z (..., N, Ms), y_eff (..., N).
    Returns (β⁺, P⁺, loglik, ok)."""
    b, Pm = beta, P
    ll = torch.zeros_like(obs_var)
    ok = torch.ones_like(obs_var, dtype=torch.bool)
    for i in range(Z.shape[-2]):
        z = Z[..., i, :]
        zP = (z[..., None, :] @ Pm)[..., 0, :]             # (..., Ms)
        f = (zP * z).sum(-1) + obs_var
        ok = ok & (f > 0) & torch.isfinite(f)
        fsafe = torch.where(f > 0, f, torch.ones_like(f))
        v = y_eff[..., i] - (z * b).sum(-1)
        K = zP / fsafe[..., None]
        b = b + K * v[..., None]
        Pm = Pm - K[..., :, None] * zP[..., None, :]
        ll = ll - 0.5 * (torch.log(fsafe) + v * v / fsafe + _LOG_2PI)
    # symmetrize: rank-1 downdates drift asymmetric in f32 over many steps
    Pm = 0.5 * (Pm + Pm.transpose(-1, -2))
    return b, Pm, ll, ok


def _filter_scan(spec: ModelSpec, params, data, start, end):
    """The sequential-update forward pass.  Returns ``(kp, ll)`` with ``ll``
    (..., T) in the joint form's per-step convention (0 unobserved, −Inf on
    a failed innovation-variance chain, NOT contribution-masked)."""
    kp = unpack_kalman(spec, params)
    dtype, device = kp.Phi.dtype, kp.Phi.device
    mats = spec.maturities_array(device, dtype)
    Z_const, d_const = measurement_setup(spec, kp, dtype)
    mfn = state_measurement(spec)
    if Z_const is not None and d_const is None:
        d_const = torch.zeros(spec.N, dtype=dtype, device=device)

    beta, P = init_state(spec, kp)
    T = data.shape[1]
    observed = observed_mask(start, end, T, device)
    lls = []
    for t in range(T):
        y = data[:, t]
        fin = torch.isfinite(y)
        if mfn is not None:
            Z, y_pred0 = mfn(beta, mats)
            ysafe = torch.where(fin, y, y_pred0)
            y_eff = ysafe - y_pred0 + (Z @ beta[..., None])[..., 0]
        else:
            # linear measurement: the round-trip above cancels to y − d
            Z = Z_const
            ysafe = torch.where(fin, y, (Z @ beta[..., None])[..., 0] + d_const)
            y_eff = ysafe - d_const
        obs = observed[..., t] & fin.all()
        beta_u, P_u, ll, ok = _sequential_update(Z, y_eff, beta, P, kp.obs_var)
        obs_f = obs.to(dtype)
        beta_m = beta + (beta_u - beta) * obs_f[..., None]
        P_m = P + (P_u - P) * obs_f[..., None, None]
        beta = kp.delta + (kp.Phi @ beta_m[..., None])[..., 0]
        P = kp.Phi @ P_m @ kp.Phi.transpose(-1, -2) + kp.Omega_state
        lls.append(torch.where(obs & ok, ll,
                               torch.where(obs, torch.full_like(ll, -math.inf),
                                           torch.zeros_like(ll))))
    return kp, torch.stack(lls, dim=-1)


def get_loss(spec: ModelSpec, params, data, start=0, end=None):
    """Gaussian loglik via sequential scalar updates — numerically equal to
    ``models.kalman.get_loss`` (same windows/NaN/−Inf conventions)."""
    T = data.shape[1]
    if end is None:
        end = T
    _, ll = _filter_scan(spec, params, data, start, end)
    contrib = loglik_contrib_mask(start, end, T, data.device)
    total = torch.where(contrib, ll, torch.zeros_like(ll)).sum(-1)
    return torch.where(torch.isfinite(total), total,
                       torch.full_like(total, -math.inf))
