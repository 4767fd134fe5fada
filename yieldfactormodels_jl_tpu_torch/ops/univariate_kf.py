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
from ..robustness import taxonomy as tax

_LOG_2PI = math.log(2.0 * math.pi)


def _sequential_update(Z, y_eff, beta, P, obs_var, coded: bool = False):
    """N scalar measurement updates over Z (..., N, Ms), y_eff (..., N).
    Returns (β⁺, P⁺, loglik, ok, code): with ``coded`` the taxonomy bits of
    the updates (NONPSD_INNOVATION for a finite f ≤ 0, STATE_EXPLODED for a
    non-finite f), else None."""
    b, Pm = beta, P
    ll = torch.zeros_like(obs_var)
    ok = torch.ones_like(obs_var, dtype=torch.bool)
    code = tax.zero_code(obs_var.shape, obs_var.device) if coded else None
    for i in range(Z.shape[-2]):
        z = Z[..., i, :]
        zP = (z[..., None, :] @ Pm)[..., 0, :]             # (..., Ms)
        f = (zP * z).sum(-1) + obs_var
        if coded:
            f_fin = torch.isfinite(f)
            code = code | tax.bit(f_fin & (f <= 0), tax.NONPSD_INNOVATION) \
                | tax.bit(~f_fin, tax.STATE_EXPLODED)
        ok = ok & (f > 0) & torch.isfinite(f)
        fsafe = torch.where(f > 0, f, torch.ones_like(f))
        v = y_eff[..., i] - (z * b).sum(-1)
        K = zP / fsafe[..., None]
        b = b + K * v[..., None]
        Pm = Pm - K[..., :, None] * zP[..., None, :]
        ll = ll - 0.5 * (torch.log(fsafe) + v * v / fsafe + _LOG_2PI)
    # symmetrize: rank-1 downdates drift asymmetric in f32 over many steps
    Pm = 0.5 * (Pm + Pm.transpose(-1, -2))
    return b, Pm, ll, ok, code


def _filter_scan(spec: ModelSpec, params, data, start, end, outs=("ll",)):
    """The sequential-update forward pass, the one source of the engine's
    NaN-column, window and failure semantics.  Returns ``(kp, o)``: ``o``
    holds the per-step outputs named in ``outs`` stacked on a trailing time
    axis — "ll" (..., T) in the joint form's per-step convention (0
    unobserved, −Inf on a failed innovation-variance chain, NOT
    contribution-masked), "obs" (..., T) the observed steps, "code" (..., T)
    the taxonomy bits of the observed steps, and the moments "beta_pred",
    "P_pred" (incoming predicted), "beta_upd", "P_upd" (the obs-blended
    posterior), the state axes before time.  The loglik's arithmetic does
    not depend on what else is asked for."""
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
    coded = "code" in outs
    steps = {k: [] for k in outs}
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
        beta_u, P_u, ll, ok, code = _sequential_update(Z, y_eff, beta, P,
                                                       kp.obs_var, coded)
        obs_f = obs.to(dtype)
        beta_m = beta + (beta_u - beta) * obs_f[..., None]
        P_m = P + (P_u - P) * obs_f[..., None, None]
        step = {"beta_pred": beta, "P_pred": P, "beta_upd": beta_m, "P_upd": P_m}
        beta = kp.delta + (kp.Phi @ beta_m[..., None])[..., 0]
        P = kp.Phi @ P_m @ kp.Phi.transpose(-1, -2) + kp.Omega_state
        step["ll"] = torch.where(obs & ok, ll,
                                 torch.where(obs, torch.full_like(ll, -math.inf),
                                             torch.zeros_like(ll)))
        if coded:
            step["code"] = torch.where(obs, code, torch.zeros_like(code))
        step["obs"] = obs.expand(ll.shape)
        for k in outs:
            steps[k].append(step[k])
    return kp, {k: torch.stack(v, dim=-1) for k, v in steps.items()}


def get_loss(spec: ModelSpec, params, data, start=0, end=None):
    """Gaussian loglik via sequential scalar updates — numerically equal to
    ``models.kalman.get_loss`` (same windows/NaN/−Inf conventions)."""
    T = data.shape[1]
    if end is None:
        end = T
    _, o = _filter_scan(spec, params, data, start, end)
    ll = o["ll"]
    contrib = loglik_contrib_mask(start, end, T, data.device)
    total = torch.where(contrib, ll, torch.zeros_like(ll)).sum(-1)
    return torch.where(torch.isfinite(total), total,
                       torch.full_like(total, -math.inf))


def get_loss_coded(spec: ModelSpec, params, data, start=0, end=None):
    """``(loss, code)``: :func:`get_loss`'s value and its taxonomy bitmask —
    the update bits of the contributing steps, TRANSFORM_OVERFLOW for
    non-finite parameters, MISSING_ALL_OBS when no contributing step is
    observed, and STATE_EXPLODED for a −Inf loss without another cause."""
    T = data.shape[1]
    if end is None:
        end = T
    _, o = _filter_scan(spec, params, data, start, end, ("ll", "obs", "code"))
    contrib = loglik_contrib_mask(start, end, T, data.device)
    ll = o["ll"]
    total = torch.where(contrib, ll, torch.zeros_like(ll)).sum(-1)
    loss = torch.where(torch.isfinite(total), total, torch.full_like(total, -math.inf))
    code = tax.params_code(params) \
        | tax.combine(torch.where(contrib, o["code"], torch.zeros_like(o["code"]))) \
        | tax.bit(~(contrib & o["obs"]).any(-1), tax.MISSING_ALL_OBS)
    code = code | tax.bit(~torch.isfinite(loss) & (code == 0), tax.STATE_EXPLODED)
    return loss, code


def filter_moments(spec: ModelSpec, params, data, start=0, end=None):
    """Per-step filtering moments of the sequential-update engine:
    ``(kp, outs)`` with "beta_pred"/"P_pred" the incoming predicted moments,
    "beta_upd"/"P_upd" the obs-blended posterior ones, "ll" the per-step
    loglik in the joint convention (NOT contribution-masked) and "obs" the
    observed steps; time is the axis after the draw axes:
    "beta_pred" (..., T, Ms), "P_pred" (..., T, Ms, Ms), "ll" (..., T)."""
    T = data.shape[1]
    if end is None:
        end = T
    names = ("beta_pred", "P_pred", "beta_upd", "P_upd", "ll", "obs")
    kp, o = _filter_scan(spec, params, data, start, end, names)
    lead = params.dim() - 1
    for k in ("beta_pred", "P_pred", "beta_upd", "P_upd"):
        o[k] = o[k].movedim(-1, lead)
    return kp, o
