"""Score-driven (MSE-driven) filter as a plain PyTorch recursion.

Counterpart of ``yieldfactormodels_jl_tpu/models/score_driven.py``, batched
over leading draw axes of the parameters, the panel shared.  Per step:

1. β̄ ← OLS(Z(γ), y_t) with the ridge fallback,
2. score = ∇_γ −‖y_t − Z(γ)β̄‖², by autograd, with β̄ detached (the JAX
   package's ``stop_gradient``; ``spec.detach_inner_beta``),
3. γ update — plain γ += A⊙score, or EWMA-scaled (``scale_grad``),
4. refresh Z(γ), re-OLS,
5. transition γ ← ν + B⊙γ (skipped for random-walk dynamics), β ← μ + Φβ;
   emit ŷ = Zβ.

A NaN first entry makes the step transition-only; a partially NaN observed
column poisons β.  This is the independent reference the fused kernel
(``ops/fused_ssd``) and its plain version are held against: its inner score
is autograd, not the kernel's hand-derived sweep.  The inner score is taken
as ``torch.autograd.grad`` of the draw batch's summed objective — the draws
are independent, so that is each draw's own gradient — with
``create_graph`` when an outer gradient is wanted.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ..ops.linalg import ols_solve
from ..robustness import taxonomy as tax
from .common import partial_nan_poison, window_contributions
from .loadings import dns_loadings, neural_loadings
from .params import MSEDParams, unpack_msed
from .specs import ModelSpec


class MSEDState(NamedTuple):
    gamma: torch.Tensor   # (..., L)
    beta: torch.Tensor    # (..., M)
    ewma: torch.Tensor    # (..., L) second-moment EWMA (scale_grad)
    count: torch.Tensor   # (...,) int64 bias-correction counter


@lru_cache(maxsize=64)
def maturities_on(spec: ModelSpec, device, dtype) -> torch.Tensor:
    """The spec's maturities on ``device`` in ``dtype``, made once: the
    recursion asks for them several times a step, and a host-to-card copy
    each time would stall the card."""
    return spec.maturities_array(device, dtype)


def loadings_fn(spec: ModelSpec, gamma):
    """Z(γ): (..., N, 3)."""
    mats = maturities_on(spec, gamma.device, gamma.dtype)
    if spec.family == "msed_lambda":
        return dns_loadings(gamma, mats)
    return neural_loadings(gamma, mats, spec.transform_bool)


def init_state(spec: ModelSpec, mp: MSEDParams) -> MSEDState:
    """β₀ = δ, γ₀ = ω; the EWMA state zeroed."""
    return MSEDState(mp.omega, mp.delta, torch.zeros_like(mp.omega),
                     torch.zeros(mp.omega.shape[:-1], dtype=torch.int64,
                                 device=mp.omega.device))


def _score(spec: ModelSpec, gamma, beta_bar, y):
    """∇_γ of −‖y − Z(γ)β̄‖² per draw, by autograd; the graph is kept for an
    outer gradient when γ carries one."""
    outer = gamma.requires_grad
    # differentiate along the paths through a fresh node g only, so that β̄
    # is a constant of the inner derivative whether or not it is detached
    g = gamma.clone() if outer else gamma.detach().requires_grad_(True)
    with torch.enable_grad():
        v = y - (loadings_fn(spec, g) @ beta_bar.unsqueeze(-1)).squeeze(-1)
        (grad,) = torch.autograd.grad(-(v * v).sum(), g, create_graph=outer)
    return grad


def _inner_beta(spec: ModelSpec, beta_ols):
    return beta_ols.detach() if spec.detach_inner_beta else beta_ols


def plain_gamma_update(spec: ModelSpec, mp: MSEDParams, gamma, ysafe, obs):
    """The non-``scale_grad`` γ measurement update — OLS β̄, the score,
    γ ← γ + A⊙score on observed steps; returns ``(gamma_obs, Z)``."""
    Z = loadings_fn(spec, gamma)
    beta_ols = ols_solve(Z, ysafe)
    grad = _score(spec, gamma, _inner_beta(spec, beta_ols), ysafe)
    return torch.where(obs, gamma + grad * mp.A, gamma), Z


def plain_gamma_transition(mp: MSEDParams, gamma_obs):
    """γ ← ν + B⊙γ (the identity for random-walk dynamics)."""
    if mp.B is None:
        return gamma_obs
    return mp.nu + mp.B * gamma_obs


def _step(spec: ModelSpec, mp: MSEDParams, state: MSEDState, y, observed: bool):
    gamma, beta, ewma, count = state
    dtype = gamma.dtype
    obs = torch.isfinite(y[0]) & observed  # the first entry decides
    ysafe = torch.where(torch.isfinite(y), y, torch.zeros_like(y))
    poison = partial_nan_poison(y, obs)

    # --- measurement update (computed unconditionally, selected in) ---
    if spec.scale_grad:
        Z = loadings_fn(spec, gamma)
        beta_ols = ols_solve(Z, ysafe)
        grad = _score(spec, gamma, _inner_beta(spec, beta_ols), ysafe)
        ff = torch.full((), spec.forget_factor, dtype=dtype, device=gamma.device)
        new_ewma = ff * ewma + (1.0 - ff) * grad * grad
        new_count = count + 1
        denom = 1.0 - ff ** new_count.to(dtype)
        eps = torch.finfo(dtype).eps
        scaled = grad / (torch.sqrt(new_ewma / denom.unsqueeze(-1)) + eps)
        gamma_upd = gamma + scaled * mp.A
        ewma = torch.where(obs, new_ewma, ewma)
        count = torch.where(obs, new_count, count)
        gamma_obs = torch.where(obs, gamma_upd, gamma)
    else:
        gamma_obs, Z = plain_gamma_update(spec, mp, gamma, ysafe, obs)

    Z_upd = loadings_fn(spec, gamma_obs)
    beta_reols = ols_solve(Z_upd, ysafe)
    beta_obs = torch.where(obs, beta_reols, beta) * poison

    # --- transition (always applied) ---
    if mp.B is None:
        gamma_next = gamma_obs
        Z_next = torch.where(obs, Z_upd, Z)  # no refresh on missing steps
    else:
        gamma_next = mp.nu + mp.B * gamma_obs
        Z_next = loadings_fn(spec, gamma_next)
    beta_next = mp.mu + (mp.Phi @ beta_obs.unsqueeze(-1)).squeeze(-1)
    pred = (Z_next @ beta_next.unsqueeze(-1)).squeeze(-1)
    out = {"pred": pred, "beta": beta_next, "gamma": gamma_next,
           "Z2": Z_next[..., 1], "Z3": Z_next[..., 2],
           # pre-transition measurement β: on a fully observed window pure
           # OLS, independent of (δ, Φ) — what the closed-form solve uses
           "beta_obs": beta_obs,
           # taxonomy bits: a non-finite prediction on an observed step (an
           # overflowed γ update, the partial-NaN poisoning) is STATE_EXPLODED
           "code": tax.bit(obs & ~torch.isfinite(pred).all(-1), tax.STATE_EXPLODED)}
    return MSEDState(gamma_next, beta_next, ewma, count), out


def scan_filter(spec: ModelSpec, params, data, start, end,
                state: MSEDState | None = None):
    """Run the recursion over all T columns of ``data`` (N, T); returns
    ``(mp, state, outs)`` with each output stacked along a T axis after the
    draw axes: (..., T, ...)."""
    mp = unpack_msed(spec, params)
    if state is None:
        state = init_state(spec, mp)
    T = data.shape[1]
    steps = []
    for t in range(T):
        state, out = _step(spec, mp, state, data[:, t], start <= t < end)
        steps.append(out)
    lead = params.dim() - 1
    outs = {k: torch.stack([o[k] for o in steps], dim=lead) for k in steps[0]}
    return mp, state, outs


def _replay(spec: ModelSpec, params, data, start, end, K: int):
    """The K filter passes of the loss: pass k continues from the end state
    of pass k−1 (k = 1), or restarts γ, β from (ω, δ) keeping the EWMA state
    (k ≥ 2), as the reference's checkpoint restore amounts to.  Returns the
    summed (..., T−1) window contributions."""
    mp = unpack_msed(spec, params)
    state = init_state(spec, mp)
    acc = 0.0
    for k in range(K):
        if k >= 2:
            state = MSEDState(mp.omega, mp.delta, state.ewma, state.count)
        mp, state, outs = scan_filter(spec, params, data, start, end, state)
        acc = acc + window_contributions(outs["pred"], data, start, end)
    return acc


def get_loss(spec: ModelSpec, params, data, start=0, end=None, K: int = 1):
    """One-step-ahead forecast −MSE, normalised by N·nobs·K; −Inf where it is
    not finite.  Shape ``params.shape[:-1]``."""
    if end is None:
        end = data.shape[1]
    nobs = end - start
    loss = _replay(spec, params, data, start, end, K).sum(-1) / spec.N / nobs / K
    return torch.where(torch.isfinite(loss), loss,
                       torch.full_like(loss, -float("inf")))


def get_loss_coded(spec: ModelSpec, params, data, start=0, end=None):
    """``(loss, code)``: :func:`get_loss` (K=1) and the taxonomy bitmask —
    the steps' STATE_EXPLODED bits inside the window, TRANSFORM_OVERFLOW for
    non-finite parameters, MISSING_ALL_OBS for a window without an observed
    column, STATE_EXPLODED for a −Inf loss without another cause."""
    T = data.shape[1]
    if end is None:
        end = T
    _, _, outs = scan_filter(spec, params, data, start, end)
    loss = window_contributions(outs["pred"], data, start, end).sum(-1) \
        / spec.N / (end - start)
    loss = torch.where(torch.isfinite(loss), loss, torch.full_like(loss, -float("inf")))
    t_idx = torch.arange(T, device=data.device)
    in_win = (t_idx >= start) & (t_idx < end)
    code = outs["code"]
    code = tax.params_code(params) \
        | tax.combine(torch.where(in_win, code, torch.zeros_like(code))) \
        | tax.bit(~(in_win & torch.isfinite(data[0])).any(), tax.MISSING_ALL_OBS)
    return loss, code | tax.bit(~torch.isfinite(loss) & (code == 0), tax.STATE_EXPLODED)


def get_loss_array(spec: ModelSpec, params, data, start=0, end=None, K: int = 1):
    """Per-step loss vector (..., T−1)."""
    if end is None:
        end = data.shape[1]
    return _replay(spec, params, data, start, end, K) / spec.N / K


def predict(spec: ModelSpec, params, data):
    """Filter all T columns and record the post-transition values at column
    t; NaN columns give multi-step forecasts.  Each entry (..., dim, T)."""
    _, _, outs = scan_filter(spec, params, data, 0, data.shape[1])
    return {"preds": outs["pred"].transpose(-1, -2),
            "factors": outs["beta"].transpose(-1, -2),
            "states": outs["gamma"].transpose(-1, -2),
            "factor_loadings_1": outs["Z2"].transpose(-1, -2),
            "factor_loadings_2": outs["Z3"].transpose(-1, -2)}
