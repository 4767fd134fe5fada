"""Differentiable fused Kalman log-likelihood: hand-written CUDA forward and
adjoint kernels behind a ``torch.autograd.Function``.

Counterpart of ``yieldfactormodels_jl_tpu/ops/pallas_kf_grad.py`` for the
three Kalman families.  The forward kernels (K2f for DNS "1C"/AFNS, K3f for
the TVλ EKF; ``csrc/fused_kf_grad.cu``) run the univariate recursion of K1
and save the (β, P) carry every S ≈ √T steps; the adjoint kernels (K2b,
K3b) recompute each segment from its checkpoint and sweep it in reverse,
accumulating

  (∂Z, ∂d, ∂Φ, ∂δ, ∂Ω, ∂σ², ∂β₀, ∂P₀)   (TVλ: no ∂Z, ∂d)

with the hand-derived adjoints of the rank-1 measurement update

    zP = Pᵀz,  f = z·zP + σ²,  v = y − d − z·b,  K = zP/f,
    b' = b + K v,  P' = P − K zPᵀ,  ll += −½(log f + v²/f + log 2π):

    K̄ = −P̄' zP + v b̄',          z̄P = −P̄'ᵀ K + K̄/f + f̄ z
    v̄ = K·b̄' − w v/f,           f̄ = −(K̄·K)/f − ½ w (1/f − v²/f²)
    b̄ = b̄' − fin·v̄·z,           P̄ = P̄' + z z̄Pᵀ
    z̄ += −fin·v̄·b + f̄·zP + P z̄P,  d̄ += −fin·v̄,  σ̄² += f̄

(w = cotangent × observed × contributing) and of the transition
β⁺ = δ + Φβ_m, P⁺ = ΦP_mΦᵀ + Ω:

    δ̄ += β̄⁺,  Ω̄ += P̄⁺,  Φ̄ += β̄⁺β_mᵀ + (P̄⁺ + P̄⁺ᵀ) Φ P_m,
    β̄_m = Φᵀβ̄⁺,  P̄_m = ΦᵀP̄⁺Φ.

**TVλ.**  The EKF rebuilds each step's loading rows from the predicted
state β (0-based: β₀ level, β₁ slope, β₂ curvature, β₃ the λ driver) and
linearizes about it: row i is z = (1, z₂, z₃, jac) and the innovation is
v = y + jb − z·b with jb = jac·β₃, i.e. the rank-1 update above with d = −jb.
So the step's ∂z rows and j̄b = fin·v̄ (= −d̄) are not parameter gradients:
they fold into the adjoint of the step's incoming β.  Per maturity τ:

    λ = 1e-2 + e^{β₃},  λ' = dλ/dβ₃ = e^{β₃},  s = λ − 1e-2,
    e = e^{−λτ},  z₂ = (1−e)/(λτ),  z₃ = z₂ − e,
    G = dz₂/dλ = e/λ − (1−e)/(λ²τ),  dz₃/dλ = G + τe,

D = ``tvl_dz2_dlam`` (= G when ``exact``; the reference's quirk
D = e/λ − e/(λ²τ) otherwise) and its λ-derivative

    exact:  D' = −τe/λ − 2e/λ² + 2(1−e)/(λ³τ)
    quirk:  D' = −τe/λ + 2e/(λ³τ),

    jac = A·s,  A = (β₁+β₂)·D + β₂·τe,
    ∂jac/∂β₁ = D·s,  ∂jac/∂β₂ = (D + τe)·s,
    ∂jac/∂β₃ = (((β₁+β₂)·D' − β₂τ²e)·s + A)·λ',
    ∂jb/∂βₖ = β₃·∂jac/∂βₖ (+ jac for k = 3).

With row cotangents (z̄₂, z̄₃, z̄₄) and j̄b, and c = z̄₄ + j̄b·β₃:

    β̄₃ += λ'·(z̄₂·G + z̄₃·(G + τe)) + c·∂jac/∂β₃ + j̄b·jac
    β̄₁ += c·∂jac/∂β₁,   β̄₂ += c·∂jac/∂β₂.

z₂ and z₃ always take the true derivative; only the Jacobian column follows
``exact``.  The Pallas kernel (``_bwd_kernel_tvl``) gets this by ``jax.vjp``
of one step; CUDA has no autodiff, so K3b and its plain version use these
formulas (:func:`tvl_rows_adjoint`).

``forward_reference``/``forward_reference_tvl`` and
``adjoint_reference``/``adjoint_reference_tvl`` are the plain versions of
the kernels, batched over draws as torch ops: the adjoints are the
CPU-testable definition of the kernels' algebra.  They keep the pre-update
state of every rank-1 update of a step instead of rebuilding it by
inverting the update as the Pallas kernel does (``P_pre = P_post + K
zPᵀ``): the inversion loses accuracy in float32 over N updates, the stored
state is exact, and the algebra is otherwise the same.

As in the JAX package, unpacking, the unconditional start and the Z/d
set-up (with the AFNS yield adjustment) stay torch ops outside the
Function, so their gradients come from autograd.
"""

from __future__ import annotations

import math

import torch

from ..models.kalman import (init_state, loglik_contrib_mask, measurement_setup,
                             observed_mask, tvl_dz2_dlam)
from ..models.loadings import LAMBDA_FLOOR
from ..models.params import unpack_kalman
from ..models.specs import ModelSpec
from . import fused_kf
from ._build import load

_LOG_2PI = math.log(2.0 * math.pi)


def _seg(T: int):
    """(segment length, #checkpoints) ≈ √T blocking."""
    S = max(1, int(math.ceil(math.sqrt(T))))
    return S, -(-T // S)


# ---------------------------------------------------------------------------
# plain versions (batched torch ops)
# ---------------------------------------------------------------------------

def _step_masks(masks, win, B, T, device):
    """(B, T) in-window and loglik-contributing masks, from the shared (T, 2)
    ``masks`` or from the (2, B) per-draw window ``win``."""
    if win is None:
        m = masks.to(device=device, dtype=torch.bool)
        return m[None, :, 0].expand(B, T), m[None, :, 1].expand(B, T)
    t = torch.arange(T, device=device)
    lo, hi = win[0].to(device)[:, None], win[1].to(device)[:, None]
    return (t >= lo) & (t < hi), (t >= lo + 1) & (t <= hi - 2)


def _chain(Z, d, ovar, y, fin, b, P, keep=None):
    """The N rank-1 measurement updates of one step.  ``y`` (N,) is the data
    column with NaNs replaced, ``fin`` its per-cell finiteness (Python
    bools).  Returns (b_u, P_u symmetrized, ll_step, ok); when ``keep`` is a
    list, each update's pre-state (b, P) is appended to it."""
    fs, vs = [], []
    for i in range(Z.shape[1]):
        if keep is not None:
            keep.append((b, P))
        z = Z[:, i]
        zP = (z[:, None, :] @ P)[:, 0]
        f = (zP * z).sum(-1) + ovar
        fsafe = torch.where(f > 0, f, torch.ones_like(f))
        v = y[i] - d[:, i] - (z * b).sum(-1) if fin[i] else torch.zeros_like(f)
        K = zP / fsafe[:, None]
        b = b + K * v[:, None]
        P = P - K[:, :, None] * zP[:, None, :]
        fs.append(f)
        vs.append(v)
    # the step's terms at once: (N, B)
    f, v = torch.stack(fs), torch.stack(vs)
    ok = ((f > 0) & torch.isfinite(f)).all(0)
    fsafe = torch.where(f > 0, f, torch.ones_like(f))
    ll = -0.5 * (torch.log(fsafe) + v * v / fsafe + _LOG_2PI).sum(0)
    return b, 0.5 * (P + P.transpose(-1, -2)), ll, ok


def _transition(Phi, delta, Om, b_m, P_m):
    return (delta + (Phi @ b_m[..., None])[..., 0],
            Phi @ P_m @ Phi.transpose(-1, -2) + Om)


def _columns(data):
    """(data with NaNs as 0, per-cell finiteness as Python lists, per-step
    all-finite flags): the panel is shared by every draw, so its missing
    pattern is read once."""
    fin = torch.isfinite(data)
    return (torch.where(fin, data, torch.zeros_like(data)),
            fin.T.tolist(), fin.all(0).tolist())


def _forward_step(rows, Phi, delta, Om, ovar, y, fin, obs, beta, P):
    """One predicted state (β, P) → the next, with the step's loglik term
    (0 where unobserved, −inf where the chain failed) and the blended
    post-update state.  ``rows(β)`` gives the step's (Z, d)."""
    b_m, P_m = beta, P
    ll_t = torch.zeros_like(ovar)
    if bool(obs.any()):  # else predict-only for every draw
        Z, d = rows(beta)
        b_u, P_u, ll_step, ok = _chain(Z, d, ovar, y, fin, beta, P)
        b_m = torch.where(obs[:, None], b_u, beta)
        P_m = torch.where(obs[:, None, None], P_u, P)
        ll_t = torch.where(ok, ll_step, torch.full_like(ll_step, -math.inf))
    return _transition(Phi, delta, Om, b_m, P_m), ll_t


def _forward(rows, Phi, delta, Om, ovar, beta0, P0, data, masks, win):
    """The recursion of the forward kernels: (ll (B,), checkpoints)."""
    B, Ms = delta.shape
    T = data.shape[1]
    S, _ = _seg(T)
    obs_m, con_m = _step_masks(masks, win, B, T, Phi.device)
    ysafe, fin, fin_all = _columns(data)
    beta, P = beta0, P0
    ll = torch.zeros_like(ovar)
    chk = []
    for t in range(T):
        if t % S == 0:
            chk.append(torch.cat([beta, P.reshape(B, Ms * Ms)], dim=1))
        obs = obs_m[:, t] & fin_all[t]
        (beta, P), ll_t = _forward_step(rows, Phi, delta, Om, ovar, ysafe[:, t],
                                        fin[t], obs, beta, P)
        ll = ll + torch.where(obs & con_m[:, t], ll_t, torch.zeros_like(ll_t))
    ll = torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -math.inf))
    return ll, torch.stack(chk, dim=1)


def forward_reference(Z, d, Phi, delta, Om, ovar, beta0, P0, data, masks, win):
    """Plain version of K2f: (ll (B,), checkpoints (B, nC, Ms+Ms²)).

    ``Z`` (B, N, Ms), ``d`` (B, N), ``Phi``/``Om`` (B, Ms, Ms), ``delta``/
    ``beta0`` (B, Ms), ``ovar`` (B,), ``P0`` (B, Ms, Ms), ``data`` (N, T);
    ``masks`` (T, 2) observed/contributing for a shared window, or ``win``
    (2, B) per-draw [start, end).  The checkpoints hold the predicted
    (β, P) at t = 0, S, 2S, …  Differentiable by autograd (the tests use
    that as a witness for the adjoint)."""
    forward_reference.calls += 1
    return _forward(lambda _: (Z, d), Phi, delta, Om, ovar, beta0, P0, data,
                    masks, win)


forward_reference.calls = 0


def tvl_rows_reference(beta, mats, exact: bool):
    """The TVλ measurement rows of predicted states ``beta`` (B, 4) at
    maturities ``mats`` (N,): Z (B, N, 4) = (1, z₂, z₃, jac) per maturity,
    with the EKF Jacobian column under ``exact``, and the linearization
    offset jb = jac·β₃ (B, N).  The batched copy of
    ``pallas_kf.tvl_rows``, with e^{−λτ} taken by ``exp`` as K1, K3f and the
    univariate engine take it (the Pallas build recovers it as z₂ − z₃)."""
    lam = LAMBDA_FLOOR + torch.exp(beta[:, 3:4])           # (B, 1)
    dlam = lam - LAMBDA_FLOOR
    x = lam * mats
    e = torch.exp(-x)
    z2 = (1.0 - e) / x
    z3 = z2 - e
    dz2 = tvl_dz2_dlam(lam, e, mats, exact)
    jac = ((beta[:, 1:2] + beta[:, 2:3]) * dz2 + beta[:, 2:3] * mats * e) * dlam
    return torch.stack([torch.ones_like(z2), z2, z3, jac], -1), jac * beta[:, 3:4]


def tvl_rows_adjoint(beta, mats, exact: bool, Zbar, jbbar):
    """The adjoint of :func:`tvl_rows_reference`: the cotangents ``Zbar``
    (B, N, 4) of the rows (column 0, the constant, is ignored) and ``jbbar``
    (B, N) of the offsets → β̄ (B, 4), by the hand-derived formulas of the
    module docstring (not autograd)."""
    b1, b2, b3 = beta[:, 1:2], beta[:, 2:3], beta[:, 3:4]
    dlam = torch.exp(b3)                                   # λ'
    lam = LAMBDA_FLOOR + dlam
    s = lam - LAMBDA_FLOOR
    e = torch.exp(-lam * mats)
    te = mats * e
    G = e / lam - (1.0 - e) / (lam * lam * mats)
    D = tvl_dz2_dlam(lam, e, mats, exact)
    if exact:
        Dp = -te / lam - 2.0 * e / (lam * lam) + 2.0 * (1.0 - e) / (lam ** 3 * mats)
    else:
        Dp = -te / lam + 2.0 * e / (lam ** 3 * mats)
    A = (b1 + b2) * D + b2 * te
    jac = A * s
    c = Zbar[..., 3] + jbbar * b3
    g1 = (c * D * s).sum(-1)
    g2 = (c * (D + te) * s).sum(-1)
    g3 = (dlam * (Zbar[..., 1] * G + Zbar[..., 2] * (G + te))
          + c * (((b1 + b2) * Dp - b2 * mats * te) * s + A) * dlam
          + jbbar * jac).sum(-1)
    return torch.stack([torch.zeros_like(g1), g1, g2, g3], -1)


def _tvl_rows(mats, exact):
    """``rows(β)`` of the TVλ step: (Z, d = −jb)."""
    def rows(beta):
        Z, jb = tvl_rows_reference(beta, mats, exact)
        return Z, -jb
    return rows


def forward_reference_tvl(Phi, delta, Om, ovar, beta0, P0, data, masks, win,
                          mats, exact: bool):
    """Plain version of K3f: the TVλ EKF loglik and checkpoints, as
    :func:`forward_reference` with each step's rows rebuilt from its
    predicted state (``mats`` (N,) maturities, ``exact`` the Jacobian
    setting).  Differentiable by autograd."""
    forward_reference_tvl.calls += 1
    return _forward(_tvl_rows(mats, exact), Phi, delta, Om, ovar, beta0, P0,
                    data, masks, win)


forward_reference_tvl.calls = 0


def _step_adjoint(Z, d, Phi, ovar, y, fin, obs, w, beta, P, bbar_n, Pbar_n, acc):
    """Adjoint of one step, given its incoming state (β, P), its rows (Z, d)
    and the adjoint (β̄⁺, P̄⁺) of the state it hands on; accumulates into
    ``acc`` and returns the adjoint of (β, P)."""
    gZ, gd, gPhi, gdelta, gOm, govar = acc
    keep = []
    observed = bool(obs.any())
    b_m, P_m = beta, P
    if observed:  # else every draw's step is predict-only: no chain to undo
        b_u, P_u, _, _ = _chain(Z, d, ovar, y, fin, beta, P, keep)
        b_m = torch.where(obs[:, None], b_u, beta)
        P_m = torch.where(obs[:, None, None], P_u, P)

    # transition
    gdelta += bbar_n
    gOm += Pbar_n
    PbS = Pbar_n + Pbar_n.transpose(-1, -2)
    gPhi += bbar_n[:, :, None] * b_m[:, None, :] + PbS @ (Phi @ P_m)
    bbar_m = (Phi.transpose(-1, -2) @ bbar_n[..., None])[..., 0]
    Pbar_m = Phi.transpose(-1, -2) @ Pbar_n @ Phi
    if not observed:
        return bbar_m, Pbar_m

    # blend β_m = obs ? β_u : β, then the symmetrization of P_u
    obs_f = obs.to(beta.dtype)
    bbar = obs_f[:, None] * bbar_m
    bbar_pre = (1.0 - obs_f)[:, None] * bbar_m
    Pbar_u = obs_f[:, None, None] * Pbar_m
    Pbar_pre = (1.0 - obs_f)[:, None, None] * Pbar_m
    Pbar = 0.5 * (Pbar_u + Pbar_u.transpose(-1, -2))

    # the N rank-1 updates, last first
    for i in reversed(range(Z.shape[1])):
        b_pre, P_pre = keep[i]
        z = Z[:, i]
        zP = (z[:, None, :] @ P_pre)[:, 0]
        f = (zP * z).sum(-1) + ovar
        fsafe = torch.where(f > 0, f, torch.ones_like(f))
        pred = (z * b_pre).sum(-1) + d[:, i]
        v = y[i] - pred if fin[i] else torch.zeros_like(pred)
        inv_f = 1.0 / fsafe
        K = zP * inv_f[:, None]
        Kbar = -(Pbar @ zP[..., None])[..., 0] + v[:, None] * bbar
        zPbar = -(Pbar.transpose(-1, -2) @ K[..., None])[..., 0] + Kbar * inv_f[:, None]
        vbar = (K * bbar).sum(-1) - w * v * inv_f
        fbar = (-(Kbar * K).sum(-1) * inv_f
                - 0.5 * w * (inv_f - v * v * inv_f * inv_f))
        zPbar = zPbar + fbar[:, None] * z
        govar += fbar
        if fin[i]:
            bbar = bbar - vbar[:, None] * z
            gd[:, i] -= vbar
            gZ[:, i] -= vbar[:, None] * b_pre
        gZ[:, i] += fbar[:, None] * zP + (P_pre @ zPbar[..., None])[..., 0]
        Pbar = Pbar + z[:, :, None] * zPbar[:, None, :]
    return bbar + bbar_pre, Pbar + Pbar_pre


def _reverse_sweep(rows, step, Phi, delta, Om, ovar, data, masks, win, chk, g):
    """The segment recompute and reverse sweep of the adjoint kernels, last
    segment first: ``step(y, fin, obs, w, β, P, β̄⁺, P̄⁺)`` is one step's
    adjoint.  Returns (β̄₀, P̄₀)."""
    B, Ms = delta.shape
    T = data.shape[1]
    S, nC = _seg(T)
    obs_m, con_m = _step_masks(masks, win, B, T, Phi.device)
    ysafe, fin, fin_all = _columns(data)
    bbar = torch.zeros_like(delta)
    Pbar = torch.zeros_like(Phi)
    zero = torch.zeros_like(g)
    for c in reversed(range(nC)):
        beta, P = chk[:, c, :Ms], chk[:, c, Ms:].reshape(B, Ms, Ms)
        ts = range(c * S, min((c + 1) * S, T))
        states = []
        for t in ts[:-1]:  # recompute the segment's incoming states
            states.append((beta, P))
            (beta, P), _ = _forward_step(rows, Phi, delta, Om, ovar, ysafe[:, t],
                                         fin[t], obs_m[:, t] & fin_all[t], beta, P)
        states.append((beta, P))
        for t in reversed(ts):
            obs = obs_m[:, t] & fin_all[t]
            w = torch.where(obs & con_m[:, t], g, zero)
            beta, P = states[t - c * S]
            bbar, Pbar = step(ysafe[:, t], fin[t], obs, w, beta, P, bbar, Pbar)
    return bbar, Pbar


def _gate(g, grads):
    """Zero the rows of draws whose cotangent is 0 (non-finite loglik)."""
    live = g != 0
    return tuple(torch.where(live.reshape((-1,) + (1,) * (x.ndim - 1)), x,
                             torch.zeros_like(x)) for x in grads)


def adjoint_reference(Z, d, Phi, delta, Om, ovar, data, masks, win, chk, g):
    """Plain version of K2b: the gradients (∂Z, ∂d, ∂Φ, ∂δ, ∂Ω, ∂σ², ∂β₀,
    ∂P₀) of Σ g·ll, in the inputs' shapes.  ``chk`` comes from
    :func:`forward_reference`; ``g`` (B,) is the cotangent, already zero
    for draws whose loglik is not finite: their rows come back zero."""
    adjoint_reference.calls += 1
    acc = (torch.zeros_like(Z), torch.zeros_like(d), torch.zeros_like(Phi),
           torch.zeros_like(delta), torch.zeros_like(Om), torch.zeros_like(ovar))

    def step(y, fin, obs, w, beta, P, bbar, Pbar):
        return _step_adjoint(Z, d, Phi, ovar, y, fin, obs, w, beta, P, bbar,
                             Pbar, acc)

    bbar, Pbar = _reverse_sweep(lambda _: (Z, d), step, Phi, delta, Om, ovar,
                                data, masks, win, chk, g)
    return _gate(g, (*acc, bbar, Pbar))


adjoint_reference.calls = 0


def adjoint_reference_tvl(Phi, delta, Om, ovar, data, masks, win, mats,
                          exact: bool, chk, g):
    """Plain version of K3b: the gradients (∂Φ, ∂δ, ∂Ω, ∂σ², ∂β₀, ∂P₀) of
    Σ g·ll for the TVλ EKF.  Each observed step runs the rank-1 adjoint
    with its rebuilt rows (d = −jb); the ∂Z, ∂d it produces go through
    :func:`tvl_rows_adjoint` into the step's incoming β̄."""
    adjoint_reference_tvl.calls += 1
    acc = (torch.zeros_like(Phi), torch.zeros_like(delta), torch.zeros_like(Om),
           torch.zeros_like(ovar))
    rows = _tvl_rows(mats, exact)

    def step(y, fin, obs, w, beta, P, bbar, Pbar):
        if not bool(obs.any()):  # predict-only: the rows play no part
            return _step_adjoint(None, None, Phi, ovar, y, fin, obs, w, beta, P,
                                 bbar, Pbar, (None, None, *acc))
        Z, d = rows(beta)
        gZ, gd = torch.zeros_like(Z), torch.zeros_like(d)
        bbar, Pbar = _step_adjoint(Z, d, Phi, ovar, y, fin, obs, w, beta, P,
                                   bbar, Pbar, (gZ, gd, *acc))
        return bbar + tvl_rows_adjoint(beta, mats, exact, gZ, -gd), Pbar

    bbar, Pbar = _reverse_sweep(rows, step, Phi, delta, Om, ovar, data, masks,
                                win, chk, g)
    return _gate(g, (*acc, bbar, Pbar))


adjoint_reference_tvl.calls = 0


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def lay_out(Z, d, Phi, delta, Om, ovar, beta0, P0, data, masks, win):
    """The kernels' buffers for the arguments of :func:`forward_reference`:
    per-draw tensors draw-minor (D, B), the panel as (T, N), in the C entry
    points' order."""
    B = Z.shape[0]
    return ([fused_kf._lay(x, B) for x in (Z, d, Phi, delta, Om, ovar, beta0, P0)]
            + [data.T.contiguous(), masks.contiguous(),
               None if win is None else win.contiguous()])


def lay_out_tvl(Phi, delta, Om, ovar, beta0, P0, data, masks, win, mats):
    """The TVλ kernels' buffers for the arguments of
    :func:`forward_reference_tvl` (without ``exact``), in the C entry
    points' order: the six per-draw tensors draw-minor, the panel (T, N),
    the masks, the window and the maturities."""
    B = Phi.shape[0]
    return ([fused_kf._lay(x, B) for x in (Phi, delta, Om, ovar, beta0, P0)]
            + [data.T.contiguous(), masks.contiguous(),
               None if win is None else win.contiguous(), mats.contiguous()])


def _ptrs(bufs):
    return [None if x is None else x.data_ptr() for x in bufs]


def _sizes(bufs):
    """(dtype code, Ms, B, N, T, S, nC) of a :func:`lay_out` buffer list."""
    Ms, B = bufs[3].shape
    T, N = bufs[8].shape
    if Ms * Ms != bufs[2].shape[0] or bufs[0].shape != (N * Ms, B):
        raise ValueError("fused_kf_grad: inconsistent buffer shapes")
    return (fused_kf._DTYPE_CODES[bufs[0].dtype], Ms, B, N, T) + _seg(T)


def _sizes_tvl(bufs):
    """(dtype code, B, N, T, S, nC) of a :func:`lay_out_tvl` buffer list."""
    Ms, B = bufs[1].shape
    T, N = bufs[6].shape
    if Ms != 4 or bufs[0].shape != (16, B) or bufs[9].shape != (N,):
        raise ValueError("fused_kf_grad: inconsistent TVλ buffer shapes")
    return (fused_kf._DTYPE_CODES[bufs[0].dtype], B, N, T) + _seg(T)


def _launch(entry, what, dev, *args):
    """Call one C entry point of ``fused_kf_grad.cu`` on PyTorch's current
    stream of ``dev``; raises if the launch is refused."""
    lib = load("fused_kf_grad")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def launch_forward(bufs):
    """One launch of K2f on PyTorch's current stream, on :func:`lay_out`
    buffers (CUDA, one float type).  Returns (ll (B,), checkpoints
    (nC·(Ms+Ms²), B) draw-minor); raises if the launch is refused."""
    code, Ms, B, N, T, S, nC = _sizes(bufs)
    dev, dtype = bufs[0].device, bufs[0].dtype
    out = torch.empty(B, dtype=dtype, device=dev)
    chk = torch.empty(nC * (Ms + Ms * Ms), B, dtype=dtype, device=dev)
    _launch("yfm_kf_grad_fwd", "K2f (fused_kf_grad forward)", dev, code, Ms, B,
            N, T, S, *_ptrs(bufs), out.data_ptr(), chk.data_ptr())
    launch_forward.launches += 1
    return out, chk


launch_forward.launches = 0


def launch_backward(bufs, chk, g):
    """One launch of K2b on PyTorch's current stream: :func:`lay_out`
    buffers, the checkpoints of :func:`launch_forward` and the gated
    cotangent g (B,).  Returns the eight gradients (∂Z, ∂d, ∂Φ, ∂δ, ∂Ω, ∂σ²,
    ∂β₀, ∂P₀) draw-minor, (D, B) each.  The segment states and the
    per-update pre-states live in draw-minor scratch allocated here."""
    code, Ms, B, N, T, S, nC = _sizes(bufs)
    dev, dtype = bufs[0].device, bufs[0].dtype
    D = Ms + Ms * Ms
    rows = (N * Ms, N, Ms * Ms, Ms, Ms * Ms, 1, Ms, Ms * Ms)
    grads = [torch.empty(r, B, dtype=dtype, device=dev) for r in rows]
    seg = torch.empty(S * D, B, dtype=dtype, device=dev)
    pre = torch.empty(N * D, B, dtype=dtype, device=dev)
    ins = bufs[:6] + bufs[8:] + [chk, g.contiguous()]
    _launch("yfm_kf_grad_bwd", "K2b (fused_kf_grad backward)", dev, code, Ms, B,
            N, T, S, nC, *_ptrs(ins), *_ptrs(grads + [seg, pre]))
    launch_backward.launches += 1
    return grads


launch_backward.launches = 0


def launch_forward_tvl(bufs, exact: bool):
    """One launch of K3f on :func:`lay_out_tvl` buffers: (ll (B,),
    checkpoints (nC·20, B) draw-minor), as :func:`launch_forward`."""
    code, B, N, T, S, nC = _sizes_tvl(bufs)
    dev, dtype = bufs[0].device, bufs[0].dtype
    out = torch.empty(B, dtype=dtype, device=dev)
    chk = torch.empty(nC * 20, B, dtype=dtype, device=dev)
    _launch("yfm_kf_tvl_grad_fwd", "K3f (fused_kf_grad TVλ forward)", dev, code,
            int(exact), B, N, T, S, *_ptrs(bufs), out.data_ptr(), chk.data_ptr())
    launch_forward_tvl.launches += 1
    return out, chk


launch_forward_tvl.launches = 0


def launch_backward_tvl(bufs, exact: bool, chk, g):
    """One launch of K3b: :func:`lay_out_tvl` buffers, the checkpoints of
    :func:`launch_forward_tvl` and the gated cotangent g (B,).  Returns the
    six gradients (∂Φ, ∂δ, ∂Ω, ∂σ², ∂β₀, ∂P₀) draw-minor, (D, B) each."""
    code, B, N, T, S, nC = _sizes_tvl(bufs)
    dev, dtype = bufs[0].device, bufs[0].dtype
    grads = [torch.empty(r, B, dtype=dtype, device=dev) for r in (16, 4, 16, 1, 4, 16)]
    seg = torch.empty(S * 20, B, dtype=dtype, device=dev)
    pre = torch.empty(N * 20, B, dtype=dtype, device=dev)
    ins = bufs[:4] + bufs[6:] + [chk, g.contiguous()]
    _launch("yfm_kf_tvl_grad_bwd", "K3b (fused_kf_grad TVλ backward)", dev, code,
            int(exact), B, N, T, S, nC, *_ptrs(ins), *_ptrs(grads + [seg, pre]))
    launch_backward_tvl.launches += 1
    return grads


launch_backward_tvl.launches = 0


class _KalmanCore(torch.autograd.Function):
    """ll = K2f(Z, d, Φ, δ, Ω, σ², β₀, P₀; data, masks, win), with K2b as its
    backward; the plain versions on CPU tensors.  The counterpart of
    ``pallas_kf_grad._core``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, Z, d, Phi, delta, Om, ovar, beta0, P0, data, masks, win):
        args = (Z, d, Phi, delta, Om, ovar, beta0, P0, data, masks, win)
        if Z.device.type == "cuda":
            saved = lay_out(*args)
            ll, chk = launch_forward(saved)
        elif Z.device.type == "cpu":
            saved = args
            ll, chk = forward_reference(*args)
        else:
            raise ValueError(f"no fused kernel for device {Z.device}")
        ctx.shapes = [x.shape for x in args[:8]]
        ctx.save_for_backward(*saved, chk, ll)
        return ll

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *saved, chk, ll = ctx.saved_tensors
        # where the forward hit the −Inf sentinel the loss is constant
        g = torch.where(torch.isfinite(ll), g, torch.zeros_like(g))
        if ll.is_cuda:
            grads = [x.T.reshape(shape) for x, shape in
                     zip(launch_backward(list(saved), chk, g), ctx.shapes)]
        else:
            grads = adjoint_reference(*saved[:6], *saved[8:], chk, g)
        return (*grads, None, None, None)


class _TvlCore(torch.autograd.Function):
    """ll = K3f(Φ, δ, Ω, σ², β₀, P₀; data, masks, win, mats, exact), with K3b
    as its backward; the plain versions on CPU tensors.  The counterpart of
    ``pallas_kf_grad._core_tvl``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, Phi, delta, Om, ovar, beta0, P0, data, masks, win, mats,
                exact):
        args = (Phi, delta, Om, ovar, beta0, P0, data, masks, win, mats)
        if Phi.device.type == "cuda":
            saved = lay_out_tvl(*args)
            ll, chk = launch_forward_tvl(saved, exact)
        elif Phi.device.type == "cpu":
            saved = args
            ll, chk = forward_reference_tvl(*args, exact)
        else:
            raise ValueError(f"no fused kernel for device {Phi.device}")
        ctx.exact = exact
        ctx.shapes = [x.shape for x in args[:6]]
        ctx.save_for_backward(*saved, chk, ll)
        return ll

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *saved, chk, ll = ctx.saved_tensors
        g = torch.where(torch.isfinite(ll), g, torch.zeros_like(g))
        if ll.is_cuda:
            grads = [x.T.reshape(shape) for x, shape in
                     zip(launch_backward_tvl(list(saved), ctx.exact, chk, g),
                         ctx.shapes)]
        else:
            grads = adjoint_reference_tvl(*saved[:4], *saved[6:], ctx.exact, chk, g)
        return (*grads, None, None, None, None, None)


def core_inputs(spec: ModelSpec, params, data, start, end, starts=None, ends=None):
    """The arguments of :func:`forward_reference` (DNS/AFNS) or of
    :func:`forward_reference_tvl` (TVλ) for a (B, n_params) batch of
    constrained draws: unpacking, the unconditional start and the Z/d
    set-up as differentiable tensor ops, and the window masks."""
    kp = unpack_kalman(spec, params)
    state0 = init_state(spec, kp)
    T = data.shape[1]
    masks = torch.stack([observed_mask(start, end, T, params.device),
                         loglik_contrib_mask(start, end, T, params.device)],
                        dim=1).to(torch.uint8)
    win = None if starts is None else torch.stack([starts, ends]).to(torch.int32)
    state = (kp.Phi, kp.delta, kp.Omega_state, kp.obs_var, state0.beta, state0.P,
             data, masks, win)
    if spec.family == "kalman_tvl":  # rows are rebuilt from the state
        return state + (spec.maturities_array(params.device, params.dtype),
                        spec.exact_jacobian)
    Z, d = measurement_setup(spec, kp, params.dtype)
    if d is None:
        d = torch.zeros(params.shape[0], spec.N, dtype=params.dtype,
                        device=params.device)
    return (Z, d) + state


def batched_loglik_diff(spec: ModelSpec, params_batch, data, start=0, end=None,
                        starts=None, ends=None, device=None, dtype=None):
    """Differentiable fused loglik: (B, n_params) constrained draws → (B,).

    ``torch.autograd`` flows through K2b (DNS/AFNS) or K3b (TVλ) for the
    state-space tensors and through ordinary autograd for the unpacking and
    loading set-up.  ``dtype`` defaults to float32 (the kernels' working
    type); float64 is accepted.  ``starts``/``ends``: optional (B,)
    per-draw windows; the scalar ``start``/``end`` are then ignored.  Numpy
    input goes to ``device`` (``None`` means CUDA); tensors stay where they
    are."""
    if spec.family not in fused_kf._FAMILIES:
        raise ValueError(f"differentiable fused kernel supports the kalman "
                         f"families, not {spec.family!r}")
    dtype = torch.float32 if dtype is None else dtype
    params, data, starts, ends = fused_kf._prepare(
        spec, params_batch, data, starts, ends, device, dtype)
    if end is None:
        end = data.shape[1]
    core = _TvlCore if spec.family == "kalman_tvl" else _KalmanCore
    return core.apply(*core_inputs(spec, params, data, start, end, starts, ends))
