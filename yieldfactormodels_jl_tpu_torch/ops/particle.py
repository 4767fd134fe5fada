"""Rao-Blackwellised particle filter for the Kalman families with
stochastic-volatility (SV) measurement errors.

Counterpart of ``yieldfactormodels_jl_tpu/ops/particle.py``.  The model:

    y_t = Z x_t + d + ε_t,   ε_t ~ N(0, σ² e^{h_t} I_N)
    h_t = φ_h h_{t-1} + σ_h η_t                     (log-vol AR(1), h₀ = 0)
    x_t as in the linear state space (Φ, δ, Ω_state)

Conditional on the volatility path the model is linear-Gaussian, so the
filter samples h alone and runs an exact square-root Kalman step per
particle.  The particle axis is last everywhere: β (..., Ms, P), S (...,
Ms, Ms, P), h and the log-weights (..., P), with leading draw axes in front.

One loop, :func:`_filter`, serves this module's filter and the plain version
of the fused kernel K5 (``ops/fused_pf.pf_loglik_batch_reference``): it runs
P particle slots of which the first ``n_eff`` are live and the rest dead
(weight −Inf, never resampled into a live slot).  With ``n_eff = P`` it is
the JAX package's filter step for step: skip the first innovation, a NaN
column is a predict-only step, the max-shifted logsumexp of the weights,
resampling when ESS < ``ess_threshold``·n_eff by systematic resampling with
searchsorted-left positions clamped to the last live particle, and the −Inf
draw sentinel.
"""

from __future__ import annotations

import math

import torch

from ..models.kalman import init_state, measurement_setup
from ..models.params import unpack_kalman
from ..models.specs import ModelSpec
from ..robustness import taxonomy as tax
from .sqrt_kf import _cholesky_or_nan

_LOG_2PI = math.log(2.0 * math.pi)


def require_constant_measurement(spec: ModelSpec):
    """Refuse a family whose measurement depends on the state."""
    if not spec.has_constant_measurement:
        raise ValueError("the SV particle filter marginalizes a LINEAR state space; "
                         f"family {spec.family!r} has a state-dependent measurement")


def _measurement(spec: ModelSpec, kp, dtype):
    """Loadings Z (..., N, Ms) and intercept d (..., N) of a constant-
    measurement family in ``dtype``."""
    require_constant_measurement(spec)
    Z, d = measurement_setup(spec, kp, dtype)
    if d is None:
        d = torch.zeros(Z.shape[:-1], dtype=dtype, device=Z.device)
    return Z, d


def factored_init(spec: ModelSpec, kp, dtype):
    """Initial state and factored covariances with the engine's jitters and
    fallbacks — the one copy the filter and K5's parameter packing share.
    Returns ``(state0, S0, chol_Om, fac_ok)``; a failed factorization is
    the draw's −Inf sentinel (``fac_ok`` False)."""
    Ms = spec.state_dim
    eye = torch.eye(Ms, dtype=dtype, device=kp.Phi.device)
    state0 = init_state(spec, kp)
    S0 = _cholesky_or_nan(0.5 * (state0.P + state0.P.transpose(-1, -2)) + 1e-9 * eye)
    chol_Om = _cholesky_or_nan(0.5 * (kp.Omega_state + kp.Omega_state.transpose(-1, -2))
                               + 1e-12 * eye)
    fac_ok = torch.isfinite(S0).all(-1).all(-1) & torch.isfinite(chol_Om).all(-1).all(-1)
    S0 = torch.where(torch.isfinite(S0), S0, eye * 1e-3)
    chol_Om = torch.where(torch.isfinite(chol_Om), chol_Om, torch.zeros_like(chol_Om))
    return state0, S0, chol_Om, fac_ok


def _systematic_resample(u, weights, n: int):
    """Slot → particle indices of systematic resampling from offsets ``u``
    (...,) over the first ``n`` of ``weights`` (..., P): the first i with
    cum_i ≥ (j + u)/n (searchsorted-left, so u = 0 clones particle 0), and
    n − 1 where no cum_i reaches it (JAX's gather clamps an index of n);
    slots j ≥ n (dead) take n − 1 too."""
    P = weights.shape[-1]
    j = torch.arange(n, dtype=weights.dtype, device=weights.device)
    positions = (j + u[..., None]) / n
    cum = torch.cumsum(weights[..., :n], dim=-1)
    idx = torch.searchsorted(cum.contiguous(), positions.contiguous(), right=False)
    idx = torch.clamp_max(idx, n - 1)
    if P > n:
        idx = torch.cat([idx, torch.full(idx.shape[:-1] + (P - n,), n - 1,
                                         dtype=idx.dtype, device=idx.device)], -1)
    return idx


def _propagate_cholesky(A, Om, Ms: int, floor: float = 1e-12):
    """Unrolled Cholesky–Banachiewicz of P = A Aᵀ + Ω for A (..., Ms, Ms, P)
    and Ω (..., Ms, Ms): each needed entry of P formed on demand, Ω first
    and then the Ms products in order, diagonal pivots floored (NaN stays
    NaN).  Returns the lower factor (..., Ms, Ms, P)."""
    L = [[None] * Ms for _ in range(Ms)]
    for i in range(Ms):
        for j in range(i + 1):
            s = Om[..., i, j, None]
            for k in range(Ms):
                s = s + A[..., i, k, :] * A[..., j, k, :]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = torch.sqrt(torch.clamp_min(s, floor))
            else:
                L[i][j] = s / L[j][j]
    zero = torch.zeros_like(L[0][0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero for j in range(Ms)], -2)
                        for i in range(Ms)], -3)


def _kf_particle_step(Z, d, Phi, delta, Omq, beta, S, y, r, obs):
    """Square-root measurement and propagation step for every particle.

    Z (..., N, Ms), d (..., N), Φ (..., Ms, Ms), δ (..., Ms), Ω (..., Ms, Ms)
    per draw; β (..., Ms, P), S (..., Ms, Ms, P) the lower factor of the
    predicted covariance; y (N,) the column with NaN read as 0; r (..., P)
    the per-particle observation variance σ²e^{h}; ``obs`` 1.0 when the
    column is finite, else 0.0 (the update is computed and blended away).
    The N scalar Potter updates keep f = φᵀφ + r > 0 whenever r > 0.
    Returns (β', S', ll (..., P)) with −Inf where an update failed."""
    sqrt_r = torch.sqrt(torch.clamp_min(r, 0.0))
    b_u, S_u = beta, S
    ll = torch.zeros_like(r)
    ok = torch.isfinite(r)
    for i in range(Z.shape[-2]):
        z = Z[..., i, :]
        phi = (S_u * z[..., :, None, None]).sum(-3)              # Sᵀz (..., Ms, P)
        f = (phi * phi).sum(-2) + r
        fsafe = torch.where(f > 0, f, torch.ones_like(f))
        ok = ok & torch.isfinite(f) & (f > 0)
        v = (y[i] - d[..., i])[..., None] - (b_u * z[..., :, None]).sum(-2)
        Sphi = (S_u * phi[..., None, :, :]).sum(-2)              # P z (..., Ms, P)
        b_u = b_u + Sphi * (v / fsafe)[..., None, :]
        alpha = 1.0 / (fsafe + sqrt_r * torch.sqrt(fsafe))
        S_u = S_u - alpha[..., None, None, :] * (Sphi[..., :, None, :] * phi[..., None, :, :])
        ll = ll - 0.5 * (torch.log(fsafe) + v * v / fsafe + _LOG_2PI)
    beta_m = beta + (b_u - beta) * obs
    S_m = S + (S_u - S) * obs
    Ms = Phi.shape[-1]
    beta_next = delta[..., :, None] + (Phi[..., :, :, None] * beta_m[..., None, :, :]).sum(-2)
    A = torch.stack([torch.stack([
        sum(Phi[..., i, j, None] * S_m[..., j, k, :] for j in range(Ms))
        for k in range(Ms)], -2) for i in range(Ms)], -3)
    S_next = _propagate_cholesky(A, Omq, Ms)
    return beta_next, S_next, torch.where(ok, ll, torch.full_like(ll, -math.inf))


def _filter(Z, d, Phi, delta, Omq, ovar, beta0, S0, data, normals, uniforms,
            n_eff: int, sv_phi, sv_sigma, ess_threshold: float):
    """The common-noise filter over P slots, the first ``n_eff`` live.

    Per-draw inputs carry the leading draw axes (...); ``beta0`` (..., Ms),
    ``S0`` (..., Ms, Ms); ``normals`` (..., T−1, P), ``uniforms`` (...,
    T−1) (shared noise broadcasts); ``sv_phi``/``sv_sigma`` floats or (...)
    tensors.  Returns (total (...), dead (...)): the summed step
    log-likelihoods, and whether a contributing step's mixture weight
    collapsed (its log-likelihood not finite)."""
    T = data.shape[1]
    P = normals.shape[-1]
    dtype, device = ovar.dtype, ovar.device
    batch = ovar.shape
    Ms = Phi.shape[-1]
    live = torch.arange(P, device=device) < n_eff
    log_uniform = torch.tensor(-math.log(float(n_eff)), dtype=dtype, device=device)
    logw_reset = torch.where(live, log_uniform, torch.tensor(-math.inf, dtype=dtype,
                                                             device=device))
    sv_phi = torch.as_tensor(sv_phi, dtype=dtype, device=device)[..., None]
    sv_sigma = torch.as_tensor(sv_sigma, dtype=dtype, device=device)[..., None]
    th = float(ess_threshold) * n_eff
    beta = beta0[..., None].expand(batch + (Ms, P))
    S = S0[..., None].expand(batch + (Ms, Ms, P))
    h = torch.zeros(batch + (P,), dtype=dtype, device=device)
    logw = logw_reset.expand(batch + (P,))
    total = torch.zeros(batch, dtype=dtype, device=device)
    dead = torch.zeros(batch, dtype=torch.bool, device=device)
    finite_cols = torch.isfinite(data).all(0).tolist()
    ysafe = torch.where(torch.isfinite(data), data, torch.zeros_like(data))
    for t in range(T - 1):
        h_new = sv_phi * h + sv_sigma * normals[..., t, :]
        r = ovar[..., None] * torch.exp(h_new)
        obs = 1.0 if finite_cols[t] else 0.0
        beta, S, ll = _kf_particle_step(Z, d, Phi, delta, Omq, beta, S, ysafe[:, t], r, obs)
        contrib = finite_cols[t] and t > 0
        logw_new = logw + ll if contrib else logw + 0.0
        m = logw_new.amax(-1)
        m_safe = torch.where(m > -math.inf, m, torch.zeros_like(m))
        step_ll = m_safe + torch.log(torch.exp(logw_new - m_safe[..., None]).sum(-1))
        logw_norm = logw_new - step_ll[..., None]
        h = h_new
        if not contrib:
            logw = logw_norm
            continue
        total = total + step_ll
        dead = dead | ~torch.isfinite(step_ll)
        wn = torch.exp(logw_norm)
        ess = 1.0 / (wn * wn).sum(-1)
        do_res = ess < th
        idx = _systematic_resample(uniforms[..., t].expand(batch), wn, n_eff)
        pick = do_res[..., None]
        beta = torch.where(pick[..., None], torch.take_along_dim(beta, idx[..., None, :], -1),
                           beta)
        S = torch.where(pick[..., None, None],
                        torch.take_along_dim(S, idx[..., None, None, :], -1), S)
        h = torch.where(pick, torch.take_along_dim(h, idx, -1), h)
        logw = torch.where(pick, logw_reset, logw_norm)
    return total, dead


def draw_noise(T: int, n_particles: int, generator=None, dtype=torch.float64,
               device=None):
    """The common-noise pair of a filter run: ``(normals (T−1, n),
    uniforms (T−1,))``, drawn in that order from ``generator`` (on
    ``device``, which must be the generator's)."""
    normals = torch.randn((T - 1, n_particles), generator=generator, dtype=dtype,
                          device=device)
    uniforms = torch.rand((T - 1,), generator=generator, dtype=dtype, device=device)
    return normals, uniforms


def particle_filter_loglik(spec: ModelSpec, params, data, generator=None,
                           n_particles: int = 1000, sv_phi=0.95, sv_sigma=0.2,
                           ess_threshold: float = 0.5, noise=None,
                           with_code: bool = False):
    """Marginal log-likelihood estimate under SV measurement errors.

    ``params`` (..., n_params) constrained, ``data`` (N, T) on the same
    device.  The reference's conventions: skip the first innovation,
    recursion over t = 1..T−1.  With ``sv_sigma`` → 0 the estimate is the
    exact Kalman loglik.

    ``noise``: ``(normals (..., T−1, n_particles), uniforms (..., T−1))``,
    the common-noise mode: the normals drive the log-vol proposal and the
    uniforms the resampling offsets, so two engines fed the same arrays
    follow the same particle trajectories.  Without it the pair is drawn
    from ``generator`` (:func:`draw_noise`; a fresh one seeded 0 when
    ``None``) — a statistical mode, not the JAX package's key-splitting
    stream.  ``with_code=True`` also returns the taxonomy bitmask.
    """
    kp = unpack_kalman(spec, params)
    dtype = params.dtype
    T = data.shape[1]
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=params.device).manual_seed(0)
        noise = draw_noise(T, n_particles, generator, dtype, params.device)
    normals, uniforms = noise
    if normals.shape[-2:] != (T - 1, n_particles) or uniforms.shape[-1] != T - 1:
        raise ValueError(
            f"common-noise shapes must be ({T - 1}, {n_particles}) / ({T - 1},); "
            f"got {tuple(normals.shape)} / {tuple(uniforms.shape)}")
    Z, d = _measurement(spec, kp, dtype)
    state0, S0, chol_Om, fac_ok = factored_init(spec, kp, dtype)
    Omq = chol_Om @ chol_Om.transpose(-1, -2)
    total, dead = _filter(Z, d, kp.Phi, kp.delta, Omq, kp.obs_var, state0.beta, S0,
                          data.to(dtype), normals.to(dtype), uniforms.to(dtype),
                          n_particles, sv_phi, sv_sigma, ess_threshold)
    loss = torch.where(fac_ok & torch.isfinite(total), total,
                       torch.full_like(total, -math.inf))
    if not with_code:
        return loss
    code = tax.params_code(params) | tax.bit(~fac_ok, tax.CHOL_BREAKDOWN) \
        | tax.bit(dead, tax.NONPSD_INNOVATION)
    code = code | tax.bit(~torch.isfinite(loss) & (code == 0), tax.STATE_EXPLODED)
    return loss, code


def draw_loglik_core(spec: ModelSpec, n_particles: int, sv_phi, sv_sigma):
    """``(draws (D, n_params), data (N, T), generator) -> (D,)``: the filter
    over a draw batch on ONE common-noise pair drawn from ``generator``, so
    the sweep is deterministic in the parameters."""
    def batch(draws, data, generator=None):
        if generator is None:
            generator = torch.Generator(device=draws.device).manual_seed(0)
        noise = draw_noise(data.shape[1], n_particles, generator, draws.dtype, draws.device)
        return particle_filter_loglik(spec, draws, data, noise=noise,
                                      n_particles=n_particles, sv_phi=sv_phi,
                                      sv_sigma=sv_sigma)

    return batch
