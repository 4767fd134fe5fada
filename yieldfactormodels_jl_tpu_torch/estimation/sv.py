"""Simulated MLE for the stochastic-volatility measurement-error extension.

Counterpart of ``yieldfactormodels_jl_tpu/estimation/sv.py``.  The particle
filter (``ops/particle.py``) gives a Monte-Carlo estimate of the SV model's
likelihood; estimation is simulated maximum likelihood with common random
numbers: one noise pair is reused at every objective evaluation, so the
estimated surface is a deterministic function of the parameters and the
gradient-free Nelder–Mead simplex descends a fixed surface.

The multi-start search runs in lockstep (``nelder_mead_batched``) and every
batch of (starts × vertices) candidates is one ``ops/fused_pf.pf_loglik_batch``
call on shared noise arrays padded to a multiple of 128 particle slots: on
the card one launch of the fused kernel K5, on the CPU its plain version.
The filter marginalizes a linear state space, so only the constant-
measurement families (DNS/AFNS) are estimated; the others are refused.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..models.params import transform_params
from ..models.specs import ModelSpec
from ..ops.fused_pf import pf_loglik_batch
from ..ops.particle import draw_loglik_core, draw_noise, require_constant_measurement
from ..utils.transformations import from_11_to_R, from_pos_to_R, from_R_to_11, from_R_to_pos
from .neldermead import nelder_mead_batched

_PENALTY = 1e12
_LANE = 128


def _generator(generator, device):
    """The caller's generator, or a fresh one seeded 0 on ``device``."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


def _penalized(ll):
    return torch.where(torch.isfinite(ll), -ll, torch.full_like(ll, _PENALTY))


def _search(spec, raw0, data, noise, n_particles, sv_phi, sv_sigma, max_iters, f_tol, full):
    """Every candidate batch (starts × vertices) is one ``pf_loglik_batch``
    call on the shared noise; ``full`` appends (φ_h, σ_h) to the search
    vector through their bijections."""
    nz, us = noise
    T = data.shape[1]
    P_pad = nz.shape[-1]

    def batch_fun(X):  # (S, K, n) -> (S, K)
        S_, K, n = X.shape
        flat = X.reshape(S_ * K, n)
        if full:
            C = transform_params(spec, flat[:, :-2])
            phis, sigs = from_R_to_11(flat[:, -2]), from_R_to_pos(flat[:, -1])
        else:
            C = transform_params(spec, flat)
            phis, sigs = sv_phi, sv_sigma
        D = S_ * K
        ll = pf_loglik_batch(spec, C, data, nz[None].expand(D, T - 1, P_pad),
                             us[None].expand(D, T - 1), n_particles=n_particles,
                             sv_phi=phis, sv_sigma=sigs)
        return _penalized(ll).reshape(S_, K)

    step = None
    if full:
        # one step vector for every start (they are jittered copies); the SV
        # coordinates' 0.5 is what matters
        step = torch.cat([0.025 + 0.05 * raw0[0, :-2],
                          torch.full((2,), 0.5, dtype=raw0.dtype, device=raw0.device)])
    return nelder_mead_batched(batch_fun, raw0, max_iters=max_iters, f_tol=f_tol, step=step)


def estimate_sv(spec: ModelSpec, data, raw_starts, generator=None, n_particles: int = 200,
                sv_phi: float = 0.95, sv_sigma: float = 0.2, max_iters: int = 200,
                f_tol: float = 1e-6, estimate_sv_params: bool = False, noise=None,
                device=None):
    """Multi-start simulated MLE under SV measurement errors.

    ``raw_starts`` is (S, P) (or (P,)) of UNCONSTRAINED parameters.  Returns
    ``(best_params_constrained, best_ll, lls (S,), iters (S,))`` as numpy,
    with the PF loglik on the search's common noise.

    The noise is one pair ``(normals (T−1, P_pad), uniforms (T−1,))``,
    P_pad = ⌈n_particles/128⌉·128, drawn once from ``generator`` (a fresh
    one seeded 0 on the data's device when ``None``) and shared by every
    evaluation.  ``noise`` hands the search that pair directly (the seam
    through which the JAX package's noise reaches it).

    ``estimate_sv_params=True`` adds (φ_h, σ_h) to the searched vector,
    ``sv_phi``/``sv_sigma`` becoming its starting point through the (−1, 1)
    and positive bijections, and a fifth return value ``(phi_h_hat,
    sigma_h_hat)`` carries the estimates.  Raises ``ValueError`` for a
    family without a constant measurement and ``RuntimeError`` when the
    loglik was non-finite at every point of every search.
    """
    require_constant_measurement(spec)
    data = config.as_tensor(data, device, spec.dtype)
    dev = data.device
    raw_starts = config.as_tensor(raw_starts, dev, spec.dtype)
    if raw_starts.ndim == 1:
        raw_starts = raw_starts[None, :]
    T = data.shape[1]
    if estimate_sv_params:
        sv0 = torch.stack([from_11_to_R(torch.tensor(float(sv_phi), dtype=torch.float64)),
                           from_pos_to_R(torch.tensor(float(sv_sigma),
                                                      dtype=torch.float64))])
        raw_starts = torch.cat([raw_starts, sv0.to(raw_starts).expand(raw_starts.shape[0], 2)],
                               dim=1)
    if noise is None:
        P_pad = -(-n_particles // _LANE) * _LANE
        noise = draw_noise(T, P_pad, _generator(generator, dev), spec.dtype, dev)
    noise = tuple(config.as_tensor(x, dev, spec.dtype) for x in noise)
    xs, fs, iters = _search(spec, raw_starts, data, noise, n_particles, float(sv_phi),
                            float(sv_sigma), int(max_iters), float(f_tol), estimate_sv_params)
    lls = -fs.double().cpu().numpy()
    lls[lls <= -_PENALTY * 0.99] = -np.inf
    if not np.isfinite(lls).any():
        raise RuntimeError(
            f"estimate_sv: PF loglik was non-finite at every point of all "
            f"{lls.shape[0]} simplex searches — starts/model/data are "
            f"structurally incompatible")
    best_j = int(np.argmax(lls))
    iters = iters.cpu().numpy()
    if estimate_sv_params:
        best = transform_params(spec, xs[best_j][:-2])
        sv_hat = (float(from_R_to_11(xs[best_j][-2])), float(from_R_to_pos(xs[best_j][-1])))
        return best.cpu().numpy(), float(lls[best_j]), lls, iters, sv_hat
    best = transform_params(spec, xs[best_j])
    return best.cpu().numpy(), float(lls[best_j]), lls, iters


def pf_draw_logliks(spec: ModelSpec, draws, data, generator=None, n_particles: int = 200,
                    sv_phi: float = 0.95, sv_sigma: float = 0.2, device=None):
    """(D,) common-random-numbers PF logliks for a (D, P) CONSTRAINED draw
    batch: one noise pair from ``generator`` (a fresh one seeded 0 when
    ``None``) reused by every draw, so the sweep is deterministic in the
    parameters."""
    data = config.as_tensor(data, device, spec.dtype)
    draws = config.as_tensor(draws, data.device, spec.dtype)
    if draws.ndim == 1:
        draws = draws[None, :]
    core = draw_loglik_core(spec, int(n_particles), float(sv_phi), float(sv_sigma))
    return core(draws, data, _generator(generator, data.device))
