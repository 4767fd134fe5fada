"""Flat-parameter unpacking, sharing, transforms and initialization.

Counterpart of ``yieldfactormodels_jl_tpu/models/params.py``.
``unpack_kalman``, ``unpack_msed`` and ``unpack_static`` build the
structured ingredients from a flat *constrained* parameter tensor of shape
(..., n_params); nothing is mutated.  The
initialization helpers work on float64 numpy vectors, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import config
from ..utils.transformations import apply_transforms, apply_untransforms
from .specs import ModelSpec


# ---------------------------------------------------------------------------
# sharing utilities
# ---------------------------------------------------------------------------

def expand_params(unique_params, duplicator):
    """unique (..., u) -> full (..., L) via the 0-based duplicator index."""
    idx = config.device_constant(tuple(int(i) for i in duplicator),
                                 unique_params.device, torch.int64)
    return unique_params[..., idx]


def get_unique_params(full_params, duplicator):
    """full (..., L) -> unique (..., u), taking the first occurrence of each index."""
    dup = np.asarray(duplicator)
    first = [int(np.argmax(dup == i)) for i in range(int(dup.max()) + 1)]
    return full_params[..., torch.as_tensor(first, device=full_params.device)]


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def transform_params(spec: ModelSpec, params):
    """unconstrained -> constrained (any leading batch axes)."""
    return apply_transforms(params, spec.transform_codes)


def untransform_params(spec: ModelSpec, params):
    """constrained -> unconstrained (any leading batch axes)."""
    return apply_untransforms(params, spec.transform_codes)


# ---------------------------------------------------------------------------
# structured view
# ---------------------------------------------------------------------------

class MSEDParams(NamedTuple):
    A: torch.Tensor                # (..., L) expanded step sizes
    B: Optional[torch.Tensor]      # (..., L) expanded persistence, None if random walk
    omega: torch.Tensor            # (..., L)
    delta: torch.Tensor            # (..., M)
    Phi: torch.Tensor              # (..., M, M)
    mu: torch.Tensor               # (..., M) = (I − Φ)δ
    nu: torch.Tensor               # (..., L) = (1 − B) ⊙ ω  (0 if random walk)


class StaticParams(NamedTuple):
    gamma: torch.Tensor            # (..., L)
    delta: torch.Tensor            # (..., M)
    Phi: torch.Tensor              # (..., M, M)
    mu: torch.Tensor               # (..., M) = (I − Φ)δ


class KalmanParams(NamedTuple):
    gamma: Optional[torch.Tensor]  # (..., n_lambdas) λ drivers (DNS/AFNS)
    obs_var: torch.Tensor          # (...,) measurement variance σ²
    Omega_state: torch.Tensor      # (..., Ms, Ms) = CᵀC
    delta: torch.Tensor            # (..., Ms)
    Phi: torch.Tensor              # (..., Ms, Ms)


def unpack_kalman(spec: ModelSpec, params) -> KalmanParams:
    """Ω_obs = σ²I; Ω_state = CᵀC with C upper-triangular, filled column by
    column; Φ filled row-major."""
    Ms = spec.state_dim
    gamma = spec.slice(params, "gamma") if "gamma" in spec.layout else None
    obs_var = spec.slice(params, "obs_var")[..., 0]
    rows, cols = (config.device_constant(tuple(int(i) for i in ix), params.device,
                                         torch.int64) for ix in spec.chol_indices)
    C = params.new_zeros(params.shape[:-1] + (Ms, Ms))
    C[..., rows, cols] = spec.slice(params, "chol")
    Omega_state = C.transpose(-1, -2) @ C
    delta = spec.slice(params, "delta")
    Phi = spec.slice(params, "phi").reshape(params.shape[:-1] + (Ms, Ms))
    return KalmanParams(gamma, obs_var, Omega_state, delta, Phi)


def unpack_msed(spec: ModelSpec, params) -> MSEDParams:
    """β₀ = δ, γ₀ = ω, μ = (I − Φ)δ, ν = (1 − B) ⊙ ω; Φ filled column-major;
    no B for random-walk dynamics."""
    M = spec.M
    A = expand_params(spec.slice(params, "A"), spec.duplicator)
    B = None if spec.random_walk else expand_params(spec.slice(params, "B"),
                                                    spec.duplicator)
    omega = spec.slice(params, "omega")
    delta = spec.slice(params, "delta")
    Phi = spec.slice(params, "phi").reshape(params.shape[:-1] + (M, M))
    Phi = Phi.transpose(-1, -2)  # column-major vec -> matrix
    mu = delta - (Phi @ delta.unsqueeze(-1)).squeeze(-1)
    nu = torch.zeros_like(omega) if B is None else (1.0 - B) * omega
    return MSEDParams(A, B, omega, delta, Phi, mu, nu)


def unpack_static(spec: ModelSpec, params) -> StaticParams:
    """γ, δ, Φ (filled column-major) and μ = (I − Φ)δ of the static
    families and the random walk."""
    M = spec.M
    gamma = spec.slice(params, "gamma")
    delta = spec.slice(params, "delta")
    Phi = spec.slice(params, "phi").reshape(params.shape[:-1] + (M, M))
    Phi = Phi.transpose(-1, -2)  # column-major vec -> matrix
    mu = delta - (Phi @ delta.unsqueeze(-1)).squeeze(-1)
    return StaticParams(gamma, delta, Phi, mu)


def get_new_initial_params(spec: ModelSpec, params, trial: int,
                           rng: np.random.Generator | None = None):
    """Trial-indexed initial proposal (``trial`` is 1-based, the grid walk
    depends on it), ``params`` (P,) float64:

    - score-driven: the ``trial``-th point of the A×B guess grid, or None
      once the grid is exhausted;
    - static neural: a structured randn/10 draw of the 18 net weights (the
      biases 0), the (δ, Φ) tail kept;
    - static λ (and the random walk): the head jittered by U(−0.05, 0.05);
    - Kalman: a standard normal redraw.

    The draws come from ``rng``, by default ``np.random.default_rng(trial)``,
    as in the JAX package."""
    if trial < 1:
        raise ValueError(f"trial is 1-based; got {trial}")
    params = np.asarray(params, dtype=np.float64).copy()
    if rng is None:
        rng = np.random.default_rng(trial)
    if spec.family == "static_neural":
        params[0:3] = rng.standard_normal(3) / 10
        params[3:6] = 0.0
        params[6:9] = rng.standard_normal(3) / 10
        params[9:12] = rng.standard_normal(3) / 10
        params[12:15] = 0.0
        params[15:18] = rng.standard_normal(3) / 10
        return params
    if spec.is_static:
        head = params.shape[0] - spec.M * (spec.M + 1)
        params[:head] += rng.uniform(size=head) * 0.1 - 0.05
        return params
    if not spec.is_msed:
        return rng.standard_normal(params.shape[0])
    num_A = len(spec.A_guesses)
    num_B = 0 if spec.random_walk else len(spec.B_guesses)
    u = spec.n_unique
    has_B = num_B > 0
    if u == 1:
        total = num_A * num_B if has_B else num_A
    else:
        total = (num_A ** 2) * (num_B ** 2) if has_B else num_A ** 2
    if trial > total:
        return None
    t = trial - 1
    if u == 1:
        if has_B:
            params[0] = spec.A_guesses[t // num_B]
            params[1] = spec.B_guesses[t % num_B]
        else:
            params[0] = spec.A_guesses[t]
        return params
    half = u // 2
    if has_B:
        a1 = t // (num_A * num_B ** 2)
        rem = t % (num_A * num_B ** 2)
        a2 = rem // (num_B ** 2)
        rem = rem % (num_B ** 2)
        b1 = rem // num_B
        b2 = rem % num_B
        params[0:half] = spec.A_guesses[a1]
        params[half:u] = spec.A_guesses[a2]
        params[u:u + half] = spec.B_guesses[b1]
        params[u + half:2 * u] = spec.B_guesses[b2]
    else:
        params[0:half] = spec.A_guesses[t // num_A]
        params[half:u] = spec.A_guesses[t % num_A]
    return params


def initialize_with_static_params(spec: ModelSpec, params, static_params):
    """Warm start from a simpler model's fitted parameters: a score-driven
    spec takes the [ω; δ; Φ] tail, TVλ the index map from the "1C" fit,
    every other family keeps ``params``."""
    params = np.asarray(params, dtype=np.float64).copy()
    sp = np.asarray(static_params, dtype=np.float64).reshape(-1)
    if spec.is_msed:
        params[len(params) - len(sp):] = sp
    elif spec.family == "kalman_tvl":
        params[0:1] = sp[1:2]
        params[1:7] = sp[-18:-12]
        params[11:14] = sp[-12:-9]
        params[15:18] = sp[-9:-6]
        params[19:22] = sp[-6:-3]
        params[23:26] = sp[-3:]
    return params
