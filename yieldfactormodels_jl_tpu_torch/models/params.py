"""Flat-parameter unpacking, sharing and transforms for the Kalman families.

Counterpart of the Kalman part of ``yieldfactormodels_jl_tpu/models/params.py``.
``unpack_kalman`` builds the structured state-space ingredients from a flat
*constrained* parameter tensor of shape (..., n_params); nothing is mutated.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.transformations import apply_transforms, apply_untransforms
from .specs import ModelSpec


# ---------------------------------------------------------------------------
# sharing utilities
# ---------------------------------------------------------------------------

def expand_params(unique_params, duplicator):
    """unique (..., u) -> full (..., L) via the 0-based duplicator index."""
    idx = torch.as_tensor(duplicator, dtype=torch.int64,
                          device=unique_params.device)
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
    rows, cols = spec.chol_indices
    C = params.new_zeros(params.shape[:-1] + (Ms, Ms))
    C[..., torch.as_tensor(rows), torch.as_tensor(cols)] = spec.slice(params, "chol")
    Omega_state = C.transpose(-1, -2) @ C
    delta = spec.slice(params, "delta")
    Phi = spec.slice(params, "phi").reshape(params.shape[:-1] + (Ms, Ms))
    return KalmanParams(gamma, obs_var, Omega_state, delta, Phi)
