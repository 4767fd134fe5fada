"""Carry flat parameter arrays from the JAX package into the port.

The flat parameter layout is the same in both packages (``models/specs.py``),
so a JAX parameter vector or batch, as a numpy array of shape
(..., n_params), becomes the port's tensor unchanged.
"""

from __future__ import annotations

import numpy as np

from . import config
from .models.specs import ModelSpec


def params_from_jax(spec: ModelSpec, params_np, device=None, dtype=None):
    """(..., n_params) numpy parameters -> tensor on ``device`` (``None``
    means CUDA) in ``dtype`` (default: the spec's)."""
    arr = np.asarray(params_np)
    if arr.ndim == 0 or arr.shape[-1] != spec.n_params:
        raise ValueError(
            f"{spec.model_code} takes {spec.n_params} parameters per draw; "
            f"got an array of shape {arr.shape}")
    return config.as_tensor(arr, device, dtype or spec.dtype)
