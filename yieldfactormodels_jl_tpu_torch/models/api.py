"""Family-dispatch façade for the Kalman families.

Counterpart of the Kalman part of ``yieldfactormodels_jl_tpu/models/api.py``.
``get_loss`` and ``predict`` take a spec, *constrained* parameters (one
vector or a (..., n_params) batch) and an (N, T) panel.  Numpy input goes to
``device`` (``None`` means CUDA; see ``config.resolve_device``); tensors stay
where they are.
"""

from __future__ import annotations

import torch

from .. import config
from . import kalman
from .specs import ModelSpec

#: where each engine or family that is not ported yet comes from
_NOT_PORTED = {
    "sqrt": "ROADMAP.md Queue 1 item 7 (remaining sequential engines)",
    "assoc": "ROADMAP.md Queue 1 item 10 (parallel-in-time engines)",
    "slr": "ROADMAP.md Queue 1 item 10 (parallel-in-time engines)",
}
_FAMILIES_ITEM = "ROADMAP.md Queue 1 item 6 (score-driven and static families)"


def _require_kalman(spec: ModelSpec):
    if not spec.is_kalman:
        raise NotImplementedError(
            f"family {spec.family!r} is not ported to PyTorch yet; "
            f"see {_FAMILIES_ITEM}")


def _inputs(spec: ModelSpec, params, data, device):
    dtype = None if isinstance(params, torch.Tensor) else spec.dtype
    params = config.as_tensor(params, device, dtype)
    data = config.as_tensor(data, params.device, params.dtype)
    return params, data


def get_loss(spec: ModelSpec, params, data, start=0, end=None,
             engine: str | None = None, device=None):
    """Gaussian loglik of the Kalman families ("univariate" by default, or
    "joint"); shape ``params.shape[:-1]``."""
    _require_kalman(spec)
    name = engine or config.kalman_engine()
    if name not in config.KALMAN_ENGINES:
        raise ValueError(
            f"unknown kalman engine {name!r}; pick from {config.KALMAN_ENGINES}")
    valid = config.engines_for(spec)
    if name not in valid:
        raise ValueError(
            f"engine {name!r} is not applicable to family {spec.family!r}; "
            f"config.engines_for lists {valid}")
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported to PyTorch yet; see "
            f"{_NOT_PORTED[name]}")
    params, data = _inputs(spec, params, data, device)
    if name == "joint":
        return kalman.get_loss(spec, params, data, start, end)
    from ..ops import univariate_kf

    return univariate_kf.get_loss(spec, params, data, start, end)


def predict(spec: ModelSpec, params, data, device=None):
    """NaN-extended one-step-ahead prediction artifacts (models/kalman.predict)."""
    _require_kalman(spec)
    params, data = _inputs(spec, params, data, device)
    return kalman.predict(spec, params, data)
