"""Family-dispatch façade over the Kalman, score-driven and static filters.

Counterpart of ``yieldfactormodels_jl_tpu/models/api.py``.  ``get_loss``,
``get_loss_array`` and ``predict`` take a spec, *constrained* parameters
(one vector or a (..., n_params) batch) and an (N, T) panel.  Numpy input
goes to ``device`` (``None`` means CUDA; see ``config.resolve_device``);
tensors stay where they are.
"""

from __future__ import annotations

import torch

from .. import config
from . import kalman, score_driven, static_model
from .specs import ModelSpec

#: where each engine that is not ported yet comes from
_NOT_PORTED = {
    "assoc": "ROADMAP.md Queue 1 item 10 (parallel-in-time engines)",
    "slr": "ROADMAP.md Queue 1 item 10 (parallel-in-time engines)",
    "score_tree": "ROADMAP.md Queue 1 item 10 (parallel-in-time engines)",
}


def _engine(spec: ModelSpec):
    if spec.is_kalman:
        return kalman
    if spec.is_msed:
        return score_driven
    return static_model


def _inputs(spec: ModelSpec, params, data, device):
    dtype = None if isinstance(params, torch.Tensor) else spec.dtype
    params = config.as_tensor(params, device, dtype)
    data = config.as_tensor(data, params.device, params.dtype)
    return params, data


def _check_engine(spec: ModelSpec, name: str):
    valid = config.engines_for(spec)
    if name not in valid:
        raise ValueError(
            f"engine {name!r} is not applicable to family {spec.family!r}; "
            f"config.engines_for lists {valid}")
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported to PyTorch yet; see "
            f"{_NOT_PORTED[name]}")


def get_loss(spec: ModelSpec, params, data, start=0, end=None, K: int = 1,
             engine: str | None = None, device=None):
    """The filter loss, shape ``params.shape[:-1]``: the Gaussian loglik of
    the Kalman families ("univariate" by default, "joint" or "sqrt"), the
    one-step-ahead −MSE of the score-driven families ("scan"; ``K`` filter
    passes) and of the static families, which have no engine to choose."""
    if spec.is_static:
        if engine is not None:
            raise ValueError(
                f"engine {engine!r} is not applicable to family "
                f"{spec.family!r}; config.engines_for lists "
                f"{config.engines_for(spec)}")
        params, data = _inputs(spec, params, data, device)
        return static_model.get_loss(spec, params, data, start, end, K)
    if spec.is_msed:
        name = engine or "scan"
        if name not in config.engines_for(spec):
            _check_engine(spec, name)  # raises: not applicable
        if name == "score_tree" and K != 1:
            raise ValueError(
                "engine 'score_tree' supports K=1 only; use the sequential "
                "'scan' engine for K-replay losses")
        _check_engine(spec, name)
        params, data = _inputs(spec, params, data, device)
        return score_driven.get_loss(spec, params, data, start, end, K)
    name = engine or config.kalman_engine()
    if name not in config.KALMAN_ENGINES:
        raise ValueError(
            f"unknown kalman engine {name!r}; pick from {config.KALMAN_ENGINES}")
    _check_engine(spec, name)
    params, data = _inputs(spec, params, data, device)
    if name == "joint":
        return kalman.get_loss(spec, params, data, start, end)
    if name == "sqrt":
        from ..ops import sqrt_kf

        return sqrt_kf.get_loss(spec, params, data, start, end)
    from ..ops import univariate_kf

    return univariate_kf.get_loss(spec, params, data, start, end)


def get_loss_array(spec: ModelSpec, params, data, start=0, end=None, K: int = 1,
                   device=None):
    """Per-step one-step-ahead −MSE contributions (..., T−1) of the family's
    filter (``kalman``, ``score_driven`` or ``static_model``)."""
    params, data = _inputs(spec, params, data, device)
    return _engine(spec).get_loss_array(spec, params, data, start, end, K)


def predict(spec: ModelSpec, params, data, device=None):
    """NaN-extended one-step-ahead prediction artifacts of the family's
    filter (``kalman``, ``score_driven`` or ``static_model``)."""
    params, data = _inputs(spec, params, data, device)
    return _engine(spec).predict(spec, params, data)


def get_param_groups(spec: ModelSpec, param_groups=None):
    """A caller's grouping if its length matches the parameter count, else
    the family default."""
    if param_groups is not None and len(param_groups) == spec.n_params:
        return tuple(param_groups)
    return spec.default_param_groups()


def get_static_model_type(spec: ModelSpec) -> str:
    """The code of the static model a spec warm-starts from ("" for the
    random walk)."""
    if spec.family == "kalman_dns":
        return "DNS"
    if spec.family == "kalman_tvl":
        return "1C"
    if spec.family in ("msed_lambda", "static_lambda"):
        return "NS"
    if spec.family in ("msed_neural", "static_neural"):
        return "NNS" if spec.transform_bool else "NNS-Anchored"
    return ""
