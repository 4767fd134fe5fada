"""Failure taxonomy: an int32 bitmask beside the −Inf/NaN sentinels.

Counterpart of ``yieldfactormodels_jl_tpu/robustness/taxonomy.py``: the same
bits and names, so a code from either package decodes the same way.  The
filters that report one (the ``get_loss_coded`` of ``ops/univariate_kf``,
``ops/sqrt_kf``, ``models/kalman``, ``models/score_driven`` and
``models/static_model``, and ``ops/particle.particle_filter_loglik(...,
with_code=True)``) OR bits into an int32 tensor beside their loss, with a
leading draw axis where the loss has one; nothing raises, and only driver
code decodes a mask into names (:func:`decode`, :func:`describe`,
:func:`diagnose`).
"""

from __future__ import annotations

import torch

#: dtype every code rides as
CODE_DTYPE = torch.int32

OK = 0
#: a scalar innovation variance f = zᵀPz + σ² came out ≤ 0 (indefinite P or
#: invalid σ²)
NONPSD_INNOVATION = 1
#: a Cholesky/QR factorization produced non-finite entries (Ω_state, P₀, or
#: the joint form's innovation factor)
CHOL_BREAKDOWN = 2
#: a state/innovation/likelihood quantity went non-finite mid-recursion
STATE_EXPLODED = 4
#: non-finite entries in the (constrained) parameter vector itself
TRANSFORM_OVERFLOW = 8
#: the estimation window contributed zero observations
MISSING_ALL_OBS = 16
#: a covariance watched by the serving health monitor lost positive
#: semi-definiteness
NONPSD_COV = 32
#: a serving state carried non-finite entries
NAN_STATE = 64
#: the second-order polish saw a non-PSD or non-finite model Hessian
NONPSD_HESSIAN = 128

#: bit → name, in bit order (the decode vocabulary; keep sorted by value)
NAMES = (
    (NONPSD_INNOVATION, "NONPSD_INNOVATION"),
    (CHOL_BREAKDOWN, "CHOL_BREAKDOWN"),
    (STATE_EXPLODED, "STATE_EXPLODED"),
    (TRANSFORM_OVERFLOW, "TRANSFORM_OVERFLOW"),
    (MISSING_ALL_OBS, "MISSING_ALL_OBS"),
    (NONPSD_COV, "NONPSD_COV"),
    (NAN_STATE, "NAN_STATE"),
    (NONPSD_HESSIAN, "NONPSD_HESSIAN"),
)


def bit(cond, flag: int) -> torch.Tensor:
    """``cond ? flag : 0`` as int32, elementwise over a boolean tensor."""
    return torch.as_tensor(cond).to(CODE_DTYPE) * flag


def zero_code(shape=(), device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=CODE_DTYPE, device=device)


def combine(codes, dim: int = -1) -> torch.Tensor:
    """Bitwise-OR reduce per-step codes over ``dim``."""
    codes = torch.as_tensor(codes).to(CODE_DTYPE)
    out = zero_code(codes.shape[:dim % codes.ndim] + codes.shape[dim % codes.ndim + 1:],
                    codes.device)
    for flag, _ in NAMES:
        out = out | bit(((codes & flag) != 0).any(dim), flag)
    return out


def params_code(params) -> torch.Tensor:
    """TRANSFORM_OVERFLOW where a constrained parameter vector (last axis)
    is not finite."""
    return bit(~torch.isfinite(params).all(-1), TRANSFORM_OVERFLOW)


def decode(code) -> tuple:
    """Bitmask → tuple of names, e.g. ``decode(3) ==
    ('NONPSD_INNOVATION', 'CHOL_BREAKDOWN')``.  ``decode(0) == ()``."""
    c = int(code)
    return tuple(name for flag, name in NAMES if c & flag)


def describe(code) -> str:
    """Log form: ``'NONPSD_INNOVATION|CHOL_BREAKDOWN'`` or ``'OK'``."""
    names = decode(code)
    return "|".join(names) if names else "OK"


def coded_loss_fn(spec):
    """The family's coded loss: the univariate engine's for a Kalman spec,
    the score-driven or static filter's otherwise."""
    from ..models import score_driven, static_model
    from ..ops import univariate_kf

    if spec.is_kalman:
        return univariate_kf.get_loss_coded
    if spec.is_msed:
        return score_driven.get_loss_coded
    return static_model.get_loss_coded


def diagnose(spec, params, data, start=0, end=None, device=None):
    """One coded evaluation at CONSTRAINED ``params`` — "why did this start
    die?".  Numpy input goes to ``device`` (``None`` means CUDA; tensors
    stay where they are), in the spec's float type.  Returns ``(loglik,
    code)`` as Python scalars."""
    from .. import config

    params = config.as_tensor(params, device, spec.dtype)
    data = config.as_tensor(data, params.device, spec.dtype)
    if end is None:
        end = int(data.shape[1])
    with torch.no_grad():
        ll, code = coded_loss_fn(spec)(spec, params, data, start, end)
    return float(ll), int(code)
