"""Shared loss-window helpers for the prediction-error engines.

Counterpart of ``yieldfactormodels_jl_tpu/models/common.py``.  Masks are
``torch.where`` selects, never multiplications: a NaN target outside the
window must poison nothing.
"""

from __future__ import annotations

import torch


def window_contributions(preds, data, start, end):
    """−‖y_{t+1} − ŷ_{t+1|t}‖² for the contributing steps t = start .. end−2
    (0-based), 0 elsewhere.

    ``preds`` (..., T, N) scan output; the raw ``data`` (N, T) is the target,
    so a NaN inside the window poisons the sum into the −Inf sentinel.
    Returns (..., T−1)."""
    T = data.shape[1]
    t_idx = torch.arange(T - 1, device=data.device)
    contrib = (t_idx >= start) & (t_idx <= end - 2)
    v = data[:, 1:].T - preds[..., :-1, :]
    return torch.where(contrib, -(v * v).sum(-1), torch.zeros((), dtype=v.dtype,
                                                             device=v.device))


def partial_nan_poison(y, obs):
    """1 normally, NaN when an observed column ``y`` (N,) is partially NaN:
    a column counts as observed by its first entry alone, and a NaN at any
    other maturity then flows through OLS and poisons β (and the loss)."""
    bad = obs & ~torch.isfinite(y).all()
    one = torch.ones((), dtype=y.dtype, device=y.device)
    return torch.where(bad, torch.full_like(one, float("nan")), one)
