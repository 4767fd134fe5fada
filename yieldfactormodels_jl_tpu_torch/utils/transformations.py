"""Scalar parameter bijections, vectorized over a flat parameter tensor.

Counterpart of ``yieldfactormodels_jl_tpu/utils/transformations.py``:

- ``R -> pos``:    exp(x)            (inverse log)
- ``R -> (-1,1)``: 2*sigmoid(x) - 1  (== tanh(x/2); inverse log1p(x)-log1p(-x))
- ``R -> (0,1)``:  sigmoid(x)        (inverse logit)

Each model spec carries an integer *code* per parameter and the whole vector
(any leading batch axes) is transformed branchlessly in one shot.  The
"double-where" idiom keeps autograd NaN-free when e.g. ``exp`` would overflow
on a parameter that belongs to a different code.
"""

from __future__ import annotations

import torch

from .. import config

# Transform codes (stored per-parameter in ModelSpec.transform_codes).
IDENTITY = 0
R_TO_POS = 1  # exp       — variances, EWMA step sizes A
R_TO_11 = 2   # 2σ(x)-1   — Phi diagonals
R_TO_01 = 3   # σ(x)      — persistence B


def from_R_to_pos(x):
    return torch.exp(x)


def from_pos_to_R(x):
    return torch.log(x)


def from_R_to_11(x):
    # tanh(x/2) is 2σ(x) − 1, numerically stable on both tails
    return torch.tanh(x / 2.0)


def from_11_to_R(x):
    return torch.log1p(x) - torch.log1p(-x)


def from_R_to_01(x):
    return torch.sigmoid(x)


def from_01_to_R(x):
    return torch.log(x) - torch.log1p(-x)


def _masked(x, mask, fn, neutral):
    """Apply ``fn`` only where ``mask``; double-where so the un-taken branch
    never sees an input that could poison gradients (inf * 0 = NaN)."""
    safe = torch.where(mask, x, torch.full_like(x, neutral))
    return torch.where(mask, fn(safe), x)


def _codes_on(params, codes):
    return config.device_constant(tuple(int(c) for c in codes), params.device)


def apply_transforms(params, codes):
    """unconstrained -> constrained, elementwise by integer code."""
    codes = _codes_on(params, codes)
    out = params
    out = _masked(out, codes == R_TO_POS, from_R_to_pos, 0.0)
    out = _masked(out, codes == R_TO_11, from_R_to_11, 0.0)
    out = _masked(out, codes == R_TO_01, from_R_to_01, 0.0)
    return out


def apply_untransforms(params, codes):
    """constrained -> unconstrained, elementwise by integer code."""
    codes = _codes_on(params, codes)
    out = params
    out = _masked(out, codes == R_TO_POS, from_pos_to_R, 1.0)
    out = _masked(out, codes == R_TO_11, from_11_to_R, 0.0)
    out = _masked(out, codes == R_TO_01, from_01_to_R, 0.5)
    return out
