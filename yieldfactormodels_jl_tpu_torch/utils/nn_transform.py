"""Shape transforms that pin learned loading curves to Nelson–Siegel form.

Counterpart of ``yieldfactormodels_jl_tpu/utils/nn_transform.py``, over a
trailing maturity axis (any leading draw axes):

- ``transform_net_1`` (slope-type curve): 1 at the short end, 0 at the last
  two maturities, squared for positivity.  The "transformed" variant first
  rescales by the first/last-but-one raw gap, (raw − raw_{n−2}) /
  (raw_0 − raw_{n−2} + ε); the "anchored" variant just squares.
- ``transform_net_2`` (curvature/hump): 0 at both ends, squared, and
  normalised.  The transformed variant first removes the endpoint line
  (evaluated as slope·x − intercept, the reference's sign quirk) and
  divides by √Σr2⁴/scale + ε; the anchored variant multiplies by
  scale/√Σr2⁴ + ε.  ε sits in the denominator in one and in the inverse in
  the other, as in the reference.

Pinned entries are ``torch.where`` selects, so autograd through them is the
JAX package's.
"""

from __future__ import annotations

import torch

_EPS = 1e-7
_SCALE = 0.9610


def transform_net_1(raw, maturities, transformed: bool):
    """Slope-type loading curve. ``raw``: (..., N) net output → (..., N)."""
    n = raw.shape[-1]
    idx = torch.arange(n, device=raw.device)
    interior = (idx >= 1) & (idx <= n - 3)
    if transformed:
        raw_first = raw[..., 0:1]
        raw_last = raw[..., n - 2:n - 1]
        t = (raw - raw_last) / (raw_first - raw_last + _EPS)
        sq = t * t
    else:
        sq = raw * raw
    out = torch.where(interior, sq, raw)
    one, zero = torch.ones_like(out), torch.zeros_like(out)
    out = torch.where(idx == 0, one, out)
    return torch.where(idx >= n - 2, zero, out)


def transform_net_2(raw, maturities, transformed: bool, scale: float = _SCALE):
    """Curvature-type loading curve. ``raw``: (..., N), ``maturities``: (N,)."""
    n = raw.shape[-1]
    idx = torch.arange(n, device=raw.device)
    interior = (idx >= 1) & (idx <= n - 2)
    zero = torch.zeros((), dtype=raw.dtype, device=raw.device)
    if transformed:
        x1 = maturities[0]
        xN = maturities[n - 1]
        raw1 = raw[..., 0:1]
        rawN = raw[..., n - 1:n]
        slope = (rawN - raw1) / (xN - x1)
        intercept = raw1 - slope * x1
        r = raw - (slope * maturities - intercept)
        r2 = torch.where(interior, r * r, zero)
        sum_sq = (r2 * r2).sum(-1, keepdim=True)
        denom = torch.sqrt(sum_sq) / scale + _EPS
        return r2 / denom
    r2 = torch.where(interior, raw * raw, zero)
    sum_sq = (r2 * r2).sum(-1, keepdim=True)
    denom_inv = scale / torch.sqrt(sum_sq) + _EPS
    return r2 * denom_inv
