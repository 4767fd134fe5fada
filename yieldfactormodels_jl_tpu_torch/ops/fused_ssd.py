"""Fused batched score-driven (MSED) loss — a hand-written CUDA kernel (K4).

Counterpart of ``yieldfactormodels_jl_tpu/ops/pallas_ssd.py``.  The kernel,
``csrc/fused_ssd.cu``, replaces the Pallas TPU kernel ``pallas_ssd._kernel``:
the whole T-step score-driven pass of one parameter draw on two warps, lane
i holding maturity i — a chain warp for the γ recursion, with the inner
score the hand-derived reverse sweep through the loading build (MLP chain
rule and the shape-transform adjoints, or the analytic dz/dλ of the λ
family), 3×3 Cholesky OLS with the plain-then-ridge select, EWMA or plain γ
steps and AR(1) or random-walk γ dynamics, and a helper warp for the
re-OLS, β and the −‖y_{t+1} − ŷ‖² window sum.  Unpacking stays a batched
tensor op outside the kernel, as in the JAX package.

``batched_loss(spec, params_batch, data, start, end)`` takes a (B, n_params)
batch of *constrained* draws and an (N, T) panel and returns (B,) losses in
the spec's float type.  On CUDA tensors it launches the kernel (or raises);
on CPU tensors it runs the plain version, :func:`batched_loss_reference`,
which repeats the kernel's arithmetic step by step in PyTorch over the draw
axis — the sweep of the docstrings below, not autograd.  The independent
reference both are held against is ``models/score_driven.get_loss``.

The hand-derived sweep (β̄ fixed, v = y − Zβ̄, ō = 2β̄ₖv the cotangent of
loading column k):

- MLP: pre_nj = ō_n·W2_j·(1 − h_nj²); ∂W1_j = Σ pre·τ, ∂b1_j = Σ pre,
  ∂W2_j = Σ ō·h.
- slope transform (transformed): t_i = (raw_i − raw_{n−2})·c,
  c = 1/(raw_0 − raw_{n−2} + ε); r̄_i = 2ō_i t_i c on the interior,
  r̄_0 = −Σ2ō t² c, r̄_{n−2} = Σ2ō t² c − Σ2ō t c.  Anchored: r̄_i = 2ō_i raw_i.
- curvature transform (transformed): r_i = raw_i − (s x_i − b), r2 = r² on
  the interior, out = r2/(√S/scale + ε) with S = Σ r2²; r2̄_i = ō_i/d −
  (Σō r2)·r2_i/(√S·scale·d²), r̄_i = 2 r_i r2̄_i; with s̄ = −(Σr̄x + Σr̄·x₁),
  r̄_0 += Σr̄ − s̄/(x_N − x₁), r̄_{n−1} += s̄/(x_N − x₁).  Anchored:
  out = r2·(scale/√S + ε), r2̄_i = ō_i·d⁻¹ − (Σō r2)·scale·r2_i/S^{3/2}.
- λ family: λ = 1e-2 + e^γ, dz₂/dλ = (z τ λτ − (1 − z)τ)/(λτ)²,
  dz₃/dλ = dz₂/dλ + τz, score = Σ2v(β̄₁dz₂ + β̄₂dz₃)·(λ − 1e-2).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import config
from ..models.params import unpack_msed
from ..models.specs import ModelSpec
from ._build import load

_FAMILIES = ("msed_lambda", "msed_neural")
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
_EPS = 1e-7        # nn_transform._EPS
_SCALE = 0.9610    # nn_transform._SCALE
_RIDGE = 1e-3      # linalg.RIDGE
_LAMBDA_FLOOR = 1e-2


def _check(spec: ModelSpec):
    """The JAX entry point's two refusals."""
    if spec.family not in _FAMILIES:
        raise ValueError(f"fused ssd kernel supports the MSED families, "
                         f"not {spec.family!r}")
    if not spec.detach_inner_beta:
        # the hand-derived score treats β̄ as a constant: the exact-AD
        # variant differentiates through β(γ) and is another recursion
        raise ValueError("fused ssd kernel implements the detached-β̄ score "
                         "(reference semantics); use the scan engine for "
                         "detach_inner_beta=False specs")


class _Draws(NamedTuple):
    """Per-draw inputs of the kernel, each (B, D)."""
    A: torch.Tensor
    B: torch.Tensor       # zeros for random-walk dynamics
    nu: torch.Tensor
    omega: torch.Tensor
    delta: torch.Tensor
    mu: torch.Tensor
    Phi: torch.Tensor     # (B, 9): Φ[m, k] at 3m + k


def _draws(spec: ModelSpec, params) -> _Draws:
    mp = unpack_msed(spec, params)
    Bv = mp.B if mp.B is not None else torch.zeros_like(mp.omega)
    return _Draws(mp.A, Bv, mp.nu, mp.omega, mp.delta, mp.mu,
                  mp.Phi.reshape(params.shape[0], 9))


class _Geometry(NamedTuple):
    """Host constants of the maturity grid, computed in float64 and rounded
    once to the working type where they are used (as the Pallas kernel's
    Python constants are)."""
    mats: tuple
    x1: float
    dx: float          # x_N − x₁
    inv_dx: float      # 1/(x_N − x₁)


def _geometry(spec: ModelSpec) -> _Geometry:
    m = tuple(float(x) for x in spec.maturities)
    dx = m[-1] - m[0]
    return _Geometry(m, m[0], dx, 1.0 / dx)


# ---------------------------------------------------------------------------
# the plain version: the kernel's arithmetic over the draw axis
# ---------------------------------------------------------------------------

def _mlp(p9, tau):
    """raw (B, N) and the three tanh activations of the 1→3→1 net."""
    hs = [torch.tanh(p9[:, j:j + 1] * tau + p9[:, 3 + j:4 + j]) for j in range(3)]
    raw = p9[:, 6:7] * hs[0] + p9[:, 7:8] * hs[1] + p9[:, 8:9] * hs[2]
    return raw, hs


def _mlp_rev(p9, tau, hs, obar):
    """Cotangents (B, 9) of the net's parameters from per-maturity ō."""
    g = [None] * 9
    for j in range(3):
        h = hs[j]
        pre = obar * p9[:, 6 + j:7 + j] * (1.0 - h * h)
        g[j] = (pre * tau).sum(1)
        g[3 + j] = pre.sum(1)
        g[6 + j] = (obar * h).sum(1)
    return torch.stack(g, 1)


def _interior(n, lo, hi, device):
    idx = torch.arange(n, device=device)
    return idx, (idx >= lo) & (idx <= hi)


def _t1_fwd(raw, transformed):
    n = raw.shape[1]
    idx, inner = _interior(n, 1, n - 3, raw.device)
    if transformed:
        rl = raw[:, n - 2:n - 1]
        c = 1.0 / (raw[:, 0:1] - rl + _EPS)
        t = (raw - rl) * c
        sq, aux = t * t, (t, c)
    else:
        sq, aux = raw * raw, None
    out = torch.where(inner, sq, torch.zeros_like(sq))
    return torch.where(idx == 0, torch.ones_like(sq), out), aux


def _t1_rev(raw, aux, obar, transformed):
    n = raw.shape[1]
    idx, inner = _interior(n, 1, n - 3, raw.device)
    zero = torch.zeros_like(obar)
    if not transformed:
        return torch.where(inner, obar * 2.0 * raw, zero)
    t, c = aux
    rb = torch.where(inner, obar * 2.0 * t * c, zero)
    s_tc = rb.sum(1, keepdim=True)
    s_t2c = torch.where(inner, obar * 2.0 * t * t * c, zero).sum(1, keepdim=True)
    rb = torch.where(idx == 0, -s_t2c, rb)
    return torch.where(idx == n - 2, s_t2c - s_tc, rb)


def _t2_fwd(raw, tau, geo: _Geometry, transformed):
    n = raw.shape[1]
    _, inner = _interior(n, 1, n - 2, raw.device)
    if transformed:
        slope = (raw[:, n - 1:n] - raw[:, 0:1]) / geo.dx
        intercept = raw[:, 0:1] - slope * geo.x1
        r = raw - (slope * tau - intercept)
    else:
        r = raw
    r2 = torch.where(inner, r * r, torch.zeros_like(r))
    sum_sq = (r2 * r2).sum(1, keepdim=True)
    if transformed:
        denom = torch.sqrt(sum_sq) / _SCALE + _EPS
        return r2 / denom, (r, r2, sum_sq, denom)
    denom_inv = _SCALE / torch.sqrt(sum_sq) + _EPS
    return r2 * denom_inv, (r, r2, sum_sq, denom_inv)


def _t2_rev(aux, obar, tau, geo: _Geometry, transformed):
    r, r2, sum_sq, d = aux
    n = r.shape[1]
    idx, inner = _interior(n, 1, n - 2, r.device)
    zero = torch.zeros_like(obar)
    dot = (obar * r2).sum(1, keepdim=True)
    if transformed:
        coef = dot / (torch.sqrt(sum_sq) * _SCALE * d * d)
        rb = torch.where(inner, 2.0 * r * (obar / d - coef * r2), zero)
        s_rbar = rb.sum(1, keepdim=True)
        s_rbarx = (rb * tau).sum(1, keepdim=True)
        slope_bar = -(s_rbarx + s_rbar * geo.x1)
        rb = torch.where(idx == 0, s_rbar - slope_bar * geo.inv_dx, rb)
        return torch.where(idx == n - 1, slope_bar * geo.inv_dx, rb)
    coef = dot * _SCALE / (sum_sq * torch.sqrt(sum_sq))
    return torch.where(inner, 2.0 * r * (obar * d - coef * r2), zero)


def _build(spec, g, tau, geo):
    """Loading columns z₂, z₃ (B, N) of γ ``g`` (B, L), and what the sweep
    needs of the forward pass."""
    if spec.family == "msed_neural":
        raw2, h2 = _mlp(g[:, 0:9], tau)
        raw3, h3 = _mlp(g[:, 9:18], tau)
        z2, aux1 = _t1_fwd(raw2, spec.transform_bool)
        z3, aux2 = _t2_fwd(raw3, tau, geo, spec.transform_bool)
        return z2, z3, (raw2, h2, aux1, h3, aux2)
    lam = _LAMBDA_FLOOR + torch.exp(g[:, 0:1])
    zt = torch.exp(-lam * tau)
    z2 = (1.0 - zt) / (lam * tau)
    return z2, z2 - zt, (lam, zt)


def _score(spec, g, tau, geo, z2, z3, aux, beta, ysafe):
    """The hand-derived ∇_γ −‖y − Zβ̄‖² (B, L)."""
    v = ysafe - (beta[:, 0:1] + beta[:, 1:2] * z2 + beta[:, 2:3] * z3)
    if spec.family == "msed_neural":
        raw2, h2, aux1, h3, aux2 = aux
        ob2 = 2.0 * beta[:, 1:2] * v
        ob3 = 2.0 * beta[:, 2:3] * v
        rb2 = _t1_rev(raw2, aux1, ob2, spec.transform_bool)
        rb3 = _t2_rev(aux2, ob3, tau, geo, spec.transform_bool)
        return torch.cat([_mlp_rev(g[:, 0:9], tau, h2, rb2),
                          _mlp_rev(g[:, 9:18], tau, h3, rb3)], 1)
    lam, zt = aux
    lt = lam * tau
    dz2 = (zt * tau * lt - (1.0 - zt) * tau) / (lt * lt)
    dz3 = dz2 + tau * zt
    acc = (2.0 * v * (beta[:, 1:2] * dz2 + beta[:, 2:3] * dz3)).sum(1, keepdim=True)
    return acc * (lam - _LAMBDA_FLOOR)


def _chol3(g11, g21, g22, g31, g32, g33):
    l11 = torch.sqrt(g11)
    l21 = g21 / l11
    l31 = g31 / l11
    l22 = torch.sqrt(g22 - l21 * l21)
    l32 = (g32 - l31 * l21) / l22
    l33 = torch.sqrt(g33 - l31 * l31 - l32 * l32)
    return l11, l21, l22, l31, l32, l33


def _ols(z2, z3, ysafe, sy, n):
    """β (B, 3) from the 3×3 normal equations, the plain Cholesky factor
    where all six pivots are finite, else the +1e-3 ridge one."""
    g21, g31 = z2.sum(1), z3.sum(1)
    g22, g32, g33 = (z2 * z2).sum(1), (z3 * z2).sum(1), (z3 * z3).sum(1)
    b2, b3 = (z2 * ysafe).sum(1), (z3 * ysafe).sum(1)
    g11 = torch.full_like(g22, float(n))
    plain = _chol3(g11, g21, g22, g31, g32, g33)
    ok = torch.stack([torch.isfinite(x) for x in plain]).all(0)
    ridge = _chol3(g11 + _RIDGE, g21, g22 + _RIDGE, g31, g32, g33 + _RIDGE)
    l11, l21, l22, l31, l32, l33 = (torch.where(ok, p, q) for p, q in zip(plain, ridge))
    b1 = sy.expand_as(g22)
    y1 = b1 / l11
    y2 = (b2 - l21 * y1) / l22
    y3 = (b3 - l31 * y1 - l32 * y2) / l33
    x3 = y3 / l33
    x2 = (y2 - l32 * x3) / l22
    x1 = (y1 - l21 * x2 - l31 * x3) / l11
    return torch.stack([x1, x2, x3], 1)


def batched_loss_reference(spec: ModelSpec, params_batch, data, start=0, end=None):
    """The plain PyTorch version of the kernel on the tensors' own device and
    dtype: (B, n_params) constrained draws, (N, T) panel → (B,) losses."""
    batched_loss_reference.calls += 1
    _check(spec)
    T = data.shape[1]
    if end is None:
        end = T
    d = _draws(spec, params_batch)
    dtype, dev = params_batch.dtype, params_batch.device
    geo = _geometry(spec)
    tau = torch.tensor(geo.mats, dtype=dtype, device=dev)
    n = spec.N
    has_B = not spec.random_walk
    y_all = data.T  # (T, N)
    ysafe_all = torch.where(torch.isfinite(y_all), y_all, torch.zeros_like(y_all))
    # the panel is shared by every draw: which steps observe is known up front
    fin0 = torch.isfinite(y_all[:, 0]).tolist()
    allfin = torch.isfinite(y_all).all(1).tolist()
    ff = torch.full((), spec.forget_factor, dtype=dtype, device=dev)
    eps = torch.finfo(dtype).eps
    nan = torch.full((), float("nan"), dtype=dtype, device=dev)

    gamma, beta = d.omega, d.delta
    ewma = torch.zeros_like(gamma)
    count = torch.zeros((), dtype=dtype, device=dev)
    loss = torch.zeros(params_batch.shape[0], dtype=dtype, device=dev)
    for t in range(T - 1):
        obs = start <= t < end and fin0[t]
        ysafe = ysafe_all[t]
        sy = ysafe.sum()
        z2, z3, aux = _build(spec, gamma, tau, geo)
        if obs:
            b_ols = _ols(z2, z3, ysafe, sy, n)
            grad = _score(spec, gamma, tau, geo, z2, z3, aux, b_ols, ysafe)
            if spec.scale_grad:
                count = count + 1.0
                denom = 1.0 - torch.pow(ff, count)
                ewma = ff * ewma + (1.0 - ff) * grad * grad
                gamma = gamma + grad / (torch.sqrt(ewma / denom) + eps) * d.A
            else:
                gamma = gamma + grad * d.A
            z2u, z3u, _ = _build(spec, gamma, tau, geo)
            beta = _ols(z2u, z3u, ysafe, sy, n)
            if not allfin[t]:
                beta = beta * nan
        else:
            z2u, z3u = z2, z3  # γ unchanged: the rebuild equals the carry
        if has_B:
            gamma = d.nu + d.B * gamma
            z2n, z3n, _ = _build(spec, gamma, tau, geo)
        else:
            z2n, z3n = z2u, z3u
        beta = d.mu + (d.Phi[:, 0::3] * beta[:, 0:1] + d.Phi[:, 1::3] * beta[:, 1:2]
                       + d.Phi[:, 2::3] * beta[:, 2:3])
        if start <= t <= end - 2:
            pv = y_all[t + 1] - (beta[:, 0:1] + beta[:, 1:2] * z2n + beta[:, 2:3] * z3n)
            loss = loss - (pv * pv).sum(1)
    loss = loss / n / (end - start)
    return torch.where(torch.isfinite(loss), loss, torch.full_like(loss, -float("inf")))


batched_loss_reference.calls = 0


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

class KernelInputs(NamedTuple):
    """What one launch reads and writes: the C entry point's integer
    arguments, its buffers in argument order, the host constants and the
    output it fills."""
    ints: tuple
    buffers: tuple
    consts: tuple
    out: torch.Tensor


def kernel_inputs(spec: ModelSpec, params, data, start, end) -> KernelInputs:
    """Unpack and lay out a batch for the kernel: one draw-major (B, 4L+15)
    block [A | B | ν | ω | δ | μ | Φ row-major], the panel as (T, N) and the
    maturities, on the inputs' device."""
    B = params.shape[0]
    N, T = data.shape
    d = _draws(spec, params)
    packed = torch.cat(list(d), 1).contiguous()
    geo = _geometry(spec)
    mats = torch.tensor(geo.mats, dtype=params.dtype, device=params.device)
    L = d.omega.shape[1]
    flags = (int(spec.family == "msed_neural") | int(spec.transform_bool) << 1
             | int(spec.scale_grad) << 2 | int(not spec.random_walk) << 3)
    ints = (_DTYPE_CODES[params.dtype], flags, L, B, N, T, int(start), int(end))
    consts = (float(spec.forget_factor), geo.x1, geo.dx, geo.inv_dx)
    return KernelInputs(ints, (packed, data.T.contiguous(), mats), consts,
                        torch.empty(B, dtype=params.dtype, device=params.device))


def launch(inputs: KernelInputs) -> torch.Tensor:
    """One launch of the CUDA kernel on PyTorch's current stream; returns
    ``inputs.out``.  Raises if the launch is refused."""
    out = inputs.out
    lib = load("fused_ssd")
    consts = [ctypes.c_double(c) for c in inputs.consts]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.yfm_fused_ssd(*inputs.ints, *consts,
                                *(x.data_ptr() for x in inputs.buffers),
                                out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_ssd kernel launch failed: cudaError {err}")
    batched_loss.launches += 1
    return out


def batched_loss(spec: ModelSpec, params_batch, data, start=0, end=None, device=None):
    """Score-driven loss for a batch of draws, (B,), in the spec's float type.

    Equivalent to the scan engine's ``get_loss`` (K = 1) for the MSED
    families: λ and neural loadings (both transform variants), plain and
    EWMA-scaled updates, AR(1) and random-walk γ dynamics; mean one-step-ahead
    −MSE over the window, −Inf where it is not finite.  Numpy input goes to
    ``device`` (``None`` means CUDA); tensors stay where they are."""
    _check(spec)
    params = config.as_tensor(params_batch, device, spec.dtype)
    if params.ndim != 2 or params.shape[1] != spec.n_params:
        raise ValueError(f"params_batch must be (B, {spec.n_params}); "
                         f"got {tuple(params.shape)}")
    data = config.as_tensor(data, params.device, spec.dtype)
    if data.ndim != 2 or data.shape[0] != spec.N:
        raise ValueError(f"data must be (N={spec.N}, T); got {tuple(data.shape)}")
    if end is None:
        end = data.shape[1]
    if params.device.type == "cpu":
        return batched_loss_reference(spec, params, data, start, end)
    if params.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {params.device}")
    return launch(kernel_inputs(spec, params, data, start, end))


#: kernel launches since the count was last set to 0
batched_loss.launches = 0
