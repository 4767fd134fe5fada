#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build its kernels, run its main
path, hold every kernel against its plain PyTorch version, and time it.

    python3 chip_smoke.py [--json PATH]   # from the repository root; one CUDA card

Phases (any failure raises and the script exits non-zero):

1. build   — compile every kernel source with nvcc (sm_90a), all at once.
2. full width — AFNS5, N=20 maturities, T=360, B=1024 and B=16384 draws
   (this file's numpy copy of bench.py's panel and draws, seeded): raw draws
   → untransform_params → transform_params → batched_loglik (the kernel),
   then predict from the best draw.  This is the main path; the launch
   counts are set to 0 just before it and read just after.  Afterwards the
   float32 kernel is held against the plain float64 version at rtol 5e-4,
   atol 1e-2, and the kernel's float64 instantiation at rtol 1e-9.
3. other families at B=2048 — "1C" DNS with interior NaN columns and an
   invalid draw (must give −inf), TVλ under both exact_jacobian settings,
   per-draw [start, end) windows; the float32 kernel against the plain
   float32 version at rtol 5e-4, atol 1e-2 and the float64 instance against
   the plain float64 version at rtol 1e-9, each on the draws whose answer its
   type determines (it moves less than a quarter of the tolerance when the
   parameters move by 1e-7, resp. 1e-15, relative; at least 85% of draws).
   The TVλ cases run on a panel from a DNS DGP that their draws fit.
4. forecast — predict from the best draw with a 12-column NaN tail on the
   card against the same call on the CPU, both float64, at rtol 1e-9.
5. timing — CUDA events around repeated launches after a warm-up, at
   B=1024 and B=16384, for K1, K2f and K2b (AFNS5), and K1-TVλ, K3f and K3b
   (TVλ on phase 3's DNS panel, both exact_jacobian settings), and
   value-and-gradient evals/s through the fused objective; the plain
   versions once, for information.
6. gradient pairs at full width — through the fused objective's
   value-and-gradient (launch counts 1 and 1, plain versions 0): AFNS5,
   B=1024 (K2f + K2b) and TVλ, B=1024, under both exact_jacobian settings
   (K3f + K3b).  The float32 value against K1 (K2f at rtol 5e-4, atol 1e-2;
   K3f bit for bit), the float32 gradient against the plain float64 adjoint
   by bench.py's direction-and-norm criterion (cosine > 0.999, norm ratio
   within 5% per draw), the float64 kernels against the plain float64
   versions at value rtol 1e-9 and gradient rtol 1e-6, the adjoint kernel's
   raw float64 outputs (K2b's eight, K3b's six) against the plain adjoint's
   on the same inputs and checkpoints leaf by leaf (rtol 1e-6, atol 1e-9 ×
   the leaf's largest entry in the draw), and the plain float64 adjoint
   against autograd of the plain recursion at B=64.  TVλ is held on the
   draws whose value and gradient each type determines: phase 3's
   criterion on the plain value, and on the plain gradient a quarter of
   the gradient tolerance under nudges of ±1e-7 (float32) or ±1e-15
   (float64) of the raw parameters, and for float32 agreement with the
   plain float64 gradient to that quarter; the counts are printed.  There
   the float32 gradient is also held against the plain float32 one.  Then "1C" and TVλ with interior NaN columns, an
   invalid draw and per-draw windows, B=2048.
7. the fused MLE — ``estimate`` at N=20, T=360, S=256 starts,
   max_iters=50, with the launch counts set to 0 just before it: K1 ≥ 1,
   the forward and adjoint kernels once per value-and-gradient call, plain
   versions 0; the result finite, through the trust-but-verify
   re-evaluation, no start that moved without gaining and, if any moved,
   above the best start.  For the starts that stopped at iteration 0 the
   stop is checked in float64 through the plain versions: no Armijo point
   among their 25 probes along −g.  AFNS5 (K2f/K2b) on a panel simulated
   from the model at the first of bench's draws, as bench.py's newton bench
   does; then TVλ (K3f/K3b) on a panel simulated from the TVλ EKF's
   nonlinear measurement at the first of its starts.  Then small "1C" and
   TVλ fits on which the optimizer moves (N=6, T=60, S=3), on the card
   against the same calls on the CPU.
8. rolling windows — ``estimate_windows`` for AFNS5 and TVλ on phase 7's
   panels: W=8 expanding windows [0, 248+16w) × S=32 starts (256 draws),
   launch counts as in 7; each window's best ll against ``estimate`` on
   that window alone from the same starts, at rtol 1e-5; the wall time.

Before the last line it prints the card's name and power limit (nvidia-smi)
and one JSON object {"kernels": [...]} with each kernel's launches on the
main path, error, times and bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# ---- the H100's published peaks (NVIDIA H100 SXM datasheet, 700 W) ---------
PEAK_FP32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_BYTES = 3.35e12         # HBM3

# ---- tolerances of a kernel against its plain version, by float type:
# (rtol, atol, relative nudge of the determinacy test) --------------------
TOLS = {torch.float32: (5e-4, 1e-2, 1e-7), torch.float64: (1e-9, 0.0, 1e-15)}

# ---- this script's copy of bench.py's panel and draws ----------------------
N_MATURITIES, T_MONTHS = 20, 360
MATURITIES = np.array([3, 6, 9, 12, 15, 18, 21, 24, 30, 36, 48, 60, 72, 84,
                       96, 108, 120, 180, 240, 360], dtype=np.float64) / 12.0


def make_panel(seed=0, T=T_MONTHS):
    """Synthetic Liu–Wu-shaped (N, T) panel from a stationary 5-factor DGP."""
    rng = np.random.default_rng(seed)
    Z = np.ones((N_MATURITIES, 5))
    for col, lam in ((1, 0.5), (3, 0.15)):
        tau = lam * MATURITIES
        Z[:, col] = (1 - np.exp(-tau)) / tau
        Z[:, col + 1] = Z[:, col] - np.exp(-tau)
    Phi = np.diag([0.98, 0.94, 0.9, 0.92, 0.88])
    delta = np.array([0.08, -0.06, 0.03, -0.02, 0.01])
    x = np.linalg.solve(np.eye(5) - Phi, delta)
    data = np.zeros((N_MATURITIES, T))
    for t in range(T):
        x = delta + Phi @ x + 0.05 * rng.standard_normal(5)
        data[:, t] = Z @ x + 0.02 * rng.standard_normal(N_MATURITIES)
    return data + 4.0


def make_dns_panel(seed, T=T_MONTHS, lam=0.5):
    """(N, T) panel from a stationary 3-factor DNS DGP (λ = 0.5, level 4):
    data the TVλ draws of phase 3 fit."""
    rng = np.random.default_rng(seed)
    tau = lam * MATURITIES
    e = np.exp(-tau)
    Z = np.stack([np.ones(N_MATURITIES), (1 - e) / tau, (1 - e) / tau - e], 1)
    delta = np.array([0.4, -0.1, 0.05])
    x = delta / 0.1
    data = np.zeros((N_MATURITIES, T))
    for t in range(T):
        x = delta + 0.9 * x + 0.05 * rng.standard_normal(3)
        data[:, t] = Z @ x + 0.02 * rng.standard_normal(N_MATURITIES)
    return data


def make_param_batch(n_params, B, seed=1):
    """(B, n_params) constrained AFNS5 draws around a stationary point."""
    rng = np.random.default_rng(seed)
    p = np.zeros(n_params)
    p[0], p[1] = math.log(0.5), math.log(0.15)
    p[2] = 4e-4
    k = 3
    for j in range(5):
        for i in range(j + 1):
            p[k] = 0.05 + 0.01 * i if i == j else 0.002
            k += 1
    p[18:23] = [4.0, -1.0, 0.5, -0.3, 0.2]
    p[23:48] = np.diag([0.98, 0.94, 0.9, 0.92, 0.88]).reshape(-1)
    batch = np.tile(p, (B, 1))
    batch[:, 0:2] += 0.1 * rng.standard_normal((B, 2))
    for idx in (23, 29, 35, 41, 47):
        batch[:, idx] = np.clip(batch[:, idx] + 0.01 * rng.standard_normal(B), 0.5, 0.995)
    return batch


def simulate_panel(spec64, p, seed, T=T_MONTHS):
    """(N, T) panel simulated in numpy from the model at constrained
    parameters ``p`` (the port's unpacking and Z/d set-up, on the CPU):
    β₀ from the unconditional moments, β_t = δ + Φβ_{t−1} + Cη_t,
    y_t = Zβ_t + d + σε_t — the JAX package's ``simulate``, as bench.py's
    newton bench uses it at the draws' base point.  For TVλ the measurement
    is the EKF's nonlinear curve: y_t = β₀ + z₂β₁ + z₃β₂ + σε_t with the DNS
    loadings at λ_t = 1e-2 + e^{β_t,3}."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    args = G.core_inputs(spec64, torch.as_tensor(p, dtype=torch.float64)[None],
                         torch.zeros(spec64.N, T, dtype=torch.float64), 0, T)
    tvl = spec64.family == "kalman_tvl"
    state = args[:6] if tvl else args[2:8]
    Phi, delta, Om, ovar, beta0, P0 = (a[0].detach().numpy() for a in state)
    mats = np.asarray(spec64.maturities, dtype=np.float64)

    def measure(x):
        if not tvl:
            return args[0][0].detach().numpy() @ x + args[1][0].detach().numpy()
        tau = (1e-2 + math.exp(x[3])) * mats
        z2 = (1 - np.exp(-tau)) / tau
        return x[0] + z2 * x[1] + (z2 - np.exp(-tau)) * x[2]

    Ms = Phi.shape[0]
    rng = np.random.default_rng(seed)
    C = np.linalg.cholesky(0.5 * (Om + Om.T) + 1e-12 * np.eye(Ms))
    x = beta0 + np.linalg.cholesky(0.5 * (P0 + P0.T) + 1e-9 * np.eye(Ms)) \
        @ rng.standard_normal(Ms)
    data = np.zeros((spec64.N, T))
    for t in range(T):
        x = delta + Phi @ x + C @ rng.standard_normal(Ms)
        data[:, t] = measure(x) + math.sqrt(ovar) * rng.standard_normal(spec64.N)
    return data


#: TVλ transition intercept: a steady state (4, −1, 0.5, ln 0.49) under Φ ≈ 0.9
TVL_DELTA = [0.4, -0.1, 0.05, 0.1 * math.log(0.49)]


def kalman_draws(spec, B, rng, delta):
    """(B, n_params) stationary draws for a "1C" or TVλ spec."""
    p = np.zeros((B, spec.n_params))
    if "gamma" in spec.layout:
        p[:, spec.layout["gamma"][0]] = math.log(0.5) + 0.1 * rng.standard_normal(B)
    p[:, spec.layout["obs_var"][0]] = 4e-4
    a, _ = spec.layout["chol"]
    rows, cols = spec.chol_indices
    for k, (r, c) in enumerate(zip(rows, cols)):
        p[:, a + k] = 0.05 if r == c else 0.002
    a, b = spec.layout["delta"]
    p[:, a:b] = delta
    Ms = spec.state_dim
    a, _ = spec.layout["phi"]
    for m in range(Ms):
        p[:, a + m * Ms + m] = np.clip(0.9 + 0.02 * rng.standard_normal(B), 0.5, 0.99)
    return p


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def close(got, ref, rtol, atol, what):
    """Hold ``got`` against ``ref`` (same −inf pattern, finite entries within
    rtol/atol); returns the largest absolute error over finite entries."""
    got = got.detach().double().cpu().numpy()
    ref = ref.detach().double().cpu().numpy()
    check(got.shape == ref.shape, f"{what}: shape {got.shape} vs {ref.shape}")
    check(np.array_equal(np.isfinite(got), np.isfinite(ref)),
          f"{what}: finite pattern differs")
    fin = np.isfinite(ref)
    err = np.abs(got[fin] - ref[fin])
    bad = err > atol + rtol * np.abs(ref[fin])
    check(not bad.any(), f"{what}: {int(bad.sum())} entries outside rtol={rtol} "
          f"atol={atol}; max abs err {err.max():.3e}")
    print(f"  {what}: ok, max abs err {err.max() if err.size else 0.0:.3e} "
          f"(rtol={rtol}, atol={atol})")
    return float(err.max()) if err.size else 0.0


def observed_steps(B, T, masks, win, data):
    """Draw-steps the kernels run the measurement chain on: in the window
    (each draw's own where given) and with a fully finite column."""
    finite_col = data.isfinite().all(0).cpu()
    if win is None:
        return int((masks[:, 0].bool().cpu() & finite_col).sum()) * B
    t = torch.arange(T)
    lo, hi = win[0].cpu()[:, None], win[1].cpu()[:, None]
    return int((((t >= lo) & (t < hi)) & finite_col).sum())


def determined_draws(spec, p64, data64, dtype, rtol, atol, eps, **kw):
    """The draws whose loglik the float type determines: the plain version
    in ``dtype`` moves by less than a quarter of the tolerance when the
    constrained parameters move by eps, −eps and 3·eps, relative.  On some
    draws the TVλ EKF amplifies rounding far beyond the tolerances — under
    the reference's Jacobian (exact_jacobian=False) in float64 too — so
    each kernel instance is held against its plain version there only.
    The nudged draws go through one batched call.  Returns (mask, the
    plain value)."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf

    pd, dd = p64.to(dtype), data64.to(dtype)
    nudges = (0.0, eps, -eps, 3 * eps)
    kw = {k: v.repeat(len(nudges)) for k, v in kw.items()}
    ll = fused_kf.batched_loglik_reference(
        spec, torch.cat([pd * (1 + n) for n in nudges]), dd, **kw).reshape(len(nudges), -1)
    ref = ll[0]
    det = torch.isfinite(ref) & ((ll[1:] - ref).abs() <= (atol + rtol * ref.abs()) / 4).all(0)
    return det, ref


def determined_gradients(yfm, spec, X64, data64, dtype, eps, win, ref=None,
                         cos_min=0.999, norm_tol=0.05, rtol=1e-6):
    """The draws whose MLE gradient the float type determines, by
    :func:`determined_draws`' criterion applied to the plain versions'
    gradient at raw parameters X: when X moves by ±eps, relative, it keeps
    a cosine above 1 − (1 − cos_min)/4 and its norm within norm_tol/4
    (float32; the criterion the kernel is held to is cos_min and norm_tol),
    or moves by less than rtol/4 of the draw's largest component (float64).
    With ``ref`` (the plain float64 gradient), a float32 gradient must also
    agree with it to the same quarter criterion: float32 can be stable
    under nudges and still biased.  The TVλ EKF's gradient amplifies
    rounding more than its value does.  Returns (mask, the plain value and
    gradient at X)."""
    nudges = (0.0, eps, -eps)
    B = X64.shape[0]
    Xd = torch.cat([X64.to(dtype) * (1 + n) for n in nudges])
    w = None if win is None else tuple(x.repeat(len(nudges)) for x in win)
    v, g = raw_value_and_grad(yfm, spec, Xd, data64.to(dtype), plain_core(spec), w)
    g = g.double().reshape(len(nudges), B, -1)
    g0 = g[0]

    def agree(ga, gb):
        if dtype == torch.float64:
            scale = gb.abs().amax(1, keepdim=True)
            return ((ga - gb).abs() <= rtol / 4 * (gb.abs() + scale)).all(1)
        na, nb = ga.norm(dim=1), gb.norm(dim=1).clamp(min=1e-300)
        cos = (ga * gb).sum(1) / (na * nb).clamp(min=1e-300)
        return (cos > 1 - (1 - cos_min) / 4) & ((na / nb - 1).abs() < norm_tol / 4)

    det = agree(g[1], g0) & agree(g[2], g0)
    if ref is not None:
        det &= agree(g0, ref.double())
    return det, v.reshape(len(nudges), B)[0], g0


def loglik_flops(Ms, B, N, T, obs_steps, tvl=False):
    """Floating-point operations of one loglik pass: the scalar measurement
    updates on the observed draw-steps, the symmetrize + transition on every
    step.  Per observation: zP 2Ms², f 2Ms+1, pred 2Ms+1, K Ms, β 2Ms, P 2Ms²,
    loglik 6 (log, divide, 4 mul/add); TVλ rows add ≈ 20 (exp, 2 divides)."""
    per_obs = 4 * Ms * Ms + 7 * Ms + 8 + (20 if tvl else 0)
    per_step = Ms * Ms + 2 * Ms * Ms + 4 * Ms ** 3 + 2 * Ms * Ms  # sym, β, ΦPΦᵀ+Ω
    return obs_steps * N * per_obs + B * T * per_step


def kernel_work(inputs, data):
    """(bytes, flops) the fused loglik must move and compute for one launch:
    every input read once and the output written once; the operations of
    :func:`loglik_flops` on the steps this run's masks observe (each draw's
    own window where given)."""
    _, Ms, tvl, _, B, N, T = inputs.ints
    obs = observed_steps(B, T, inputs.buffers[9], inputs.buffers[10], data)
    return nbytes(*inputs.buffers, inputs.out), loglik_flops(Ms, B, N, T, obs, tvl)


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


#: operations of one TVλ row build (exp, two divides and the Jacobian
#: column) and of its adjoint (TvlRows::adjoint), per observed update
TVL_ROW_FLOPS, TVL_ROW_ADJOINT_FLOPS = 20, 40


def grad_kernel_work(bufs, data, out, chk, grads, tvl=False):
    """(bytes, flops) of the forward kernel (K2f/K3f) and of the adjoint's
    function (K2b/K3b) for one launch on these buffers (``lay_out`` or
    ``lay_out_tvl``), and the operations the adjoint kernel itself runs:
    each input read once, each output written once.  The forward kernel
    does K1's operations.  The least work the adjoint's function needs is
    one forward recompute (K1's operations), the adjoint of each observed
    rank-1 update beyond its forward values — K̄, z̄P, v̄, f̄, the z̄ row, ∂d,
    ∂σ², b̄, P̄: 8Ms²+14Ms+13, and for TVλ the row adjoint — the
    de-symmetrization on each observed step (2Ms²) and the transition
    adjoint Φ̄, β̄_m, P̄_m, δ̄, Ω̄ on every step (8Ms³+7Ms²+Ms).  The kernel
    also runs the chain a second time on each observed step to record the
    pre-update states, and recomputes zP, f, v, K (and the TVλ rows) in the
    adjoint loop (2Ms²+5Ms+2 an update): that is its overhead over the
    bound, counted apart."""
    first, panel = (1, 6) if tvl else (3, 8)
    Ms, B = bufs[first].shape
    T, N = bufs[panel].shape
    obs = observed_steps(B, T, bufs[panel + 1], bufs[panel + 2], data)
    fwd = loglik_flops(Ms, B, N, T, obs, tvl)
    row_adj = TVL_ROW_ADJOINT_FLOPS if tvl else 0
    row = TVL_ROW_FLOPS if tvl else 0
    bwd = (fwd + obs * N * (8 * Ms * Ms + 14 * Ms + 13 + row_adj) + obs * 2 * Ms * Ms
           + B * T * (8 * Ms ** 3 + 7 * Ms * Ms + Ms))
    bwd_run = bwd + obs * N * ((4 * Ms * Ms + 7 * Ms + 8 + row)
                               + (2 * Ms * Ms + 5 * Ms + 2 + row))
    fwd_bytes = nbytes(*bufs, out, chk)
    skip = (4, 6) if tvl else (6, 8)  # β₀, P₀: the adjoint reads the checkpoints
    bwd_in = bufs[:skip[0]] + bufs[skip[1]:]
    bwd_bytes = nbytes(*bwd_in, chk, out, *grads)
    return (fwd_bytes, fwd), (bwd_bytes, bwd), bwd_run


def bound(bytes_, flops):
    """(bound ms, what bounds it) on the H100's published float32 peaks."""
    by_bytes, by_ops = bytes_ / PEAK_BYTES, flops / PEAK_FP32_FLOPS
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes > by_ops else "operations"


class PlainCore(torch.autograd.Function):
    """The plain versions of K2f and K2b as one autograd Function, on any
    device: the reference the kernels are held against on the card."""

    @staticmethod
    def forward(ctx, Z, d, Phi, delta, Om, ovar, beta0, P0, data, masks, win):
        from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

        ll, chk = G.forward_reference(Z, d, Phi, delta, Om, ovar, beta0, P0,
                                      data, masks, win)
        ctx.win = win
        ctx.save_for_backward(Z, d, Phi, delta, Om, ovar, data, masks, chk, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

        Z, d, Phi, delta, Om, ovar, data, masks, chk, ll = ctx.saved_tensors
        g = torch.where(torch.isfinite(ll), g, torch.zeros_like(g))
        grads = G.adjoint_reference(Z, d, Phi, delta, Om, ovar, data, masks,
                                    ctx.win, chk, g)
        return (*grads, None, None, None)


class PlainTvlCore(torch.autograd.Function):
    """The plain versions of K3f and K3b as one autograd Function."""

    @staticmethod
    def forward(ctx, Phi, delta, Om, ovar, beta0, P0, data, masks, win, mats, exact):
        from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

        ll, chk = G.forward_reference_tvl(Phi, delta, Om, ovar, beta0, P0, data,
                                          masks, win, mats, exact)
        ctx.win, ctx.exact = win, exact
        ctx.save_for_backward(Phi, delta, Om, ovar, data, masks, mats, chk, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

        Phi, delta, Om, ovar, data, masks, mats, chk, ll = ctx.saved_tensors
        g = torch.where(torch.isfinite(ll), g, torch.zeros_like(g))
        grads = G.adjoint_reference_tvl(Phi, delta, Om, ovar, data, masks, ctx.win,
                                        mats, ctx.exact, chk, g)
        return (*grads, None, None, None, None, None)


def plain_core(spec):
    """The plain versions' autograd Function for the spec's family."""
    return (PlainTvlCore if spec.family == "kalman_tvl" else PlainCore).apply


def raw_value_and_grad(yfm, spec, X, data, core, win=None):
    """The MLE objective −ll (clamped to 1e12) at raw parameters X and its
    gradient, through ``core`` (the kernels, the plain versions, or the plain
    forward under autograd), in X's float type."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    X = X.detach().requires_grad_(True)
    kw = {} if win is None else {"starts": win[0], "ends": win[1]}
    args = G.core_inputs(spec, yfm.transform_params(spec, X), data, 0,
                         data.shape[1], **kw)
    ll = core(*args)
    v = torch.where(torch.isfinite(ll), -ll, torch.full_like(ll, 1e12))
    (g,) = torch.autograd.grad(v, X, torch.ones_like(v))
    return v.detach(), torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def grad_agreement(g_a, g_b, what, cos_min=0.999, norm_tol=0.05):
    """bench.py's direction-and-norm criterion (benchmarks/common.py): per
    draw, cosine > cos_min and |‖g_a‖/‖g_b‖ − 1| < norm_tol; returns the
    worst (1 − cosine, norm ratio error)."""
    g_a, g_b = g_a.double().cpu(), g_b.double().cpu()
    check(g_a.shape[0] > 0, f"{what}: no finite draws")
    na, nb = g_a.norm(dim=1), g_b.norm(dim=1)
    cos = (g_a * g_b).sum(1) / torch.clamp(na * nb, min=1e-12)
    ratio = (na / torch.clamp(nb, min=1e-12) - 1).abs()
    check(bool(cos.min() > cos_min) and bool((ratio < norm_tol).all()),
          f"{what}: cos_min {cos.min():.6f}, norm_ratio_max {ratio.max():.3f}")
    print(f"  {what}: ok, cos_min {cos.min():.9f}, norm ratio max "
          f"{ratio.max():.3e} ({g_a.shape[0]} draws)")
    return float(1 - cos.min()), float(ratio.max())


def grads_close(got, ref, rtol, what):
    """Per-draw gradients within rtol of the reference, relative to each
    draw's largest component (the components span many decades)."""
    got, ref = got.double().cpu(), ref.double().cpu()
    scale = ref.abs().amax(1, keepdim=True)
    err = (got - ref).abs()
    check(bool((err <= rtol * (ref.abs() + scale)).all()),
          f"{what}: max relative error {(err / scale).max():.3e} > {rtol}")
    print(f"  {what}: ok, max error / draw scale {(err / scale).max():.3e} "
          f"(rtol={rtol})")
    return float(err.max())


K2B_LEAVES = ("∂Z", "∂d", "∂Φ", "∂δ", "∂Ω", "∂σ²", "∂β₀", "∂P₀")
K3B_LEAVES = K2B_LEAVES[2:]


def leaves_close(got, ref, rtol, atol_rel, what, rows=None):
    """The adjoint kernel's raw outputs (draw-minor, as launch_backward[_tvl]
    returns them: K2b's eight, K3b's six) against the plain adjoint's, leaf
    by leaf and element by element, on the draws ``rows`` (all if None):
    |got − ref| ≤ rtol·|ref| + atol_rel·(that leaf's largest entry in the
    draw).  Returns the largest error over that leaf scale."""
    worst = 0.0
    names = K2B_LEAVES if len(got) == len(K2B_LEAVES) else K3B_LEAVES
    for name, g, r in zip(names, got, ref):
        r = r.double().cpu().reshape(r.shape[0], -1)
        g = g.double().cpu().T.reshape(r.shape)
        if rows is not None:
            r, g = r[rows.cpu()], g[rows.cpu()]
        scale = r.abs().amax(1, keepdim=True)
        err = (g - r).abs()
        rel = err / scale.clamp(min=1e-300)
        bad = err > rtol * r.abs() + atol_rel * scale
        check(not bool(bad.any()), f"{what} {name}: {int(bad.sum())} entries outside "
              f"rtol={rtol}, atol={atol_rel}×leaf scale; max error/scale {rel.max():.3e}")
        worst = max(worst, float(rel.max()))
    print(f"  {what}: ok, all {len(got)} leaves, max error / leaf scale {worst:.3e} "
          f"(rtol={rtol}, atol={atol_rel}×leaf scale)")
    return worst


def chain_ms(Ms, N, T, clock_mhz):
    """Estimate of the serial dependency chain of one draw: T steps of N
    scalar updates, each waiting for the previous one's P — zP and f are
    Ms-deep FMA chains, the IEEE division about 10 dependent operations,
    then one FMA into P — plus the 2·Ms-deep transition; 4 cycles an
    operation at the card's maximum SM clock."""
    cycles = T * (N * (2 * Ms + 11) + 2 * Ms) * 4
    return cycles / (clock_mhz * 1e6) * 1e3


def cuda_ms(fn, reps, warmup=3):
    """Mean milliseconds per call of ``fn`` from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nvidia_smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def counted_objectives(optimize):
    """Count the value-and-gradient calls of every fused objective that
    ``optimize`` builds inside the block; yields a one-element list."""
    calls = [0]
    make = optimize.fused_objectives

    def counting(*a, **k):
        value_fn, vag = make(*a, **k)

        def counted(X):
            calls[0] += 1
            return vag(X)
        return value_fn, counted

    optimize.fused_objectives = counting
    try:
        yield calls
    finally:
        optimize.fused_objectives = make


def launch_counters(spec):
    """(forward kernel, adjoint kernel, plain forward, plain adjoint) of the
    spec's family: K3f/K3b for TVλ, K2f/K2b otherwise."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    if spec.family == "kalman_tvl":
        return (G.launch_forward_tvl, G.launch_backward_tvl, G.forward_reference_tvl,
                G.adjoint_reference_tvl)
    return G.launch_forward, G.launch_backward, G.forward_reference, G.adjoint_reference


def zero_counts(spec):
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf

    fwd, bwd, fwd_p, bwd_p = launch_counters(spec)
    fused_kf.batched_loglik.launches = fwd.launches = bwd.launches = 0
    fwd_p.calls = bwd_p.calls = fused_kf.batched_loglik_reference.calls = 0


def read_counts(spec, vag_calls):
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf

    fwd, bwd, fwd_p, bwd_p = launch_counters(spec)
    return {"K1": fused_kf.batched_loglik.launches, "forward": fwd.launches,
            "backward": bwd.launches, "value_and_grad_calls": vag_calls,
            "plain": (fwd_p.calls, bwd_p.calls, fused_kf.batched_loglik_reference.calls)}


def check_counts(counts, what):
    check(counts["K1"] >= 1, f"{what}: the Armijo probes never launched K1")
    check(counts["forward"] == counts["backward"] == counts["value_and_grad_calls"] >= 1,
          f"{what}: forward/adjoint launches differ from the value-and-gradient calls: "
          f"{counts}")
    check(counts["plain"] == (0, 0, 0), f"{what}: plain versions ran on the card: {counts}")


def full_width_fit(yfm, optimize, spec, spec64, sim, starts, dev):
    """``estimate`` at N=20, T=360 from the (S, P) constrained ``starts`` on
    the card, with the launch counts set to 0 just before it: K1 ≥ 1, the
    forward and adjoint kernels once per value-and-gradient call, the plain
    versions never.  The result passes the trust-but-verify re-evaluation,
    no start that moved failed to gain, and a moved run beats the best
    start.  Starts that stopped at iteration 0 are checked in float64
    through the plain versions: no Armijo point among their 25 probes
    along −g.  Returns the report."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf

    f32, f64 = torch.float32, torch.float64
    S = starts.shape[0]
    sim32 = torch.as_tensor(sim, device=dev, dtype=f32)
    # the starts as estimate makes them: untransformed on the host in float64
    raw0_64 = torch.as_tensor(optimize._sanitize(
        yfm.untransform_params(spec, torch.as_tensor(starts))), device=dev)
    f_start = optimize.fused_objectives(spec, sim32, 0, T_MONTHS)[0](raw0_64.to(f32))
    best_start = float((-f_start).max())
    with counted_objectives(optimize) as vag_calls:
        zero_counts(spec)
        t0 = time.perf_counter()
        _, ll_fit, best_p, conv = yfm.estimate(spec, sim, starts.T, max_iters=50)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts(spec, vag_calls[0])
    fit_report = yfm.last_multistart_report()
    print(f"  main path: {counts}")
    check_counts(counts, "estimate")
    check(math.isfinite(ll_fit), f"estimate: non-finite ll {ll_fit}")
    iters = np.array(fit_report["iters"])
    moved = int((iters > 0).sum())
    lls_fit = torch.as_tensor(fit_report["lls"], dtype=f64)
    # K1 (the starts' values here) and the forward kernel (the optimizer's)
    # run one float32 recursion (kf_common.cuh) behind separate set-ups:
    # allow their rounding, rtol 1e-6.  A start that did not move keeps its
    # value; one that moved passed Armijo tests and must have gained.
    f_start64 = -f_start.double().cpu()
    still = iters == 0
    check(bool(((lls_fit - f_start64).abs()[still]
                <= 1e-6 * f_start64.abs()[still]).all()),
          "estimate: a start that did not move changed its value")
    check(bool((lls_fit[~still] > f_start64[~still]).all()),
          "estimate: a start that moved did not gain")
    check(moved == 0 or ll_fit > best_start,
          f"estimate: ll {ll_fit} not above the best start's {best_start}")
    check(ll_fit >= best_start - 1e-6 * abs(best_start),
          f"estimate: ll {ll_fit} below the best start's {best_start}")
    if moved < S:
        # The reference's first step is −g from α = 1 with at most 25
        # backtracks by 0.8: show that a start that stopped there had no
        # Armijo point, in float64 through the plain versions — the plain
        # adjoint's gradient at the start and the plain loglik at all 25
        # probes of every such start, in one batch.
        sim64 = torch.as_tensor(sim, device=dev)
        X = raw0_64[torch.as_tensor(still, device=dev)]
        f0, g0 = raw_value_and_grad(yfm, spec64, X, sim64, plain_core(spec64))
        alphas = 0.8 ** torch.arange(25, device=dev, dtype=f64)
        probes = (X[None] - alphas[:, None, None] * g0[None]).reshape(-1, X.shape[1])
        ll_p = fused_kf.batched_loglik_reference(
            spec64, yfm.transform_params(spec64, probes), sim64)
        f_p = torch.where(torch.isfinite(ll_p), -ll_p, torch.full_like(ll_p, 1e12))
        armijo = f_p.reshape(25, -1) <= f0[None] - 1e-4 * alphas[:, None] * (g0 * g0).sum(1)[None]
        check(not bool(armijo.any()), f"estimate: {int(armijo.any(0).sum())} starts that "
              "stopped have an Armijo point in float64")
        gnorm = g0.norm(dim=1)
        print(f"  {S - moved} starts stopped at iteration 0; float64 check: no Armijo "
              f"point among their 25 probes along −g (‖g‖ {float(gnorm.min()):.3e} "
              f"… {float(gnorm.max()):.3e})")
    # the share of the wall that the trust-but-verify re-evaluation takes:
    # the same plain-engine call on the winner, timed again
    t0 = time.perf_counter()
    yfm.get_loss(spec, best_p, sim)
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t0
    print(f"  ll {ll_fit:.4f} (best start {best_start:.4f}), {conv}, "
          f"iterations max {iters.max()}, mean {iters.mean():.2f}, starts that moved "
          f"{moved}/{S}, wall {fit_s:.2f} s (the plain re-evaluation alone "
          f"{verify_s:.2f} s); trust-but-verify passed")
    return {"S": S, "ll": ll_fit, "best_start_ll": best_start,
            "iterations_max": int(iters.max()), "iterations_mean": float(iters.mean()),
            "starts_moved": moved, "converged": bool(conv), "wall_s": fit_s,
            "verify_s": verify_s, "counts": counts}


def small_fit(yfm, optimize, code, mats, obs_var):
    """A fit on which the optimizer moves — N=6, T=60, S=3 on a unit-scale
    panel (tests/test_torch_estimation.py's), from starts around a
    stationary point with measurement variance ``obs_var`` — on the card
    against the same call on the CPU, float32 both: ll within rtol 1e-3,
    since Armijo decisions on float32 values rounded in another order may
    send the two L-BFGS paths a step apart."""
    spec, _ = yfm.create_model(code, mats)
    rng = np.random.default_rng(0)
    data = 0.5 * rng.standard_normal((len(mats), 60))
    base = np.zeros(spec.n_params)
    base[spec.layout["obs_var"][0]] = obs_var
    a, _ = spec.layout["chol"]
    for k, (r, c) in enumerate(zip(*spec.chol_indices)):
        base[a + k] = 0.3 if r == c else 0.01
    Ms = spec.state_dim
    lo, hi = spec.layout["phi"]
    base[lo:hi] = (0.5 * np.eye(Ms)).reshape(-1)
    if "gamma" in spec.layout:
        base[spec.layout["gamma"][0]] = math.log(0.49)
    else:  # TVλ: the λ driver's steady state at ln 0.49
        base[spec.layout["delta"][0] + 3] = 0.5 * math.log(0.49)
    starts = np.stack([base * (1 + 0.05 * rng.standard_normal(spec.n_params))
                       for _ in range(3)], axis=1)
    raw = yfm.untransform_params(spec, torch.as_tensor(starts.T)).to(torch.float32)
    best = float((-optimize.fused_objectives(spec, torch.as_tensor(data, dtype=torch.float32),
                                             0, 60)[0](raw)).max())
    _, ll_card, _, conv_card = yfm.estimate(spec, data, starts, max_iters=20)
    _, ll_cpu, _, conv_cpu = yfm.estimate(spec, data, starts, max_iters=20, device="cpu")
    print(f"  card ll {ll_card:.6f} ({conv_card}), CPU ll {ll_cpu:.6f} ({conv_cpu}), "
          f"best start {best:.6f}")
    check(conv_card.iterations > 0 and ll_card > best,
          f"the small {code} fit did not move on the card")
    check(abs(ll_card - ll_cpu) <= 1e-3 * abs(ll_cpu),
          f"the small {code} fit on the card and on the CPU differ by more than rtol 1e-3")


def windows_fit(yfm, optimize, label, spec, sim, starts, ends):
    """``estimate_windows`` over expanding windows [0, end) × the (S, P)
    constrained ``starts``, with launch counts (one forward and one adjoint
    launch per value-and-gradient call); each window's best ll against an
    ``estimate`` on that window alone from the same starts, on the card, at
    rtol 1e-5.  Returns the report."""
    W, S = len(ends), starts.shape[0]
    raw = optimize._sanitize(yfm.untransform_params(spec, torch.as_tensor(starts)))
    with counted_objectives(optimize) as vag_calls:
        zero_counts(spec)
        t0 = time.perf_counter()
        xs, lls = yfm.estimate_windows(spec, sim, raw, [0] * W, ends, max_iters=50)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts(spec, vag_calls[0])
    print(f"  {label}: {W}×{S} draws, launches {counts}, wall {wall_s:.2f} s")
    check_counts(counts, f"{label} estimate_windows")
    check(xs.shape == (W, S, spec.n_params) and lls.shape == (W, S),
          f"{label}: shapes {xs.shape} {lls.shape}")
    best = lls.max(1)
    check(bool(np.isfinite(best).all()), f"{label}: a window has no finite ll")
    alone = []
    for w, end in enumerate(ends):
        _, ll_w, _, _ = yfm.estimate(spec, sim, starts.T, start=0, end=end, max_iters=50)
        alone.append(ll_w)
    alone = np.array(alone)
    err = np.abs(best - alone)
    check(bool((err <= 1e-5 * np.abs(alone)).all()),
          f"{label}: windows' best ll differ from estimate per window: {best} vs {alone}")
    print(f"  {label}: each window's best ll equals estimate on that window alone "
          f"(max rel err {float((err / np.abs(alone)).max()):.3e}); lls {np.round(best, 3)}")
    return {"W": W, "S": S, "wall_s": wall_s, "counts": counts,
            "best_ll": best.tolist(), "estimate_ll": alone.tolist(),
            "max_rel_err": float((err / np.abs(alone)).max())}


def main(json_path=None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import yieldfactormodels_jl_tpu_torch as yfm
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    from yieldfactormodels_jl_tpu_torch.estimation import optimize
    from yieldfactormodels_jl_tpu_torch.ops import _build, fused_kf
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    torch.backends.cuda.matmul.allow_tf32 = False  # full-precision references
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ------------------------------------------------------------
    print("[1] build")
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.KERNELS:
        _build.load(name)
    report["build_s"] = time.perf_counter() - t0
    print(f"  built {list(_build.KERNELS)} in {report['build_s']:.1f} s")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 2. full width: the main path -----------------------------------------
    print("[2] full width: AFNS5, N=20, T=360")
    spec, _ = yfm.create_model("AFNS5", MATURITIES)
    spec64, _ = yfm.create_model("AFNS5", MATURITIES, float_type="float64")
    panel = make_panel(seed=0)
    panel_ext = np.concatenate([panel, np.full((N_MATURITIES, 12), np.nan)], axis=1)
    sizes = (1024, 16384)
    draws = {B: yfm.params_from_jax(spec64, make_param_batch(spec.n_params, B))
             for B in sizes}

    fused_kf.batched_loglik.launches = 0
    lls, cons = {}, {}
    for B in sizes:
        cons[B] = yfm.transform_params(spec, yfm.untransform_params(spec, draws[B]))
        lls[B] = yfm.batched_loglik(spec, cons[B], panel)
    best = int(torch.argmax(lls[1024]))
    forecast = yfm.predict(spec64, cons[1024][best], panel_ext)
    torch.cuda.synchronize()
    launches = fused_kf.batched_loglik.launches
    print(f"  main path: batched_loglik launches = {launches}")
    check(launches == len(sizes), f"main path launched the kernel {launches} times")

    errs = []
    panel64 = torch.as_tensor(panel, device=dev, dtype=f64)
    for B in sizes:
        ll = lls[B]
        check(ll.shape == (B,) and ll.dtype == f32, f"B={B}: output {ll.shape} {ll.dtype}")
        check(bool(torch.isfinite(ll).all()), f"B={B}: non-finite loglik")
        close(cons[B], draws[B], 1e-12, 1e-12, f"B={B} transform round trip")
        ref = fused_kf.batched_loglik_reference(spec64, cons[B], panel64)
        errs.append(close(ll, ref, 5e-4, 1e-2, f"B={B} f32 kernel vs plain f64"))
        got64 = fused_kf._batched_loglik(spec64, cons[B], panel64, dtype=f64)
        close(got64, ref, 1e-9, 0.0, f"B={B} f64 kernel vs plain f64")
    report["loglik_best"] = float(lls[1024][best])

    # ---- 3. other families ------------------------------------------------------
    print("[3] other families at B=2048")
    rng = np.random.default_rng(7)
    Bo = 2048
    gapped = panel.copy()
    gapped[:, 50] = np.nan
    gapped[3, 120] = np.nan
    gapped[:, 200:203] = np.nan
    gapped64 = torch.as_tensor(gapped, device=dev, dtype=f64)
    cases = []
    dns64, _ = yfm.create_model("1C", MATURITIES, float_type="float64")
    p = kalman_draws(dns64, Bo, rng, [0.4, -0.1, 0.05])
    p[5] = np.nan                                      # invalid draw → −inf
    cases.append(("1C NaN columns + invalid row", dns64, p, gapped64, {}))
    tvl32, _ = yfm.create_model("TVλ", MATURITIES)
    tvl64, _ = yfm.create_model("TVλ", MATURITIES, float_type="float64")
    dns_panel = make_dns_panel(seed=2)
    dns64_panel = torch.as_tensor(dns_panel, device=dev, dtype=f64)
    for exact in (False, True):
        s = dataclasses.replace(tvl64, exact_jacobian=exact)
        cases.append((f"TVλ exact_jacobian={exact}", s,
                      kalman_draws(s, Bo, rng, TVL_DELTA), dns64_panel, {}))
    win = {"starts": torch.as_tensor(rng.integers(0, 100, Bo), device=dev),
           "ends": torch.as_tensor(rng.integers(200, T_MONTHS + 1, Bo), device=dev)}
    cases.append(("AFNS5 per-draw windows", spec64,
                  make_param_batch(spec.n_params, Bo, seed=3), panel64, win))
    # each kernel instance against the plain version in its own type, on
    # the draws where that type determines the answer (most draws)
    for what, s, p, data64, kw in cases:
        pt = torch.as_tensor(p, device=dev, dtype=f64)
        for dtype, (rtol, atol, eps) in TOLS.items():
            determined, ref = determined_draws(s, pt, data64, dtype, rtol, atol, eps, **kw)
            n_det = int(determined.sum())
            name = str(dtype).replace("torch.float", "f")
            print(f"  {what}: {name} determines {n_det} of {Bo} draws")
            check(n_det >= 0.85 * Bo, f"{what}: {name} determines only {n_det} draws")
            got = fused_kf._batched_loglik(s, pt, data64, dtype=dtype, **kw)
            err = close(got[determined], ref[determined], rtol, atol,
                        f"{what}: {name} kernel vs plain {name}")
            if dtype == f32:
                errs.append(err)
            if "invalid" in what:
                g = got.cpu()
                check(g[5] == -math.inf and bool(torch.isfinite(g[4])),
                      "invalid draw must give −inf and leave its neighbour finite")

    # ---- 4. forecast -------------------------------------------------------------
    print("[4] forecast: predict from the best draw, 12-step NaN tail")
    cpu = yfm.predict(spec64, cons[1024][best].cpu().numpy(), panel_ext, device="cpu")
    for key, val in forecast.items():
        check(val.shape == cpu[key].shape, f"predict {key}: {val.shape} vs {cpu[key].shape}")
        check(bool(torch.isfinite(val).all()), f"predict {key}: non-finite")
        close(val, cpu[key], 1e-9, 1e-9, f"predict {key} card vs CPU")
    check(forecast["preds"].shape == (N_MATURITIES, T_MONTHS + 12), "preds shape")

    # ---- 5. timing ---------------------------------------------------------------
    print("[5] timing (CUDA events)")
    shapes, grad_shapes, tvl_shapes = {}, {}, {}
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    panel32 = torch.as_tensor(panel, device=dev, dtype=f32)
    _, vag32 = optimize.fused_objectives(spec, panel32, 0, T_MONTHS)
    for B in sizes:
        p32 = cons[B].to(f32)
        inputs = fused_kf.kernel_inputs(spec, p32, panel32, 0, T_MONTHS)
        ms = cuda_ms(lambda: fused_kf.launch(inputs), reps=20)
        entry_ms = cuda_ms(lambda: yfm.batched_loglik(spec, p32, panel32), reps=10)
        plain_ms = cuda_ms(lambda: fused_kf.batched_loglik_reference(spec, p32, panel32),
                           reps=1, warmup=1)
        bytes_, flops = kernel_work(inputs, panel32)
        bound_ms, bound_by = bound(bytes_, flops)
        shapes[str(B)] = {
            "ms": ms, "entry_ms": entry_ms, "plain_ms": plain_ms,
            "evals_per_s": B / (ms * 1e-3), "bytes": bytes_, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "chain_ms": chain_ms(spec.state_dim, N_MATURITIES, T_MONTHS, clock_mhz)}
        print(f"  K1 B={B}: kernel {ms:.4f} ms ({B / (ms * 1e-3):.0f} evals/s), "
              f"entry point {entry_ms:.4f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound_ms:.4f} ms ({flops / B:.0f} flop/draw), "
              f"serial-chain estimate {shapes[str(B)]['chain_ms']:.4f} ms")

        args = G.core_inputs(spec, p32, panel32, 0, T_MONTHS)
        bufs = G.lay_out(*args)
        out, chk = G.launch_forward(bufs)
        g = torch.ones(B, device=dev, dtype=f32)
        grads = G.launch_backward(bufs, chk, g)
        fwd_ms = cuda_ms(lambda: G.launch_forward(bufs), reps=10)
        bwd_ms = cuda_ms(lambda: G.launch_backward(bufs, chk, g), reps=5)
        plain = [a.detach() if a is not None else None for a in args]
        fwd_plain_ms = cuda_ms(lambda: G.forward_reference(*plain), reps=1, warmup=0)
        chk_plain = G.forward_reference(*plain)[1]
        bwd_plain_ms = cuda_ms(lambda: G.adjoint_reference(
            *plain[:6], *plain[8:], chk_plain, g), reps=1, warmup=0)
        X = yfm.untransform_params(spec, p32)
        vag_ms = cuda_ms(lambda: vag32(X), reps=5, warmup=2)
        (fb, ff), (bb, bf), bf_run = grad_kernel_work(bufs, panel32, out, chk, grads)
        f_bound, f_by = bound(fb, ff)
        b_bound, b_by = bound(bb, bf)
        grad_shapes[str(B)] = {
            "K2f": {"ms": fwd_ms, "plain_ms": fwd_plain_ms, "bytes": fb, "flops": ff,
                    "bound_ms": f_bound, "bound_by": f_by},
            "K2b": {"ms": bwd_ms, "plain_ms": bwd_plain_ms, "bytes": bb, "flops": bf,
                    "bound_ms": b_bound, "bound_by": b_by, "kernel_flops": bf_run},
            "value_and_grad_ms": vag_ms, "grad_evals_per_s": B / (vag_ms * 1e-3)}
        print(f"  K2f B={B}: kernel {fwd_ms:.4f} ms, plain {fwd_plain_ms:.1f} ms, "
              f"bound {f_bound:.4f} ms ({f_by})")
        print(f"  K2b B={B}: kernel {bwd_ms:.4f} ms, plain {bwd_plain_ms:.1f} ms, "
              f"bound {b_bound:.4f} ms ({b_by}; {bf / B:.0f} flop/draw needed, "
              f"{bf_run / B:.0f} run by the kernel)")
        print(f"  value-and-gradient through the fused objective B={B}: "
              f"{vag_ms:.4f} ms ({B / (vag_ms * 1e-3):.0f} grad evals/s)")
    report["shapes"] = shapes
    report["grad_shapes"] = grad_shapes

    # TVλ on phase 3's DNS panel: K1-TVλ beside K3f and K3b in the same
    # call, both Jacobian settings; the plain versions once, under the
    # spec's default (the reference's Jacobian)
    dns_panel32 = torch.as_tensor(dns_panel, device=dev, dtype=f32)
    for exact in (False, True):
        s32 = dataclasses.replace(tvl32, exact_jacobian=exact)
        _, vag_tvl = optimize.fused_objectives(s32, dns_panel32, 0, T_MONTHS)
        for B in sizes:
            p32 = torch.as_tensor(kalman_draws(s32, B, np.random.default_rng(B), TVL_DELTA),
                                  device=dev, dtype=f32)
            inputs = fused_kf.kernel_inputs(s32, p32, dns_panel32, 0, T_MONTHS)
            k1_ms = cuda_ms(lambda: fused_kf.launch(inputs), reps=10)
            args = G.core_inputs(s32, p32, dns_panel32, 0, T_MONTHS)
            bufs = G.lay_out_tvl(*args[:10])
            out, chk = G.launch_forward_tvl(bufs, exact)
            g = torch.ones(B, device=dev, dtype=f32)
            grads = G.launch_backward_tvl(bufs, exact, chk, g)
            fwd_ms = cuda_ms(lambda: G.launch_forward_tvl(bufs, exact), reps=10)
            bwd_ms = cuda_ms(lambda: G.launch_backward_tvl(bufs, exact, chk, g), reps=5)
            fwd_plain_ms = bwd_plain_ms = None
            if not exact:
                plain = [a.detach() if torch.is_tensor(a) else a for a in args]
                fwd_plain_ms = cuda_ms(lambda: G.forward_reference_tvl(*plain), reps=1,
                                       warmup=0)
                chk_plain = G.forward_reference_tvl(*plain)[1]
                bwd_plain_ms = cuda_ms(lambda: G.adjoint_reference_tvl(
                    *plain[:4], *plain[6:], chk_plain, g), reps=1, warmup=0)
            X = yfm.untransform_params(s32, p32)
            vag_ms = cuda_ms(lambda: vag_tvl(X), reps=5, warmup=2)
            (fb, ff), (bb, bf), bf_run = grad_kernel_work(bufs, dns_panel32, out, chk, grads,
                                                          tvl=True)
            f_bound, f_by = bound(fb, ff)
            b_bound, b_by = bound(bb, bf)
            tvl_shapes[f"{B} exact={exact}"] = {
                "K1_ms": k1_ms,
                "K3f": {"ms": fwd_ms, "plain_ms": fwd_plain_ms, "bytes": fb, "flops": ff,
                        "bound_ms": f_bound, "bound_by": f_by},
                "K3b": {"ms": bwd_ms, "plain_ms": bwd_plain_ms, "bytes": bb, "flops": bf,
                        "bound_ms": b_bound, "bound_by": b_by, "kernel_flops": bf_run},
                "value_and_grad_ms": vag_ms, "grad_evals_per_s": B / (vag_ms * 1e-3)}
            plain_txt = ("" if exact else f", plain {fwd_plain_ms:.1f} / "
                         f"{bwd_plain_ms:.1f} ms")
            print(f"  TVλ exact={exact} B={B}: K1 {k1_ms:.4f} ms, K3f {fwd_ms:.4f} ms "
                  f"(bound {f_bound:.4f}, {f_by}), K3b {bwd_ms:.4f} ms (bound "
                  f"{b_bound:.4f}, {b_by}; {bf / B:.0f} flop/draw needed, "
                  f"{bf_run / B:.0f} run){plain_txt}; value-and-gradient "
                  f"{vag_ms:.4f} ms ({B / (vag_ms * 1e-3):.0f} grad evals/s)")
    report["tvl_shapes"] = tvl_shapes

    # ---- 6. gradient pairs at full width ---------------------------------------
    print("[6] gradient pair: K2f + K2b against the plain versions")
    grad_errs = {"K2f": [], "K2b": [], "K2b_leaves": [],
                 "K3f": [], "K3b": [], "K3b_leaves": []}
    wins = torch.as_tensor(rng.integers(0, 100, 2048), device=dev), \
        torch.as_tensor(rng.integers(200, T_MONTHS + 1, 2048), device=dev)
    dns32, _ = yfm.create_model("1C", MATURITIES)
    p_dns = kalman_draws(dns64, 2048, rng, [0.4, -0.1, 0.05])
    p_dns[5] = np.nan                                  # invalid draw
    grad_cases = [
        ("AFNS5 B=1024", spec, spec64, draws[1024], panel, None),
        ('"1C" NaN columns, invalid draw, per-draw windows, B=2048', dns32, dns64,
         torch.as_tensor(p_dns, device=dev), gapped, wins),
    ]
    for exact in (False, True):
        grad_cases.append((f"TVλ exact_jacobian={exact} B=1024",
                           dataclasses.replace(tvl32, exact_jacobian=exact),
                           dataclasses.replace(tvl64, exact_jacobian=exact),
                           torch.as_tensor(kalman_draws(tvl64, 1024, rng, TVL_DELTA),
                                           device=dev), dns_panel, None))
    p_tvl = kalman_draws(tvl64, 2048, rng, TVL_DELTA)
    p_tvl[5] = np.nan                                  # invalid draw
    gapped_dns = dns_panel.copy()
    gapped_dns[:, 50] = np.nan
    gapped_dns[3, 120] = np.nan
    grad_cases.append(("TVλ NaN columns, invalid draw, per-draw windows, B=2048", tvl32,
                       tvl64, torch.as_tensor(p_tvl, device=dev), gapped_dns, wins))
    for what, s32, s64, p64, data_np, win in grad_cases:
        tvl = s64.family == "kalman_tvl"
        fwd_k, bwd_k, fwd_p, bwd_p = launch_counters(s64)
        names = ("K3f", "K3b") if tvl else ("K2f", "K2b")
        data32 = torch.as_tensor(data_np, device=dev, dtype=f32)
        data64 = torch.as_tensor(data_np, device=dev, dtype=f64)
        X64 = yfm.untransform_params(s64, p64)
        X32 = X64.to(f32)
        kw = {} if win is None else {"win_starts": win[0], "win_ends": win[1]}
        wkw = {} if win is None else {"starts": win[0], "ends": win[1]}
        value_fn, vag = optimize.fused_objectives(s32, data32, 0, T_MONTHS, **kw)
        fwd_k.launches = bwd_k.launches = 0
        fwd_p.calls = bwd_p.calls = 0
        v32, g32 = vag(X32)
        torch.cuda.synchronize()
        n = (fwd_k.launches, bwd_k.launches, fwd_p.calls, bwd_p.calls)
        print(f"  {what}: {names[0]}, {names[1]} launches {n[:2]}, plain-version calls {n[2:]}")
        check(n == (1, 1, 0, 0), f"{what}: launches/plain calls {n}")
        v_k1 = value_fn(X32)
        fin = v32 < optimize.PENALTY_THRESH
        check(torch.equal(fin, v_k1 < optimize.PENALTY_THRESH), f"{what}: {names[0]} and K1 disagree on validity")
        if tvl:  # one recursion (kf_common.cuh) behind one set-up
            check(torch.equal(v32, v_k1), f"{what}: f32 K3f value differs from K1's")
            print(f"  {what}: f32 K3f value equals K1's bit for bit")
        else:
            close(v32[fin], v_k1[fin], 5e-4, 1e-2, f"{what}: f32 K2f value vs K1")
        # the draws each type determines, in value (phase 3's criterion) and
        # in gradient; all of them for DNS/AFNS, well conditioned here
        det = {f32: fin, f64: fin}
        if tvl:
            for dtype in (f64, f32):  # the float64 gradient first: float32's reference
                rtol, atol, eps = TOLS[dtype]
                d_val = fin & determined_draws(s64, p64, data64, dtype, rtol, atol, eps,
                                               **wkw)[0]
                d_grad, v_p, g_p = determined_gradients(
                    yfm, s64, X64, data64, dtype, eps, win,
                    ref=None if dtype == f64 else g_ref)
                if dtype == f64:
                    v_ref, g_ref = v_p, g_p
                else:
                    g_plain32 = g_p
                det[dtype] = d_val & d_grad
                n_fin, n_val, n_both = int(fin.sum()), int(d_val.sum()), int(det[dtype].sum())
                print(f"  {what}: {str(dtype)[-7:]} determines the value of {n_val} and "
                      f"value and gradient of {n_both} of {n_fin} finite draws")
                check(n_val >= 0.85 * n_fin, f"{what}: {dtype} determines too few values")
                check(n_both >= 0.5 * n_fin, f"{what}: {dtype} determines too few gradients")
        else:
            v_ref, g_ref = raw_value_and_grad(yfm, s64, X64, data64, plain_core(s64), win)
        check(torch.equal(fin, v_ref < optimize.PENALTY_THRESH), f"{what}: validity differs from plain")
        d32, d64 = det[f32], det[f64]
        grad_errs[names[0]].append(close(v32[d32], v_ref[d32], 5e-4, 1e-2,
                                         f"{what}: f32 value vs plain f64"))
        cos_err, ratio_err = grad_agreement(g32[d32], g_ref[d32],
                                            f"{what}: f32 gradient vs plain f64")
        if tvl:
            grad_agreement(g32[d32], g_plain32[d32], f"{what}: f32 gradient vs plain f32")
        grad_errs[names[1]].append({"max_one_minus_cos": cos_err,
                                    "max_norm_ratio_err": ratio_err,
                                    "max_abs_err": float((g32[d32].double()
                                                          - g_ref[d32]).abs().max())})
        core = G._TvlCore.apply if tvl else G._KalmanCore.apply
        v64, g64 = raw_value_and_grad(yfm, s64, X64, data64, core, win)
        close(v64[d64], v_ref[d64], 1e-9, 0.0, f"{what}: f64 kernels value vs plain f64")
        grads_close(g64[d64], g_ref[d64], 1e-6, f"{what}: f64 kernels gradient vs plain f64")
        # the adjoint kernel's raw outputs, leaf by leaf, against the plain
        # adjoint on the same float64 inputs, checkpoints and gated cotangent
        args64 = [a.detach() if torch.is_tensor(a) else a for a in G.core_inputs(
            s64, yfm.transform_params(s64, X64), data64, 0, T_MONTHS, **wkw)]
        if tvl:
            bufs64 = G.lay_out_tvl(*args64[:10])
            ll64, chk64 = G.launch_forward_tvl(bufs64, args64[10])
        else:
            bufs64 = G.lay_out(*args64)
            ll64, chk64 = G.launch_forward(bufs64)
        cot = torch.rand(ll64.shape, generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev, dtype=f64) + 0.5
        cot = torch.where(torch.isfinite(ll64), cot, torch.zeros_like(cot))
        chk_ref = chk64.T.reshape(ll64.shape[0], G._seg(T_MONTHS)[1], -1)
        if tvl:
            got_leaves = G.launch_backward_tvl(bufs64, args64[10], chk64, cot)
            ref_leaves = G.adjoint_reference_tvl(*args64[:4], *args64[6:], chk_ref, cot)
        else:
            got_leaves = G.launch_backward(bufs64, chk64, cot)
            ref_leaves = G.adjoint_reference(*args64[:6], *args64[8:], chk_ref, cot)
        grad_errs[names[1] + "_leaves"].append(leaves_close(
            got_leaves, ref_leaves, 1e-6, 1e-9,
            f"{what}: f64 {names[1]} leaves vs plain f64 adjoint", rows=d64))
        if win is not None:
            bad = (~fin).nonzero().flatten().tolist()
            check(bad == [5], f"{what}: invalid draws {bad}, expected [5]")
            check(bool((g32[5] == 0).all()) and bool(torch.isfinite(v_k1[4])),
                  "invalid draw: gradient row must be 0 and its neighbour finite")
        else:
            sub = torch.arange(64, device=dev)
            _, g_auto = raw_value_and_grad(
                yfm, s64, X64[sub], data64, lambda *a: fwd_p(*a)[0])
            keep = d64[sub]
            grads_close(g_ref[sub][keep], g_auto[keep], 1e-6,
                        f"{what}: plain f64 adjoint vs autograd of the plain recursion, "
                        f"B=64 ({int(keep.sum())} determined)")

    # ---- 7. the fused MLE ----------------------------------------------------------
    S = 256
    print(f"[7] estimate: AFNS5, N=20, T=360, S={S}, max_iters=50")
    # the panel simulated from the model at the first of phase 2's draws, as
    # bench.py's newton bench simulates its panel at its draws' base point
    sim = simulate_panel(spec64, draws[1024][0].cpu().numpy(), seed=9)
    starts = make_param_batch(spec.n_params, S, seed=11)
    fits = {"AFNS5": full_width_fit(yfm, optimize, spec, spec64, sim, starts, dev)}
    print(f"[7] estimate: TVλ, N=20, T=360, S={S}, max_iters=50")
    tvl_starts = kalman_draws(tvl64, S, np.random.default_rng(13), TVL_DELTA)
    sim_tvl = simulate_panel(tvl64, tvl_starts[0], seed=17)
    fits["TVλ"] = full_width_fit(yfm, optimize, tvl32, tvl64, sim_tvl, tvl_starts, dev)
    report["estimate"] = fits

    mats6 = tuple(np.array([3, 12, 36, 84, 180, 360]) / 12.0)
    # TVλ from σ² = 0.25 stops at iteration 0, its first step −g too long
    # for 25 backtracks; from σ² = 1 it moves
    for code, obs_var in (("1C", 0.25), ("TVλ", 1.0)):
        print(f'  "{code}", N=6, T=60, S=3: the card against the CPU')
        small_fit(yfm, optimize, code, mats6, obs_var)

    # ---- 8. rolling-window re-estimation ---------------------------------------------
    W, S8 = 8, 32
    ends = [248 + 16 * w for w in range(W)]
    print(f"[8] estimate_windows: W={W} expanding windows [0, 248+16w) × S={S8} starts")
    report["estimate_windows"] = {}
    for label, s32, sim_np, starts_np in (("AFNS5", spec, sim, starts[:S8]),
                                          ("TVλ", tvl32, sim_tvl, tvl_starts[:S8])):
        report["estimate_windows"][label] = windows_fit(yfm, optimize, label, s32, sim_np,
                                                        starts_np, ends)

    head = shapes["1024"]
    kernels = [{
        "name": "K1 fused_kf", "route": "cuda",
        "source": "yieldfactormodels_jl_tpu_torch/csrc/fused_kf.cu",
        "replaces": "yieldfactormodels_jl_tpu/ops/pallas_kf.py:102",
        "launches": launches, "max_abs_err": max(errs),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "shapes": shapes,
    }]
    pairs = (("K2f", "yieldfactormodels_jl_tpu/ops/pallas_kf_grad.py:127", "AFNS5"),
             ("K2b", "yieldfactormodels_jl_tpu/ops/pallas_kf_grad.py:181", "AFNS5"),
             ("K3f", "yieldfactormodels_jl_tpu/ops/pallas_kf_grad.py:414", "TVλ"),
             ("K3b", "yieldfactormodels_jl_tpu/ops/pallas_kf_grad.py:452", "TVλ"))
    for name, replaces, fit in pairs:
        errs_k = grad_errs[name]
        err = max(errs_k) if name.endswith("f") else max(e["max_abs_err"] for e in errs_k)
        if name.startswith("K2"):
            k, by_shape = grad_shapes["1024"][name], {B: v[name] for B, v in grad_shapes.items()}
        else:
            k = tvl_shapes["1024 exact=False"][name]
            by_shape = {key: v[name] for key, v in tvl_shapes.items()}
        entry = {
            "name": f"{name} fused_kf_grad", "route": "cuda",
            "source": "yieldfactormodels_jl_tpu_torch/csrc/fused_kf_grad.cu",
            "replaces": replaces,
            "launches": fits[fit]["counts"]["forward" if name.endswith("f") else "backward"],
            "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
            "shapes": by_shape}
        if name.endswith("b"):
            entry["gradient_criterion"] = {
                key: max(e[key] for e in errs_k)
                for key in ("max_one_minus_cos", "max_norm_ratio_err")}
            entry["f64_leaf_error_over_scale"] = max(grad_errs[name + "_leaves"])
        kernels.append(entry)
    report["kernels"] = kernels
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
        with open(json_path, "w") as fh:
            json.dump(report, fh, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", metavar="PATH",
                    help="also write the full report (build, errors, timings) here")
    sys.exit(main(ap.parse_args().json))
