#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build its kernels, run its main
path, hold every kernel against its plain PyTorch version, and time it.

    python3 chip_smoke.py [--json PATH] [--only kalman,ssd,sv]
                                          # from the repository root; one CUDA card

``--only`` runs the build and the named phase groups alone (kalman: [2]–[8],
ssd: [9]–[11], sv: [12]–[14]); the kernels line then holds their kernels.

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
   versions once, at B=1024, for information.
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
9. K4 at full width — the score-driven loss kernel on bench's DNS panel
   (benchmarks/common.py's, seed 0, +4), N=20, T=360: 1SSD-NNS and SSD-NS at
   B=257 (the A×B grid around bench's ``ssd_nns_params``, filled with
   jittered copies) and B=2048.  The float64 kernel against the plain
   float64 version at rtol 1e-6, the float32 kernel against the plain
   float64 and float32 versions at rtol 2e-2 (bench.py's bar for the
   float32 kernel), each type on the draws whose loss it determines (the
   plain version moves by less than a quarter of the tolerance under ±1e-15
   resp. ±1e-7 relative nudges, and for float32 the plain float32 loss is
   within a quarter of it of the plain float64 one; with the draws that are
   −inf under every nudge, at least 85% of draws; counts printed).  Where
   the plain version is −inf under every nudge the kernel must be −inf, and
   finite where it determines a finite value.
   Then 1RWSD-NNS, 1SD-NNS-Anchored, 3SRWSD-NNS-Anchored and SRWSD-NS at
   B=512 on the panel with a NaN column at the window's first step (a
   transition-only step that is no target) and a partially NaN column
   after the window's end, window [120, 300): finite; the window [130,
   340), which observes the partial column: −Inf; an invalid draw: −Inf.
10. K4 timing — CUDA events at B=1, 23, 257, 16384 for 1SSD-NNS and SSD-NS,
    float32; the plain version once at B=257; the bound from the operation
    count of the recursion on these inputs.  Then, at B=1 in both types,
    the stage clocks of one step from the clock build of the same source
    (``fused_ssd_clocks``: clock64() stamps between the stages, which cost
    ≈2% of the time), the latency-chain bound (the dependent path of a step
    at the latencies a probe in that build measures) and the SASS
    instructions of each kernel instance and of its step loop
    (``cuobjdump``).
11. ``estimate_steps`` on bench's config 6 ("ssd-nns-m3"): 1SSD-NNS, N=20,
    T=360, the DNS panel, 3 jittered starts of ``ssd_nns_params``, the
    default groups (Nelder–Mead, 500 iterations, on the 22-parameter head;
    the closed-form (δ, Φ) solve), 10 group iterations, with the launch
    counts set to 0 just before it: K4 ≥ 1, its plain version 0.  The grid
    winner is the plain float64 version's, or their plain float64 losses
    differ by less than the float32 tolerance; the ll is finite and no
    worse than the grid winner's; the kernel-reported optimum agrees with
    the plain scan on the card at rtol 2e-2; ``predict`` with a 12-column
    NaN tail on the card matches the CPU in float64 at rtol 1e-6.  Prints
    the wall, group iterations, launches and where the wall went (K4's
    device time from CUDA events around each launch, the phases' walls).
12. K5 at full width — the SV particle filter on this file's AFNS5 panel,
    N=20, T=360, D=256 stationary draws (benchmarks/common.py's
    ``stationary_draws`` of bench's AFNS5 point, scale 0.02), P=1024 slots
    with 1000 live (config 3's work), numpy-seeded noise: the float64
    kernel against the plain float64 version at σ_h=0.2, rtol 1e-9 with
    equal −inf sets; at σ_h=0 (no resampling changes a trajectory) the
    plain float64 version against engine "sqrt" at rtol 1e-9 and the
    float32 kernel against the plain float32 version at rtol 5e-4, atol
    1e-2; the float32 kernel at σ_h=0.2 against the plain float64 version
    by paired gaps per draw (a float32 weight on a resampling boundary can
    fall either way and de-synchronise a trajectory): equal −inf sets, the
    mean gap within 3 standard errors of the gaps' spread plus the largest
    float32 gap at σ_h=0 on the same draws, the median relative gap under
    1e-4.  Then
    "1C" at D=64, P=128, the float64 kernel against the plain version at
    rtol 1e-9 on: NaN columns, ess_threshold 0 and 1.5, every offset u = 0,
    96 live of 128 slots, per-draw (φ_h, σ_h); two invalid draws in each
    (Φ₁₁ > 1 and σ² < 0) give −inf.  And at phase 14's shapes (D=392,
    P=256, 200 live, one noise pair shared by every draw as an expanded
    view): float64 at rtol 1e-9, float32 by the paired criterion.  And
    above 1,024 slots (several slots a thread, their state in the wrapper's
    scratch): AFNS5 at full width, D=16, P=1152 and 2048 (2000 live),
    float64 at rtol 1e-9 with an invalid draw −inf.
13. K5 timing — CUDA events, float32: config 3 (D=1000, P=1024, 1000
    live), the batches of phase 14's search (8 and 8×49 draws, P=256,
    200 live, on one shared noise pair) and D=64 at P=2048 (2000 live);
    the plain version once at config 3; the bound from the operation count
    of these inputs.
14. ``estimate_sv`` — AFNS5, N=20, T=360, 8 stationary starts jittered from
    bench's AFNS5 point, 200 particles, max_iters=200, with (φ_h, σ_h)
    fixed (twice, from generators seeded alike: the same result bit for
    bit) and searched, each with the launch counts set to 0 just before
    it: K5 ≥ 1, its plain version 0; finite, the best ll at least the best
    start's on the same noise, (φ_h, σ_h) in range; the wall and K5's share
    of it.  Then "1C" in float64 (T=120, 2 starts, 128 particles,
    max_iters=30) on the card against the same call on the CPU: the same
    best start, ll at rtol 1e-8, the same iterations.

Before the last line it prints the card's name and power limit (nvidia-smi)
and one JSON object {"kernels": [...]} with each kernel's launches on the
main path, error, times and bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import os
import re
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


_PHASES = []


def begin_phase(title):
    """Print a phase's header with the seconds since the script started."""
    elapsed = time.perf_counter() - _T0
    _PHASES.append((title.split("]")[0] + "]", elapsed))
    print(f"{title}  (t = {elapsed:.1f} s)")


_T0 = time.perf_counter()


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


# ---- this script's copies of benchmarks/common.py's config-6 inputs ---------

def bench_dns_panel(seed=0, lam=0.5, T=T_MONTHS):
    """benchmarks/common.py's 3-factor DNS DGP panel (N, T), level +4."""
    rng = np.random.default_rng(seed)
    tau = lam * MATURITIES
    Z = np.ones((N_MATURITIES, 3))
    Z[:, 1] = (1 - np.exp(-tau)) / tau
    Z[:, 2] = Z[:, 1] - np.exp(-tau)
    Phi = np.diag([0.98, 0.94, 0.9])
    delta = np.array([0.08, -0.06, 0.03])
    x = np.linalg.solve(np.eye(3) - Phi, delta)
    data = np.zeros((N_MATURITIES, T))
    for t in range(T):
        x = delta + Phi @ x + 0.05 * rng.standard_normal(3)
        data[:, t] = Z @ x + 0.02 * rng.standard_normal(N_MATURITIES)
    return data + 4.0


def ssd_nns_params(spec):
    """benchmarks/common.py's constrained 1SSD-NNS point (layout-driven, so
    it serves every score-driven code): A = 1e-4, B = 0.98, ω ~ N(0, 0.1²),
    δ = (0.3, −0.1, 0.05), Φ = diag(0.95, 0.9, 0.85)."""
    rng = np.random.default_rng(3)
    p = np.zeros(spec.n_params)
    p[slice(*spec.layout["A"])] = 1e-4
    if "B" in spec.layout:
        p[slice(*spec.layout["B"])] = 0.98
    lo, hi = spec.layout["omega"]
    p[lo:hi] = rng.standard_normal(hi - lo) / 10
    p[slice(*spec.layout["delta"])] = [0.3, -0.1, 0.05]
    p[slice(*spec.layout["phi"])] = np.diag([0.95, 0.9, 0.85]).T.reshape(-1)
    return p


def jitter_starts(p, n_starts, seed=1, scale=0.05):
    """benchmarks/common.py's (S, P) jittered copies of ``p``."""
    rng = np.random.default_rng(seed)
    out = np.tile(p, (n_starts, 1))
    out += scale * rng.standard_normal(out.shape) * np.maximum(np.abs(p), 0.01)[None, :]
    return out


def ssd_draws(spec, base, B, seed):
    """(B, P) draws: ``base``, its A×B initialization grid, then jittered
    copies of ``base`` (scale 0.02) up to B."""
    from yieldfactormodels_jl_tpu_torch.models.params import get_new_initial_params

    rows = [base]
    t = 1
    while len(rows) < B:
        cand = get_new_initial_params(spec, base, t)
        if cand is None:
            break
        rows.append(cand)
        t += 1
    if len(rows) < B:
        rows.extend(jitter_starts(base, B - len(rows), seed=seed, scale=0.02))
    return np.stack(rows[:B])


def ssd_determined(spec64, p64, data64, dtype, rtol, eps, start=0, end=None):
    """The draws whose score-driven loss the float type determines: the plain
    version in ``dtype`` moves by less than a quarter of rtol when the
    constrained parameters move by eps, −eps and 3·eps, relative (one
    batched call).  The recursion amplifies rounding on wild draws of the
    grid.  Returns (mask, the plain value, the mask of draws that are −inf
    under every nudge)."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_ssd

    nudges = (0.0, eps, -eps, 3 * eps)
    pd = p64.to(dtype)
    ll = fused_ssd.batched_loss_reference(  # in the tensors' type
        spec64, torch.cat([pd * (1 + n) for n in nudges]), data64.to(dtype), start,
        end).reshape(len(nudges), -1)
    ref = ll[0]
    det = torch.isfinite(ref) & ((ll[1:] - ref).abs() <= rtol * ref.abs() / 4).all(0)
    return det, ref, (ll == -math.inf).all(0)


def ssd_flops(spec, data, start=0, end=None):
    """Operations of one draw's score-driven pass on this panel and window,
    each arithmetic operation, tanh, exp, sqrt and pow counted once.  Per
    observed step: two loading builds (the third, Z of the next γ, is the
    next step's first), two OLS (seven maturity sums, 2 each, and ≈30 for
    the 3×3 Cholesky, its ridge twin and the solves), the inner sweep and
    the L-wide γ step (≈9 a value), ν + Bγ, and Φβ (21); an unobserved step
    keeps the transition (with a build under AR(1) dynamics); the random
    walk builds once an observed step; each contributing step adds the
    prediction error (7 a maturity); Z(ω) is built once.  Neural: a build is ≈38 a maturity (two 1→3→1 nets 28,
    the two shape transforms 10) + 10, the sweep ≈83 a maturity (residual,
    transform adjoints, the 18 MLP sums) + 20.  λ: a build 7 a maturity
    + 2, the sweep 22 + 2."""
    N, T = data.shape
    if end is None:
        end = T
    neural = spec.family == "msed_neural"
    L = spec.L
    build = 38 * N + 10 if neural else 7 * N + 2
    sweep = 83 * N + 20 if neural else 22 * N + 2
    ols = 12 * N + 30
    gamma_T = 2 * L if not spec.random_walk else 0
    finite0 = torch.isfinite(data[0]).cpu()
    ar1 = not spec.random_walk
    flops = build
    for t in range(T - 1):
        obs = start <= t < end and bool(finite0[t])
        if obs:
            flops += (1 + ar1) * build + 2 * ols + sweep + N + 9 * L
        else:
            flops += ar1 * build
        flops += gamma_T + 21
        if start <= t <= end - 2:
            flops += 7 * N + 1
    return flops


#: K4's stage clocks, in the order of fused_ssd.cu's Stage enum: the chain
#: warp's stages, then the helper warp's waiting and working cycles
SSD_STAGES = ("head", "ols1", "score1", "score2", "score3", "update", "build_obs",
              "transition", "handoff", "stamp_pair", "helper_wait", "helper_work")
#: operation classes of fused_ssd.cu's latency probe, in its LatOp order
SSD_LAT_OPS = ("add", "mul", "div", "sqrt", "tanh", "exp", "shfl", "stamp")


def ssd_stage_clocks(fused_ssd, spec, params, data, reps=3):
    """K4's cycles by stage at one draw (the clock build, ``fused_ssd_clocks``:
    the same source with clock64() stamps between a step's stages, draw 0,
    lane 0 of each warp), from the last of ``reps`` launches; cycles a step,
    averaged over the T−1 steps (every step of the full panel is observed);
    the loop is the chain warp's.  Also the launch's time with the stamps
    on."""
    from yieldfactormodels_jl_tpu_torch.ops import _build

    lib = _build.load("fused_ssd_clocks")
    inputs = fused_ssd.kernel_inputs(spec, params, data, 0, data.shape[1])
    clocks = torch.zeros(len(SSD_STAGES) + 3, dtype=torch.int64, device=params.device)
    consts = [ctypes.c_double(c) for c in inputs.consts]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.yfm_fused_ssd_clocks(*inputs.ints, *consts,
                                       *(x.data_ptr() for x in inputs.buffers),
                                       inputs.out.data_ptr(), clocks.data_ptr(), stream)
        check(err == 0, f"clock build launch failed: cudaError {err}")

    ms = cuda_ms(run, reps=reps, warmup=1)
    c = clocks.cpu().tolist()
    steps, n_obs, loop = c[-3:]
    per_step = {name: c[q] / steps for q, name in enumerate(SSD_STAGES)}
    return {"cycles_per_step": per_step, "loop_cycles_per_step": loop / steps,
            "steps": steps, "observed_steps": n_obs, "ms_with_stamps": ms}


def ssd_latencies(dtype, dev):
    """Cycles of one dependent operation of each class on one warp, in
    ``dtype``, from the clock build's latency probe (128 in a chain)."""
    from yieldfactormodels_jl_tpu_torch.ops import _build

    lib = _build.load("fused_ssd_clocks")
    out = torch.zeros(len(SSD_LAT_OPS), dtype=torch.int64, device=dev)
    sink = torch.zeros(32, dtype=dtype, device=dev)
    for _ in range(2):  # the second launch runs from a warm instruction cache
        err = lib.yfm_ssd_latencies(0 if dtype == torch.float32 else 1, out.data_ptr(),
                                    sink.data_ptr(), torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"latency probe launch failed: cudaError {err}")
    torch.cuda.synchronize()
    return {name: v / 128 for name, v in zip(SSD_LAT_OPS, out.cpu().tolist())}


def ssd_chain_counts(spec):
    """The dependent path of one observed step of the score-driven recursion
    and of one unobserved step, by operation class, with every per-maturity
    operation on its own lane and every sum over maturities a 5-level
    shuffle tree (add and mul each counted once where they chain).  An
    observed step's path is OLS on Z(γ_t) → the inner score → the γ step →
    Z(γ_obs) → (AR(1)) ν + Bγ → Z(γ_next); the re-OLS and the loss feed only
    the loss and β, which the next step's path does not wait for.

    - OLS: the products (mul), five levels (shfl + add), the 3×3 Cholesky's
      dependent l21, l22, l32, l33 (2 sqrt, 2 div) and the back-substitution
      (4 div), ≈14 add/mul between them.
    - neural build (transformed): tanh(W₁τ + b₁) (mul, add, tanh), W₂·h
      (mul, add, add), the curvature transform's broadcast (shfl), slope
      (add, div), r and r² (≈6 add/mul), Σr2² (five levels), √S/scale + ε
      (sqrt, div, add) and r2/d (div).  λ: e^γ, e^{−λτ} (2 exp), z₂, z₃
      (add, mul, div, add, add).
    - neural score: v (mul, 3 add), ō (mul), the three rounds (five levels
      each, the first two after a mul), the curvature adjoint between them
      (div, ≈6 add/mul), the MLP parameter products (3 mul).  λ: v, the
      score term (mul, add, mul) and one sum (five levels), ×(λ − 0.01).
    - γ step: EWMA (3 mul, 3 add, 2 div, 1 sqrt) or plain (mul, add), then
      one broadcast of the new γ (shfl); AR(1): ν + Bγ (mul, add)."""
    neural = spec.family == "msed_neural"
    ols = {"mul": 7, "add": 8 + 5, "shfl": 5, "div": 6, "sqrt": 2}
    if neural:
        build = {"mul": 6, "add": 8 + 5, "tanh": 1, "shfl": 1 + 5, "div": 3, "sqrt": 1}
        score = {"mul": 10, "add": 6 + 15, "shfl": 15, "div": 1}
    else:
        build = {"exp": 2, "add": 3, "mul": 1, "div": 1}
        score = {"mul": 4, "add": 4 + 5, "shfl": 5}
    step = ({"mul": 3, "add": 3, "div": 2, "sqrt": 1, "shfl": 1} if spec.scale_grad
            else {"mul": 1, "add": 1, "shfl": 1})
    ar1 = not spec.random_walk
    observed, unobserved = {}, {}
    parts = [ols, score, step, build] + ([{"mul": 1, "add": 1}, build] if ar1 else [])
    for part in parts:
        for k, v in part.items():
            observed[k] = observed.get(k, 0) + v
    if ar1:
        for part in ({"mul": 1, "add": 1}, build):
            for k, v in part.items():
                unobserved[k] = unobserved.get(k, 0) + v
    return observed, unobserved


def ssd_chain_ms(spec, data, latencies, clock_mhz, start=0, end=None):
    """K4's latency-chain bound at one draw: the dependent path of every
    step (``ssd_chain_counts``) at the measured cycles of each operation
    class (``ssd_latencies``), over this panel's observed and unobserved
    steps, at the card's maximum SM clock."""
    N, T = data.shape
    if end is None:
        end = T
    observed, unobserved = ssd_chain_counts(spec)
    finite0 = torch.isfinite(data[0]).cpu()
    n_obs = sum(1 for t in range(T - 1) if start <= t < end and bool(finite0[t]))

    def cycles(counts):
        return sum(v * latencies[k] for k, v in counts.items())

    total = n_obs * cycles(observed) + (T - 1 - n_obs) * cycles(unobserved)
    return total / (clock_mhz * 1e6) * 1e3, cycles(observed)


def sass_loop_counts(lib_path, needle="ssd_loss_kernel"):
    """SASS instructions of each compiled ``needle`` kernel in a library
    (``cuobjdump -sass``): the whole function, and its step loop — the
    instructions from the target of its widest backward branch to that
    branch.  Keyed by the kernel's template arguments as they appear in its
    mangled name; None when the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(_nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if needle not in name:
            continue
        addrs, labels, branches = [], {}, []
        for line in block.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                labels[m.group(1)] = len(addrs)
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if not m:
                continue
            addrs.append(int(m.group(1), 16))
            b = re.search(r"\bBRA(?:\.\w+)*\s+`?\(?(0x[0-9a-f]+|\.L_x_\d+)", m.group(2))
            if b:
                branches.append((len(addrs) - 1, b.group(1)))
        index = {a: i for i, a in enumerate(addrs)}
        span = 0
        for i, target in branches:
            j = labels.get(target) if target.startswith(".L") else index.get(int(target, 16))
            if j is not None and j <= i:
                span = max(span, i - j + 1)
        args = re.search(needle + r"I([fd])Lb([01])ELi(\d+)E(?:Lb([01])E)?", name)
        key = name if args is None else (
            f"{'f32' if args.group(1) == 'f' else 'f64'} "
            f"{'neural' if args.group(2) == '1' else 'λ'} PL={args.group(3)}"
            + ("" if args.group(4) is None else
               (" AR(1)" if args.group(4) == "1" else " random walk")))
        out[key] = {"instructions": len(addrs), "step_loop": span}
    return out


def _nvcc_path():
    from yieldfactormodels_jl_tpu_torch.ops import _build

    return _build._nvcc()


@contextlib.contextmanager
def timed_estimate_steps(optimize, fused_ssd):
    """Time the phases of ``estimate_steps`` inside the block: the grid
    (``try_initializations``), the Nelder–Mead groups, the closed-form
    groups and the trust-but-verify re-evaluation, each by its wall after a
    synchronize; and K4's device time, from CUDA events around every launch
    (with its batch size and the phase it ran in).  Yields the dict that
    fills in."""
    acc = {"grid_s": 0.0, "neldermead_s": 0.0, "closed_s": 0.0, "verify_s": 0.0,
           "k4_events": [], "grid_winner": None, "active": "other"}
    names = {"try_initializations": "grid_s", "_neldermead_group": "neldermead_s",
             "_msed_closed_group": "closed_s", "_trust_but_verify": "verify_s"}
    saved = {name: getattr(optimize, name) for name in names}
    launch = fused_ssd.launch

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc["active"] = names[name]
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc["active"] = "other"
            acc[names[name]] += time.perf_counter() - t0
            if name == "try_initializations":
                acc["grid_winner"] = out
            return out
        return run

    def timed_launch(inputs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = launch(inputs)
        e1.record()
        acc["k4_events"].append((inputs.out.shape[0], acc["active"], e0, e1))
        return out

    for name, fn in saved.items():
        setattr(optimize, name, timed(name, fn))
    fused_ssd.launch = timed_launch
    try:
        yield acc
    finally:
        for name, fn in saved.items():
            setattr(optimize, name, fn)
        fused_ssd.launch = launch


# ---- the SV particle filter (K5) and estimate_sv: phases 12–14 -------------

def afns5_point(n_params):
    """bench.py's constrained AFNS5 point (the base of make_param_batch)."""
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
    return p


def stationary_draws(spec, p, n_draws, seed=1, scale=0.02):
    """benchmarks/common.py's jittered draws with Φ rescaled by 0.995/ρ(Φ)
    where its spectral radius reaches 1."""
    draws = jitter_starts(p, n_draws, seed=seed, scale=scale)
    lo, hi = spec.layout["phi"]
    Ms = spec.state_dim
    for i in range(n_draws):
        Phi = draws[i, lo:hi].reshape(Ms, Ms)
        rho = float(np.max(np.abs(np.linalg.eigvals(Phi))))
        if rho >= 1.0:
            draws[i, lo:hi] = (Phi * (0.995 / rho)).reshape(-1)
    return draws


def pf_flops(Ms, N, n_live, draws, finite_cols):
    """Operations of the SV filter that every run on these inputs needs, a
    fused multiply-add counted as two: per live particle and step the
    proposal (6: h, e^h, r, √r); per observed update 6Ms² + 7Ms + 15 (Sᵀz
    and Sφ 2Ms² each, the rank-1 downdate 2Ms² + Ms with Sφ scaled by α
    once, f, v, β and the log-likelihood term with its log, divide and
    square root); the propagation 2Ms² + Ms (β) + 2Ms³ (ΦS) and the
    Cholesky of A Aᵀ + Ω (2Ms + 1 an entry plus 2 per earlier column, and Ms
    square roots); the weights 10 and, on a contributing step, the ESS 3.  A
    NaN column's step needs no update (β and S carry over), so only the
    observed columns' updates count.  Resampling is left out: how often it
    fires depends on the run.  ``finite_cols`` flags the T − 1 steps'
    columns."""
    steps = len(finite_cols)
    obs = int(sum(finite_cols))
    contrib = int(sum(finite_cols[1:]))
    chol = sum(2 * Ms + 1 + 2 * j for i in range(Ms) for j in range(i + 1)) + Ms
    per_step = 6 + 2 * Ms * Ms + Ms + 2 * Ms ** 3 + chol + 10
    per_update = 6 * Ms * Ms + 7 * Ms + 15
    return draws * n_live * (steps * per_step + obs * N * per_update + contrib * 3)


def storage_bytes(x):
    """Bytes of the distinct elements a tensor reads: an expanded (stride-0)
    axis counts once."""
    n = 1
    for size, stride in zip(x.shape, x.stride()):
        if stride != 0:
            n *= size
    return n * x.element_size()


def pf_work(inputs, spec, finite_cols):
    """(bytes, flops) of one K5 launch: every input read once (the noise
    once however many draws share it), the output written once."""
    T, N = inputs.panel.shape
    bytes_ = (nbytes(inputs.rows, inputs.panel, inputs.out) + storage_bytes(inputs.normals)
              + storage_bytes(inputs.uniforms))
    return bytes_, pf_flops(spec.state_dim, N, inputs.n_eff, inputs.rows.shape[0],
                            finite_cols)


def pf_distribution(got, ref, got0, ref0, what):
    """A float32 filter against the float64 one where resampling fires, so
    that a weight on a resampling boundary may fall either way and
    de-synchronise a draw's trajectory: equal −inf sets; the paired gaps
    got − ref with their mean within 3 standard errors of their own spread
    plus the float32 rounding allowance, the largest gap at σ_h = 0 on the
    same draws and noise (``got0``/``ref0``: no resampling, so float32
    rounding alone); and the median relative gap per draw under 1e-4, a
    fifth of the elementwise float32 rtol."""
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    check(np.array_equal(np.isfinite(got), np.isfinite(ref)), f"{what}: −inf sets differ")
    fin = np.isfinite(ref)
    check(fin.sum() >= 2, f"{what}: fewer than 2 finite draws")
    got0, ref0 = got0.double().cpu().numpy(), ref0.double().cpu().numpy()
    fin0 = np.isfinite(ref0) & np.isfinite(got0)
    check(fin0.any(), f"{what}: no finite draw at σ_h = 0")
    rounding = float(np.abs(got0[fin0] - ref0[fin0]).max())
    gaps = got[fin] - ref[fin]
    se = float(np.std(gaps, ddof=1)) / math.sqrt(fin.sum())
    mean_gap = abs(float(np.mean(gaps)))
    tol = 3.0 * se + rounding
    check(mean_gap <= tol, f"{what}: mean paired gap {mean_gap:.4f} > 3 SE {3 * se:.4f} "
          f"+ rounding {rounding:.4f}")
    med_rel = float(np.median(np.abs(gaps) / np.abs(ref[fin])))
    check(med_rel < 1e-4, f"{what}: median relative gap {med_rel:.3e} ≥ 1e-4")
    print(f"  {what}: ok, {int(fin.sum())} finite, mean paired gap {mean_gap:.4f} ≤ 3 SE "
          f"{3 * se:.4f} + rounding {rounding:.4f}; median relative gap {med_rel:.3e} < 1e-4; "
          f"max abs gap {np.abs(gaps).max():.3e}")
    return float(np.abs(gaps).max())


@contextlib.contextmanager
def timed_pf_launches(fused_pf):
    """CUDA events around every K5 launch inside the block; yields the list
    of (draws, start event, stop event)."""
    events = []
    launch = fused_pf.launch

    def timed(inputs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = launch(inputs)
        e1.record()
        events.append((inputs.rows.shape[0], e0, e1))
        return out

    fused_pf.launch = timed
    try:
        yield events
    finally:
        fused_pf.launch = launch


def sv_phases(yfm, dev, report):
    """Phases 12–14: K5 against its plain version at full width and on the
    edge cases, its timing, and estimate_sv on the card.  Returns K5's entry
    of the kernels line."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_pf, sqrt_kf
    from yieldfactormodels_jl_tpu_torch.ops.particle import draw_noise

    f32, f64 = torch.float32, torch.float64
    bp, ref_calls = fused_pf.pf_loglik_batch, fused_pf.reference

    # ---- 12. K5 at full width ----------------------------------------------------
    begin_phase("[12] K5 (SV particle filter) at full width: AFNS5, N=20, T=360, D=256, "
          "P=1024, 1000 live")
    spec, _ = yfm.create_model("AFNS5", MATURITIES)
    spec64, _ = yfm.create_model("AFNS5", MATURITIES, float_type="float64")
    panel64 = torch.as_tensor(make_panel(seed=0), device=dev, dtype=f64)
    base = afns5_point(spec.n_params)
    D, Pn, n_live = 256, 1024, 1000
    rng = np.random.default_rng(12)
    p64 = torch.as_tensor(stationary_draws(spec64, base, D), device=dev, dtype=f64)
    nz64 = torch.as_tensor(rng.standard_normal((D, T_MONTHS - 1, Pn)), device=dev)
    u64 = torch.as_tensor(rng.uniform(size=(D, T_MONTHS - 1)), device=dev)
    args64 = (p64, panel64, nz64, u64)
    args32 = tuple(x.float() for x in args64)
    pf_errs = []
    got64 = bp(spec64, *args64, n_particles=n_live)
    ref64 = fused_pf.pf_loglik_batch_reference(spec64, *args64, n_particles=n_live)
    check(int(torch.isfinite(ref64).sum()) >= 0.9 * D, "too few finite draws at σ_h=0.2")
    close(got64, ref64, 1e-9, 0.0, "σ_h=0.2 f64 kernel vs plain f64")
    ref0_64 = fused_pf.pf_loglik_batch_reference(spec64, *args64, n_particles=n_live,
                                                 sv_sigma=0.0)
    close(ref0_64, sqrt_kf.get_loss(spec64, p64, panel64), 1e-9, 0.0,
          "σ_h=0 plain f64 vs engine \"sqrt\"")
    got0_32 = bp(spec, *args32, n_particles=n_live, sv_sigma=0.0)
    ref0_32 = fused_pf.pf_loglik_batch_reference(spec, *args32, n_particles=n_live,
                                                 sv_sigma=0.0)
    pf_errs.append(close(got0_32, ref0_32, 5e-4, 1e-2, "σ_h=0 f32 kernel vs plain f32"))
    got32 = bp(spec, *args32, n_particles=n_live)
    pf_errs.append(pf_distribution(got32, ref64, got0_32, ref0_64,
                                   "σ_h=0.2 f32 kernel vs plain f64 (paired)"))
    del nz64, args64, args32

    print("  estimate_sv's shapes: D=392, P=256, 200 live, one noise pair shared by "
          "every draw (an expanded view)")
    rng = np.random.default_rng(16)
    pe = torch.as_tensor(stationary_draws(spec64, base, 392, seed=3), device=dev, dtype=f64)
    nz1 = torch.as_tensor(rng.standard_normal((T_MONTHS - 1, 256)), device=dev)
    u1 = torch.as_tensor(rng.uniform(size=T_MONTHS - 1), device=dev)
    args_e = (pe, panel64, nz1.expand(392, -1, -1), u1.expand(392, -1))
    ref_e = fused_pf.pf_loglik_batch_reference(spec64, *args_e, n_particles=200)
    close(bp(spec64, *args_e, n_particles=200), ref_e, 1e-9, 0.0,
          "shared noise f64 kernel vs plain f64")
    args_e32 = tuple(x.float() for x in args_e)
    pf_errs.append(pf_distribution(
        bp(spec, *args_e32, n_particles=200), ref_e,
        bp(spec, *args_e32, n_particles=200, sv_sigma=0.0),
        fused_pf.pf_loglik_batch_reference(spec64, *args_e, n_particles=200, sv_sigma=0.0),
        "shared noise f32 kernel vs plain f64 (paired)"))

    print("  \"1C\" edge cases, D=64, P=128, f64 kernel vs plain f64 at rtol 1e-9")
    dns64, _ = yfm.create_model("1C", MATURITIES, float_type="float64")
    Dc, Pc = 64, 128
    rng = np.random.default_rng(13)
    pc = kalman_draws(dns64, Dc, rng, [0.4, -0.1, 0.05])
    pc[0, dns64.layout["phi"][0]] = 1.5           # Φ₁₁ > 1: P₀ fails to factor
    pc[1, dns64.layout["obs_var"][0]] = -4e-4     # σ² < 0: f ≤ 0
    pc = torch.as_tensor(pc, device=dev)
    dpanel = make_dns_panel(seed=2)
    dpanel64 = torch.as_tensor(dpanel, device=dev)
    nan_panel = dpanel.copy()
    nan_panel[:, 40] = np.nan
    nan_panel[7, 200] = np.nan
    nzc = torch.as_tensor(rng.standard_normal((Dc, T_MONTHS - 1, Pc)), device=dev)
    uc = torch.as_tensor(rng.uniform(size=(Dc, T_MONTHS - 1)), device=dev)
    phis = torch.linspace(0.5, 0.98, Dc, device=dev, dtype=f64)
    sigs = torch.linspace(0.05, 0.5, Dc, device=dev, dtype=f64)
    edge = {"NaN columns": ({}, torch.as_tensor(nan_panel, device=dev), uc),
            "ess_threshold 0": ({"ess_threshold": 0.0}, dpanel64, uc),
            "ess_threshold 1.5": ({"ess_threshold": 1.5}, dpanel64, uc),
            "all offsets u = 0": ({"ess_threshold": 1.5}, dpanel64, torch.zeros_like(uc)),
            "96 live of 128": ({"n_particles": 96}, dpanel64, uc),
            "per-draw (φ_h, σ_h)": ({"sv_phi": phis, "sv_sigma": sigs}, dpanel64, uc)}
    for what, (kw, data, u) in edge.items():
        got = bp(dns64, pc, data, nzc, u, **kw)
        ref = fused_pf.pf_loglik_batch_reference(dns64, pc, data, nzc, u, **kw)
        g = got.cpu()
        check(g[0] == -math.inf and g[1] == -math.inf,
              f"{what}: the invalid draws must give −inf, got {g[:2].tolist()}")
        check(int(torch.isfinite(ref).sum()) == Dc - 2, f"{what}: a valid draw is not finite")
        close(got, ref, 1e-9, 0.0, f"1C {what}")

    print("  above 1,024 slots (several slots a thread, state in scratch): AFNS5, D=16, "
          "P=1152 and 2048 (2000 live), f64 kernel vs plain f64 at rtol 1e-9")
    rng = np.random.default_rng(17)
    pm = stationary_draws(spec64, base, 16, seed=4)
    pm[3, spec64.layout["phi"][0]] = 1.5          # Φ₁₁ > 1: −inf
    pm = torch.as_tensor(pm, device=dev, dtype=f64)
    for Pm, live in ((1152, 1152), (2048, 2000)):
        nzm = torch.as_tensor(rng.standard_normal((16, T_MONTHS - 1, Pm)), device=dev)
        um = torch.as_tensor(rng.uniform(size=(16, T_MONTHS - 1)), device=dev)
        got = bp(spec64, pm, panel64, nzm, um, n_particles=live)
        ref = fused_pf.pf_loglik_batch_reference(spec64, pm, panel64, nzm, um,
                                                 n_particles=live)
        check(bool(got[3] == -math.inf) and int(torch.isfinite(ref).sum()) >= 14,
              f"P={Pm}: the invalid draw must give −inf and the rest be finite")
        close(got, ref, 1e-9, 0.0, f"P={Pm}, {live} live f64 kernel vs plain f64")

    # ---- 13. K5 timing ----------------------------------------------------------------
    begin_phase("[13] K5 timing (CUDA events), float32")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    panel32 = panel64.float()
    finite_cols = torch.isfinite(panel32).all(0).tolist()[:T_MONTHS - 1]
    rng = np.random.default_rng(14)
    shapes = {}
    P_sv, n_sv, S_sv = 256, 200, 8
    nz_sv = torch.as_tensor(rng.standard_normal((T_MONTHS - 1, P_sv)), device=dev, dtype=f32)
    u_sv = torch.as_tensor(rng.uniform(size=T_MONTHS - 1), device=dev, dtype=f32)
    for label, Dt, Pt, live in (("config 3", 1000, 1024, 1000),
                                (f"estimate_sv step, {S_sv} starts", S_sv, P_sv, n_sv),
                                (f"estimate_sv simplex, {S_sv}x49", S_sv * 49, P_sv, n_sv),
                                ("above 1,024 slots", 64, 2048, 2000)):
        pt = torch.as_tensor(stationary_draws(spec, base, Dt, seed=2), device=dev, dtype=f32)
        if Pt >= 1024:
            nzt = torch.randn((Dt, T_MONTHS - 1, Pt), device=dev, dtype=f32,
                              generator=torch.Generator(device=dev).manual_seed(3))
            ut = torch.rand((Dt, T_MONTHS - 1), device=dev, dtype=f32,
                            generator=torch.Generator(device=dev).manual_seed(4))
        else:
            nzt, ut = nz_sv.expand(Dt, T_MONTHS - 1, Pt), u_sv.expand(Dt, T_MONTHS - 1)
        inputs = fused_pf.kernel_inputs(spec, pt, panel32, nzt, ut, live, 0.95, 0.2, 0.5)
        ms = cuda_ms(lambda: fused_pf.launch(inputs), reps=3 if Dt >= 1000 else 20, warmup=1)
        bytes_, flops = pf_work(inputs, spec, finite_cols)
        bound_ms, bound_by = bound(bytes_, flops)
        row = {"D": Dt, "P": Pt, "n_live": live, "ms": ms, "bytes": bytes_, "flops": flops,
               "bound_ms": bound_ms, "bound_by": bound_by, "plain_ms": None,
               "particle_steps_per_s": Dt * live * (T_MONTHS - 1) / (ms * 1e-3)}
        if label == "config 3":
            row["plain_ms"] = cuda_ms(lambda: fused_pf.reference(inputs), reps=1, warmup=0)
            del nzt
        shapes[label] = row
        plain_txt = "" if row["plain_ms"] is None else f", plain {row['plain_ms']:.1f} ms"
        print(f"  {label} (D={Dt}, P={Pt}, {live} live): kernel {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; "
              f"{flops / (Dt * live * (T_MONTHS - 1)):.0f} flop a particle-step, "
              f"{bytes_ / 1e6:.1f} MB){plain_txt}")
    report["k5_shapes"] = shapes
    report["k5_clock_mhz"] = clock_mhz

    # ---- 14. estimate_sv on the card --------------------------------------------------
    begin_phase(f"[14] estimate_sv: AFNS5, N=20, T=360, S={S_sv} starts, {n_sv} particles, "
          f"max_iters=200")
    panel_np = make_panel(seed=0)
    starts = stationary_draws(spec, base, S_sv, seed=5)
    raw = yfm.untransform_params(spec, torch.as_tensor(starts)).numpy()
    sv_runs = {}
    with timed_pf_launches(fused_pf) as events:
        for label, full in (("fixed (φ_h, σ_h)", False), ("fixed, again", False),
                            ("(φ_h, σ_h) searched", True)):
            events.clear()
            bp.launches = 0
            ref_calls.calls = 0
            t0 = time.perf_counter()
            out = yfm.estimate_sv(spec, panel_np, raw,
                                  torch.Generator(device=dev).manual_seed(21),
                                  n_particles=n_sv, max_iters=200, estimate_sv_params=full)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k5_s = sum(e0.elapsed_time(e1) for _, e0, e1 in events) / 1e3
            by_batch = {}
            for Db, _, _ in events:
                by_batch[Db] = by_batch.get(Db, 0) + 1
            run = {"ll": out[1], "lls": out[2].tolist(), "iters": out[3].tolist(),
                   "best": out[0], "wall_s": wall, "k5_s": k5_s, "launches": bp.launches,
                   "launches_by_batch": by_batch, "plain_calls": ref_calls.calls}
            if full:
                run["sv_hat"] = out[4]
            sv_runs[label] = run
            print(f"  {label}: ll {out[1]:.6f}, iterations {out[3].tolist()}, launches "
                  f"{bp.launches} (by batch {by_batch}), plain {ref_calls.calls}; wall "
                  f"{wall:.2f} s, K5 on the card {k5_s:.2f} s ({100 * k5_s / wall:.1f}%)"
                  + (f"; (φ_h, σ_h) = ({out[4][0]:.4f}, {out[4][1]:.4f})" if full else ""))
            check(bp.launches >= 1, f"estimate_sv {label}: K5 never launched")
            check(ref_calls.calls == 0, f"estimate_sv {label}: the plain version ran")
            check(math.isfinite(out[1]), f"estimate_sv {label}: non-finite ll")
            if full:
                check(-1.0 < out[4][0] < 1.0 and out[4][1] > 0.0,
                      f"estimate_sv: (φ_h, σ_h) = {out[4]} out of range")
    a, b = sv_runs["fixed (φ_h, σ_h)"], sv_runs["fixed, again"]
    check(a["ll"] == b["ll"] and np.array_equal(a["best"], b["best"])
          and a["iters"] == b["iters"], "estimate_sv: a second call with the same "
          "generator differs")
    gen = torch.Generator(device=dev).manual_seed(21)
    nz_s, u_s = draw_noise(T_MONTHS, P_sv, gen, f32, dev)
    ll_starts = bp(spec, yfm.transform_params(spec, torch.as_tensor(raw, device=dev,
                                                                    dtype=f32)),
                   panel_np, nz_s.expand(S_sv, -1, -1), u_s.expand(S_sv, -1),
                   n_particles=n_sv)
    best_start = float(ll_starts.max())
    check(a["ll"] >= best_start, f"estimate_sv: ll {a['ll']} below the best start's "
          f"{best_start}")
    print(f"  deterministic: ok; best ll {a['ll']:.6f} ≥ best start {best_start:.6f}")

    print("  \"1C\" f64 on the card vs the CPU: T=120, S=2, P=128, max_iters=30")
    dns_starts = kalman_draws(dns64, 2, np.random.default_rng(15), [0.4, -0.1, 0.05])
    raw_c = yfm.untransform_params(dns64, torch.as_tensor(dns_starts)).numpy()
    small = dpanel[:, :120]
    gen = torch.Generator().manual_seed(16)
    noise = (torch.randn(119, 128, generator=gen, dtype=f64),
             torch.rand(119, generator=gen, dtype=f64))
    kw = dict(n_particles=128, max_iters=30, noise=noise)
    on_card = yfm.estimate_sv(dns64, small, raw_c, **kw)
    on_cpu = yfm.estimate_sv(dns64, small, raw_c, device="cpu", **kw)
    check(int(np.argmax(on_card[2])) == int(np.argmax(on_cpu[2])),
          "estimate_sv card vs CPU: another best start")
    check(np.array_equal(on_card[3], on_cpu[3]), f"estimate_sv card vs CPU: iterations "
          f"{on_card[3]} vs {on_cpu[3]}")
    check(abs(on_card[1] - on_cpu[1]) <= 1e-8 * abs(on_cpu[1]),
          f"estimate_sv card vs CPU: ll {on_card[1]} vs {on_cpu[1]}")
    print(f"  ok: ll {on_card[1]:.10f} vs {on_cpu[1]:.10f}, iterations {on_card[3].tolist()}")
    report["estimate_sv"] = {k: {kk: (vv.tolist() if isinstance(vv, np.ndarray) else vv)
                                 for kk, vv in v.items()} for k, v in sv_runs.items()}
    report["estimate_sv"]["best_start_ll"] = best_start

    head = shapes["config 3"]
    return {
        "name": "K5 fused_pf", "route": "cuda",
        "source": "yieldfactormodels_jl_tpu_torch/csrc/fused_pf.cu",
        "replaces": "yieldfactormodels_jl_tpu/ops/pallas_pf.py:56",
        "launches": sv_runs["fixed (φ_h, σ_h)"]["launches"], "max_abs_err": max(pf_errs),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None, "shapes": shapes}


def kalman_phases(yfm, dev, report):
    """Phases 2–8: K1–K3 on the Kalman main path, their checks and timing,
    ``estimate`` and ``estimate_windows``.  Returns the kernels line's
    entries of K1, K2f, K2b, K3f and K3b."""
    from yieldfactormodels_jl_tpu_torch.estimation import optimize
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    f32, f64 = torch.float32, torch.float64

    # ---- 2. full width: the main path -----------------------------------------
    begin_phase("[2] full width: AFNS5, N=20, T=360")
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
    begin_phase("[3] other families at B=2048")
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
    begin_phase("[4] forecast: predict from the best draw, 12-step NaN tail")
    cpu = yfm.predict(spec64, cons[1024][best].cpu().numpy(), panel_ext, device="cpu")
    for key, val in forecast.items():
        check(val.shape == cpu[key].shape, f"predict {key}: {val.shape} vs {cpu[key].shape}")
        check(bool(torch.isfinite(val).all()), f"predict {key}: non-finite")
        close(val, cpu[key], 1e-9, 1e-9, f"predict {key} card vs CPU")
    check(forecast["preds"].shape == (N_MATURITIES, T_MONTHS + 12), "preds shape")

    # ---- 5. timing ---------------------------------------------------------------
    begin_phase("[5] timing (CUDA events)")
    shapes, grad_shapes, tvl_shapes = {}, {}, {}
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    panel32 = torch.as_tensor(panel, device=dev, dtype=f32)
    _, vag32 = optimize.fused_objectives(spec, panel32, 0, T_MONTHS)
    for B in sizes:
        p32 = cons[B].to(f32)
        inputs = fused_kf.kernel_inputs(spec, p32, panel32, 0, T_MONTHS)
        ms = cuda_ms(lambda: fused_kf.launch(inputs), reps=20)
        entry_ms = cuda_ms(lambda: yfm.batched_loglik(spec, p32, panel32), reps=10)
        plain_ms = None  # the plain versions are timed once, at B=1024
        if B == 1024:
            plain_ms = cuda_ms(lambda: fused_kf.batched_loglik_reference(spec, p32, panel32),
                               reps=1, warmup=0)
        bytes_, flops = kernel_work(inputs, panel32)
        bound_ms, bound_by = bound(bytes_, flops)
        shapes[str(B)] = {
            "ms": ms, "entry_ms": entry_ms, "plain_ms": plain_ms,
            "evals_per_s": B / (ms * 1e-3), "bytes": bytes_, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "chain_ms": chain_ms(spec.state_dim, N_MATURITIES, T_MONTHS, clock_mhz)}
        plain_txt = "" if plain_ms is None else f", plain {plain_ms:.1f} ms"
        print(f"  K1 B={B}: kernel {ms:.4f} ms ({B / (ms * 1e-3):.0f} evals/s), "
              f"entry point {entry_ms:.4f} ms{plain_txt}, "
              f"bound {bound_ms:.4f} ms ({flops / B:.0f} flop/draw), "
              f"serial-chain estimate {shapes[str(B)]['chain_ms']:.4f} ms")

        args = G.core_inputs(spec, p32, panel32, 0, T_MONTHS)
        bufs = G.lay_out(*args)
        out, chk = G.launch_forward(bufs)
        g = torch.ones(B, device=dev, dtype=f32)
        grads = G.launch_backward(bufs, chk, g)
        fwd_ms = cuda_ms(lambda: G.launch_forward(bufs), reps=10)
        bwd_ms = cuda_ms(lambda: G.launch_backward(bufs, chk, g), reps=5)
        fwd_plain_ms = bwd_plain_ms = None
        if B == 1024:
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
        fp_txt = "" if fwd_plain_ms is None else f", plain {fwd_plain_ms:.1f} ms"
        bp_txt = "" if bwd_plain_ms is None else f", plain {bwd_plain_ms:.1f} ms"
        print(f"  K2f B={B}: kernel {fwd_ms:.4f} ms{fp_txt}, "
              f"bound {f_bound:.4f} ms ({f_by})")
        print(f"  K2b B={B}: kernel {bwd_ms:.4f} ms{bp_txt}, "
              f"bound {b_bound:.4f} ms ({b_by}; {bf / B:.0f} flop/draw needed, "
              f"{bf_run / B:.0f} run by the kernel)")
        print(f"  value-and-gradient through the fused objective B={B}: "
              f"{vag_ms:.4f} ms ({B / (vag_ms * 1e-3):.0f} grad evals/s)")
    report["shapes"] = shapes
    report["grad_shapes"] = grad_shapes

    # TVλ on phase 3's DNS panel: K1-TVλ beside K3f and K3b in the same
    # call, both Jacobian settings; the plain versions once, at B=1024 under
    # the spec's default (the reference's Jacobian)
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
            if not exact and B == 1024:
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
            plain_txt = ("" if fwd_plain_ms is None else f", plain {fwd_plain_ms:.1f} / "
                         f"{bwd_plain_ms:.1f} ms")
            print(f"  TVλ exact={exact} B={B}: K1 {k1_ms:.4f} ms, K3f {fwd_ms:.4f} ms "
                  f"(bound {f_bound:.4f}, {f_by}), K3b {bwd_ms:.4f} ms (bound "
                  f"{b_bound:.4f}, {b_by}; {bf / B:.0f} flop/draw needed, "
                  f"{bf_run / B:.0f} run){plain_txt}; value-and-gradient "
                  f"{vag_ms:.4f} ms ({B / (vag_ms * 1e-3):.0f} grad evals/s)")
    report["tvl_shapes"] = tvl_shapes

    # ---- 6. gradient pairs at full width ---------------------------------------
    begin_phase("[6] gradient pair: K2f + K2b against the plain versions")
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
    begin_phase(f"[7] estimate: AFNS5, N=20, T=360, S={S}, max_iters=50")
    # the panel simulated from the model at the first of phase 2's draws, as
    # bench.py's newton bench simulates its panel at its draws' base point
    sim = simulate_panel(spec64, draws[1024][0].cpu().numpy(), seed=9)
    starts = make_param_batch(spec.n_params, S, seed=11)
    fits = {"AFNS5": full_width_fit(yfm, optimize, spec, spec64, sim, starts, dev)}
    begin_phase(f"[7] estimate: TVλ, N=20, T=360, S={S}, max_iters=50")
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
    begin_phase(f"[8] estimate_windows: W={W} expanding windows [0, 248+16w) × S={S8} starts")
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
    return kernels


def ssd_phases(yfm, dev, report):
    """Phases 9–11: K4 against its plain version at full width and on the
    edge cases, its timing and stage clocks, and ``estimate_steps`` on
    config 6.  Returns K4's entry of the kernels line."""
    from yieldfactormodels_jl_tpu_torch.estimation import optimize
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    f32, f64 = torch.float32, torch.float64

    # ---- 9. K4 at full width ---------------------------------------------------------
    from yieldfactormodels_jl_tpu_torch.models import api as tapi
    from yieldfactormodels_jl_tpu_torch.ops import fused_ssd

    begin_phase("[9] K4 (score-driven loss) at full width: N=20, T=360, bench's DNS panel")
    bpanel = bench_dns_panel()
    bpanel64 = torch.as_tensor(bpanel, device=dev, dtype=f64)
    bpanel32 = bpanel64.float()
    K4_TOLS = {f64: (1e-6, 1e-15), f32: (2e-2, 1e-7)}
    k4_errs, k4_counts = [], {}

    def hold_k4(what, s64, p64, data64, start=0, end=None, expect_all_inf=False):
        """K4 in both types against the plain versions on the draws each type
        determines (float32 also against the plain float64); returns the
        float32-vs-plain-float64 max abs error."""
        s32 = dataclasses.replace(s64, dtype_name="float32")
        dets, refs, infs = {}, {}, {}
        for dtype, (rtol, eps) in K4_TOLS.items():
            dets[dtype], refs[dtype], infs[dtype] = ssd_determined(
                s64, p64, data64, dtype, rtol, eps, start, end)
        got64 = fused_ssd.batched_loss(s64, p64, data64, start, end)
        got32 = fused_ssd.batched_loss(s32, p64.float(), data64.float(), start, end)
        B = p64.shape[0]
        # −inf where the plain version is −inf under every nudge, finite where
        # it determines a finite value; a draw on the edge of overflow (a
        # wild grid point) may go either way in another summation order
        for name, got, dtype in (("f64", got64, f64), ("f32", got32, f32)):
            bad = (infs[dtype] & (got != -math.inf)) | (dets[dtype] & ~torch.isfinite(got))
            check(not bool(bad.any()), f"{what}: {name} kernel finite pattern differs on "
                  f"draws {bad.nonzero().flatten().tolist()[:8]}: kernel "
                  f"{got[bad][:4].tolist()}, plain {refs[dtype][bad][:4].tolist()}")
        if expect_all_inf:
            check(bool(infs[f64].all()) and bool((got32 == -math.inf).all())
                  and bool((got64 == -math.inf).all()), f"{what}: expected −inf for every draw")
            print(f"  {what}: every draw −inf in both types and the plain version")
            return 0.0
        # float32 is held against float64 where its plain version also
        # agrees with the plain float64 one to a quarter of the tolerance: it
        # can be stable under nudges and still biased
        agree = (refs[f32].double() - refs[f64]).abs() <= K4_TOLS[f32][0] / 4 * refs[f64].abs()
        d64, d32 = dets[f64], dets[f32] & dets[f64] & agree
        n64, n32 = int(d64.sum()), int(d32.sum())
        n_inf = int((infs[f64] & infs[f32]).sum())
        k4_counts[what] = {"B": B, "minus_inf": n_inf, "f64_determined": n64,
                           "f32_determined": n32}
        print(f"  {what}: −inf under every nudge {n_inf} of {B}; of the rest f64 determines "
              f"{n64}, f32 {n32}")
        check(min(n64, n32) + n_inf >= 0.85 * B, f"{what}: too few determined draws")
        close(got64[d64], refs[f64][d64], 1e-6, 0.0, f"{what}: f64 kernel vs plain f64")
        err = close(got32[d32], refs[f64][d32], 2e-2, 0.0, f"{what}: f32 kernel vs plain f64")
        close(got32[d32], refs[f32][d32], 2e-2, 0.0, f"{what}: f32 kernel vs plain f32")
        return err

    ssd_specs = {}
    for code in ("1SSD-NNS", "SSD-NS"):
        s64, _ = yfm.create_model(code, MATURITIES, float_type="float64")
        ssd_specs[code] = s64
        base = ssd_nns_params(s64)
        for B in (257, 2048):
            p64 = torch.as_tensor(ssd_draws(s64, base, B, seed=B), device=dev)
            k4_errs.append(hold_k4(f"{code} B={B}", s64, p64, bpanel64))
    gp = bpanel.copy()
    gp[:, 120] = np.nan     # the window's first step: transition-only, no target
    gp[5, 330] = np.nan     # partially NaN: after the window's end, then observed
    gp64 = torch.as_tensor(gp, device=dev, dtype=f64)
    for code in ("1RWSD-NNS", "1SD-NNS-Anchored", "3SRWSD-NNS-Anchored", "SRWSD-NS"):
        s64, _ = yfm.create_model(code, MATURITIES, float_type="float64")
        p = ssd_draws(s64, ssd_nns_params(s64), 512, seed=5)
        p[3] = np.nan                                   # invalid draw → −inf
        p64 = torch.as_tensor(p, device=dev)
        k4_errs.append(hold_k4(f"{code} B=512 NaN column, window [120, 300)", s64, p64,
                               gp64, 120, 300))
        check(bool(fused_ssd.batched_loss(s64, p64, gp64, 120, 300)[3] == -math.inf),
              f"{code}: the invalid draw must give −inf")
        hold_k4(f"{code} B=512 window [130, 340) with the partial NaN column", s64, p64,
                gp64, 130, 340, expect_all_inf=True)

    # ---- 10. K4 timing ----------------------------------------------------------------
    begin_phase("[10] K4 timing (CUDA events), float32")
    k4_shapes = {}
    for code, s64 in ssd_specs.items():
        s32 = dataclasses.replace(s64, dtype_name="float32")
        base = ssd_nns_params(s64)
        per_draw = ssd_flops(s32, bpanel32)
        for B in (1, 23, 257, 16384):
            p32 = torch.as_tensor(ssd_draws(s64, base, B, seed=B), device=dev, dtype=f32)
            inputs = fused_ssd.kernel_inputs(s32, p32, bpanel32, 0, T_MONTHS)
            ms = cuda_ms(lambda: fused_ssd.launch(inputs), reps=20 if B < 16384 else 5)
            bytes_ = nbytes(*inputs.buffers, inputs.out)
            bound_ms, bound_by = bound(bytes_, per_draw * B)
            row = {"ms": ms, "bytes": bytes_, "flops": per_draw * B, "bound_ms": bound_ms,
                   "bound_by": bound_by, "evals_per_s": B / (ms * 1e-3), "plain_ms": None}
            if B == 257:
                row["plain_ms"] = cuda_ms(lambda: fused_ssd.batched_loss_reference(
                    s32, p32, bpanel32), reps=1, warmup=0)
            k4_shapes[f"{code} {B}"] = row
            plain_txt = "" if row["plain_ms"] is None else f", plain {row['plain_ms']:.1f} ms"
            print(f"  {code} B={B}: kernel {ms:.4f} ms ({B / (ms * 1e-3):.0f} evals/s), "
                  f"bound {bound_ms:.6f} ms ({bound_by}; {per_draw} flop/draw){plain_txt}")
    # stage clocks at one draw (the clock build), the latency-chain bound
    # from the measured latencies, and the step loop's SASS
    from yieldfactormodels_jl_tpu_torch.ops import _build

    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    lats = {dtype: ssd_latencies(dtype, dev) for dtype in (f32, f64)}
    for dtype, lat in lats.items():
        print(f"  latency probe {str(dtype)[6:]} (cycles an operation): "
              + ", ".join(f"{k} {v:.1f}" for k, v in lat.items()))
    k4_stages = {}
    for code, s64 in ssd_specs.items():
        p1 = torch.as_tensor(ssd_draws(s64, ssd_nns_params(s64), 1, seed=1), device=dev)
        for dtype in (f32, f64):
            sd = dataclasses.replace(s64, dtype_name=str(dtype)[6:])
            st = ssd_stage_clocks(fused_ssd, sd, p1.to(dtype), bpanel64.to(dtype))
            chain, chain_cyc = ssd_chain_ms(sd, bpanel64, lats[dtype], clock_mhz)
            inputs1 = fused_ssd.kernel_inputs(sd, p1.to(dtype), bpanel64.to(dtype), 0,
                                              T_MONTHS)
            ms1 = cuda_ms(lambda: fused_ssd.launch(inputs1), reps=20)
            st.update({"chain_bound_ms": chain, "chain_cycles_observed_step": chain_cyc,
                       "ms": ms1, "clock_mhz": clock_mhz})
            k4_stages[f"{code} {str(dtype)[6:]}"] = st
            cyc = st["cycles_per_step"]
            print(f"  {code} {str(dtype)[6:]} B=1: {ms1:.4f} ms, chain bound {chain:.4f} ms "
                  f"({chain_cyc:.0f} cycles an observed step); stage cycles a step: "
                  + ", ".join(f"{k} {v:.0f}" for k, v in cyc.items())
                  + f"; loop {st['loop_cycles_per_step']:.0f} a step "
                  f"({st['loop_cycles_per_step'] * st['steps'] / (clock_mhz * 1e3):.4f} ms at "
                  f"{clock_mhz:.0f} MHz), {st['ms_with_stamps']:.4f} ms with the stamps")
            if dtype == f32:
                k4_shapes[f"{code} 1"]["chain_bound_ms"] = chain
    sass = sass_loop_counts(_build._lib_path("fused_ssd"))
    if sass is None:
        print("  SASS: no cuobjdump in this toolkit: not measured")
    else:
        for name, v in sass.items():
            print(f"  SASS {name}: {v['instructions']} instructions, step loop {v['step_loop']}")
    report["k4_stage_clocks"] = k4_stages
    report["k4_latencies"] = {str(k): v for k, v in lats.items()}
    report["k4_sass"] = sass
    report["k4_shapes"] = k4_shapes
    report["k4_determined"] = k4_counts

    # ---- 11. estimate_steps on config 6 ------------------------------------------------
    begin_phase("[11] estimate_steps: 1SSD-NNS, N=20, T=360, 3 starts, 10 group iterations")
    cfg, _ = yfm.create_model("1SSD-NNS", MATURITIES)
    cfg64 = ssd_specs["1SSD-NNS"]
    starts6 = jitter_starts(ssd_nns_params(cfg), 3, scale=0.02).T  # (P, 3)
    groups6 = yfm.get_param_groups(cfg)
    plain_counters = (fused_ssd.batched_loss_reference, fused_kf.batched_loglik_reference,
                      G.forward_reference, G.adjoint_reference)
    with timed_estimate_steps(optimize, fused_ssd) as phases:
        fused_ssd.batched_loss.launches = 0
        for fn in plain_counters:
            fn.calls = 0
        t0 = time.perf_counter()
        init6, ll6, best6, conv6 = yfm.estimate_steps(cfg, bpanel, starts6, groups6,
                                                      max_group_iters=10)
        torch.cuda.synchronize()
        wall6 = time.perf_counter() - t0
        k4_launches = fused_ssd.batched_loss.launches
        plain_calls = [fn.calls for fn in plain_counters]
    by_batch, k4_dev_s = {}, {}
    for B, phase, e0, e1 in phases["k4_events"]:
        k4_dev_s[phase] = k4_dev_s.get(phase, 0.0) + e0.elapsed_time(e1) / 1e3
        by_batch[B] = by_batch.get(B, 0) + 1
    k4_total_s = sum(k4_dev_s.values())
    print(f"  main path: K4 launches {k4_launches} (by batch size {by_batch}), "
          f"plain-version calls {plain_calls}")
    check(k4_launches >= 1, "estimate_steps never launched K4")
    check(plain_calls == [0, 0, 0, 0], f"plain versions ran on the card: {plain_calls}")
    check(math.isfinite(ll6), f"estimate_steps: non-finite ll {ll6}")
    # the grid: the winner against the plain float64 version's on the card
    cands = ssd_draws(cfg64, starts6[:, 0], 257, seed=0)
    check(cands.shape[0] == 257, "the grid has 257 candidates")
    grid64 = fused_ssd.batched_loss_reference(cfg64, torch.as_tensor(cands, device=dev),
                                              bpanel64).cpu().numpy()
    grid32 = fused_ssd.batched_loss(cfg, torch.as_tensor(cands, device=dev, dtype=f32),
                                    bpanel32).double().cpu().numpy()
    won = int(np.argmax(np.where(np.isfinite(grid32), grid32, -np.inf)))
    won64 = int(np.argmax(np.where(np.isfinite(grid64), grid64, -np.inf)))
    check(np.array_equal(phases["grid_winner"][:, 0], cands[won]),
          "estimate_steps' grid winner is not the kernel's argmax")
    check(won == won64 or abs(grid64[won] - grid64[won64]) < 2e-2 * abs(grid64[won64]),
          f"grid winner {won} vs plain f64 {won64}: {grid64[won]} vs {grid64[won64]}")
    check(ll6 >= grid32[won] - 1e-6 * abs(grid32[won]),
          f"estimate_steps: ll {ll6} below the grid winner's {grid32[won]}")
    # the kernel-reported optimum against the plain scan on the card
    ll_scan = float(tapi.get_loss(cfg, torch.as_tensor(best6, device=dev), bpanel32))
    check(abs(ll_scan - ll6) <= 2e-2 * abs(ll_scan),
          f"kernel optimum {ll6} vs plain scan {ll_scan}: beyond rtol 2e-2")
    bpanel_ext = np.concatenate([bpanel, np.full((N_MATURITIES, 12), np.nan)], axis=1)
    fc_card = yfm.predict(cfg64, best6, bpanel_ext)
    fc_cpu = yfm.predict(cfg64, best6, bpanel_ext, device="cpu")
    for key, val in fc_card.items():
        check(bool(torch.isfinite(val).all()), f"predict {key}: non-finite")
        close(val, fc_cpu[key], 1e-6, 1e-9, f"config 6 predict {key} card vs CPU")
    check(fc_card["preds"].shape == (N_MATURITIES, T_MONTHS + 12), "config 6 preds shape")
    # the Nelder–Mead groups' host share: their wall less K4's device time in them
    nm_host_s = phases["neldermead_s"] - k4_dev_s.get("neldermead_s", 0.0)
    print(f"  ll {ll6:.8f} (grid winner {grid32[won]:.8f}, plain scan {ll_scan:.8f}), "
          f"{conv6}, wall {wall6:.2f} s: grid {phases['grid_s']:.2f} s, Nelder–Mead "
          f"{phases['neldermead_s']:.2f} s (K4 on the card {k4_dev_s.get('neldermead_s', 0):.2f}"
          f" s, host {nm_host_s:.2f} s = {100 * nm_host_s / phases['neldermead_s']:.1f}%), "
          f"closed form {phases['closed_s']:.2f} s, trust-but-verify "
          f"{phases['verify_s']:.2f} s; K4 on the card {k4_total_s:.2f} s of the "
          f"{wall6:.2f} s wall ({100 * k4_total_s / wall6:.1f}%)")
    report["estimate_steps"] = {
        "ll": ll6, "grid_winner_ll": float(grid32[won]), "plain_scan_ll": ll_scan,
        "group_iterations": conv6.iterations, "converged": bool(conv6), "wall_s": wall6,
        "k4_launches": k4_launches, "k4_launches_by_batch": by_batch,
        "k4_device_s": k4_dev_s, "grid_s": phases["grid_s"],
        "neldermead_s": phases["neldermead_s"], "neldermead_host_s": nm_host_s,
        "closed_form_s": phases["closed_s"], "verify_s": phases["verify_s"]}

    k4 = k4_shapes["1SSD-NNS 257"]
    return {
        "name": "K4 fused_ssd", "route": "cuda",
        "source": "yieldfactormodels_jl_tpu_torch/csrc/fused_ssd.cu",
        "replaces": "yieldfactormodels_jl_tpu/ops/pallas_ssd.py:214",
        "launches": k4_launches, "max_abs_err": max(k4_errs),
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"], "library_ms": None,
        "shapes": k4_shapes}


PHASE_GROUPS = ("kalman", "ssd", "sv")


def main(json_path=None, only=PHASE_GROUPS) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import yieldfactormodels_jl_tpu_torch as yfm
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    from yieldfactormodels_jl_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # full-precision references
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ------------------------------------------------------------
    begin_phase("[1] build")
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

    kernels = []
    if "kalman" in only:
        kernels += kalman_phases(yfm, dev, report)
    if "ssd" in only:
        kernels.append(ssd_phases(yfm, dev, report))
    if "sv" in only:
        kernels.append(sv_phases(yfm, dev, report))
    report["kernels"] = kernels
    report["phase_start_s"] = dict(_PHASES)
    report["wall_s"] = time.perf_counter() - _T0
    print(f"  chip_smoke wall {report['wall_s']:.1f} s")
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
    ap.add_argument("--only", default=",".join(PHASE_GROUPS),
                    help="comma-separated phase groups to run after the build: "
                         "kalman ([2]–[8]), ssd ([9]–[11]), sv ([12]–[14]); all by "
                         "default")
    args = ap.parse_args()
    only = tuple(args.only.split(","))
    if not set(only) <= set(PHASE_GROUPS):
        ap.error(f"--only takes {PHASE_GROUPS}")
    sys.exit(main(args.json, only))
