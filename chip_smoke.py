#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build its kernels, run its main
path, hold every kernel against its plain PyTorch version, and time it.

    python3 chip_smoke.py [--json PATH] [--only kalman,ssd,sv,run,cascade,grad]
                                          # from the repository root; one CUDA card

``--only`` runs the build and the named phase groups alone (kalman: [2]–[8],
ssd: [9]–[11], sv: [12]–[14], run: [15], cascade: [16], grad: [17]); the
kernels line then holds their kernels.

Phases (any failure raises and the script exits non-zero; a phase also
fails where a fit's trust-but-verify re-evaluation falls back to the plain
engines):

1. build   — compile every kernel source with nvcc (sm_90a), all at once;
   wait for the library the first phase launches (K1's for [2]); every
   other library is waited for at its first use, so [2]–[4], which launch
   K1 alone, run beside the other builds, and the clock builds (at the
   lowest CPU priority) finish beside [2]–[5].  Before the last lines the
   script waits for every main library, so a build that fails fails the
   run whichever phases ran.
2. full width — AFNS5, N=20 maturities, T=360, B=1024 and B=16384 draws
   (this file's numpy copy of bench.py's panel and draws, seeded): raw draws
   → untransform_params → transform_params → batched_loglik (the kernel),
   then predict from the best draw.  This is the main path; the launch
   counts are set to 0 just before it and read just after.  Afterwards the
   float32 kernel is held against the plain float64 version at rtol 5e-4,
   atol 1e-2, and the kernel's float64 instantiation at rtol 1e-9.  Every
   K1 layout (warp and octet) against the thread layout bit for bit
   (torch.equal), float32 and float64, at B = 1, 256, 1024 and 16384.
3. other families at B=2048 — "1C" DNS with interior NaN columns and an
   invalid draw (must give −inf), TVλ under both exact_jacobian settings,
   per-draw [start, end) windows; the float32 kernel against the plain
   float32 version at rtol 5e-4, atol 1e-2 and the float64 instance against
   the plain float64 version at rtol 1e-9, each on the draws whose answer its
   type determines (it moves less than a quarter of the tolerance when the
   parameters move by 1e-7, resp. 1e-15, relative; at least 85% of draws).
   The TVλ cases run on a panel from a DNS DGP that their draws fit.  All
   but TVλ under the reference's Jacobian (the main path's) run on the
   panels' first ``T_EDGE`` = 120 months, the windows and NaN columns
   moved inside them.  On
   every case, every K1 layout against the thread layout bit for bit.
   Then AFNS5 at 360 maturities in float64, B = 256 and 1,024: the pick
   (warp, then the thread layout once four draws' rows pass a block's
   shared memory) equals the thread layout bit for bit and the plain
   version at rtol 1e-9.
4. forecast — predict from the best draw with a 12-column NaN tail on the
   card against the same call on the CPU, both float64, at rtol 1e-9.
5. timing — CUDA events around repeated launches after a warm-up, at
   B=1024 and B=16384, for K1, K2f and K2b (AFNS5), and K1-TVλ, K3f and K3b
   (TVλ on phase 3's DNS panel, both exact_jacobian settings), and
   value-and-gradient evals/s through the fused objective; the plain
   versions once, at B=1024, for information.  K1 by layout, each in
   turns, at B = 1 to 16384 (AFNS5 and TVλ float32, AFNS5 float64) with
   the layout the kernel picks; at B=1 K1's cycles a step by stage in each
   layout and type from the clock build (``fused_kf_clocks``), its
   latency-chain bound (``kf_chain_ms``, at K4's probe's latencies) and the
   SASS counts of its instances.  K2b (AFNS5) and K3b (TVλ, the reference's
   Jacobian) by layout and store, each in turns, with the pick, at B = 1,
   3, 256, 1024, 4096 and 16384 (float32), their cycles by stage from the
   clock build (``fused_kf_grad_clocks``) for the thread layout and the
   pick at B = 1, 256 and 1024, and the adjoint's latency-chain bound
   (``kf_grad_chain_ms``).  K2f (AFNS5) and K3f (TVλ, the reference's
   Jacobian) by layout, each in turns, with the pick, at the same batches
   (float32), each layout's ratio to K1's latency-chain bound (the
   checkpoint stores are off the chain), and at B=1 their cycles by stage
   for the thread layout and the pick from the clock build of their launch
   of K1's kernels (``fused_kf_fwd_clocks``).
6. gradient pairs at full width — through the fused objective's
   value-and-gradient (launch counts 1 and 1, plain versions 0): AFNS5,
   B=1024 (K2f + K2b) and TVλ, B=1024, under both exact_jacobian settings
   (K3f + K3b).  The float32 value against K1 (K2f at rtol 5e-4, atol 1e-2;
   K3f bit for bit), the float32 gradient against the plain float64 adjoint
   by bench.py's direction-and-norm criterion (cosine > 0.999, norm ratio
   within 5% per draw), the float64 kernels against the plain float64
   versions at value rtol 1e-9 and gradient rtol 1e-6, the adjoint kernel's
   raw float64 outputs (K2b's eight, K3b's six) against the plain adjoint's
   inside that plain gradient (the same inputs, checkpoints and
   cotangent) leaf by leaf (rtol 1e-6, atol 1e-9 ×
   the leaf's largest entry in the draw), and the plain float64 adjoint
   against autograd of the plain recursion at B=64.  TVλ is held on the
   draws whose value and gradient each type determines: phase 3's
   criterion on the plain value, and on the plain gradient a quarter of
   the gradient tolerance under nudges of ±1e-7 (float32) or ±1e-15
   (float64) of the raw parameters, and for float32 agreement with the
   plain float64 gradient to that quarter; the counts are printed.  There
   the float32 gradient is also held against the plain float32 one.  Then "1C" and TVλ with interior NaN columns, an
   invalid draw and per-draw windows, B=2048.  The cases off the main
   path's shapes (TVλ under exact_jacobian=True and the two with NaN
   columns) run on the panels' first ``T_EDGE`` = 120 months: the plain
   versions launch step by step, and their time goes with T.  On every case every forward
   layout (warp, octet) against the thread layout bit for bit on the value
   and every checkpoint word, float32 and float64, and every adjoint
   layout and store (warp and octet keeping the segment, one step or 9
   steps) against the thread layout bit for bit on the raw leaves, float32
   and float64 (torch.equal); the same on a four-state constant
   measurement (Svensson's loadings, the Ms = 4 instance, with the pick's
   float64 leaves against the plain adjoint; T = 120) and TVλ under both Jacobians
   with per-draw windows, B=512; and AFNS5 at 360 maturities in
   float64, where 64 draws pick the warp keeping a few steps (its leaves
   against the plain adjoint) and 256 the thread layout, and a forced octet
   or a forced segment store raises without launching; there the forward
   picks the warp at both batches and a forced forward octet raises without
   launching.
7. the fused MLE — ``estimate`` at N=20, T=360, S=256 starts,
   max_iters=50, with the launch counts set to 0 just before it: K1 ≥ 1,
   the forward and adjoint kernels once per value-and-gradient call, plain
   versions 0; the result finite, through the trust-but-verify
   re-evaluation, no start that moved without gaining and, if any moved,
   above the best start.  For the starts that stopped at iteration 0 the
   stop is checked in float64 through the kernels' float64 instances (held
   to the plain versions in [3] and [6]): no Armijo point among their 25
   probes along −g.  AFNS5 (K2f/K2b) on a panel simulated
   from the model at the first of bench's draws, as bench.py's newton bench
   does; then TVλ (K3f/K3b) on a panel simulated from the TVλ EKF's
   nonlinear measurement at the first of its starts.  Then small "1C" and
   TVλ fits on which the optimizer moves (N=6, T=60, S=3), on the card
   against the same calls on the CPU.  Each fit's ll, iterations, launches
   by kernel and parameter hash equal the thread kernel's recorded result
   (``PARENT_FITS``) bit for bit.
8. rolling windows — ``estimate_windows`` for AFNS5 and TVλ on phase 7's
   panels: W=8 expanding windows [0, 248+16w) × S=32 starts (256 draws),
   launch counts as in 7; the shortest and the longest window's best ll
   against ``estimate`` on that window alone from the same starts, at rtol
   1e-5; the wall time;
   the record against ``PARENT_FITS`` bit for bit.
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
   B=512 on the panel's first 120 months with a NaN column at the window's
   first step (a transition-only step that is no target) and a partially
   NaN column after the window's end, window [40, 100): finite; the window
   [43, 113), which observes the partial column: −Inf; an invalid draw: −Inf.
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
    the closed-form (δ, Φ) solve), ``SSD_GROUP_ITERS`` = 1 group
    iteration (the reference's 10 take 80–90 s of host time), with the launch
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
    "1C" at D=64, P=128, T=120, the float64 kernel against the plain version at
    rtol 1e-9 on: NaN columns, ess_threshold 0 and 1.5, every offset u = 0,
    96 live of 128 slots, per-draw (φ_h, σ_h); two invalid draws in each
    (Φ₁₁ > 1 and σ² < 0) give −inf.  And at phase 14's shapes (D=392,
    P=256, 200 live, one noise pair shared by every draw as an expanded
    view): float64 at rtol 1e-9, float32 by the paired criterion; there
    the cluster launch (a draw over a thread-block cluster) against the
    block launch bit for bit (torch.equal) at D=8 and D=392, float32 and
    float64, and on every "1C" edge case (float64, also against the plain
    version at rtol 1e-9) and its −inf draws in float32.  And
    above 1,024 slots (several slots a thread, their state in the wrapper's
    scratch): AFNS5 at full width, T=120, D=16, P=1152 and 2048 (2000 live),
    float64 at rtol 1e-9 with an invalid draw −inf.
13. K5 timing — CUDA events, float32: config 3 (D=1000, P=1024, 1000
    live), the batches of phase 14's search (8 and 8×49 draws, P=256,
    200 live, on one shared noise pair) and D=64 at P=2048 (2000 live),
    each layout that takes the shape in turns (block, cluster, block,
    cluster), and the layout the kernel picks; the plain version once at
    config 3; the bound from the operation count of these inputs.  Then,
    at config 3 and D=8, the cycles a step by stage from the clock build
    (``fused_pf_clocks``; in the cluster layout the chain and helper warps
    apart), the latency-chain bound from the probes' latencies, and the
    SASS instruction counts of each instance and its step loop.
14. ``estimate_sv`` — AFNS5, N=20, T=360, 8 stationary starts jittered from
    bench's AFNS5 point, 200 particles, max_iters=200, with (φ_h, σ_h)
    fixed (twice, from generators seeded alike: the same result bit for
    bit) and searched, each with the launch counts set to 0 just before
    it: K5 ≥ 1, its plain version 0; finite, the best ll at least the best
    start's on the same noise, (φ_h, σ_h) in range; the layout of each
    batch; the ll, iterations, launches by batch and best parameters equal
    to the block kernel's recorded result (``PARENT_SV``) bit for bit; the
    wall and K5's share of it.  Then "1C" in float64 (T=120, 2 starts, 128 particles,
    max_iters=``SV_CPU_ITERS`` = 5) on the card against the same call on the CPU: the same
    best start, ll at rtol 1e-8, the same iterations.
15. ``run()`` — the reference's driver on "1C", N=20, T=360, float32, in
    a temporary working directory: the reference's data, maturity and
    initial-parameter CSVs (a stationary point of this file's DNS DGP, on
    ``make_dns_panel``'s panel).  ``run("1", 357, 12, True, "1C",
    "float32", window_type="expanding")``: the in-sample fit at the
    reference's budget (10 group iterations of a 500-iteration Nelder–Mead
    over all 20 parameters, every candidate batch one K1 launch), then 4
    origins, each re-estimated the same way, forecast, sharded, merged and
    exported; with the launch counts set to 0 just before it: K1 ≥ 1, its
    plain version 0.  Checks: 5 fits, none ending below its start's ll;
    the in-sample ll within rtol 1e-4 of the plain float64 loss on the CPU
    at the written parameters; every artifact present and finite, the
    merged DB with 4 rows, the forecast CSV 48 × 22; the parameters' and
    the forecast CSV's hashes and K1's launches equal to ``RUN_FITS``.
    Prints the wall by stage (``StageTimer``), K1's launches by batch size
    (eager, or replayed from the CUDA graph of a Nelder–Mead iteration's
    evaluation), its device time (launches × the time a launch at that
    batch size takes by CUDA events) and share of the wall, and the
    Nelder–Mead groups' time outside K1.  Then the same 4
    origins through ``run(..., run_optimization=False,
    batched_windows=True)``: ``estimate_windows`` on K2f/K2b (launch counts
    ≥ 1, plain versions 0), the same artifact checks.  Then K1 at the
    path's batch sizes (B=1 at the fit, B=21 Nelder–Mead's first simplex),
    its graph replay against its eager launch bit for bit, and K2f/K2b at
    the batched run's 4 windows (the value and the raw gradient)
    against their plain versions on the same float32 inputs (rtol 5e-4,
    atol 1e-2; the gradient by bench.py's cosine/norm criterion), each
    timed beside its plain version (the same call, by CUDA events) and its
    bound.
16. the reference's warm-start cascade — in one temporary working
    directory, on [15]'s panel (N=20, T=360, float32, expanding windows):
    ``run("1", 357, 12, True, "NS", "float32")`` at the reference's budget
    (10 group iterations; group "1", λ, by a 500-iteration Nelder–Mead on
    the batched static loss, group "2" by the closed form), then
    ``run("1", 360, 12, True, "SD-NS", "float32")`` from NS's results at 1
    group iteration ([11]'s depth) and 1 origin (360), the depth the
    script's time limit allows (``CASCADE_RUNS``), each with the launch
    counts set to 0 just before it.  Checks: every static loss
    evaluation of the NS run on CUDA tensors, none on the CPU, and none in
    the SD-NS run; K4 0 times in the NS run, ≥ 1 in the SD-NS run and its
    plain version 0; the in-sample fit and one fit an origin of each code,
    each ending at or above its start (after the grid) in the run's own
    evaluation; NS's in-sample ll
    within rtol 1e-4 of the plain float64 loss on the CPU; SD-NS's first
    start's [ω; δ; Φ] tail equal to NS's out-params (in-sample) and to
    NS's merged-DB row for the task (each origin), bit for bit; both runs'
    artifacts present and finite; the NS and SD-NS parameters' hashes,
    SD-NS's forecast CSV's hash and K4's launches equal to
    ``CASCADE_FITS``.  Prints each run's wall by stage, K4's launches by
    batch size, its device time (CUDA events around each launch) and share
    of the SD-NS wall; then K4 on the in-sample grid and the fitted point
    (B=32) against its plain versions ([9]'s criterion), and at B=1 (the
    Nelder–Mead batch) timed beside its plain version and its bound.
17. the gradient groups — the estimation paths that take gradients outside
    the fused Kalman kernels, at N=20 on [15]'s panel with its first column
    NaN (a transition-only step: the closed-form (δ, Φ) solve does not
    apply, and the loss stays finite; a NaN column further in is a target
    and makes every loss −Inf).  (a) "SD-NS" ``estimate_steps`` at T=360,
    float32, from [16]'s SD-NS start: the grid, 1 group iteration of the
    default table — group "1" by Nelder–Mead on K4, group "2" by the
    batched L-BFGS whose Armijo probes are K4 launches and whose gradients
    are value-and-gradient passes of the scan through the inner score,
    capped at ``GRAD_LBFGS_ITERS`` iterations — with the launch counts set
    to 0 just before it: K4 ≥ 1, its plain version 0; the ll at or above
    the start's (after the grid, by K4); the wall by stage, the gradient
    passes counted, K4's share and theirs.  The same call in float64 at
    T=``GRAD_F64_T`` with group "2" capped at ``GRAD_F64_ITERS``, on the
    card and on the CPU: the same iterations of every group, the ll within
    rtol 1e-6.  (b) ``estimate("1C", objective="vmap")`` at T=``T_EDGE``,
    ``GRAD_VMAP_STARTS`` stationary starts, ``GRAD_VMAP_ITERS`` iterations
    (each start's own L-BFGS on the plain univariate engine; K1 never
    launched): every start at or above its start's ll, the winner within
    rtol 1e-4 of the plain float64 loss on the CPU.  (c) ``run("1", 360,
    12, True, "RW", "float32")`` with 1 origin in a temporary directory: the
    random walk's (δ, Φ) group by the per-start L-BFGS; every static loss
    evaluation on CUDA tensors, the artifacts present and finite; then
    ``GRAD_ADAM_ITERS`` Adam iterations on the static "NS" group "1" in
    float64 on the card and on the CPU: every iterate within rtol 1e-9.
    (a)'s and (c)'s parameter hashes, (c)'s forecast CSV's hash and (a)'s
    K4 launches equal ``GRAD_FITS``.  Then K4 on (a)'s grid and
    fitted point (B=32) against its plain versions ([9]'s criterion), and
    at B=1 (the Armijo probe) timed beside its plain version and its bound.

Before the last line it prints the card's name and power limit (nvidia-smi)
and one JSON object {"kernels": [...]} with each kernel's launches on the
main path, error, times and bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import hashlib
import io
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
#: the months of the edge cases' panels: the plain versions step through
#: every month, launch by launch, so their time goes with T
T_EDGE = 120
#: [11]'s group iterations and the iterations of [14]'s fit on the CPU
SSD_GROUP_ITERS, SV_CPU_ITERS = 1, 5
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


def svensson_inputs(B, data, rng, win=None):
    """The arguments of ``fused_kf_grad.forward_reference`` for a four-state
    constant measurement, Svensson's loadings (level, slope and two
    curvatures at λ₁ = 0.6, λ₂ = 0.15 a year) at this file's maturities, B
    stationary draws of Φ, δ, Ω and σ² from ``rng``, the unconditional start
    and ``data`` (N, T) with the per-draw ``win`` (starts, ends) or the
    whole panel: the Ms = 4 instance of K2f/K2b, which no model of the port
    reaches yet."""
    dev, dtype = data.device, data.dtype
    tau = np.asarray(MATURITIES, dtype=np.float64)
    x1, x2 = 0.6 * tau, 0.15 * tau
    slope = (1 - np.exp(-x1)) / x1
    Z = np.stack([np.ones_like(tau), slope, slope - np.exp(-x1),
                  (1 - np.exp(-x2)) / x2 - np.exp(-x2)], -1)    # (N, 4)
    Ms = 4
    phi = 0.9 * np.eye(Ms) + 0.01 * rng.standard_normal((B, Ms, Ms))
    delta = np.array([0.4, -0.1, 0.05, 0.02]) + 0.02 * rng.standard_normal((B, Ms))
    om = np.tile(np.diag([0.01, 0.02, 0.03, 0.03]), (B, 1, 1))
    beta0 = np.linalg.solve(np.eye(Ms) - phi, delta[..., None])[..., 0]
    P0 = np.tile(np.eye(Ms), (B, 1, 1))
    for _ in range(200):                                        # P = ΦPΦᵀ + Ω
        P0 = phi @ P0 @ phi.transpose(0, 2, 1) + om
    T = data.shape[1]

    def t(x):
        return torch.as_tensor(x, device=dev, dtype=dtype)

    masks = torch.ones(T, 2, dtype=torch.uint8, device=dev)
    masks[0, 1] = masks[T - 1, 1] = 0
    win_t = None if win is None else torch.stack([win[0], win[1]]).to(torch.int32)
    return (t(np.tile(Z, (B, 1, 1))), t(np.zeros((B, Z.shape[0]))), t(phi), t(delta), t(om),
            t(np.full(B, 0.01)), t(beta0), t(P0), data, masks, win_t)


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
    device: the reference the kernels are held against on the card.  The
    checkpoints of the last forward stay in ``chk``, the plain adjoint's raw
    outputs of the last backward in ``leaves``."""

    chk = leaves = None

    @staticmethod
    def forward(ctx, Z, d, Phi, delta, Om, ovar, beta0, P0, data, masks, win):
        from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

        ll, chk = G.forward_reference(Z, d, Phi, delta, Om, ovar, beta0, P0,
                                      data, masks, win)
        PlainCore.chk = chk
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
        PlainCore.leaves = grads
        return (*grads, None, None, None)


class PlainTvlCore(torch.autograd.Function):
    """The plain versions of K3f and K3b as one autograd Function; ``chk``
    and ``leaves`` as :class:`PlainCore`'s."""

    chk = leaves = None

    @staticmethod
    def forward(ctx, Phi, delta, Om, ovar, beta0, P0, data, masks, win, mats, exact):
        from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

        ll, chk = G.forward_reference_tvl(Phi, delta, Om, ovar, beta0, P0, data,
                                          masks, win, mats, exact)
        PlainTvlCore.chk = chk
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
        PlainTvlCore.leaves = grads
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


#: K1's layouts ("thread" first: the others are held against it), the batches
#: [5] times them at, and its stage clocks in the order of kf_common.cuh's
#: KfStage enum
K1_LAYOUTS = ("thread", "warp", "octet")
K1_TIMING_BATCHES = (1, 256, 512, 1024, 2048, 4096, 8192, 16384)
KF_STAGES = ("head", "row", "zP", "f_pred", "div", "update", "loglik", "sym",
             "transition", "stamp_pair")
#: the stages that run on every step, observed or not; the others run on
#: observed steps only
KF_EVERY_STEP = ("head", "transition", "stamp_pair")


def kf_layouts_equal(fused_kf, inputs, what):
    """Every K1 layout against the thread layout on the same inputs, bit for
    bit (torch.equal: the same −inf draws and every finite bit).  Returns
    the picked layout's output."""
    outs = {lay: fused_kf.launch(inputs, layout=lay).clone() for lay in K1_LAYOUTS}
    pick = fused_kf.layout_of(inputs)
    ref = outs["thread"]
    for lay in K1_LAYOUTS[1:]:
        n_diff = int((outs[lay] != ref).sum())
        check(torch.equal(outs[lay], ref), f"{what}: the {lay} layout differs from the "
              f"thread layout on {n_diff} of {ref.numel()} draws")
    print(f"  {what}: {' and '.join(K1_LAYOUTS[1:])} == thread bit for bit on "
          f"{ref.numel()} draws ({int(torch.isinf(ref).sum())} −inf); picks {pick}")
    return outs[pick]


def kf_stage_clocks(fused_kf, inputs, layout, reps=3, chk=None, S=1):
    """K1's cycles by stage for draw 0 (the clock build, ``fused_kf_clocks``:
    the same source with clock64() stamps between a step's stages; lane 0's
    in a group layout), from the last of ``reps`` launches: each stage's
    cycles a step — an observed step for the stages that run only there —
    and the loop's.  Also the launch's time with the stamps on.  With a
    checkpoint buffer ``chk`` it runs K2f's or K3f's launch of the same
    kernels (``fwd_kernel_inputs``), the checkpoints every S steps, from
    their own clock build (``fused_kf_fwd_clocks``)."""
    from yieldfactormodels_jl_tpu_torch.ops import _build

    lib = _build.load("fused_kf_clocks" if chk is None else "fused_kf_fwd_clocks")
    clocks = torch.zeros(len(KF_STAGES) + 3, dtype=torch.int64, device=inputs.out.device)
    ptrs = [None if x is None else x.data_ptr() for x in inputs.buffers]
    code = fused_kf._layout_code(layout)
    chk_ptr = None if chk is None else chk.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.yfm_fused_kf_clocks(*inputs.ints, *ptrs, inputs.out.data_ptr(), chk_ptr, S,
                                      code, clocks.data_ptr(), stream)
        check(err == 0, f"K1 clock build launch failed: cudaError {err}")

    ms = cuda_ms(run, reps=reps, warmup=1)
    c = clocks.cpu().tolist()
    steps, n_obs, loop = c[-3:]
    per_step = {name: c[q] / (steps if name in KF_EVERY_STEP else max(n_obs, 1))
                for q, name in enumerate(KF_STAGES)}
    return {"cycles_per_step": per_step, "loop_cycles_per_step": loop / steps,
            "steps": steps, "observed_steps": n_obs, "ms_with_stamps": ms}


#: the forward kernels' (K2f/K3f) layouts, "thread" first: the others are
#: held against it
KFG_FWD_LAYOUTS = ("thread", "warp", "octet")


def fwd_launch(bufs, tvl, exact, layout=None):
    """One forward launch (K3f when ``tvl``, else K2f) in a forced or the
    picked layout; returns (ll, checkpoints)."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    if tvl:
        return G.launch_forward_tvl(bufs, exact, layout=layout)
    return G.launch_forward(bufs, layout=layout)


def same_bits(a, b):
    """Bit for bit, NaN words too (an invalid draw's checkpoints are NaN)."""
    as_int = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.shape == b.shape and torch.equal(a.view(as_int), b.view(as_int))


def fwd_layouts(bufs, tvl, exact):
    """Each forward layout that launches on these buffers, with its (ll,
    checkpoints): a forced group layout whose draws' rows pass a block's
    shared memory is refused (cudaErrorInvalidValue), launches nothing and
    is left out."""
    out = {}
    for layout in KFG_FWD_LAYOUTS:
        try:
            res = fwd_launch(bufs, tvl, exact, layout)
        except RuntimeError as e:
            check("cudaError 1" in str(e) and layout != "thread", f"forward {layout}: {e}")
            continue
        out[layout] = [x.clone() for x in res]
    return out


def fwd_layouts_equal(bufs, tvl, exact, what):
    """Every forward layout that launches against the thread layout on the
    same buffers: the value equal (torch.equal) and every checkpoint word the
    same bits; and the pick among them.  Returns the pick."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    outs = fwd_layouts(bufs, tvl, exact)
    ll_t, chk_t = outs.pop("thread")
    pick = G.forward_layout_of(bufs, tvl)
    outs["pick"] = fwd_launch(bufs, tvl, exact)
    for layout, (ll, chk) in outs.items():
        n_diff = int((ll != ll_t).sum())
        check(torch.equal(ll, ll_t), f"{what}: forward {layout} value differs from the thread "
              f"layout on {n_diff} of {ll.numel()} draws")
        check(same_bits(chk, chk_t), f"{what}: forward {layout} checkpoints differ from the "
              "thread layout")
    print(f"  {what}: forward {', '.join(k for k in outs if k != 'pick')} == thread bit for bit "
          f"(value and {chk_t.numel()} checkpoint words); picks {pick}")
    return pick


def fwd_kernel_inputs(fused_kf, bufs, tvl, exact):
    """K1's KernelInputs for the buffers of a K2f (``lay_out``) or K3f
    (``lay_out_tvl``) launch: the clock build runs K2f's or K3f's launch from
    them with a checkpoint buffer."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    if tvl:
        (code, B, N, T, _, _), Ms = G._sizes_tvl(bufs), 4
        buffers = (None, None, *bufs)
    else:
        code, Ms, B, N, T, _, _ = G._sizes(bufs)
        buffers = (*bufs, None)
    return fused_kf.KernelInputs((code, Ms, int(tvl), int(exact), B, N, T), buffers,
                                 torch.empty(B, dtype=bufs[0].dtype, device=bufs[0].device))


#: the adjoints' (K2b/K3b) stages in the order of fused_kf_grad.cu's KfgStage
KFG_STAGES = ("recompute", "pre_pass", "update", "row", "transition", "stamp_pair")


def kfg_stage_clocks(bufs, chk, g, tvl, exact, layout, store=None, reps=3):
    """The adjoint's cycles by stage for draw 0 (the clock build,
    ``fused_kf_grad_clocks``: the same source with clock64() stamps between
    the sweep's stages; lane 0's in a group layout), from the last of
    ``reps`` launches on ``lay_out``/``lay_out_tvl`` buffers: each stage's
    cycles a step (over every step of the sweep) and the sweep's.  Also the
    launch's time with the stamps on."""
    from yieldfactormodels_jl_tpu_torch.ops import _build
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    lib = _build.load("fused_kf_grad_clocks")
    dev, dtype = bufs[0].device, bufs[0].dtype
    if tvl:
        (code, B, N, T, S, nC), Ms = G._sizes_tvl(bufs), 4
        Z = d = None
        phi, delta, om, ovar, _, _, data, masks, win, mats = bufs
        rows = (None, None, 16, 4, 16, 1, 4, 16)
    else:
        code, Ms, B, N, T, S, nC = G._sizes(bufs)
        Z, d, phi, delta, om, ovar, _, _, data, masks, win = bufs
        mats = None
        rows = (N * Ms, N, Ms * Ms, Ms, Ms * Ms, 1, Ms, Ms * Ms)
    grads = [None if r is None else torch.empty(r, B, dtype=dtype, device=dev) for r in rows]
    D = Ms + Ms * Ms
    seg, pre = G._scratch(bufs, tvl, layout, (S * D, N * D), dtype, dev)
    lay, keep = G._choice_codes(layout, store)
    clocks = torch.zeros(len(KFG_STAGES) + 3, dtype=torch.int64, device=dev)
    ptrs = G._ptrs([Z, d, mats, phi, delta, om, ovar, data, masks, win, chk, g.contiguous(),
                    *grads, seg, pre])
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.yfm_kf_grad_bwd_clocks(code, int(tvl), int(exact), Ms, B, N, T, S, nC, *ptrs,
                                         lay, keep(S), clocks.data_ptr(), stream)
        check(err == 0, f"adjoint clock build launch failed: cudaError {err}")

    ms = cuda_ms(run, reps=reps, warmup=1)
    c = clocks.cpu().tolist()
    steps, n_obs, loop = c[-3:]
    per_step = {name: c[q] / max(steps, 1) for q, name in enumerate(KFG_STAGES)}
    return {"cycles_per_step": per_step, "loop_cycles_per_step": loop / max(steps, 1),
            "steps": steps, "observed_steps": n_obs, "ms_with_stamps": ms}


#: the adjoints' layouts and what a group layout keeps of each segment
#: (the whole segment, one step, 9 of its 19 steps at T = 360: the pick's
#: store at 1,024 draws), "thread" first: the others are held against it;
#: and the batches [5] times them at
KFG_VARIANTS = (("thread", None), ("warp", "segment"), ("warp", "step"), ("warp", 9),
                ("octet", "segment"), ("octet", "step"), ("octet", 9))
KFG_TIMING_BATCHES = (1, 3, 256, 1024, 4096, 16384)


def kfg_name(layout, store):
    if store is None:
        return layout
    return f"{layout}/{store}" if isinstance(store, str) else f"{layout}/{store} steps"


def kfg_launch(bufs, chk, g, tvl, exact, layout=None, store=None):
    """One adjoint launch (K3b when ``tvl``, else K2b) in a forced or the
    picked layout; returns its leaves."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    if tvl:
        return G.launch_backward_tvl(bufs, exact, chk, g, layout=layout, store=store)
    return G.launch_backward(bufs, chk, g, layout=layout, store=store)


def kfg_variants(bufs, chk, g, tvl, exact):
    """Each variant of KFG_VARIANTS that launches on these buffers, with its
    leaves: a forced group layout whose draws' states pass a block's shared
    memory is refused (cudaErrorInvalidValue), launches nothing and is left
    out."""
    out = {}
    for layout, store in KFG_VARIANTS:
        try:
            leaves = kfg_launch(bufs, chk, g, tvl, exact, layout, store)
        except RuntimeError as e:
            check("cudaError 1" in str(e) and layout != "thread",
                  f"{kfg_name(layout, store)}: {e}")
            continue
        out[(layout, store)] = [x.clone() for x in leaves]
    return out


def kfg_layouts_equal(bufs, chk, g, tvl, exact, what):
    """Every adjoint layout (and store) that launches against the thread
    layout on the same buffers, checkpoints and cotangent, bit for bit on
    every leaf (torch.equal), and the pick among them.  Returns the picked
    plan and its leaves."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

    outs = kfg_variants(bufs, chk, g, tvl, exact)
    ref = outs.pop(("thread", None))
    pick = G.backward_plan(bufs, tvl)
    outs[pick] = picked = kfg_launch(bufs, chk, g, tvl, exact)
    for (layout, store), got in outs.items():
        for k, (a, r) in enumerate(zip(got, ref)):
            n_diff = int((a != r).sum())
            check(torch.equal(a, r), f"{what}: {kfg_name(layout, store)} differs from the "
                  f"thread layout on leaf {k}, {n_diff} of {r.numel()} entries")
    names = [kfg_name(*v) for v in outs]
    print(f"  {what}: {', '.join(names)} == thread bit for bit on all {len(ref)} leaves, "
          f"{ref[0].shape[1]} draws; picks {kfg_name(*pick)}")
    return pick, picked


def kf_grad_chain_ms(Ms, N, steps, obs_steps, lat, clock_mhz, tvl=False):
    """The adjoint's latency-chain bound for one draw (K2b, K3b when
    ``tvl``): the forward recompute's dependent path (``kf_chain_counts``,
    every step once) and then the reverse sweep's, at the cycles of each
    operation class that K4's probe measures, at the card's maximum SM
    clock.  The reverse path, every sum in the thread kernel's order and
    each independent operation on its own unit, no layout's broadcasts:
    - an observed update's adjoint (the next waits for P̄): K̄ (Ms FMAs),
      the K̄·K sum (Ms FMAs), f̄ (one FMA), z̄P += f̄z (one FMA), P̄ += z z̄Pᵀ
      (one FMA): 2Ms + 3 multiply-class operations; b̄, z̄P's other terms,
      z̄ and the ∂Z, ∂d sums run beside it;
    - an observed step: the de-symmetrization (add, mul), and for TVλ the
      row adjoint's tail past P̄'s path at the step's end (a mul-class
      operation for z̄ past z̄P, c, two for β̄₃, the fold into β̄: 4 and an
      add);
    - every step: the transition adjoint's P̄ path, ΦᵀP̄ then ·Φ (2Ms).
    The recompute of a segment could run beside the sweep of the next; the
    bound counts them in series, as every layout runs them.  Returns (ms,
    cycles of an observed step, forward and reverse)."""
    fwd_update, fwd_obs, fwd_trans = kf_chain_counts(Ms, tvl)
    rev_update = {"mul": 2 * Ms + 3}
    rev_obs = {"add": 1 + int(tvl), "mul": 1 + 4 * int(tvl)}
    rev_trans = {"mul": 2 * Ms}

    def cycles(counts):
        return sum(v * lat[k] for k, v in counts.items())

    obs_step = (N * (cycles(fwd_update) + cycles(rev_update)) + cycles(fwd_obs)
                + cycles(rev_obs))
    every = cycles(fwd_trans) + cycles(rev_trans)
    total = obs_steps * obs_step + steps * every
    return total / (clock_mhz * 1e6) * 1e3, obs_step + every


def kf_chain_counts(Ms, tvl=False):
    """The dependent path of the Kalman recursion by operation class, every
    sum kept in the recursion's order but every independent operation on
    its own unit (a fused multiply-add counted as one mul), and no layout's
    broadcasts: the function's own path, which no layout can beat.  Returns
    the counts of one observed update, of an observed step's additions and
    of every step's transition.

    - update (the next update waits for P): the Ms column sums zP (Ms FMAs,
      side by side), f from σ² in order (each FMA waits for its zP, so f
      ends Ms FMAs after the last zP), the f > 0 select (add), one IEEE
      division (the gains side by side) and one FMA into P; β, v and the
      loglik term run beside it.
    - observed step: the symmetrization (add, mul), and for TVλ the rows'
      build from the predicted β: e^{β₃}, λ, x = λτ, e^{−x}, 1 − e^{−x},
      a division, the Jacobian's subtraction, FMA and scaling.
    - transition: an element of ΦP (Ms FMAs), then of ΦPΦᵀ + Ω (Ms FMAs);
      β⁺ runs beside it."""
    update = {"mul": 2 * Ms + 1, "add": 1, "div": 1}
    observed = {"add": 1, "mul": 1}
    if tvl:
        for k, v in {"exp": 2, "add": 3, "mul": 3, "div": 1}.items():
            observed[k] = observed.get(k, 0) + v
    transition = {"mul": 2 * Ms}
    return update, observed, transition


def kf_chain_ms(Ms, N, steps, obs_steps, lat, clock_mhz, tvl=False):
    """K1's latency-chain bound for one draw: the dependent path of
    ``kf_chain_counts`` at the cycles of each operation class that K4's
    probe measures (``ssd_latencies``), over ``obs_steps`` observed steps of
    N updates and ``steps`` transitions, at the card's maximum SM clock.
    Returns (ms, cycles of an observed step)."""
    update, observed, transition = kf_chain_counts(Ms, tvl)

    def cycles(counts):
        return sum(v * lat[k] for k, v in counts.items())

    step = N * cycles(update) + cycles(observed) + cycles(transition)
    total = obs_steps * (N * cycles(update) + cycles(observed)) + steps * cycles(transition)
    return total / (clock_mhz * 1e6) * 1e3, step


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


#: ``estimate``'s and ``estimate_windows``' results in [7] and [8] on an H100
#: with K1's thread layout alone (before the warp and octet layouts
#: existed): the ll's float.hex() (each window's best for estimate_windows),
#: the launches by kernel, and the first 16 hex digits of the sha256 of the
#: iterations (int64) and of the best parameters (float64 bytes; for
#: estimate_windows the (W, S) lls and the (W, S, P) parameters); [7] and [8]
#: must repeat them bit for bit (recorded on an NVIDIA H100 80GB HBM3)
PARENT_FITS = {
    "estimate AFNS5": {
        "K1": 25, "forward": 2, "backward": 2, "value_and_grad_calls": 2,
        "ll": "0x1.b7c8320000000p+13",
        "iters": "e5a00aa9991ac8a5",
        "best_sha256": "4087dc1697f75be0",
    },
    "estimate TVλ": {
        "K1": 25, "forward": 2, "backward": 2, "value_and_grad_calls": 2,
        "ll": "0x1.f2776e0000000p+13",
        "iters": "e5a00aa9991ac8a5",
        "best_sha256": "d6d68b700564f744",
    },
    "estimate 1C N=6": {
        "K1": 42, "forward": 21, "backward": 21, "value_and_grad_calls": 21,
        "ll": "-0x1.f8699a0000000p+7",
        "iters": 20,
        "best_sha256": "32aa6af8de99914f",
    },
    "estimate TVλ N=6": {
        "K1": 43, "forward": 21, "backward": 21, "value_and_grad_calls": 21,
        "ll": "-0x1.faee720000000p+7",
        "iters": 20,
        "best_sha256": "a5e74e4e85985223",
    },
    "estimate_windows AFNS5": {
        "K1": 25, "forward": 2, "backward": 2, "value_and_grad_calls": 2,
        "ll": [
            "0x1.2c55000000000p+13", "0x1.4079700000000p+13", "0x1.5451fe0000000p+13",
            "0x1.67f8280000000p+13", "0x1.7b84080000000p+13", "0x1.8ff9ca0000000p+13",
            "0x1.a2f4b80000000p+13", "0x1.b7c8320000000p+13",
        ],
        "lls_sha256": "f29124335a4bce72",
        "best_sha256": "62d8c3e39cd28a27",
    },
    "estimate_windows TVλ": {
        "K1": 25, "forward": 2, "backward": 2, "value_and_grad_calls": 2,
        "ll": [
            "0x1.5593160000000p+13", "0x1.6bae8c0000000p+13", "0x1.81f06e0000000p+13",
            "0x1.98b1a00000000p+13", "0x1.aef7d60000000p+13", "0x1.c5733e0000000p+13",
            "0x1.dc484e0000000p+13", "0x1.f2776e0000000p+13",
        ],
        "lls_sha256": "cbdb06c54e9b85a8",
        "best_sha256": "7b405ab4991dffc1",
    },
}


def sha16(x):
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()[:16]


def fit_record(counts, **fields):
    """What [7] and [8] hold against ``PARENT_FITS``: the launches by kernel
    and the given fields."""
    rec = {k: counts[k] for k in ("K1", "forward", "backward", "value_and_grad_calls")}
    rec.update(fields)
    return rec


def check_parent_fit(label, rec):
    """Print a fit's record and hold it against the parent's, bit for bit."""
    print(f"  record {label!r}: {json.dumps(rec, ensure_ascii=False)}")
    check(PARENT_FITS is not None and label in PARENT_FITS,
          f"{label}: no parent record to hold it against")
    check(PARENT_FITS[label] == rec, f"{label}: differs from the parent's record "
          f"{PARENT_FITS[label]}")
    print(f"  {label}: the parent's ll, iterations, launches and parameters bit for bit")


def full_width_fit(yfm, optimize, spec, spec64, sim, starts, dev):
    """``estimate`` at N=20, T=360 from the (S, P) constrained ``starts`` on
    the card, with the launch counts set to 0 just before it: K1 ≥ 1, the
    forward and adjoint kernels once per value-and-gradient call, the plain
    versions never.  The result passes the trust-but-verify re-evaluation,
    no start that moved failed to gain, and a moved run beats the best
    start.  Starts that stopped at iteration 0 are checked in float64
    through the kernels' float64 instances, which [3] and [6] hold against
    the plain versions: no Armijo point among their 25 probes along −g.
    Returns the report."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G

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
        # Armijo point, in float64 — the float64 adjoint kernel's gradient at
        # the start and K1's float64 loglik at all 25 probes of every such
        # start, in one batch.  (The plain versions take ≈15 s at these
        # shapes on an H100, a launch a step; [6] holds these instances to
        # them.)
        sim64 = torch.as_tensor(sim, device=dev)
        X = raw0_64[torch.as_tensor(still, device=dev)]
        core = G._TvlCore.apply if spec64.family == "kalman_tvl" else G._KalmanCore.apply
        f0, g0 = raw_value_and_grad(yfm, spec64, X, sim64, core)
        alphas = 0.8 ** torch.arange(25, device=dev, dtype=f64)
        probes = (X[None] - alphas[:, None, None] * g0[None]).reshape(-1, X.shape[1])
        ll_p = fused_kf._batched_loglik(
            spec64, yfm.transform_params(spec64, probes), sim64, dtype=f64)
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
    record = fit_record(counts, ll=float.hex(ll_fit), iters=sha16(iters.astype(np.int64)),
                        best_sha256=sha16(np.asarray(best_p, dtype=np.float64)))
    return {"S": S, "ll": ll_fit, "best_start_ll": best_start,
            "iterations_max": int(iters.max()), "iterations_mean": float(iters.mean()),
            "starts_moved": moved, "converged": bool(conv), "wall_s": fit_s,
            "verify_s": verify_s, "counts": counts, "record": record}


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
    with counted_objectives(optimize) as vag_calls:
        zero_counts(spec)
        _, ll_card, best_card, conv_card = yfm.estimate(spec, data, starts, max_iters=20)
        torch.cuda.synchronize()
        counts = read_counts(spec, vag_calls[0])
    _, ll_cpu, _, conv_cpu = yfm.estimate(spec, data, starts, max_iters=20, device="cpu")
    print(f"  card ll {ll_card:.6f} ({conv_card}), CPU ll {ll_cpu:.6f} ({conv_cpu}), "
          f"best start {best:.6f}")
    check(conv_card.iterations > 0 and ll_card > best,
          f"the small {code} fit did not move on the card")
    check(abs(ll_card - ll_cpu) <= 1e-3 * abs(ll_cpu),
          f"the small {code} fit on the card and on the CPU differ by more than rtol 1e-3")
    return fit_record(counts, ll=float.hex(ll_card), iters=conv_card.iterations,
                      best_sha256=sha16(np.asarray(best_card, dtype=np.float64)))


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
    held = (0, W - 1)   # the shortest and the longest window
    alone = np.array([yfm.estimate(spec, sim, starts.T, start=0, end=ends[w],
                                   max_iters=50)[1] for w in held])
    err = np.abs(best[list(held)] - alone)
    check(bool((err <= 1e-5 * np.abs(alone)).all()),
          f"{label}: windows' best ll differ from estimate per window: "
          f"{best[list(held)]} vs {alone}")
    print(f"  {label}: windows {list(held)}' best ll equal estimate on that window alone "
          f"(max rel err {float((err / np.abs(alone)).max()):.3e}); lls {np.round(best, 3)}")
    record = fit_record(counts, ll=[float.hex(float(v)) for v in best],
                        lls_sha256=sha16(np.asarray(lls, dtype=np.float64)),
                        best_sha256=sha16(np.asarray(xs, dtype=np.float64)))
    return {"W": W, "S": S, "wall_s": wall_s, "counts": counts,
            "best_ll": best.tolist(), "estimate_ll": dict(zip(held, alone.tolist())),
            "max_rel_err": float((err / np.abs(alone)).max()), "record": record}


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


#: ``cuobjdump -sass`` of a library, by path: started in the background
#: right after the build (:func:`prefetch_sass`), read by :func:`sass_loop_counts`
_SASS_DUMPS = {}


def _cuobjdump(lib_path):
    tool = os.path.join(os.path.dirname(_nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout


def prefetch_sass(pool, lib_paths):
    """Start ``cuobjdump -sass`` on each library in ``pool``'s threads, so
    that the phases that count SASS instructions do not wait for it."""
    for path in lib_paths:
        _SASS_DUMPS[str(path)] = pool.submit(_cuobjdump, path)


def sass_loop_counts(lib_path, needle="ssd_loss_kernel"):
    """SASS instructions of each compiled ``needle`` kernel in a library
    (``cuobjdump -sass``): the whole function, and its step loop — the
    instructions from the target of its widest backward branch to that
    branch.  Keyed by the kernel's template arguments as they appear in its
    mangled name; None when the toolkit has no cuobjdump."""
    dump = _SASS_DUMPS.pop(str(lib_path), None)
    text = _cuobjdump(lib_path) if dump is None else dump.result()
    if text is None:
        return None
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
        kf = re.search(r"(fused_kf(?:_group)?_kernel)I([fd])", name)
        if kf is not None:
            # the measurement's argument, then the group layout's lanes and
            # the checkpoint flag
            ints = re.findall(r"L([ib])(\d+)E", name)
            meas = (f"TVλ exact={ints[0][1] == '1'}" if "TvlMeas" in name
                    else f"Ms={ints[0][1]}")
            lanes = "".join(f" G={v}" for k, v in ints[1:] if k == "i")
            lanes += "".join(" checkpoints" for k, v in ints[1:] if k == "b" and v == "1")
            out[f"{kf.group(1)} {'f32' if kf.group(2) == 'f' else 'f64'} {meas}{lanes}"] = {
                "instructions": len(addrs), "step_loop": span}
            continue
        args = re.search(needle + r"I([fd])Lb([01])ELi(\d+)E(?:Lb([01])E)?", name)
        pf = re.search(r"(fused_pf\w*?_kernel)I([fd])Li(\d+)E(?:Li(\d+)E)?", name)
        if args is None and pf is not None:
            out[f"{pf.group(1)} {'f32' if pf.group(2) == 'f' else 'f64'} Ms={pf.group(3)}"
                + ("" if pf.group(4) is None else f" {pf.group(4)}")] = {
                    "instructions": len(addrs), "step_loop": span}
            continue
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
    groups, the batched L-BFGS groups, the value-and-gradient passes of the
    plain engines (``_values_and_grads``, counted; inside the L-BFGS groups)
    and the trust-but-verify re-evaluation, each by its wall after a
    synchronize; the iterations of every Nelder–Mead and L-BFGS group; and
    K4's device time, from CUDA events around every launch (with its batch
    size and the phase it ran in).  Yields the dict that fills in."""
    acc = {"grid_s": 0.0, "neldermead_s": 0.0, "closed_s": 0.0, "verify_s": 0.0,
           "lbfgs_s": 0.0, "grad_s": 0.0, "grad_passes": 0, "nm_iters": [],
           "lbfgs_iters": [], "k4_events": [], "grid_winner": None, "active": "other"}
    names = {"try_initializations": "grid_s", "_neldermead_group": "neldermead_s",
             "_msed_closed_group": "closed_s", "_falls_back": "verify_s",
             "batched_lbfgs": "lbfgs_s", "_values_and_grads": "grad_s",
             "nelder_mead_batched": None}
    saved = {name: getattr(optimize, name) for name in names}
    launch = fused_ssd.launch

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outer = acc["active"]
            acc["active"] = names[name] or outer
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc["active"] = outer
            if names[name]:
                acc[names[name]] += time.perf_counter() - t0
            if name == "try_initializations":
                acc["grid_winner"] = out
            elif name == "_values_and_grads":
                acc["grad_passes"] += 1
            elif name == "batched_lbfgs":
                acc["lbfgs_iters"].append(out.iters.tolist())
            elif name == "nelder_mead_batched":
                acc["nm_iters"].append(out[2].tolist())
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
    of (draws, start event, stop event).  ``timed_pf_launches.layouts``
    gets the layout K5 picked for each batch size."""
    events = []
    launch = fused_pf.launch
    timed_pf_launches.layouts = {}

    def timed(inputs, **kw):
        D = inputs.rows.shape[0]
        if D not in timed_pf_launches.layouts:
            timed_pf_launches.layouts[D] = fused_pf.layout_of(inputs)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = launch(inputs, **kw)
        e1.record()
        events.append((inputs.rows.shape[0], e0, e1))
        return out

    fused_pf.launch = timed
    try:
        yield events
    finally:
        fused_pf.launch = launch


#: K5's layouts that [13] times (the cluster one takes P ≤ 256 slots), and
#: the shapes whose stage clocks it takes
K5_LAYOUTS = ("block", "cluster")
K5_STAGE_SHAPES = ("config 3", "estimate_sv step, 8 starts")
#: estimate_sv's results in [14] from the block kernel before the cluster
#: layout existed, on an H100: the ll's float.hex(), the iterations of each start, the K5
#: launches by batch size and the first 16 hex digits of the best
#: parameters' sha256 (float32 bytes); [14] must repeat them bit for bit
PARENT_SV = {
    label: {"ll": ll, "iters": [200] * 8, "launches_by_batch": {8: 400, D: 1},
            "best_sha256": sha}
    for label, ll, D, sha in (
        ("fixed (φ_h, σ_h)", "-0x1.1342d20000000p+16", 392, "e149c8ca85c0797d"),
        ("fixed, again", "-0x1.1342d20000000p+16", 392, "e149c8ca85c0797d"),
        ("(φ_h, σ_h) searched", "-0x1.5215320000000p+15", 408, "28111e175ee49c9f"))}
def pf_layouts_equal(fused_pf, spec, params, data, normals, uniforms, n_eff, what,
                     sv_phi=0.95, sv_sigma=0.2, ess_threshold=0.5, n_particles=None):
    """K5's cluster launch against its block launch on the same inputs, bit
    for bit (torch.equal: the same −inf draws and every finite bit); returns
    the cluster launch's logliks."""
    inputs = fused_pf.kernel_inputs(spec, params, data, normals, uniforms, n_eff, sv_phi,
                                    sv_sigma, ess_threshold)
    block = fused_pf.launch(inputs, layout="block")
    cluster = fused_pf.launch(inputs, layout="cluster")
    n_diff = int((block != cluster).sum())
    check(torch.equal(block, cluster), f"{what}: the cluster launch differs from the block "
          f"launch on {n_diff} of {block.numel()} draws")
    print(f"  {what}: cluster == block bit for bit on {block.numel()} draws "
          f"({int(torch.isinf(block).sum())} −inf)")
    return cluster


#: K5's stage clocks, in the order of fused_pf.cu's Stage enum
PF_STAGES = ("updates", "propagate", "barrier", "max", "sum", "ess", "scan", "search",
             "gather", "loop_top")
#: the stages that run on contributing / resampling steps alone, averaged over those
PF_CONTRIB_STAGES, PF_RESAMPLE_STAGES = ("ess",), ("scan", "search", "gather")
#: operation classes of fused_pf.cu's latency probe, in its LatOp order
PF_LAT_OPS = ("log_add", "shared_load", "remote_load", "cluster_barrier")


def pf_stage_clocks(fused_pf, inputs, layout, reps=3):
    """K5's cycles by stage for draw 0 (the clock build, ``fused_pf_clocks``:
    the same source with clock64() stamps between a step's stages, thread 0
    of draw 0; for the cluster layout its chain warp's, and its helper
    warp's apart), from the last of ``reps`` launches under ``layout``:
    cycles a step averaged over the T−1 steps (the ESS over the contributing
    steps, the scan, search and gather over the resampling steps), the
    counts of contributing and resampling steps, the SMs of draw 0's CTAs,
    and the launch's time with the stamps on."""
    from yieldfactormodels_jl_tpu_torch.ops import _build

    lib = _build.load("fused_pf_clocks")
    n_st = len(PF_STAGES)
    helper0 = n_st + 4 + 16
    clocks = torch.full((helper0 + n_st + 1,), -1, dtype=torch.int64,
                        device=inputs.out.device)
    code = {"block": 1, "cluster": 2}[layout]
    args = fused_pf.launch_args(inputs, fused_pf._scratch(inputs))
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.yfm_fused_pf_clocks(*args, code, clocks.data_ptr(), stream)
        check(err == 0, f"K5 clock build launch failed: cudaError {err}")

    ms = cuda_ms(run, reps=reps, warmup=1)
    c = clocks.cpu().tolist()
    steps, contrib, resampled, loop = c[n_st:n_st + 4]
    def per(first):
        out = {}
        for q, name in enumerate(PF_STAGES):
            n = (contrib if name in PF_CONTRIB_STAGES else
                 resampled if name in PF_RESAMPLE_STAGES else steps)
            out[name] = c[first + q] / max(n, 1)
        return out

    per_step = per(0)
    helper = None
    if layout == "cluster":
        helper = per(helper0)
        helper["waiting"] = c[helper0 + n_st] / steps
    return {"cycles_per_step": per_step, "loop_cycles_per_step": loop / steps,
            "helper_cycles_per_step": helper, "steps": steps, "contributing_steps": contrib,
            "resampling_steps": resampled, "sms": [x for x in c[n_st + 4:helper0] if x >= 0],
            "ms_with_stamps": ms}


def pf_latencies(dtype, dev):
    """Cycles of one dependent operation of each PF_LAT_OPS class on one
    warp, from the K5 clock build's probe (128 in a chain, in one cluster of
    8 one-warp CTAs); "log_add" is a log and the add after it."""
    from yieldfactormodels_jl_tpu_torch.ops import _build

    lib = _build.load("fused_pf_clocks")
    out = torch.zeros(len(PF_LAT_OPS), dtype=torch.int64, device=dev)
    sink = torch.zeros(256, dtype=torch.int32, device=dev)
    for _ in range(2):  # the second launch runs from a warm instruction cache
        err = lib.yfm_pf_latencies(0 if dtype == torch.float32 else 1, out.data_ptr(),
                                   sink.data_ptr(), torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"K5 latency probe launch failed: cudaError {err}")
    torch.cuda.synchronize()
    return {name: v / 128 for name, v in zip(PF_LAT_OPS, out.cpu().tolist())}


def pf_chain_counts(Ms, P, n_live):
    """The dependent path of one particle-step of the SV filter by operation
    class, every particle on its own thread and every sum over the P slots
    a log2(P)-level tree (shfl + the op at each level), a fused multiply-add
    counted as one mul.  Returns the counts of an observed update, the
    propagation, the weights, a contributing step's ESS and a resampling.

    - update (the next update waits for S): Sᵀz (Ms), Σφ² + r (Ms + 1), the
      pivot guard (1 add), √f, α = 1/(f + √r√f) (1 mul, 1 div), the
      downdate (1 mul); β and the log-likelihood term run beside it.
    - propagation: the blend (add, mul), A = ΦS (Ms), AAᵀ + Ω (Ms), then the
      Cholesky's columns in turn: the last earlier-column product (Ms − 1
      mul), the floor (add) and √ of each pivot, each column's division
      (Ms − 1).
    - weights: the max tree (a NaN-propagating max is two add-class
      operations), the guard and the shift, exp, the Σ tree, the log and
      two adds.
    - ESS (contributing step): exp of the weight, its square, the Σ tree,
      1/Σ and the gate's compare.
    - resampling: the scan tree, the cumulative add, the binary search
      (⌈log2 n_live⌉ dependent shared loads, each with its compare) and the
      gather's load."""
    lv = max(1, math.ceil(math.log2(P)))
    search = max(1, math.ceil(math.log2(n_live)))
    update = {"mul": 2 * Ms + 3, "add": 2, "sqrt": 1, "div": 1}
    propagate = {"add": 1 + Ms, "mul": 3 * Ms, "sqrt": Ms, "div": Ms - 1}
    weights = {"shfl": 2 * lv, "add": 3 * lv + 4, "exp": 1, "log": 1}
    ess = {"exp": 1, "mul": 1, "shfl": lv, "add": lv + 1, "div": 1}
    resample = {"shfl": lv, "add": lv + 1 + search, "shared": search + 1}
    return update, propagate, weights, ess, resample


def pf_chain_ms(Ms, N, P, n_live, finite_cols, n_resample, lat, clock_mhz):
    """K5's latency-chain bound for one draw at the measured cycles of each
    operation class — add, mul, div, sqrt, exp and shfl from K4's probe
    (``ssd_latencies``), log (less an add) and the shared load from K5's
    (``pf_latencies``) — at the card's maximum SM clock.  A step's path is
    its N updates (on an observed column) and the propagation; the weights
    and the ESS run beside the propagation, and on a resampling step the
    scan, search and gather follow the later of the two.  ``n_resample``
    resampling steps (the clock build's count on draw 0).  Returns (ms,
    cycles of an observed step, of a resampling step's addition)."""
    update, propagate, weights, ess, resample = pf_chain_counts(Ms, P, n_live)

    def cycles(counts):
        return sum(v * lat[k] for k, v in counts.items())

    steps, obs = len(finite_cols), int(sum(finite_cols))
    step = cycles(propagate)
    extra = max(0.0, cycles(weights) + cycles(ess) - step) + cycles(resample)
    total = steps * step + obs * N * cycles(update) + n_resample * extra
    return total / (clock_mhz * 1e6) * 1e3, step + N * cycles(update), extra


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
    print("  the cluster launch (a draw over a thread-block cluster) against the block "
          "launch, bit for bit: D=8 and 392, P=256, 200 live, f32 and f64")
    for Dl in (8, 392):
        for sp, args in ((spec64, args_e), (spec, args_e32)):
            pe_, panel_, nz_, u_ = args
            pf_layouts_equal(fused_pf, sp, pe_[:Dl], panel_, nz_[:Dl], u_[:Dl], 200,
                             f"D={Dl} {str(pe_.dtype)[6:]}")
    pf_errs.append(pf_distribution(
        bp(spec, *args_e32, n_particles=200), ref_e,
        bp(spec, *args_e32, n_particles=200, sv_sigma=0.0),
        fused_pf.pf_loglik_batch_reference(spec64, *args_e, n_particles=200, sv_sigma=0.0),
        "shared noise f32 kernel vs plain f64 (paired)"))

    print(f"  \"1C\" edge cases, D=64, P=128, T={T_EDGE}, f64 kernel vs plain f64 at rtol 1e-9")
    dns64, _ = yfm.create_model("1C", MATURITIES, float_type="float64")
    Dc, Pc = 64, 128
    rng = np.random.default_rng(13)
    pc = kalman_draws(dns64, Dc, rng, [0.4, -0.1, 0.05])
    pc[0, dns64.layout["phi"][0]] = 1.5           # Φ₁₁ > 1: P₀ fails to factor
    pc[1, dns64.layout["obs_var"][0]] = -4e-4     # σ² < 0: f ≤ 0
    pc = torch.as_tensor(pc, device=dev)
    dpanel = make_dns_panel(seed=2)
    dpanel64 = torch.as_tensor(np.ascontiguousarray(dpanel[:, :T_EDGE]), device=dev)
    nan_panel = dpanel[:, :T_EDGE].copy()
    nan_panel[:, 40] = np.nan
    nan_panel[7, 100] = np.nan
    nzc = torch.as_tensor(rng.standard_normal((Dc, T_EDGE - 1, Pc)), device=dev)
    uc = torch.as_tensor(rng.uniform(size=(Dc, T_EDGE - 1)), device=dev)
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
        clus = pf_layouts_equal(fused_pf, dns64, pc, data, nzc, u, kw.get("n_particles", Pc),
                                f"1C {what}, f64", **kw)
        close(clus, ref, 1e-9, 0.0, f"1C {what}, the cluster launch")
    print("  \"1C\" −Inf draws through both launches, f32: σ² < 0 (every step −Inf) and "
          "Φ₁₁ > 1")
    pc32 = pc.float()
    got = pf_layouts_equal(fused_pf, yfm.create_model("1C", MATURITIES)[0], pc32,
                           dpanel64.float(), nzc.float(), uc.float(), Pc, "1C f32")
    check(bool((got[:2] == -math.inf).all()), f"1C f32: the invalid draws gave {got[:2]}")

    print(f"  above 1,024 slots (several slots a thread, state in scratch): AFNS5, D=16, "
          f"P=1152 and 2048 (2000 live), T={T_EDGE}, f64 kernel vs plain f64 at rtol 1e-9")
    rng = np.random.default_rng(17)
    pm = stationary_draws(spec64, base, 16, seed=4)
    pm[3, spec64.layout["phi"][0]] = 1.5          # Φ₁₁ > 1: −inf
    pm = torch.as_tensor(pm, device=dev, dtype=f64)
    panel_e = panel64[:, :T_EDGE].contiguous()
    for Pm, live in ((1152, 1152), (2048, 2000)):
        nzm = torch.as_tensor(rng.standard_normal((16, T_EDGE - 1, Pm)), device=dev)
        um = torch.as_tensor(rng.uniform(size=(16, T_EDGE - 1)), device=dev)
        got = bp(spec64, pm, panel_e, nzm, um, n_particles=live)
        ref = fused_pf.pf_loglik_batch_reference(spec64, pm, panel_e, nzm, um,
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
    shapes, stage_inputs = {}, {}
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
        reps = 3 if Dt >= 1000 else 20
        layouts = K5_LAYOUTS if Pt <= 256 else ("block",)
        # the layouts in turns, twice (block, cluster, block, cluster), so a
        # drift of the card's clock falls on both alike
        times = {lay: [] for lay in layouts}
        for _ in range(2):
            for lay in layouts:
                times[lay].append(cuda_ms(lambda: fused_pf.launch(inputs, layout=lay),
                                          reps=reps, warmup=1))
        by_layout = {lay: sum(v) / len(v) for lay, v in times.items()}
        chosen = fused_pf.layout_of(inputs)
        ms = by_layout["block" if chosen == "multi" else chosen]
        bytes_, flops = pf_work(inputs, spec, finite_cols)
        bound_ms, bound_by = bound(bytes_, flops)
        row = {"D": Dt, "P": Pt, "n_live": live, "ms": ms, "layout": chosen,
               "ms_by_layout": by_layout, "bytes": bytes_, "flops": flops,
               "bound_ms": bound_ms, "bound_by": bound_by, "plain_ms": None,
               "particle_steps_per_s": Dt * live * (T_MONTHS - 1) / (ms * 1e-3)}
        if label == "config 3":
            row["plain_ms"] = cuda_ms(lambda: fused_pf.reference(inputs), reps=1, warmup=0)
            del nzt
        if label in K5_STAGE_SHAPES:
            stage_inputs[label] = inputs
        shapes[label] = row
        plain_txt = "" if row["plain_ms"] is None else f", plain {row['plain_ms']:.1f} ms"
        lay_txt = ", ".join(f"{k} {v:.4f} ms" for k, v in by_layout.items())
        print(f"  {label} (D={Dt}, P={Pt}, {live} live): {lay_txt}; picks {chosen}; bound "
              f"{bound_ms:.4f} ms ({bound_by}; "
              f"{flops / (Dt * live * (T_MONTHS - 1)):.0f} flop a particle-step, "
              f"{bytes_ / 1e6:.1f} MB){plain_txt}")
    # stage clocks (the clock build), the latency-chain bound from the
    # probes' latencies, and the step loop's SASS
    from yieldfactormodels_jl_tpu_torch.ops import _build

    lat = ssd_latencies(f32, dev)
    plat = pf_latencies(f32, dev)
    lat.update({"log": plat["log_add"] - lat["add"], "shared": plat["shared_load"]})
    print("  latency probe f32 (cycles an operation): "
          + ", ".join(f"{k} {v:.1f}" for k, v in {**lat, **plat}.items()))
    k5_stages = {}
    for label, inputs in stage_inputs.items():
        Pt, live = inputs.normals.shape[-1], inputs.n_eff
        for lay in shapes[label]["ms_by_layout"]:
            st = pf_stage_clocks(fused_pf, inputs, lay)
            chain, step_cyc, extra = pf_chain_ms(spec.state_dim, inputs.panel.shape[1], Pt,
                                                 live, finite_cols, st["resampling_steps"],
                                                 lat, clock_mhz)
            st.update({"chain_bound_ms": chain, "chain_cycles_step": step_cyc,
                       "chain_cycles_resample": extra, "clock_mhz": clock_mhz,
                       "ms": shapes[label]["ms_by_layout"][lay]})
            k5_stages[f"{label} {lay}"] = st
            shapes[label].setdefault("chain_bound_ms", chain)
            cyc = st["cycles_per_step"]
            print(f"  {label} {lay}: {st['ms']:.4f} ms, chain bound {chain:.4f} ms "
                  f"({step_cyc:.0f} cycles an observed step, +{extra:.0f} a resampling); "
                  f"stage cycles a step: " + ", ".join(f"{k} {v:.0f}" for k, v in cyc.items())
                  + f" (ess per contributing, scan/search/gather per resampling step); loop "
                  f"{st['loop_cycles_per_step']:.0f} a "
                  f"step ({st['loop_cycles_per_step'] * st['steps'] / (clock_mhz * 1e3):.4f} ms "
                  f"at {clock_mhz:.0f} MHz); {st['contributing_steps']} contributing, "
                  f"{st['resampling_steps']} resampling steps; {st['ms_with_stamps']:.4f} ms "
                  f"with the stamps; draw 0 on SMs {st['sms']}")
            if st["helper_cycles_per_step"] is not None:
                print(f"    helper warp, cycles a step: " + ", ".join(
                    f"{k} {v:.0f}" for k, v in st["helper_cycles_per_step"].items()))
    sass = sass_loop_counts(_build._lib_path("fused_pf"), needle="fused_pf")
    if sass is None:
        print("  SASS: no cuobjdump in this toolkit: not measured")
    else:
        for name, v in sass.items():
            print(f"  SASS {name}: {v['instructions']} instructions, step loop {v['step_loop']}")
    report["k5_stage_clocks"] = k5_stages
    report["k5_latencies"] = {"ssd_probe": {k: v for k, v in lat.items()}, "pf_probe": plat}
    report["k5_sass"] = sass
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
            best_sha = hashlib.sha256(np.ascontiguousarray(out[0]).tobytes()).hexdigest()
            run = {"ll": out[1], "lls": out[2].tolist(), "iters": out[3].tolist(),
                   "best": out[0], "best_sha256": best_sha, "wall_s": wall, "k5_s": k5_s,
                   "launches": bp.launches, "launches_by_batch": by_batch,
                   "layout_by_batch": dict(timed_pf_launches.layouts),
                   "plain_calls": ref_calls.calls}
            if full:
                run["sv_hat"] = out[4]
            sv_runs[label] = run
            print(f"  {label}: ll {out[1]:.6f} ({out[1].hex()}), iterations "
                  f"{out[3].tolist()}, launches {bp.launches} (by batch {by_batch}), plain "
                  f"{ref_calls.calls}; layouts {timed_pf_launches.layouts}; best parameters "
                  f"sha256 {best_sha[:16]}; wall "
                  f"{wall:.2f} s, K5 on the card {k5_s:.2f} s ({100 * k5_s / wall:.1f}%)"
                  + (f"; (φ_h, σ_h) = ({out[4][0]:.4f}, {out[4][1]:.4f})" if full else ""))
            want = PARENT_SV.get(label)
            if want is not None:
                got = {"ll": out[1].hex(), "iters": out[3].tolist(),
                       "launches_by_batch": by_batch, "best_sha256": best_sha[:16]}
                check(got == want, f"estimate_sv {label}: {got} is not the recorded "
                      f"result of the block kernel, {want}")
                print(f"  {label}: the block kernel's recorded result, bit for bit")
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

    print(f"  \"1C\" f64 on the card vs the CPU: T=120, S=2, P=128, max_iters={SV_CPU_ITERS}")
    dns_starts = kalman_draws(dns64, 2, np.random.default_rng(15), [0.4, -0.1, 0.05])
    raw_c = yfm.untransform_params(dns64, torch.as_tensor(dns_starts)).numpy()
    small = dpanel[:, :120]
    gen = torch.Generator().manual_seed(16)
    noise = (torch.randn(119, 128, generator=gen, dtype=f64),
             torch.rand(119, generator=gen, dtype=f64))
    kw = dict(n_particles=128, max_iters=SV_CPU_ITERS, noise=noise)
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
    # every K1 layout against the thread layout, bit for bit, on the main
    # path's batches and on B = 1 and 256 of its draws, in both types
    for B, p in ((1, cons[1024][:1]), (256, cons[1024][:256]), (1024, cons[1024]),
                 (16384, cons[16384])):
        for s_t, dtype in ((spec, f32), (spec64, f64)):
            inputs = fused_kf.kernel_inputs(s_t, p.to(dtype), panel64.to(dtype), 0, T_MONTHS)
            kf_layouts_equal(fused_kf, inputs, f"AFNS5 B={B} {str(dtype)[6:]}")

    # ---- 3. other families ------------------------------------------------------
    begin_phase("[3] other families at B=2048")
    rng = np.random.default_rng(7)
    Bo = 2048
    gapped = panel.copy()
    gapped[:, 50] = np.nan
    gapped[3, 120] = np.nan
    gapped[:, 200:203] = np.nan
    cases = []
    dns64, _ = yfm.create_model("1C", MATURITIES, float_type="float64")
    p = kalman_draws(dns64, Bo, rng, [0.4, -0.1, 0.05])
    p[5] = np.nan                                      # invalid draw → −inf
    # the main path's families on the full panel (AFNS5 in [2]; TVλ under
    # the reference's Jacobian here); the edge cases on its first T_EDGE months
    gapped_e = gapped[:, :T_EDGE].copy()
    gapped_e[:, 100:103] = np.nan
    cases.append((f"1C NaN columns + invalid row, T={T_EDGE}", dns64, p,
                  torch.as_tensor(gapped_e, device=dev, dtype=f64), {}))
    tvl32, _ = yfm.create_model("TVλ", MATURITIES)
    tvl64, _ = yfm.create_model("TVλ", MATURITIES, float_type="float64")
    dns_panel = make_dns_panel(seed=2)
    dns64_panel = torch.as_tensor(dns_panel, device=dev, dtype=f64)
    for exact in (False, True):
        s = dataclasses.replace(tvl64, exact_jacobian=exact)
        cases.append((f"TVλ exact_jacobian={exact}" + (f", T={T_EDGE}" if exact else ""), s,
                      kalman_draws(s, Bo, rng, TVL_DELTA),
                      dns64_panel[:, :T_EDGE].contiguous() if exact else dns64_panel, {}))
    win = {"starts": torch.as_tensor(rng.integers(0, 100, Bo), device=dev) // 3,
           "ends": torch.as_tensor(rng.integers(200, T_MONTHS + 1, Bo), device=dev) // 3}
    cases.append((f"AFNS5 per-draw windows, T={T_EDGE}", spec64,
                  make_param_batch(spec.n_params, Bo, seed=3),
                  panel64[:, :T_EDGE].contiguous(), win))
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
            pl, dl, st, en = fused_kf._prepare(s, pt, data64, kw.get("starts"),
                                               kw.get("ends"), None, dtype)
            kf_layouts_equal(fused_kf, fused_kf.kernel_inputs(s, pl, dl, 0, dl.shape[1], st,
                                                              en), f"{what} {name}")
            if dtype == f32:
                errs.append(err)
            if "invalid" in what:
                g = got.cpu()
                check(g[5] == -math.inf and bool(torch.isfinite(g[4])),
                      "invalid draw must give −inf and leave its neighbour finite")
    # many maturities: the pick takes a group layout only while its blocks
    # fit the card at once.  360 monthly maturities in float64 (24 months of
    # the panel, interpolated): a warp's block holds one AFNS5 draw's rows,
    # an octet block's four draws pass a block's shared memory
    wide_mats = np.arange(1, 361) / 12.0
    wide64, _ = yfm.create_model("AFNS5", wide_mats, float_type="float64")
    wide_panel = torch.as_tensor(
        np.stack([np.interp(wide_mats, MATURITIES, panel[:, t]) for t in range(24)], 1),
        device=dev, dtype=f64)
    for B, want in ((256, "warp"), (1024, "thread")):
        pw = torch.as_tensor(yfm.params_from_jax(wide64, make_param_batch(spec.n_params, B)),
                             device=dev, dtype=f64)
        inputs = fused_kf.kernel_inputs(wide64, pw, wide_panel, 0, 24)
        pick = fused_kf.layout_of(inputs)
        check(pick == want, f"N=360 f64 B={B}: picks {pick}, not {want}")
        got = fused_kf.launch(inputs).clone()
        thread = fused_kf.launch(inputs, layout="thread")
        check(torch.equal(got, thread), f"N=360 f64 B={B}: the pick differs from the thread "
              "layout")
        check(bool(torch.isfinite(got).all()), f"N=360 f64 B={B}: non-finite loglik")
        ref = fused_kf.batched_loglik_reference(wide64, pw, wide_panel)
        close(got, ref, 1e-9, 0.0, f"N=360 f64 B={B}: picked {pick} vs plain f64")
        print(f"  N=360 f64 B={B}: picks {pick}, == thread bit for bit, agrees with the plain "
              "version")

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
    dns_panel32 = torch.as_tensor(dns_panel, device=dev, dtype=f32)
    tvl_ref32 = dataclasses.replace(tvl32, exact_jacobian=False)
    lats = {dtype: ssd_latencies(dtype, dev) for dtype in (f32, f64)}
    for dtype, lat in lats.items():
        print(f"  latency probe {str(dtype)[6:]} (K4's, cycles an operation): "
              + ", ".join(f"{k} {v:.1f}" for k, v in lat.items()))
    chain = {}
    for fam, Ms, tvl in (("AFNS5", spec.state_dim, False), ("TVλ", 4, True)):
        for dtype in (f32, f64):
            chain[f"{fam} {str(dtype)[6:]}"] = kf_chain_ms(
                Ms, N_MATURITIES, T_MONTHS, T_MONTHS, lats[dtype], clock_mhz, tvl)
    for key, (ms_c, cyc) in chain.items():
        print(f"  K1 latency-chain bound {key}, one draw: {ms_c:.4f} ms ({cyc:.0f} cycles an "
              f"observed step at {clock_mhz:.0f} MHz)")

    # K1 by layout, each in turns (thread, warp, octet, thread, warp, octet)
    # in this one call, at the batches of the main paths and above
    def k1_draws(fam, B):
        if fam == "AFNS5":
            if B <= 1024:
                return cons[1024][:B].to(f32)
            return cons[B].to(f32) if B in cons else torch.as_tensor(
                yfm.params_from_jax(spec64, make_param_batch(spec.n_params, B, seed=B)),
                device=dev, dtype=f32)
        return torch.as_tensor(kalman_draws(tvl_ref32, B, np.random.default_rng(B),
                                            TVL_DELTA), device=dev, dtype=f32)

    k1_layouts = {}
    for fam, s32, pan in (("AFNS5", spec, panel32), ("TVλ", tvl_ref32, dns_panel32),
                          ("AFNS5 float64", spec64, panel64)):
        for B in K1_TIMING_BATCHES:
            inputs = fused_kf.kernel_inputs(s32, k1_draws(fam.split()[0], B).to(pan.dtype),
                                            pan, 0, T_MONTHS)
            turns = {lay: [] for lay in K1_LAYOUTS}
            for _ in range(2):
                for lay in K1_LAYOUTS:
                    turns[lay].append(cuda_ms(lambda: fused_kf.launch(inputs, layout=lay),
                                              reps=20 if B < 16384 else 10))
            ms = {lay: sum(v) / len(v) for lay, v in turns.items()}
            pick = fused_kf.layout_of(inputs)
            bytes_, flops = kernel_work(inputs, pan)
            bound_ms, bound_by = bound(bytes_, flops)
            k1_layouts[f"{fam} {B}"] = {"ms": ms, "turns": turns, "pick": pick,
                                        "pick_ms": ms[pick], "bound_ms": bound_ms,
                                        "bound_by": bound_by}
            print(f"  K1 {fam} B={B}: " + ", ".join(
                f"{lay} {ms[lay]:.4f} ms ({' / '.join(f'{t:.4f}' for t in turns[lay])})"
                for lay in K1_LAYOUTS)
                + f"; picks {pick} ({ms[pick] / ms['thread']:.3f}× thread); bound "
                f"{bound_ms:.4f} ms ({bound_by})")
    report["k1_layouts"] = k1_layouts
    # stage clocks at one draw (the clock build), each layout, both types
    k1_stages = {}
    for fam, s32, pan in (("AFNS5", spec, panel32), ("TVλ", tvl_ref32, dns_panel32)):
        p1 = k1_draws(fam, 1)
        for dtype in (f32, f64):
            sd = dataclasses.replace(s32, dtype_name=str(dtype)[6:])
            inputs = fused_kf.kernel_inputs(sd, p1.to(dtype), pan.to(dtype), 0, T_MONTHS)
            for lay in K1_LAYOUTS:
                st = kf_stage_clocks(fused_kf, inputs, lay)
                st["ms"] = cuda_ms(lambda: fused_kf.launch(inputs, layout=lay), reps=20)
                k1_stages[f"{fam} {str(dtype)[6:]} {lay}"] = st
                cyc = st["cycles_per_step"]
                print(f"  K1 {fam} {str(dtype)[6:]} B=1 {lay}: {st['ms']:.4f} ms; cycles a step "
                      f"(observed step for the chain's stages): "
                      + ", ".join(f"{k} {v:.0f}" for k, v in cyc.items())
                      + f"; loop {st['loop_cycles_per_step']:.0f} a step, "
                      f"{st['loop_cycles_per_step'] / N_MATURITIES:.0f} an update; "
                      f"{st['ms_with_stamps']:.4f} ms with the stamps")
    report["k1_stage_clocks"] = k1_stages
    from yieldfactormodels_jl_tpu_torch.ops import _build

    k1_sass = sass_loop_counts(_build._lib_path("fused_kf"), needle="fused_kf")
    if k1_sass is None:
        print("  SASS: no cuobjdump in this toolkit: not measured")
    else:
        for name, v in k1_sass.items():
            print(f"  SASS {name}: {v['instructions']} instructions, step loop {v['step_loop']}")
    report["k1_sass"] = k1_sass
    report["k1_chain_bound_ms"] = {k: v[0] for k, v in chain.items()}
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
            "chain_bound_ms": chain["AFNS5 float32"][0]}
        plain_txt = "" if plain_ms is None else f", plain {plain_ms:.1f} ms"
        print(f"  K1 B={B}: kernel {ms:.4f} ms ({B / (ms * 1e-3):.0f} evals/s), "
              f"entry point {entry_ms:.4f} ms{plain_txt}, "
              f"bound {bound_ms:.4f} ms ({flops / B:.0f} flop/draw), "
              f"latency-chain bound {chain['AFNS5 float32'][0]:.4f} ms")

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
            fwd_plain_ms, (_, chk_plain) = timed_call(lambda: G.forward_reference(*plain))
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
                fwd_plain_ms, (_, chk_plain) = timed_call(
                    lambda: G.forward_reference_tvl(*plain))
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

    # K2b and K3b by layout and store, each in turns in this one call (f32;
    # AFNS5 on this file's panel, TVλ under the reference's Jacobian on
    # phase 3's DNS panel), with the pick and the bound; the stage clocks of
    # the thread layout and of the pick at B = 1 and 256; the adjoint's
    # latency-chain bound
    kfg_chain = {}
    for fam, Ms, tvl in (("AFNS5", spec.state_dim, False), ("TVλ", 4, True)):
        for dtype in (f32, f64):
            kfg_chain[f"{fam} {str(dtype)[6:]}"] = kf_grad_chain_ms(
                Ms, N_MATURITIES, T_MONTHS, T_MONTHS, lats[dtype], clock_mhz, tvl)
    for key, (ms_c, cyc) in kfg_chain.items():
        print(f"  adjoint latency-chain bound {key}, one draw: {ms_c:.4f} ms ({cyc:.0f} cycles "
              f"an observed step, forward and reverse, at {clock_mhz:.0f} MHz)")
    kfg_layouts, kfg_stages, fwd_layouts_ms, fwd_stages = {}, {}, {}, {}
    for fam, s32, pan, tvl in (("AFNS5", spec, panel32, False),
                               ("TVλ", tvl_ref32, dns_panel32, True)):
        name = "K3b" if tvl else "K2b"
        fname = "K3f" if tvl else "K2f"
        for B in KFG_TIMING_BATCHES:
            args = G.core_inputs(s32, k1_draws(fam, B), pan, 0, T_MONTHS)
            bufs = G.lay_out_tvl(*args[:10]) if tvl else G.lay_out(*args)
            out, chk = G.launch_forward_tvl(bufs, False) if tvl else G.launch_forward(bufs)
            g = torch.ones(B, device=dev, dtype=f32)
            grads = kfg_launch(bufs, chk, g, tvl, False)
            # the forward by layout, each in turns, and the pick; its
            # latency-chain bound is K1's (the checkpoint stores are off the
            # chain)
            fpick = G.forward_layout_of(bufs, tvl)
            fturns = {lay: [] for lay in KFG_FWD_LAYOUTS}
            for _ in range(2):
                for lay in KFG_FWD_LAYOUTS:
                    fturns[lay].append(cuda_ms(lambda: fwd_launch(bufs, tvl, False, lay),
                                               reps=10 if B < 16384 else 5))
            fms = {lay: sum(v) / len(v) for lay, v in fturns.items()}
            (fb, ff), _, _ = grad_kernel_work(bufs, pan, out, chk, grads, tvl)
            f_bound, f_by = bound(fb, ff)
            f_chain = chain[f"{fam} float32"][0]
            fwd_layouts_ms[f"{fam} {B}"] = {
                "kernel": fname, "ms": fms, "turns": fturns, "pick": fpick,
                "pick_ms": fms[fpick], "pick_over_thread": fms[fpick] / fms["thread"],
                "bound_ms": f_bound, "bound_by": f_by, "chain_bound_ms": f_chain,
                "over_chain": {lay: v / f_chain for lay, v in fms.items()}}
            print(f"  {fname} {fam} B={B}: " + ", ".join(
                f"{lay} {fms[lay]:.4f} ms ({' / '.join(f'{t:.4f}' for t in fturns[lay])}; "
                f"{fms[lay] / f_chain:.2f}× chain)" for lay in KFG_FWD_LAYOUTS)
                + f"; picks {fpick} ({fms[fpick] / fms['thread']:.3f}× thread); bound "
                f"{f_bound:.4f} ms ({f_by}); latency-chain bound {f_chain:.4f} ms")
            if B == 1:  # the forward's cycles by stage: the thread layout and the pick
                k_in = fwd_kernel_inputs(fused_kf, bufs, tvl, False)
                chk_c = torch.empty_like(chk)
                for lay in ("thread", fpick):
                    st = kf_stage_clocks(fused_kf, k_in, lay, chk=chk_c, S=G._seg(T_MONTHS)[0])
                    st["ms"] = fms[lay]
                    fwd_stages[f"{fname} {fam} f32 B=1 {lay}"] = st
                    cyc = st["cycles_per_step"]
                    print(f"  {fname} {fam} f32 B=1 {lay}: {st['ms']:.4f} ms; cycles a step "
                          f"(observed step for the chain's stages): "
                          + ", ".join(f"{k} {v:.0f}" for k, v in cyc.items())
                          + f"; loop {st['loop_cycles_per_step']:.0f} a step, "
                          f"{st['loop_cycles_per_step'] / N_MATURITIES:.0f} an update; "
                          f"{st['ms_with_stamps']:.4f} ms with the stamps")
            # the variants that launch, and the pick (layout None) where it is
            # none of them
            plan = G.backward_plan(bufs, tvl)
            pick = kfg_name(*plan)
            variants = list(kfg_variants(bufs, chk, g, tvl, False))
            names = [kfg_name(*v) for v in variants]
            if pick not in names:
                variants.append((None, None))
                names.append(pick)
            reps = 3 if B <= 1024 else 2 if B <= 4096 else 1
            turns = {k: [] for k in names}
            for _ in range(2):
                for k, v in zip(names, variants):
                    turns[k].append(cuda_ms(lambda: kfg_launch(bufs, chk, g, tvl, False, *v),
                                            reps=reps, warmup=1))
            ms = {k: sum(v) / len(v) for k, v in turns.items()}
            _, (bb, bf), _ = grad_kernel_work(bufs, pan, out, chk, grads, tvl)
            bound_ms, bound_by = bound(bb, bf)
            key = f"{fam} {B}"
            kfg_layouts[key] = {"kernel": name, "ms": ms, "turns": turns, "pick": pick,
                                "pick_ms": ms[pick], "pick_over_thread": ms[pick] / ms["thread"],
                                "bound_ms": bound_ms, "bound_by": bound_by}
            print(f"  {name} {fam} B={B}: " + ", ".join(
                f"{k} {v:.4f} ms ({' / '.join(f'{t:.4f}' for t in turns[k])})"
                for k, v in ms.items())
                + f"; picks {pick} ({ms[pick] / ms['thread']:.3f}× thread); bound "
                f"{bound_ms:.4f} ms ({bound_by})")
            if B in (1, 256, 1024):  # the thread layout and the pick (layout None)
                for label, v in (("thread", ("thread", None)), (pick, (None, None))):
                    st = kfg_stage_clocks(bufs, chk, g, tvl, False, *v)
                    kfg_stages[f"{fam} B={B} {label}"] = st
                    cyc = st["cycles_per_step"]
                    print(f"  {name} {fam} f32 B={B} {label}: cycles a step "
                          + ", ".join(f"{k} {c:.0f}" for k, c in cyc.items())
                          + f"; sweep {st['loop_cycles_per_step']:.0f} a step, "
                          f"{st['loop_cycles_per_step'] / N_MATURITIES:.0f} an update "
                          f"({st['observed_steps']} of {st['steps']} steps observed); "
                          f"{st['ms_with_stamps']:.4f} ms with the stamps")
    report["kfg_layouts"] = kfg_layouts
    report["kfg_stage_clocks"] = kfg_stages
    report["kfg_fwd_layouts"] = fwd_layouts_ms
    report["kfg_fwd_stage_clocks"] = fwd_stages
    report["kfg_chain_bound_ms"] = {k: v[0] for k, v in kfg_chain.items()}

    # ---- 6. gradient pairs at full width ---------------------------------------
    begin_phase("[6] gradient pair: K2f + K2b against the plain versions")
    grad_errs = {"K2f": [], "K2b": [], "K2b_leaves": [],
                 "K3f": [], "K3b": [], "K3b_leaves": []}
    wins = torch.as_tensor(rng.integers(0, 100, 2048), device=dev), \
        torch.as_tensor(rng.integers(200, T_MONTHS + 1, 2048), device=dev)
    dns32, _ = yfm.create_model("1C", MATURITIES)
    p_dns = kalman_draws(dns64, 2048, rng, [0.4, -0.1, 0.05])
    p_dns[5] = np.nan                                  # invalid draw
    # the main path's shapes (AFNS5 and TVλ under the reference's Jacobian,
    # T=360) in full; the edge cases (the other Jacobian, NaN columns, an
    # invalid draw, per-draw windows) on the panels' first T_EDGE months,
    # since the plain versions' time goes with the steps
    wins_edge = wins[0] // 3, wins[1] // 3            # starts < 34, ends ≥ 66
    gapped_edge = gapped[:, :T_EDGE].copy()
    gapped_edge[3, 100] = np.nan
    gapped_edge[:, 80:83] = np.nan
    grad_cases = [
        ("AFNS5 B=1024", spec, spec64, draws[1024], panel, None),
        (f'"1C" NaN columns, invalid draw, per-draw windows, B=2048, T={T_EDGE}', dns32,
         dns64, torch.as_tensor(p_dns, device=dev), gapped_edge, wins_edge),
    ]
    for exact in (False, True):
        grad_cases.append((f"TVλ exact_jacobian={exact} B=1024"
                           + (f", T={T_EDGE}" if exact else ""),
                           dataclasses.replace(tvl32, exact_jacobian=exact),
                           dataclasses.replace(tvl64, exact_jacobian=exact),
                           torch.as_tensor(kalman_draws(tvl64, 1024, rng, TVL_DELTA),
                                           device=dev),
                           np.ascontiguousarray(dns_panel[:, :T_EDGE]) if exact else dns_panel,
                           None))
    p_tvl = kalman_draws(tvl64, 2048, rng, TVL_DELTA)
    p_tvl[5] = np.nan                                  # invalid draw
    gapped_dns = dns_panel[:, :T_EDGE].copy()
    gapped_dns[:, 50] = np.nan
    gapped_dns[3, 100] = np.nan
    grad_cases.append((f"TVλ NaN columns, invalid draw, per-draw windows, B=2048, T={T_EDGE}",
                       tvl32, tvl64, torch.as_tensor(p_tvl, device=dev), gapped_dns,
                       wins_edge))
    for what, s32, s64, p64, data_np, win in grad_cases:
        tvl = s64.family == "kalman_tvl"
        T_c = data_np.shape[1]
        fwd_k, bwd_k, fwd_p, bwd_p = launch_counters(s64)
        names = ("K3f", "K3b") if tvl else ("K2f", "K2b")
        data32 = torch.as_tensor(data_np, device=dev, dtype=f32)
        data64 = torch.as_tensor(data_np, device=dev, dtype=f64)
        X64 = yfm.untransform_params(s64, p64)
        X32 = X64.to(f32)
        kw = {} if win is None else {"win_starts": win[0], "win_ends": win[1]}
        wkw = {} if win is None else {"starts": win[0], "ends": win[1]}
        value_fn, vag = optimize.fused_objectives(s32, data32, 0, T_c, **kw)
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
                    plain_chk = PlainTvlCore.chk[:X64.shape[0]]
                    plain_leaves = [x[:X64.shape[0]] for x in PlainTvlCore.leaves]
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
            plain_chk, plain_leaves = PlainCore.chk, PlainCore.leaves
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
        # adjoint's in the plain gradient above: the same float64 inputs, the
        # plain forward's checkpoints (in the kernel's draw-minor layout) and
        # the objective's cotangent, −1 on the finite draws
        args64 = [a.detach() if torch.is_tensor(a) else a for a in G.core_inputs(
            s64, yfm.transform_params(s64, X64), data64, 0, T_c, **wkw)]
        if tvl:
            bufs64 = G.lay_out_tvl(*args64[:10])
            ll64, chk64 = G.launch_forward_tvl(bufs64, args64[10])
        else:
            bufs64 = G.lay_out(*args64)
            ll64, chk64 = G.launch_forward(bufs64)
        cot_obj = torch.where(torch.isfinite(ll64), -torch.ones_like(ll64),
                              torch.zeros_like(ll64))
        chk_p = plain_chk.reshape(plain_chk.shape[0], -1).T.contiguous()
        check(chk_p.shape == chk64.shape, f"{what}: checkpoints {tuple(chk_p.shape)} vs "
              f"{tuple(chk64.shape)}")
        got_leaves = (G.launch_backward_tvl(bufs64, args64[10], chk_p, cot_obj) if tvl
                      else G.launch_backward(bufs64, chk_p, cot_obj))
        grad_errs[names[1] + "_leaves"].append(leaves_close(
            got_leaves, plain_leaves, 1e-6, 1e-9,
            f"{what}: f64 {names[1]} leaves vs plain f64 adjoint", rows=d64))
        cot = torch.rand(ll64.shape, generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev, dtype=f64) + 0.5
        cot = torch.where(torch.isfinite(ll64), cot, torch.zeros_like(cot))
        # every adjoint layout against the thread layout on the raw leaves,
        # float64 (the inputs above) and float32 (the same draws)
        exact = bool(args64[10]) if tvl else False
        fwd_layouts_equal(bufs64, tvl, exact, f"{what}: f64 {names[0]}")
        kfg_layouts_equal(bufs64, chk64, cot, tvl, exact, f"{what}: f64 {names[1]} layouts")
        args32 = [a.detach() if torch.is_tensor(a) else a for a in G.core_inputs(
            s32, yfm.transform_params(s32, X32), data32, 0, T_c, **wkw)]
        bufs32 = G.lay_out_tvl(*args32[:10]) if tvl else G.lay_out(*args32)
        ll32, chk32 = G.launch_forward_tvl(bufs32, exact) if tvl else G.launch_forward(bufs32)
        cot32 = torch.where(torch.isfinite(ll32), cot.to(f32), torch.zeros_like(ll32))
        fwd_layouts_equal(bufs32, tvl, exact, f"{what}: f32 {names[0]}")
        kfg_layouts_equal(bufs32, chk32, cot32, tvl, exact, f"{what}: f32 {names[1]} layouts")
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

    # the adjoints' layouts on the cases left: a four-state constant
    # measurement (Svensson's loadings), TVλ under both Jacobians with
    # per-draw windows, each in both types with the f64 leaves against the
    # plain adjoint; and 360 maturities in float64, where no group layout
    # fits 256 draws at once and a forced one that cannot fit raises
    for what, tvl, exact in ((f"Svensson Ms=4, per-draw windows, B=512, T={T_EDGE}", False,
                              False),
                             ("TVλ exact_jacobian=False, per-draw windows, B=512", True, False),
                             ("TVλ exact_jacobian=True, per-draw windows, B=512", True, True)):
        for dtype in (f64, f32):
            if tvl:
                s_t = dataclasses.replace(tvl64 if dtype == f64 else tvl32, exact_jacobian=exact)
                p_t = torch.as_tensor(kalman_draws(tvl64, 512, np.random.default_rng(21),
                                                   TVL_DELTA), device=dev, dtype=dtype)
                args = [a.detach() if torch.is_tensor(a) else a for a in G.core_inputs(
                    s_t, p_t, torch.as_tensor(dns_panel, device=dev, dtype=dtype), 0, T_MONTHS,
                    wins[0][:512], wins[1][:512])]
                bufs = G.lay_out_tvl(*args[:10])
                ll, chk = G.launch_forward_tvl(bufs, exact)
            else:
                panel_e = torch.as_tensor(np.ascontiguousarray(panel[:, :T_EDGE]), device=dev,
                                          dtype=dtype)
                args = svensson_inputs(512, panel_e, np.random.default_rng(22),
                                       (wins_edge[0][:512], wins_edge[1][:512]))
                bufs = G.lay_out(*args)
                ll, chk = G.launch_forward(bufs)
            fin = torch.isfinite(ll)
            check(int(fin.sum()) >= 0.9 * ll.numel(), f"{what}: {int((~fin).sum())} draws −inf")
            cot = torch.rand(ll.shape, generator=torch.Generator(device=dev).manual_seed(6),
                             device=dev, dtype=dtype) + 0.5
            cot = torch.where(fin, cot, torch.zeros_like(cot))
            fwd_layouts_equal(bufs, tvl, exact, f"{what}: {str(dtype)[6:]}")
            _, picked = kfg_layouts_equal(bufs, chk, cot, tvl, exact,
                                          f"{what}: {str(dtype)[6:]} layouts")
            if dtype == f64 and not tvl:  # TVλ with windows: the B=2048 case above
                chk_ref = chk.T.reshape(512, G._seg(T_EDGE)[1], -1)
                ref = (G.adjoint_reference_tvl(*args[:4], *args[6:], chk_ref, cot) if tvl else
                       G.adjoint_reference(*args[:6], *args[8:], chk_ref, cot))
                leaves_close(picked, ref, 1e-6, 1e-9, f"{what}: f64 pick's leaves vs plain f64 "
                             "adjoint")
    mats360 = tuple(np.arange(1, 361) / 12.0)
    spec360, _ = yfm.create_model("AFNS5", mats360, float_type="float64")
    rng360 = np.random.default_rng(360)
    data360 = torch.as_tensor(0.5 * rng360.standard_normal((360, 12)) + 4, device=dev)
    for B, pick in ((64, "warp"), (256, "thread")):
        p360 = yfm.params_from_jax(spec360, make_param_batch(spec360.n_params, B, seed=B))
        args = G.core_inputs(spec360, p360, data360, 0, 12)
        bufs = G.lay_out(*args)
        ll, chk = G.launch_forward(bufs)
        cot = torch.where(torch.isfinite(ll), torch.ones_like(ll), torch.zeros_like(ll))
        # the forward as K1: warp at 64 and 256 draws, a forced octet refused
        fwd_launches = G.launch_forward.launches
        try:
            G.launch_forward(bufs, layout="octet")
        except RuntimeError as e:
            check("cudaError 1" in str(e), f"360 maturities forward: {e}")
        else:
            check(False, f"360 maturities f64 B={B}: forward octet launched")
        check(G.launch_forward.launches == fwd_launches, "a refused forward launch was counted")
        check(fwd_layouts_equal(bufs, False, False, f"360 maturities f64 B={B}") == "warp",
              f"360 maturities f64 B={B}: the forward does not pick the warp")
        plan = G.backward_plan(bufs)
        check(plan[0] == pick and plan[1] != "segment", f"360 maturities f64 B={B}: picks "
              f"{kfg_name(*plan)}, expected {pick} keeping less than the segment")
        launches = G.launch_backward.launches
        for layout, store in (("octet", None), ("warp", "segment")):
            try:
                G.launch_backward(bufs, chk, cot, layout=layout, store=store)
            except RuntimeError as e:
                check("cudaError 1" in str(e), f"360 maturities: {e}")
            else:
                check(False, f"360 maturities f64 B={B}: {kfg_name(layout, store)} launched")
        check(G.launch_backward.launches == launches, "a refused launch was counted")
        _, picked = kfg_layouts_equal(bufs, chk, cot, False, False,
                                      f"360 maturities f64 B={B}")
        if pick == "warp":
            chk_ref = chk.T.reshape(B, G._seg(12)[1], -1)
            leaves_close(picked, G.adjoint_reference(*args[:6], *args[8:], chk_ref, cot), 1e-6,
                         1e-9, f"360 maturities f64 B={B}: pick's leaves vs plain f64 adjoint")
        print(f"  360 maturities f64 B={B}: picks {kfg_name(*plan)}; octet and warp/segment "
              f"refused, nothing launched")

    # ---- 7. the fused MLE ----------------------------------------------------------
    S = 256
    begin_phase(f"[7] estimate: AFNS5, N=20, T=360, S={S}, max_iters=50")
    # the panel simulated from the model at the first of phase 2's draws, as
    # bench.py's newton bench simulates its panel at its draws' base point
    sim = simulate_panel(spec64, draws[1024][0].cpu().numpy(), seed=9)
    starts = make_param_batch(spec.n_params, S, seed=11)
    fits = {"AFNS5": full_width_fit(yfm, optimize, spec, spec64, sim, starts, dev)}
    check_parent_fit("estimate AFNS5", fits["AFNS5"]["record"])
    begin_phase(f"[7] estimate: TVλ, N=20, T=360, S={S}, max_iters=50")
    tvl_starts = kalman_draws(tvl64, S, np.random.default_rng(13), TVL_DELTA)
    sim_tvl = simulate_panel(tvl64, tvl_starts[0], seed=17)
    fits["TVλ"] = full_width_fit(yfm, optimize, tvl32, tvl64, sim_tvl, tvl_starts, dev)
    check_parent_fit("estimate TVλ", fits["TVλ"]["record"])
    report["estimate"] = fits

    mats6 = tuple(np.array([3, 12, 36, 84, 180, 360]) / 12.0)
    # TVλ from σ² = 0.25 stops at iteration 0, its first step −g too long
    # for 25 backtracks; from σ² = 1 it moves
    for code, obs_var in (("1C", 0.25), ("TVλ", 1.0)):
        print(f'  "{code}", N=6, T=60, S=3: the card against the CPU')
        check_parent_fit(f"estimate {code} N=6", small_fit(yfm, optimize, code, mats6, obs_var))

    # ---- 8. rolling-window re-estimation ---------------------------------------------
    W, S8 = 8, 32
    ends = [248 + 16 * w for w in range(W)]
    begin_phase(f"[8] estimate_windows: W={W} expanding windows [0, 248+16w) × S={S8} starts")
    report["estimate_windows"] = {}
    for label, s32, sim_np, starts_np in (("AFNS5", spec, sim, starts[:S8]),
                                          ("TVλ", tvl32, sim_tvl, tvl_starts[:S8])):
        report["estimate_windows"][label] = windows_fit(yfm, optimize, label, s32, sim_np,
                                                        starts_np, ends)
        check_parent_fit(f"estimate_windows {label}",
                         report["estimate_windows"][label]["record"])

    head = shapes["1024"]
    kernels = [{
        "name": "K1 fused_kf", "route": "cuda",
        "source": "yieldfactormodels_jl_tpu_torch/csrc/fused_kf.cu",
        "replaces": "yieldfactormodels_jl_tpu/ops/pallas_kf.py:102",
        "launches": launches, "max_abs_err": max(errs),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "shapes": shapes,
        "chain_bound_ms": report["k1_chain_bound_ms"],
        "layouts": {key: v["ms"] for key, v in k1_layouts.items()},
        "pick": {key: v["pick"] for key, v in k1_layouts.items()},
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
        if name.endswith("f"):
            mine = {k: v for k, v in fwd_layouts_ms.items() if v["kernel"] == name}
            entry["layouts"] = {k: v["ms"] for k, v in mine.items()}
            entry["pick"] = {k: v["pick"] for k, v in mine.items()}
            entry["pick_over_thread"] = {k: v["pick_over_thread"] for k, v in mine.items()}
            entry["chain_bound_ms"] = next(iter(mine.values()))["chain_bound_ms"]
            entry["pick_over_chain"] = {k: v["over_chain"][v["pick"]] for k, v in mine.items()}
        if name.endswith("b"):
            fam = "AFNS5" if name == "K2b" else "TVλ"
            entry["layouts"] = {k: v["ms"] for k, v in kfg_layouts.items() if v["kernel"] == name}
            entry["pick"] = {k: v["pick"] for k, v in kfg_layouts.items() if v["kernel"] == name}
            entry["chain_bound_ms"] = {k: v for k, v in report["kfg_chain_bound_ms"].items()
                                       if k.startswith(fam)}
            entry["gradient_criterion"] = {
                key: max(e[key] for e in errs_k)
                for key in ("max_one_minus_cos", "max_norm_ratio_err")}
            entry["f64_leaf_error_over_scale"] = max(grad_errs[name + "_leaves"])
        kernels.append(entry)
    return kernels


#: K4's (rtol, relative nudge) in each type: the kernel against the plain
#: version, and the nudges that decide which draws a type determines
K4_TOLS = {torch.float64: (1e-6, 1e-15), torch.float32: (2e-2, 1e-7)}


def k4_by_phase(events):
    """K4's device seconds and launches by phase, and its launches by batch
    size."""
    dev_s, n_phase, by_batch = {}, {}, {}
    for B, phase, e0, e1 in events:
        dev_s[phase] = dev_s.get(phase, 0.0) + e0.elapsed_time(e1) / 1e3
        n_phase[phase] = n_phase.get(phase, 0) + 1
        by_batch[B] = by_batch.get(B, 0) + 1
    return dev_s, n_phase, by_batch


def hold_k4_counted(k4_counts, what, s64, p64, data64, start=0, end=None, expect_all_inf=False):
    """K4 in both types against the plain versions on the draws each type
    determines (float32 also against the plain float64), the counts kept in
    ``k4_counts``; returns the float32-vs-plain-float64 max abs error."""
    from yieldfactormodels_jl_tpu_torch.ops import fused_ssd

    f32, f64 = torch.float32, torch.float64
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
    k4_errs, k4_counts = [], {}

    def hold_k4(*a, **k):
        return hold_k4_counted(k4_counts, *a, **k)

    ssd_specs = {}
    for code in ("1SSD-NNS", "SSD-NS"):
        s64, _ = yfm.create_model(code, MATURITIES, float_type="float64")
        ssd_specs[code] = s64
        base = ssd_nns_params(s64)
        for B in (257, 2048):
            p64 = torch.as_tensor(ssd_draws(s64, base, B, seed=B), device=dev)
            k4_errs.append(hold_k4(f"{code} B={B}", s64, p64, bpanel64))
    # the other families on the panel's first T_EDGE months
    gp = bpanel[:, :T_EDGE].copy()
    gp[:, 40] = np.nan      # the window's first step: transition-only, no target
    gp[5, 110] = np.nan     # partially NaN: after the window's end, then observed
    gp64 = torch.as_tensor(gp, device=dev, dtype=f64)
    for code in ("1RWSD-NNS", "1SD-NNS-Anchored", "3SRWSD-NNS-Anchored", "SRWSD-NS"):
        s64, _ = yfm.create_model(code, MATURITIES, float_type="float64")
        p = ssd_draws(s64, ssd_nns_params(s64), 512, seed=5)
        p[3] = np.nan                                   # invalid draw → −inf
        p64 = torch.as_tensor(p, device=dev)
        k4_errs.append(hold_k4(f"{code} B=512 NaN column, T={T_EDGE}, window [40, 100)",
                               s64, p64, gp64, 40, 100))
        check(bool(fused_ssd.batched_loss(s64, p64, gp64, 40, 100)[3] == -math.inf),
              f"{code}: the invalid draw must give −inf")
        hold_k4(f"{code} B=512 window [43, 113) with the partial NaN column", s64, p64,
                gp64, 43, 113, expect_all_inf=True)

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
    begin_phase(f"[11] estimate_steps: 1SSD-NNS, N=20, T=360, 3 starts, {SSD_GROUP_ITERS} "
                "group iteration(s)")
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
                                                      max_group_iters=SSD_GROUP_ITERS)
        torch.cuda.synchronize()
        wall6 = time.perf_counter() - t0
        k4_launches = fused_ssd.batched_loss.launches
        plain_calls = [fn.calls for fn in plain_counters]
    k4_dev_s, _, by_batch = k4_by_phase(phases["k4_events"])
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


# ---- the reference's driver: run() on "1C" at full width, phase 15 -----------

#: ``run()``'s results in [15] on an H100: the first 16 hex digits of the
#: sha256 of the in-sample fit's parameters (float64 bytes, as ``run``
#: returns them) and of the sequential run's expanding-window forecast CSV
#: (its bytes), and K1's launches; [15] must repeat them bit for bit
#: (recorded on an NVIDIA H100 80GB HBM3)
RUN_FITS = {"params_sha256": "18548d5b956ed1bb", "forecasts_sha256": "32270505768e6ae1",
            "K1": 50936}

RUN_T_IN, RUN_H = 357, 12   # in-sample end and horizon: origins 357..360
RUN_DELTA = [0.4, -0.1, 0.05]


@contextlib.contextmanager
def _chdir(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def write_run_inputs(root, panel, p0, code="1C"):
    """The reference's data, maturity and initial-parameter CSVs for thread
    "1" and ``code`` under ``root`` (the initial parameters relative to it,
    where ``load_initial_parameters`` reads them with ``root`` as the working
    directory)."""
    data_dir = os.path.join(root, "YieldFactorModels.jl", "data")
    init_dir = os.path.join(root, "YieldFactorModels.jl", "initializations", code)
    os.makedirs(data_dir)
    os.makedirs(init_dir)
    np.savetxt(os.path.join(data_dir, "thread_id__1__data.csv"), panel, delimiter=",")
    np.savetxt(os.path.join(data_dir, "thread_id__1__maturities.csv"), MATURITIES,
               delimiter=",")
    np.savetxt(os.path.join(init_dir, f"init_params_{code}.csv"), p0, delimiter=",")
    return os.path.join(root, "YieldFactorModels.jl", "results", "thread_id__1", code)


@contextlib.contextmanager
def instrumented_run(yfm, timer, fits, k1_runs):
    """Inside the block: ``timer`` records the walls of ``run``'s stages
    (in-sample estimation, window estimations, the Nelder–Mead groups in
    them, predicts, merge and export), each ending in a synchronize;
    ``fits`` collects (end, ll) of every ``estimate_steps``; ``k1_runs``
    (batch size, stage) of every K1 launch, eager or replayed from its CUDA
    graph."""
    import importlib

    from yieldfactormodels_jl_tpu_torch import forecasting
    from yieldfactormodels_jl_tpu_torch.estimation import optimize
    from yieldfactormodels_jl_tpu_torch.models import api
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf

    run_mod = importlib.import_module("yieldfactormodels_jl_tpu_torch.run")
    active = ["other"]
    targets = ((run_mod, "run_estimation", "insample_estimation"),
               (forecasting, "_estimate_for_window", "window_estimation"),
               (optimize, "_neldermead_group", "neldermead"),
               (api, "predict", "predict"),
               (forecasting, "merge_and_export", "merge_export"))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

    def staged(fn, stage):
        def run(*a, **k):
            torch.cuda.synchronize()
            outer, active[0] = active[0], stage
            try:
                with timer.stage(stage):
                    out = fn(*a, **k)
                    torch.cuda.synchronize()
            finally:
                active[0] = outer
            return out
        return run

    steps = optimize.estimate_steps

    def recorded_steps(*a, **k):
        out = steps(*a, **k)
        fits.append((int(k["end"]), float(out[1])))
        return out

    launch, replay = fused_kf.launch, fused_kf.LoglikGraph.__call__

    def counted_launch(inputs, layout=None):
        if not torch.cuda.is_current_stream_capturing():
            k1_runs.append((inputs.out.shape[0], active[0]))
        return launch(inputs, layout)

    def counted_replay(graph, x):
        k1_runs.append((graph.out.numel(), active[0]))
        return replay(graph, x)

    for (mod, name, stage), (_, _, fn) in zip(targets, saved):
        setattr(mod, name, staged(fn, stage))
    optimize.estimate_steps = recorded_steps
    fused_kf.launch = counted_launch
    fused_kf.LoglikGraph.__call__ = counted_replay
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        optimize.estimate_steps = steps
        fused_kf.launch = launch
        fused_kf.LoglikGraph.__call__ = replay


def check_run_artifacts(res_dir, what, n_origins=4, code="1C", t_in=None):
    """The files a sequential or batched run of ``code`` with in-sample end
    ``t_in`` (``RUN_T_IN``) leaves: in-sample CSVs, the merged DB with one
    row an origin, the legacy window CSVs; all finite.  Returns the forecast
    CSV's path."""
    t_in = RUN_T_IN if t_in is None else t_in
    import sqlite3

    for suffix in ("factors_filtered_insample", "fit_filtered_insample",
                   "factor_loadings_1_filtered_insample", "factors_filtered_outofsample",
                   "fit_filtered_outofsample", "loss", "out_params"):
        arr = np.loadtxt(os.path.join(res_dir, f"{code}__thread_id__1__{suffix}.csv"),
                         delimiter=",")
        check(np.isfinite(arr).all(), f"{what}: {suffix} is not finite")
    merged = os.path.join(res_dir, "db", "forecasts_expanding_merged.sqlite3")
    conn = sqlite3.connect(merged)
    try:
        rows = conn.execute("SELECT task_id, loss FROM forecasts ORDER BY task_id").fetchall()
    finally:
        conn.close()
    check([r[0] for r in rows] == list(range(t_in, t_in + n_origins)),
          f"{what}: merged DB rows {rows}")
    check(all(r[1] is not None and math.isfinite(r[1]) for r in rows),
          f"{what}: a window's ll is not finite: {rows}")
    for kind in ("forecasts", "fitted_params", "factors", "states", "fl1", "fl2"):
        arr = np.loadtxt(os.path.join(res_dir,
                                      f"{code}__thread_id__1__expanding_window_{kind}.csv"),
                         delimiter=",")
        check(np.isfinite(arr).all(), f"{what}: expanding_window_{kind} is not finite")
        if kind == "forecasts":
            check(arr.shape == (n_origins * RUN_H, 2 + N_MATURITIES),
                  f"{what}: forecast CSV shape {arr.shape}")
    print(f"  {what}: in-sample CSVs, merged DB ({len(rows)} rows) and window CSVs "
          f"present and finite; forecast CSV {n_origins * RUN_H} × {2 + N_MATURITIES}")
    return os.path.join(res_dir, f"{code}__thread_id__1__expanding_window_forecasts.csv")


def timed_call(fn):
    """One call of ``fn`` between CUDA events: (ms, its result)."""
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


@contextlib.contextmanager
def timed_plain_adjoint(G):
    """Inside the block, time every call of the plain K2f and K2b
    (``forward_reference``, ``adjoint_reference``) by CUDA events; yields
    the dict of their last times in ms."""
    times = {}
    saved = {"forward": G.forward_reference, "adjoint": G.adjoint_reference}

    def timing(name, fn):
        def run(*a, **k):
            times[name], out = timed_call(lambda: fn(*a, **k))
            return out
        run.calls = 0  # the plain versions count themselves by their module names
        return run

    G.forward_reference = timing("forward", saved["forward"])
    G.adjoint_reference = timing("adjoint", saved["adjoint"])
    try:
        yield times
    finally:
        G.forward_reference, G.adjoint_reference = saved["forward"], saved["adjoint"]


def run_phases(yfm, dev, report):
    """Phase 15: the port's ``run()`` on "1C" at full width, sequential (the
    Kalman ``estimate_steps`` on K1) and with batched windows (K2f/K2b).
    Returns the kernels line's entries for K1, K2f and K2b on this path."""
    import tempfile

    from yieldfactormodels_jl_tpu_torch.estimation import optimize
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf_grad as G
    from yieldfactormodels_jl_tpu_torch.utils.profiling import StageTimer

    f32 = torch.float32
    begin_phase(f'[15] run(): "1C", N={N_MATURITIES}, T={T_MONTHS}, float32, in-sample '
                f"fit and 4 re-estimated origins, then the origins batched")
    panel = make_dns_panel(seed=21)
    spec64, _ = yfm.create_model("1C", MATURITIES, float_type="float64")
    spec32, _ = yfm.create_model("1C", MATURITIES)
    p0 = kalman_draws(spec64, 1, np.random.default_rng(23), RUN_DELTA)[0]
    panel32 = torch.as_tensor(panel, device=dev, dtype=f32)
    # every fit starts at p0 (the windows too: the reference passes the
    # initial parameters to each origin); its ll on each fit's sample, as
    # estimate_steps' first simplex vertex sees it
    x0 = optimize._sanitize(yfm.untransform_params(spec64, torch.as_tensor(p0)).numpy())
    c0 = yfm.transform_params(spec32, torch.as_tensor(x0, dtype=f32, device=dev))[None]
    ll_start = {end: float(fused_kf.batched_loglik(spec32, c0, panel32, 0, end))
                for end in range(RUN_T_IN, RUN_T_IN + 4)}
    check(all(math.isfinite(v) for v in ll_start.values()), f"start lls {ll_start}")

    with tempfile.TemporaryDirectory(prefix="yfm_run_") as root:
        seq_root, bat_root = os.path.join(root, "sequential"), os.path.join(root, "batched")
        res_seq = write_run_inputs(seq_root, panel, p0)
        res_bat = write_run_inputs(bat_root, panel, p0)

        timer, fits, k1_runs = StageTimer(), [], []
        with _chdir(seq_root), instrumented_run(yfm, timer, fits, k1_runs), \
                contextlib.redirect_stdout(io.StringIO()) as log:
            fused_kf.batched_loglik.launches = 0
            fused_kf.batched_loglik_reference.calls = 0
            t0 = time.perf_counter()
            _, params = yfm.run("1", RUN_T_IN, RUN_H, True, "1C", "float32",
                                window_type="expanding", scratch_dir=seq_root + os.sep)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k1_launches = fused_kf.batched_loglik.launches
            k1_plain = fused_kf.batched_loglik_reference.calls
        check(k1_launches >= 1 and k1_plain == 0,
              f"run(): K1 launches {k1_launches}, plain-version calls {k1_plain}")
        check(len(fits) == 5, f"run(): {len(fits)} estimate_steps calls, not 5")
        for end, ll in fits:
            check(ll >= ll_start[end], f"fit on [0, {end}) ended at ll {ll} below its "
                  f"start's {ll_start[end]}")
        fc_seq = check_run_artifacts(res_seq, "sequential run")
        ll_in = float(np.loadtxt(os.path.join(res_seq, "1C__thread_id__1__loss.csv")))
        out_params = np.loadtxt(os.path.join(res_seq, "1C__thread_id__1__out_params.csv"))
        ll_cpu = float(yfm.get_loss(spec64, out_params, panel.astype(np.float32), 0,
                                    RUN_T_IN, device="cpu"))
        check(abs(ll_in - ll_cpu) <= 1e-4 * abs(ll_cpu),
              f"in-sample ll {ll_in} vs the plain float64 loss on the CPU {ll_cpu}")
        by_batch, by_stage = {}, {}
        for B, stage in k1_runs:
            by_batch[B] = by_batch.get(B, 0) + 1
            by_stage[stage, B] = by_stage.get((stage, B), 0) + 1
        check(sum(by_batch.values()) == k1_launches,
              f"run(): {sum(by_batch.values())} K1 launches seen, {k1_launches} counted")
        stages = timer.summary()
        record = {"params_sha256": sha16(np.asarray(params, dtype=np.float64)),
                  "forecasts_sha256": hashlib.sha256(open(fc_seq, "rb").read()).hexdigest()[:16],
                  "K1": k1_launches}
        print(f"  sequential run: wall {wall:.2f} s, in-sample ll {ll_in!r} (plain f64 on "
              f"the CPU {ll_cpu!r}); fits (end, ll): {fits}")
        print("  wall by stage: " + ", ".join(
            f"{k} {v['total']:.2f} s ({v['count']}×)" for k, v in stages.items()))
        print(f"  K1 launches {k1_launches} by batch size {dict(sorted(by_batch.items()))}")
        print(f"  record: {json.dumps(record)}")
        check(RUN_FITS == record, f"run(): differs from the recorded {RUN_FITS}")
        print("  the recorded parameters, forecasts and K1 launches bit for bit")

        with _chdir(bat_root), contextlib.redirect_stdout(io.StringIO()):
            zero_counts(spec32)
            t0 = time.perf_counter()
            yfm.run("1", RUN_T_IN, RUN_H, True, "1C", "float32", window_type="expanding",
                    run_optimization=False, batched_windows=True,
                    scratch_dir=bat_root + os.sep)
            torch.cuda.synchronize()
            wall_b = time.perf_counter() - t0
            counts_b = read_counts(spec32, None)
        check(counts_b["forward"] == counts_b["backward"] >= 1 and counts_b["K1"] >= 1,
              f"batched run: launches {counts_b}")
        check(counts_b["plain"] == (0, 0, 0), f"batched run: plain versions ran {counts_b}")
        check_run_artifacts(res_bat, "batched run")
        print(f"  batched run: wall {wall_b:.2f} s, launches {counts_b}")

    # the kernels at the path's shapes against their plain versions on the
    # same float32 inputs, each plain call timed by CUDA events; K1 at every
    # batch size the run launched, at the fit (one draw) or on Nelder–Mead's
    # first simplex (more)
    k1_rows = {}
    x0t = torch.as_tensor(x0, device=dev)
    simplex = yfm.transform_params(
        spec64, torch.cat([x0t[None], x0t + torch.diag_embed(0.025 + 0.05 * x0t)]))
    errs = []
    for B in sorted(by_batch):
        p64 = (torch.as_tensor(out_params, device=dev)[None] if B == 1
               else simplex.repeat(-(-B // simplex.shape[0]), 1)[:B])
        p32 = p64.float()
        inputs = fused_kf.kernel_inputs(spec32, p32, panel32, 0, RUN_T_IN)
        got = fused_kf.launch(inputs).clone()
        plain_ms, ref = timed_call(lambda: fused_kf.batched_loglik_reference(
            spec32, p32, panel32, 0, RUN_T_IN))
        errs.append(close(got, ref, *TOLS[f32][:2], f"K1 B={B} vs plain"))
        ms = cuda_ms(lambda: fused_kf.launch(inputs), reps=50)
        bound_ms, bound_by = bound(*kernel_work(inputs, panel32))
        k1_rows[B] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "launches": by_batch[B],
                      "layout": fused_kf.layout_of(inputs)}
        print(f"  K1 B={B} ({k1_rows[B]['layout']}): {ms:.4f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound_ms:.6f} ms ({bound_by})")
    # the Nelder–Mead iterations' K1 runs replayed from a CUDA graph: the
    # replay against the eager launch, bit for bit
    X1 = yfm.untransform_params(spec64, simplex).float()
    graph = fused_kf.LoglikGraph(lambda X: fused_kf.batched_loglik(
        spec32, yfm.transform_params(spec32, X), panel32, 0, RUN_T_IN), X1[:1])
    for row in X1[:4]:
        eager = fused_kf.batched_loglik(spec32, yfm.transform_params(spec32, row[None]),
                                        panel32, 0, RUN_T_IN)
        check(torch.equal(graph(row[None]), eager), "K1's graph replay differs from "
              "its eager launch")
    print("  K1 replayed from its CUDA graph: the eager launch's bits on 4 draws")
    k1_dev = {key: n * k1_rows[key[1]]["ms"] / 1e3 for key, n in by_stage.items()}
    k1_s = sum(k1_dev.values())
    nm_s = stages["neldermead"]["total"]
    nm_k1 = sum(v for (stage, _), v in k1_dev.items() if stage == "neldermead")
    print(f"  K1 on the card (launches × ms a launch at their batch size) {k1_s:.2f} s of "
          f"the sequential run's {wall:.2f} s wall ({100 * k1_s / wall:.1f}%); {nm_k1:.2f} s "
          f"of the Nelder–Mead groups' {nm_s:.2f} s, the rest (host and K1's set-up "
          f"kernels) {nm_s - nm_k1:.2f} s ({100 * (nm_s - nm_k1) / nm_s:.1f}%)")
    # K2f/K2b on the batched run's windows: 4 origins × 1 start, value and
    # gradient in the raw parameters through the kernels against the plain
    # versions
    ends = torch.arange(RUN_T_IN, RUN_T_IN + 4, device=dev)
    win = (torch.zeros_like(ends), ends)
    X4 = torch.as_tensor(np.tile(x0, (4, 1)), device=dev, dtype=f32)
    v_k, g_k = raw_value_and_grad(yfm, spec32, X4, panel32, G._KalmanCore.apply, win)
    with timed_plain_adjoint(G) as plain_ms2:
        v_p, g_p = raw_value_and_grad(yfm, spec32, X4, panel32, plain_core(spec32), win)
    err_f = close(v_k, v_p, *TOLS[f32][:2], "K2f B=4 windows: −ll vs plain")
    grad_agreement(g_k, g_p, "K2b B=4 windows: raw gradient vs plain")
    err_b = float((g_k - g_p).abs().max())
    args = G.core_inputs(spec32, yfm.transform_params(spec32, X4), panel32, 0, T_MONTHS, *win)
    bufs = G.lay_out(*args)
    ll_k, chk = G.launch_forward(bufs)
    g = torch.ones(4, device=dev, dtype=f32)
    grads = G.launch_backward(bufs, chk, g)
    f_ms = cuda_ms(lambda: G.launch_forward(bufs), reps=20)
    b_ms = cuda_ms(lambda: G.launch_backward(bufs, chk, g), reps=20)
    f_plain, b_plain = plain_ms2["forward"], plain_ms2["adjoint"]
    (fb, ff), (bb, bf), _ = grad_kernel_work(bufs, panel32, ll_k, chk, grads)
    f_bound, f_by = bound(fb, ff)
    b_bound, b_by = bound(bb, bf)
    print(f"  K2f B=4: {f_ms:.4f} ms, plain {f_plain:.1f} ms, bound {f_bound:.6f} ms; "
          f"K2b B=4: {b_ms:.4f} ms, plain {b_plain:.1f} ms, bound {b_bound:.6f} ms")

    report["run"] = {
        "wall_s": wall, "stages": stages, "fits": fits, "ll_start": ll_start,
        "insample_ll": ll_in, "insample_ll_cpu_f64": ll_cpu, "record": record,
        "k1_launches": k1_launches, "k1_launches_by_batch": by_batch,
        "k1_launches_by_stage": {f"{k[0]} B={k[1]}": v for k, v in by_stage.items()},
        "k1_device_s": k1_s,
        "k1_share": k1_s / wall, "neldermead_host_share": (nm_s - nm_k1) / nm_s,
        "batched_wall_s": wall_b, "batched_counts": counts_b,
        "k1_shapes": k1_rows, "log_tail": log.getvalue()[-2000:]}
    head = k1_rows[1]
    common = {"route": "cuda", "library_ms": None}
    return [
        {"name": "K1 fused_kf in run()", **common,
         "source": "yieldfactormodels_jl_tpu_torch/csrc/fused_kf.cu",
         "replaces": "yieldfactormodels_jl_tpu/ops/pallas_kf.py:102",
         "launches": k1_launches, "max_abs_err": max(errs), "ms": head["ms"],
         "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
         "bound_by": head["bound_by"], "shapes": k1_rows},
        {"name": "K2f fused_kf_grad in run(batched_windows)", **common,
         "source": "yieldfactormodels_jl_tpu_torch/csrc/fused_kf_grad.cu",
         "replaces": "yieldfactormodels_jl_tpu/ops/pallas_kf_grad.py:127",
         "launches": counts_b["forward"], "max_abs_err": err_f, "ms": f_ms,
         "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by},
        {"name": "K2b fused_kf_grad in run(batched_windows)", **common,
         "source": "yieldfactormodels_jl_tpu_torch/csrc/fused_kf_grad.cu",
         "replaces": "yieldfactormodels_jl_tpu/ops/pallas_kf_grad.py:181",
         "launches": counts_b["backward"], "max_abs_err": err_b, "ms": b_ms,
         "plain_ms": b_plain, "bound_ms": b_bound, "bound_by": b_by},
    ]


# ---- the reference's warm-start cascade: run("NS") → run("SD-NS"), phase 16 --

#: the cascade's results in [16] on an H100: the first 16 hex digits of the
#: sha256 of the NS and SD-NS in-sample parameters (float64 bytes, as ``run``
#: returns them) and of SD-NS's expanding-window forecast CSV (its bytes), and
#: K4's launches in ``run("SD-NS")``; [16] must repeat them bit for bit
#: (recorded on an NVIDIA H100 80GB HBM3)
CASCADE_FITS = {"ns_params_sha256": "b16e901df681dcc8", "sdns_params_sha256": "7961767537d0d7ac",
                "forecasts_sha256": "0be45741c216fcff", "K4": 182}

#: (code, in-sample end, group iterations) of [16]'s two runs: NS at the
#: reference's budget, its 4 origins 357..360; SD-NS at 1 group iteration
#: and 1 origin (360, in-sample end 360), the depth the script's time limit
#: allows (a score-driven fit costs ≈3–7 s of plain scans on the card, a
#: predict 1–2 s, a group iteration more another 2–4 s)
CASCADE_RUNS = (("NS", RUN_T_IN, 10), ("SD-NS", T_MONTHS, 1))
#: the NS start: λ = 0.4 (γ = ln 0.39), δ = (0.4, −0.1, 0.05), Φ = 0.85 I
CASCADE_NS_START = [math.log(0.39), 0.4, -0.1, 0.05] + (0.85 * np.eye(3)).T.reshape(-1).tolist()
#: the SD-NS start: A = 1e-3, B = 0.97; its [ω; δ; Φ] tail is NS's fit
CASCADE_SD_START = [1e-3, 0.97] + CASCADE_NS_START


def write_cascade_inputs(root, panel):
    """The data and maturity CSVs of thread "1" and the NS and SD-NS
    initial parameters under ``root`` (the working directory of the runs)."""
    data_dir = os.path.join(root, "YieldFactorModels.jl", "data")
    os.makedirs(data_dir)
    np.savetxt(os.path.join(data_dir, "thread_id__1__data.csv"), panel, delimiter=",")
    np.savetxt(os.path.join(data_dir, "thread_id__1__maturities.csv"), MATURITIES,
               delimiter=",")
    for code, p0 in (("NS", CASCADE_NS_START), ("SD-NS", CASCADE_SD_START)):
        init_dir = os.path.join(root, "YieldFactorModels.jl", "initializations", code)
        os.makedirs(init_dir)
        np.savetxt(os.path.join(init_dir, f"init_params_{code}.csv"), np.asarray(p0),
                   delimiter=",")
    return os.path.join(root, "YieldFactorModels.jl", "results", "thread_id__1")


@contextlib.contextmanager
def recorded_fits(optimize, static_model):
    """Inside the block: every ``estimate_steps`` call's (code, window end,
    first start as given, start after the initialization grid, ll), and the
    device type of every static loss evaluation."""
    acc = {"fits": [], "static_devices": {}}
    steps, inits, run = (optimize.estimate_steps, optimize.try_initializations,
                         static_model._run)
    grid = []

    def recorded_steps(spec, data, all_params, *a, **k):
        grid.clear()
        out = steps(spec, data, all_params, *a, **k)
        acc["fits"].append({"code": spec.model_string, "end": int(k["end"]),
                            "given": np.asarray(all_params, dtype=np.float64)[:, 0].copy(),
                            "start": grid[0][:, 0], "ll": float(out[1])})
        return out

    def recorded_inits(*a, **k):
        out = inits(*a, **k)
        grid.append(out)
        return out

    def counted_run(spec, params, *a, **k):
        kind = params.device.type
        acc["static_devices"][kind] = acc["static_devices"].get(kind, 0) + 1
        return run(spec, params, *a, **k)

    optimize.estimate_steps, optimize.try_initializations = recorded_steps, recorded_inits
    static_model._run = counted_run
    try:
        yield acc
    finally:
        optimize.estimate_steps, optimize.try_initializations = steps, inits
        static_model._run = run


def cascade_phases(yfm, dev, report):
    """Phase 16: the reference's warm-start cascade on the card — ``run("NS")``
    (the static λ family: its loss on the card's tensors, no kernel) then
    ``run("SD-NS")`` warm-started from NS's results (K4).  Returns the
    kernels line's entry for K4 on this path."""
    import tempfile

    from yieldfactormodels_jl_tpu_torch.estimation import optimize
    from yieldfactormodels_jl_tpu_torch.models import static_model
    from yieldfactormodels_jl_tpu_torch.ops import fused_ssd
    from yieldfactormodels_jl_tpu_torch.persistence import database as tdb
    from yieldfactormodels_jl_tpu_torch.utils.profiling import StageTimer

    f32 = torch.float32
    begin_phase(f'[16] the cascade run("NS") → run("SD-NS"): N={N_MATURITIES}, T={T_MONTHS}, '
                f"float32, NS with 4 re-estimated origins, SD-NS with 1")
    panel = make_dns_panel(seed=21)
    panel32 = torch.as_tensor(panel, device=dev, dtype=f32)
    specs = {code: (yfm.create_model(code, MATURITIES)[0],
                    yfm.create_model(code, MATURITIES, float_type="float64")[0])
             for code in ("NS", "SD-NS")}
    walls, stages, records, k4_events = {}, {}, {}, []
    with tempfile.TemporaryDirectory(prefix="yfm_cascade_") as root:
        results = write_cascade_inputs(root, panel)
        with recorded_fits(optimize, static_model) as rec:
            for code, t_in, iters in CASCADE_RUNS:
                timer = StageTimer()
                with _chdir(root), instrumented_run(yfm, timer, [], []), \
                        timed_estimate_steps(optimize, fused_ssd) as phases, \
                        contextlib.redirect_stdout(io.StringIO()):
                    fused_ssd.batched_loss.launches = 0
                    fused_ssd.batched_loss_reference.calls = 0
                    t0 = time.perf_counter()
                    _, params = yfm.run("1", t_in, RUN_H, True, code, "float32",
                                        window_type="expanding", max_group_iters=iters,
                                        scratch_dir=root + os.sep)
                    torch.cuda.synchronize()
                    walls[code] = time.perf_counter() - t0
                    k4 = (fused_ssd.batched_loss.launches,
                          fused_ssd.batched_loss_reference.calls)
                stages[code] = timer.summary()
                records[code] = np.asarray(params, dtype=np.float64)
                if code == "NS":
                    static_devices = dict(rec["static_devices"])
                    check(static_devices.get("cuda", 0) >= 1 and set(static_devices) == {"cuda"},
                          f'run("NS"): static loss evaluations by device {static_devices}')
                    check(k4[0] == 0, f'run("NS") launched K4 {k4[0]} times')
                else:
                    k4_launches, k4_plain = k4
                    k4_events = phases["k4_events"]
                    check(k4_launches >= 1 and k4_plain == 0,
                          f'run("SD-NS"): K4 launches {k4_launches}, plain-version calls '
                          f"{k4_plain}")
                    check(rec["static_devices"] == static_devices,
                          f'run("SD-NS") evaluated a static loss: {rec["static_devices"]}')
                check_run_artifacts(os.path.join(results, code), f'run("{code}")',
                                    n_origins=T_MONTHS + 1 - t_in, code=code, t_in=t_in)
        fits = rec["fits"]
        res_ns, res_sd = os.path.join(results, "NS"), os.path.join(results, "SD-NS")
        ns_out = np.loadtxt(os.path.join(res_ns, "NS__thread_id__1__out_params.csv"))
        ll_in = float(np.loadtxt(os.path.join(res_ns, "NS__thread_id__1__loss.csv")))
        merged_ns = os.path.join(res_ns, "db", "forecasts_expanding_merged.sqlite3")
        ns_rows = {t: tdb.read_task_params(merged_ns, t)
                   for t in range(RUN_T_IN, RUN_T_IN + 4)}
        fc_sd = os.path.join(res_sd, "SD-NS__thread_id__1__expanding_window_forecasts.csv")
        fc_sha = hashlib.sha256(open(fc_sd, "rb").read()).hexdigest()[:16]

    # the fits: the in-sample one first, then one an origin, each at or above
    # its start (the start after the grid, in the run's own evaluation: the
    # static loss on the card, K4)
    for code, t_in, _ in CASCADE_RUNS:
        mine = [f for f in fits if f["code"] == code]
        check(mine[0]["end"] == t_in and sorted(f["end"] for f in mine[1:])
              == list(range(t_in, T_MONTHS + 1)), f"{code}: fits {[f['end'] for f in mine]}")
        s32 = specs[code][0]
        for f in mine:
            x0 = optimize._sanitize(yfm.untransform_params(
                specs[code][1], torch.as_tensor(f["start"])).numpy())
            c0 = yfm.transform_params(s32, torch.as_tensor(x0, device=dev, dtype=f32))[None]
            f["ll_start"] = float(optimize._batch_loss(s32, c0, panel32, 0, f["end"])[0])
            check(f["ll"] >= f["ll_start"], f"{code} fit on [0, {f['end']}) ended at ll "
                  f"{f['ll']} below its start's {f['ll_start']}")
    # the in-sample NS fit against the plain float64 loss on the CPU
    ll_cpu = float(yfm.get_loss(specs["NS"][1], ns_out, panel.astype(np.float32), 0, RUN_T_IN,
                                device="cpu"))
    check(abs(ll_in - ll_cpu) <= 1e-4 * abs(ll_cpu),
          f"NS in-sample ll {ll_in} vs the plain float64 loss on the CPU {ll_cpu}")
    # SD-NS's warm starts: the [ω; δ; Φ] tail of its first start is NS's
    # out-params in-sample and NS's merged-DB row for the task per origin
    sd = [f for f in fits if f["code"] == "SD-NS"]
    tail = ns_out.size
    check(np.array_equal(sd[0]["given"][-tail:], ns_out),
          "SD-NS in-sample start: its tail is not NS's out-params")
    for f in sd[1:]:
        check(np.array_equal(f["given"][-tail:], ns_rows[f["end"]]),
              f"SD-NS origin {f['end']}: its start's tail is not NS's merged-DB row")
    print(f'  run("NS"): {static_devices} static loss evaluations by device; '
          f"in-sample ll {ll_in!r} (plain f64 on the CPU {ll_cpu!r})")
    print("  SD-NS starts: the in-sample tail is NS's out-params, each origin's NS's "
          "merged-DB row for its task, bit for bit")

    k4_dev_s, _, by_batch = k4_by_phase(k4_events)
    k4_s = sum(k4_dev_s.values())
    for code in ("NS", "SD-NS"):
        print(f'  run("{code}"): wall {walls[code]:.2f} s; fits (end, start ll → ll): '
              + ", ".join(f"({f['end']}, {f['ll_start']:.8f} → {f['ll']:.8f})"
                          for f in fits if f["code"] == code))
        print("    wall by stage: " + ", ".join(
            f"{k} {v['total']:.2f} s ({v['count']}×)" for k, v in stages[code].items()))
    nm_s = stages["SD-NS"].get("neldermead", {"total": 0.0})["total"]
    nm_k4 = k4_dev_s.get("neldermead_s", 0.0)
    print(f'  run("SD-NS"): K4 launches {k4_launches} by batch size '
          f"{dict(sorted(by_batch.items()))}; K4 on the card {k4_s:.2f} s of the "
          f"{walls['SD-NS']:.2f} s wall ({100 * k4_s / walls['SD-NS']:.1f}%), the host and "
          f"the plain scans the rest ({100 * (1 - k4_s / walls['SD-NS']):.1f}%); "
          f"Nelder–Mead {nm_s:.2f} s, K4 {nm_k4:.2f} s of it")
    record = {"ns_params_sha256": sha16(records["NS"]),
              "sdns_params_sha256": sha16(records["SD-NS"]),
              "forecasts_sha256": fc_sha, "K4": k4_launches}
    print(f"  record: {json.dumps(record)}")
    check(CASCADE_FITS == record, f"cascade: differs from the recorded {CASCADE_FITS}")
    print("  the recorded parameters, forecasts and K4 launches bit for bit")

    # K4 at the path's shapes against its plain versions: the in-sample
    # fit's grid (its start and the 30 A×B guesses) and the fitted point
    s32, s64 = specs["SD-NS"]
    panel64 = panel32.double()
    t_sd = CASCADE_RUNS[1][1]
    grid = np.concatenate([ssd_draws(s64, sd[0]["given"], 31, seed=0), records["SD-NS"][None]])
    counts = {}
    err = hold_k4_counted(counts, f"K4 B={grid.shape[0]}: SD-NS grid and fit on [0, {t_sd})",
                          s64, torch.as_tensor(grid, device=dev), panel64, 0, t_sd)
    p1 = torch.as_tensor(records["SD-NS"][None], device=dev, dtype=f32)
    inputs = fused_ssd.kernel_inputs(s32, p1, panel32, 0, t_sd)
    ms = cuda_ms(lambda: fused_ssd.launch(inputs), reps=20)
    plain_ms, _ = timed_call(lambda: fused_ssd.batched_loss_reference(s32, p1, panel32, 0,
                                                                      t_sd))
    flops = ssd_flops(s32, panel32, 0, t_sd)
    bound_ms, bound_by = bound(nbytes(*inputs.buffers, inputs.out), flops)
    print(f"  K4 B=1 (the Nelder–Mead batch): {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}); K4 time × launches ≈ {k4_s:.2f} s")
    report["cascade"] = {
        "walls_s": walls, "stages": stages, "record": record,
        "fits": [{k: v for k, v in f.items() if k in ("code", "end", "ll", "ll_start")}
                 for f in fits],
        "static_devices": static_devices, "insample_ll": ll_in, "insample_ll_cpu_f64": ll_cpu,
        "k4_launches": k4_launches, "k4_launches_by_batch": by_batch,
        "k4_device_s": k4_dev_s, "k4_share": k4_s / walls["SD-NS"], "k4_determined": counts}
    return [{"name": "K4 fused_ssd in run(SD-NS)", "route": "cuda",
             "source": "yieldfactormodels_jl_tpu_torch/csrc/fused_ssd.cu",
             "replaces": "yieldfactormodels_jl_tpu/ops/pallas_ssd.py:214",
             "launches": k4_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
             "launches_by_batch": by_batch}]


# ---- the gradient groups: phase 17 ----------------------------------------------

#: [17]'s results on an H100: the first 16 hex digits of the sha256 of (a)'s
#: "SD-NS" best parameters and (c)'s "RW" in-sample parameters (float64
#: bytes) and of (c)'s expanding-window forecast CSV (its bytes), and K4's
#: launches in (a); [17] must repeat them bit for bit (recorded on an NVIDIA
#: H100 80GB HBM3)
GRAD_FITS = {"sdns_params_sha256": "21841b52f80d7cce", "rw_params_sha256": "195429b258956ae1",
             "rw_forecasts_sha256": "3b04855969602f67", "K4": 194}

#: [17]'s budgets.  (a) runs the reference's default table at 1 group
#: iteration ([11]'s depth) with group "2" L-BFGS capped at
#: ``GRAD_LBFGS_ITERS`` iterations (the reference's 250: each iteration
#: takes one value-and-gradient pass of the score-driven scan through the
#: inner score, ≈2.5 s a pass at T=360 on an H100), and its float64 repeat
#: on the card and the CPU at T=``GRAD_F64_T`` with group "2" capped at
#: ``GRAD_F64_ITERS``; (b) runs ``GRAD_VMAP_ITERS`` L-BFGS iteration (the
#: reference's 1,000; 3 took (b) to 38 s, its value-and-gradient passes
#: ≈2.9 s each on the univariate engine at T=120) from ``GRAD_VMAP_STARTS``
#: starts; (c)'s Adam check runs ``GRAD_ADAM_ITERS`` iterations
GRAD_LBFGS_ITERS = 3
GRAD_F64_T, GRAD_F64_ITERS = 60, 3
GRAD_VMAP_STARTS, GRAD_VMAP_ITERS = 4, 1
GRAD_ADAM_ITERS = 50


def capped_table(optimize, iters):
    """The default group table with group "2"'s L-BFGS capped at ``iters``."""
    table = dict(optimize.DEFAULT_OPTIMIZERS)
    kind, opts = table["2"]
    table["2"] = (kind, dict(opts, max_iters=iters))
    return table


@contextlib.contextmanager
def recorded_iterates(optimize):
    """Inside the block, every point at which a value-and-gradient pass of a
    plain engine ran (float64 on the host); yields the list."""
    seen, vag = [], optimize._values_and_grads

    def recording(objective, X):
        seen.append(X.detach().double().cpu().clone())
        return vag(objective, X)

    optimize._values_and_grads = recording
    try:
        yield seen
    finally:
        optimize._values_and_grads = vag


def grad_phases(yfm, dev, report):
    """Phase 17: the estimation paths that take gradients outside the fused
    Kalman kernels, on the card — (a) "SD-NS" ``estimate_steps`` off the
    closed form (group "2" by the batched L-BFGS whose Armijo probes are K4
    launches and whose gradients come from the scan through the inner
    score), (b) ``estimate("1C", objective="vmap")`` (each start's own
    L-BFGS on the plain univariate engine), (c) ``run("RW")`` (the random
    walk's (δ, Φ) group by the per-start L-BFGS on the static loss) and Adam
    on a static group.  Returns the kernels line's entry for K4 on (a)."""
    import tempfile

    from yieldfactormodels_jl_tpu_torch.estimation import optimize
    from yieldfactormodels_jl_tpu_torch.models import static_model
    from yieldfactormodels_jl_tpu_torch.ops import fused_kf, fused_ssd
    from yieldfactormodels_jl_tpu_torch.utils.profiling import StageTimer

    f32, f64 = torch.float32, torch.float64
    begin_phase(f'[17] the gradient groups: "SD-NS" estimate_steps off the closed form, '
                f'estimate("1C", objective="vmap"), run("RW"); N={N_MATURITIES}')
    panel = make_dns_panel(seed=21)
    # a missing first column: a transition-only step, so the closed form
    # does not apply while the loss stays finite (a NaN column after the
    # window's first step is a target, and every loss is −Inf)
    gapped = panel.copy()
    gapped[:, 0] = np.nan
    s32, _ = yfm.create_model("SD-NS", MATURITIES)
    s64, _ = yfm.create_model("SD-NS", MATURITIES, float_type="float64")
    groups = yfm.get_param_groups(s32)
    start = np.asarray(CASCADE_SD_START)[:, None]

    # ---- (a) "SD-NS" estimate_steps, float32, T=360 -------------------------------
    with timed_estimate_steps(optimize, fused_ssd) as ph:
        fused_ssd.batched_loss.launches = 0
        fused_ssd.batched_loss_reference.calls = 0
        t0 = time.perf_counter()
        _, ll_a, best_a, conv_a = yfm.estimate_steps(
            s32, gapped, start, groups, max_group_iters=1,
            optimizers=capped_table(optimize, GRAD_LBFGS_ITERS))
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        k4_a, k4_plain_a = fused_ssd.batched_loss.launches, fused_ssd.batched_loss_reference.calls
    check(k4_a >= 1 and k4_plain_a == 0,
          f"(a): K4 launches {k4_a}, plain-version calls {k4_plain_a}")
    check(len(ph["lbfgs_iters"]) == 1 and ph["grad_passes"] >= 1,
          f"(a): group \"2\" did not run the batched L-BFGS: {ph['lbfgs_iters']}")
    g32 = torch.as_tensor(gapped, device=dev, dtype=f32)
    x0 = optimize._sanitize(yfm.untransform_params(
        s64, torch.as_tensor(ph["grid_winner"][:, 0])).numpy())
    ll_start = float(optimize._batch_loss(
        s32, yfm.transform_params(s32, torch.as_tensor(x0, device=dev, dtype=f32))[None],
        g32, 0, T_MONTHS)[0])
    check(math.isfinite(ll_a) and ll_a >= ll_start,
          f"(a): ll {ll_a} below the start's {ll_start}")
    k4_dev_s, k4_phases, k4_batches = k4_by_phase(ph["k4_events"])
    check(k4_phases.get("lbfgs_s", 0) >= 1,
          f"(a): no Armijo probe of the L-BFGS group launched K4: {k4_phases}")
    k4_s = sum(k4_dev_s.values())
    other_s = wall_a - ph["grid_s"] - ph["neldermead_s"] - ph["lbfgs_s"] - ph["verify_s"]
    print(f"  (a) SD-NS, T={T_MONTHS}, NaN first column, float32: ll {ll_start!r} → {ll_a!r}, "
          f"{conv_a}; Nelder–Mead iterations {ph['nm_iters']}, L-BFGS iterations "
          f"{ph['lbfgs_iters']} (cap {GRAD_LBFGS_ITERS})")
    print(f"    wall {wall_a:.2f} s: grid {ph['grid_s']:.2f} s, Nelder–Mead "
          f"{ph['neldermead_s']:.2f} s, L-BFGS {ph['lbfgs_s']:.2f} s (of which "
          f"{ph['grad_passes']} scan value-and-gradient passes {ph['grad_s']:.2f} s, "
          f"{ph['grad_s'] / ph['grad_passes']:.2f} s a pass), trust-but-verify "
          f"{ph['verify_s']:.2f} s, other {other_s:.2f} s")
    print(f"    K4 launches {k4_a} by batch size {dict(sorted(k4_batches.items()))}, by "
          f"phase {k4_phases}, on the card {k4_s:.3f} s ({100 * k4_s / wall_a:.2f}% of the "
          f"wall; in the L-BFGS probes {k4_dev_s.get('lbfgs_s', 0.0):.3f} s); gradient "
          f"passes {100 * ph['grad_s'] / wall_a:.1f}% of the wall")

    # ---- (a) in float64 at T=GRAD_F64_T, the card against the CPU ------------------
    cut = gapped[:, :GRAD_F64_T]
    runs = []
    for where in (dev, torch.device("cpu")):
        with timed_estimate_steps(optimize, fused_ssd) as ph64:
            t0 = time.perf_counter()
            out = yfm.estimate_steps(s64, cut, start, groups, max_group_iters=1,
                                     optimizers=capped_table(optimize, GRAD_F64_ITERS),
                                     device=where)
            torch.cuda.synchronize()
            runs.append((out, ph64["nm_iters"], ph64["lbfgs_iters"], ph64["grad_passes"],
                         time.perf_counter() - t0))
    ((_, ll_g, best_g, conv_g), nm_g, lb_g, passes_g, wall_g), \
        ((_, ll_c, best_c, conv_c), nm_c, lb_c, passes_c, wall_c) = runs
    check(tuple(conv_g) == tuple(conv_c) and nm_g == nm_c and lb_g == lb_c,
          f"(a) float64: iterations differ, card {conv_g} {nm_g} {lb_g}, CPU {conv_c} "
          f"{nm_c} {lb_c}")
    check(abs(ll_g - ll_c) <= 1e-6 * abs(ll_c),
          f"(a) float64: ll on the card {ll_g!r}, on the CPU {ll_c!r}")
    print(f"  (a) float64, T={GRAD_F64_T}, group \"2\" capped at {GRAD_F64_ITERS}: card ll "
          f"{ll_g!r} ({wall_g:.2f} s, {passes_g} gradient passes), CPU {ll_c!r} "
          f"({wall_c:.2f} s); Nelder–Mead iterations {nm_g}, L-BFGS {lb_g} on both")

    # ---- (b) estimate("1C", objective="vmap") at T=T_EDGE ------------------------
    c32, _ = yfm.create_model("1C", MATURITIES)
    c64, _ = yfm.create_model("1C", MATURITIES, float_type="float64")
    starts_b = kalman_draws(c64, GRAD_VMAP_STARTS, np.random.default_rng(23), RUN_DELTA)
    pan_b = torch.as_tensor(panel[:, :T_EDGE], device=dev, dtype=f32)
    X0 = yfm.untransform_params(c64, torch.as_tensor(starts_b))
    ll_b0 = -optimize._finite_objective(c32, pan_b, X0.to(dev, f32), 0, T_EDGE)
    with timed_estimate_steps(optimize, fused_ssd) as phb:
        fused_kf.batched_loglik.launches = 0
        t0 = time.perf_counter()
        _, ll_b, best_b, conv_b = yfm.estimate(c32, pan_b, starts_b.T,
                                               max_iters=GRAD_VMAP_ITERS, objective="vmap")
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
        k1_b = fused_kf.batched_loglik.launches
    rep_b = yfm.last_multistart_report()
    check(k1_b == 0, f"(b): the vmap objective launched K1 {k1_b} times")
    lls_b = np.asarray(rep_b["lls"])
    check(bool((lls_b >= ll_b0.double().cpu().numpy()).all()),
          f"(b): a start ended below its start: {lls_b} vs {ll_b0.tolist()}")
    ll_b_cpu = float(yfm.get_loss(c64, best_b, panel[:, :T_EDGE].astype(np.float32), 0,
                                  T_EDGE, device="cpu"))
    check(abs(ll_b - ll_b_cpu) <= 1e-4 * abs(ll_b_cpu),
          f"(b): winner's ll {ll_b!r} vs the plain float64 loss on the CPU {ll_b_cpu!r}")
    print(f"  (b) 1C, T={T_EDGE}, {GRAD_VMAP_STARTS} starts, max_iters {GRAD_VMAP_ITERS}: "
          f"lls {ll_b0.tolist()} → {lls_b.tolist()}, iterations {rep_b['iters']}, winner "
          f"{rep_b['best']} (plain f64 on the CPU {ll_b_cpu!r}); wall {wall_b:.2f} s, "
          f"{phb['grad_passes']} value-and-gradient passes {phb['grad_s']:.2f} s")

    # ---- (c) run("RW") and Adam on a static group --------------------------------
    rw32, _ = yfm.create_model("RW", MATURITIES)
    with tempfile.TemporaryDirectory(prefix="yfm_rw_") as root:
        res_rw = write_run_inputs(root, panel, np.full(rw32.n_params, 0.5), code="RW")
        timer = StageTimer()
        with recorded_fits(optimize, static_model) as rec, _chdir(root), \
                instrumented_run(yfm, timer, [], []), \
                contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            _, params_c = yfm.run("1", T_MONTHS, RUN_H, True, "RW", "float32",
                                  window_type="expanding", scratch_dir=root + os.sep)
            torch.cuda.synchronize()
            wall_rw = time.perf_counter() - t0
        static_devices = dict(rec["static_devices"])
        check(static_devices.get("cuda", 0) >= 1 and set(static_devices) == {"cuda"},
              f'run("RW"): static loss evaluations by device {static_devices}')
        check(len(rec["fits"]) == 2, f'run("RW"): {len(rec["fits"])} fits, not 2')
        fc_rw = check_run_artifacts(res_rw, 'run("RW")', n_origins=1, code="RW",
                                    t_in=T_MONTHS)
        fc_sha = hashlib.sha256(open(fc_rw, "rb").read()).hexdigest()[:16]
    print(f'  (c) run("RW"): wall {wall_rw:.2f} s, {static_devices} static loss '
          f"evaluations by device; fits (end, ll) "
          + ", ".join(f"({f['end']}, {f['ll']!r})" for f in rec["fits"]))
    print("    wall by stage: " + ", ".join(
        f"{k} {v['total']:.2f} s ({v['count']}×)" for k, v in timer.summary().items()))
    ns64, _ = yfm.create_model("NS", MATURITIES, float_type="float64")
    inds = tuple(i for i, g in enumerate(yfm.get_param_groups(ns64)) if g == "1")
    x_ns = yfm.untransform_params(ns64, torch.as_tensor(CASCADE_NS_START, dtype=f64))[None]
    adam = []
    for where in (dev, torch.device("cpu")):
        with recorded_iterates(optimize) as seen:
            X, _ = optimize._group_opt_batched(
                ns64, x_ns.to(where), inds, "adam", dict(max_iters=GRAD_ADAM_ITERS, lr=1e-3),
                torch.as_tensor(panel, device=where, dtype=f64), 0, T_MONTHS)
        adam.append((torch.stack(seen), X.cpu()))
    (its_g, x_g), (its_c, x_c) = adam
    check(its_g.shape[0] == GRAD_ADAM_ITERS,
          f"Adam: {its_g.shape[0]} iterations, not {GRAD_ADAM_ITERS}")
    close(its_g, its_c, 1e-9, 0.0, "Adam iterates card vs CPU")
    close(x_g, x_c, 1e-9, 0.0, "Adam final point card vs CPU")
    print(f'  Adam, NS group "1", float64, {GRAD_ADAM_ITERS} iterations: the card\'s iterates '
          f"equal the CPU's at rtol 1e-9 (λ raw {float(its_c[0, 0, 0])!r} → "
          f"{float(x_c[0, 0])!r})")

    record = {"sdns_params_sha256": sha16(np.asarray(best_a, dtype=np.float64)),
              "rw_params_sha256": sha16(np.asarray(params_c, dtype=np.float64)),
              "rw_forecasts_sha256": fc_sha, "K4": k4_a}
    print(f"  record: {json.dumps(record)}")

    # K4 at (a)'s shapes against its plain versions: the grid around the
    # start and the fitted point (B=32), then at B=1 (the Armijo probe)
    g64 = torch.as_tensor(gapped, device=dev, dtype=f64)
    draws = np.concatenate([ssd_draws(s64, start[:, 0], 31, seed=0),
                            np.asarray(best_a, dtype=np.float64)[None]])
    counts = {}
    err = hold_k4_counted(counts, f"K4 B={draws.shape[0]}: SD-NS grid and fit, NaN first "
                          f"column", s64, torch.as_tensor(draws, device=dev), g64, 0, T_MONTHS)
    p1 = torch.as_tensor(best_a[None], device=dev, dtype=f32)
    inputs = fused_ssd.kernel_inputs(s32, p1, g32, 0, T_MONTHS)
    ms = cuda_ms(lambda: fused_ssd.launch(inputs), reps=20)
    plain_ms, _ = timed_call(lambda: fused_ssd.batched_loss_reference(s32, p1, g32, 0,
                                                                      T_MONTHS))
    bound_ms, bound_by = bound(nbytes(*inputs.buffers, inputs.out), ssd_flops(s32, g32))
    print(f"  K4 B=1 (the Armijo probe): {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by})")
    report["grad"] = {
        "a": {"wall_s": wall_a, "ll_start": ll_start, "ll": ll_a, "nm_iters": ph["nm_iters"],
              "lbfgs_iters": ph["lbfgs_iters"], "grad_passes": ph["grad_passes"],
              "grad_s": ph["grad_s"], "grid_s": ph["grid_s"],
              "neldermead_s": ph["neldermead_s"], "lbfgs_s": ph["lbfgs_s"],
              "verify_s": ph["verify_s"], "k4_launches": k4_a, "k4_by_batch": k4_batches,
              "k4_by_phase": k4_phases, "k4_device_s": k4_dev_s},
        "a_f64": {"ll_card": ll_g, "ll_cpu": ll_c, "wall_card_s": wall_g, "wall_cpu_s": wall_c,
                  "nm_iters": nm_g, "lbfgs_iters": lb_g},
        "b": {"wall_s": wall_b, "lls": lls_b.tolist(), "iters": rep_b["iters"],
              "grad_passes": phb["grad_passes"], "grad_s": phb["grad_s"]},
        "c": {"wall_s": wall_rw, "static_devices": static_devices,
              "stages": timer.summary()},
        "record": record, "k4_determined": counts}
    check(GRAD_FITS == record, f"[17]: differs from the recorded {GRAD_FITS}")
    print("  the recorded parameters, forecasts and K4 launches bit for bit")
    return [{"name": "K4 fused_ssd in estimate_steps off the closed form", "route": "cuda",
             "source": "yieldfactormodels_jl_tpu_torch/csrc/fused_ssd.cu",
             "replaces": "yieldfactormodels_jl_tpu/ops/pallas_ssd.py:214",
             "launches": k4_a, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
             "launches_by_batch": k4_batches}]


PHASE_GROUPS = ("kalman", "ssd", "sv", "run", "cascade", "grad")
#: the kernel library each phase group launches first
FIRST_LIBRARY = {"kalman": "fused_kf", "ssd": "fused_ssd", "sv": "fused_pf",
                 "run": "fused_kf", "cascade": "fused_ssd", "grad": "fused_ssd"}


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
    # every nvcc at once; each library is waited for at its first use (the
    # first phase's here), the clock builds at the lowest CPU priority
    main_libs = [name for name in _build.KERNELS if not name.endswith("_clocks")]
    _build.start_all(later=[name for name in _build.KERNELS if name not in main_libs])
    first = FIRST_LIBRARY[next(g for g in PHASE_GROUPS if g in only)]
    _build.load(first)
    report["build_s"] = time.perf_counter() - t0
    print(f"  built {first} in {report['build_s']:.1f} s; the other builds go on, each "
          f"waited for at its first use")

    kernels = []
    try:
        kernels = run_phase_groups(yfm, dev, report, only)
        for name in main_libs:  # a main library no phase loaded must build too
            _build.load(name)
    finally:
        _build.stop_pending()
    print("  the main builds, each from its start to its first use: " + ", ".join(
        f"{n} {_build.BUILD_SECONDS[n]:.1f} s" for n in main_libs if n in _build.BUILD_SECONDS))
    print_build_logs(main_libs)
    clock_libs = [name for name in _build.KERNELS if name in _build.BUILD_SECONDS
                  and name not in main_libs]
    print(f"  the clock builds {clock_libs}, each from its start: "
          + ", ".join(f"{_build.BUILD_SECONDS[n]:.1f} s" for n in clock_libs))
    print_build_logs(clock_libs)
    report["build_seconds"] = dict(_build.BUILD_SECONDS)
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


def print_build_logs(names):
    """The compiler's register, spill and entry lines of each library."""
    from yieldfactormodels_jl_tpu_torch.ops import _build

    for name in names:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")


@contextlib.contextmanager
def no_plain_fallback(optimize):
    """Fail the phase in which a trust-but-verify re-evaluation gives way to
    the plain engines (``_falls_back`` returns True): a kernel-reported
    optimum must agree with its plain re-evaluation, and no fit re-runs on
    the plain engines."""
    falls_back = optimize._falls_back

    def guarded(tag, *a, **k):
        out = falls_back(tag, *a, **k)
        check(not out, f"{tag}: the kernels' optimum disagreed with its plain "
                       f"re-evaluation and the fit fell back to the plain engines")
        return out

    optimize._falls_back = guarded
    try:
        yield
    finally:
        optimize._falls_back = falls_back


def run_phase_groups(yfm, dev, report, only):
    """Phases [2]–[17] of the groups in ``only``; returns the kernels line.
    A phase fails where a fit falls back to the plain engines."""
    from yieldfactormodels_jl_tpu_torch.estimation import optimize
    from yieldfactormodels_jl_tpu_torch.ops import _build

    kernels = []

    def built(name):  # wait for a library, then dump its SASS in a thread
        _build.load(name)
        prefetch_sass(pool, [_build._lib_path(name)])

    with concurrent.futures.ThreadPoolExecutor(max_workers=3) as pool, \
            no_plain_fallback(optimize):
        if "kalman" in only:
            built("fused_kf")
            kernels += kalman_phases(yfm, dev, report)
        if "ssd" in only:
            built("fused_ssd")
            kernels.append(ssd_phases(yfm, dev, report))
        if "sv" in only:
            built("fused_pf")
            kernels.append(sv_phases(yfm, dev, report))
        if "run" in only:
            kernels += run_phases(yfm, dev, report)
        if "cascade" in only:
            kernels += cascade_phases(yfm, dev, report)
        if "grad" in only:
            built("fused_ssd")
            kernels += grad_phases(yfm, dev, report)
    return kernels


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", metavar="PATH",
                    help="also write the full report (build, errors, timings) here")
    ap.add_argument("--only", default=",".join(PHASE_GROUPS),
                    help="comma-separated phase groups to run after the build: "
                         "kalman ([2]–[8]), ssd ([9]–[11]), sv ([12]–[14]), run "
                         "([15]), cascade ([16]), grad ([17]); all by default")
    args = ap.parse_args()
    only = tuple(args.only.split(","))
    if not set(only) <= set(PHASE_GROUPS):
        ap.error(f"--only takes {PHASE_GROUPS}")
    sys.exit(main(args.json, only))
