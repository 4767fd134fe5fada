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
   B=1024 and B=16384; the plain version once, for information.

Before the last line it prints the card's name and power limit (nvidia-smi)
and one JSON object {"kernels": [...]} with each kernel's launches on the
main path, error, times and bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

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


def kernel_work(inputs, data):
    """(bytes, flops) the fused loglik must move and compute for one launch:
    every input read once and the output written once; floating-point
    operations of the scalar measurement updates on the steps this run's
    masks observe (each draw's own window where given) and of the symmetrize
    + transition on every step."""
    bytes_ = sum(x.numel() * x.element_size() for x in inputs.buffers
                 if x is not None) + inputs.out.numel() * inputs.out.element_size()
    _, Ms, tvl, _, B, N, T = inputs.ints
    masks, win = inputs.buffers[9], inputs.buffers[10]
    finite_col = data.isfinite().all(0).cpu()
    if win is None:
        obs_steps = int((masks[:, 0].bool().cpu() & finite_col).sum()) * B
    else:
        t = torch.arange(T)
        lo, hi = win[0].cpu()[:, None], win[1].cpu()[:, None]
        obs_steps = int((((t >= lo) & (t < hi)) & finite_col).sum())
    # per observation: zP 2Ms², f 2Ms+1, pred 2Ms+1, K Ms, β 2Ms, P 2Ms²,
    # loglik 6 (log, divide, 4 mul/add); TVλ rows add ≈ 20 (exp, 2 divides)
    per_obs = 4 * Ms * Ms + 7 * Ms + 8 + (20 if tvl else 0)
    per_step = Ms * Ms + 2 * Ms * Ms + 4 * Ms ** 3 + 2 * Ms * Ms  # sym, β, ΦPΦᵀ+Ω
    flops = obs_steps * N * per_obs + B * T * per_step
    return bytes_, flops


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
    from yieldfactormodels_jl_tpu_torch.ops import _build, fused_kf

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
    tvl64, _ = yfm.create_model("TVλ", MATURITIES, float_type="float64")
    dns64_panel = torch.as_tensor(make_dns_panel(seed=2), device=dev, dtype=f64)
    tvl_delta = [0.4, -0.1, 0.05, 0.1 * math.log(0.49)]
    for exact in (False, True):
        s = dataclasses.replace(tvl64, exact_jacobian=exact)
        cases.append((f"TVλ exact_jacobian={exact}", s,
                      kalman_draws(s, Bo, rng, tvl_delta), dns64_panel, {}))
    win = {"starts": torch.as_tensor(rng.integers(0, 100, Bo), device=dev),
           "ends": torch.as_tensor(rng.integers(200, T_MONTHS + 1, Bo), device=dev)}
    cases.append(("AFNS5 per-draw windows", spec64,
                  make_param_batch(spec.n_params, Bo, seed=3), panel64, win))
    # On some draws the TVλ EKF amplifies rounding far beyond the tolerances —
    # under the reference's Jacobian (exact_jacobian=False) in float64 too:
    # there the plain version itself moves by more than the tolerance when the
    # parameters move by a few units in the last place.  Each kernel instance
    # is held against the plain version in its own type on the draws where
    # that type determines the answer, and those must be most draws.
    for what, s, p, data64, kw in cases:
        pt = torch.as_tensor(p, device=dev, dtype=f64)
        for dtype, rtol, atol, eps in ((f32, 5e-4, 1e-2, 1e-7), (f64, 1e-9, 0.0, 1e-15)):
            pd, dd = pt.to(dtype), data64.to(dtype)
            ref = fused_kf.batched_loglik_reference(s, pd, dd, **kw)
            tol = atol + rtol * ref.abs()
            determined = torch.isfinite(ref)
            for nudge in (eps, -eps, 3 * eps):
                moved = fused_kf.batched_loglik_reference(s, pd * (1 + nudge), dd, **kw)
                determined &= (moved - ref).abs() <= tol / 4
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
    shapes = {}
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    panel32 = torch.as_tensor(panel, device=dev, dtype=f32)
    for B in sizes:
        p32 = cons[B].to(f32)
        inputs = fused_kf.kernel_inputs(spec, p32, panel32, 0, T_MONTHS)
        ms = cuda_ms(lambda: fused_kf.launch(inputs), reps=20)
        entry_ms = cuda_ms(lambda: yfm.batched_loglik(spec, p32, panel32), reps=10)
        plain_ms = cuda_ms(lambda: fused_kf.batched_loglik_reference(spec, p32, panel32),
                           reps=1, warmup=1)
        bytes_, flops = kernel_work(inputs, panel32)
        bound_ms = max(bytes_ / PEAK_BYTES, flops / PEAK_FP32_FLOPS) * 1e3
        shapes[str(B)] = {
            "ms": ms, "entry_ms": entry_ms, "plain_ms": plain_ms,
            "evals_per_s": B / (ms * 1e-3), "bytes": bytes_, "flops": flops,
            "bound_ms": bound_ms,
            "chain_ms": chain_ms(spec.state_dim, N_MATURITIES, T_MONTHS, clock_mhz),
            "bound_by": "bytes" if bytes_ / PEAK_BYTES > flops / PEAK_FP32_FLOPS
            else "operations"}
        print(f"  B={B}: kernel {ms:.4f} ms ({B / (ms * 1e-3):.0f} evals/s), "
              f"entry point {entry_ms:.4f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound_ms:.4f} ms ({flops / B:.0f} flop/draw), "
              f"serial-chain estimate {shapes[str(B)]['chain_ms']:.4f} ms")
    report["shapes"] = shapes

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
