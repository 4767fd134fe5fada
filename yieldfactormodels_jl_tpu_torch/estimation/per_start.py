"""Per-start L-BFGS and Adam, all starts in lockstep.

Counterpart of ``_run_lbfgs``, ``_run_adam`` and ``_run_named`` of
``yieldfactormodels_jl_tpu/estimation/optimize.py``, which the JAX package
runs once per start under ``jax.vmap``.  Here the starts are the lanes of one
(S, P) batch: every objective call serves the lanes still running, and a
lane whose stopping rule has fired is frozen with its values, as a vmapped
``lax.while_loop`` keeps them.  Each lane follows its own start's trajectory
exactly, so a lane's iterates do not depend on the other lanes.

The objectives take the lanes' points and the lanes' indices:
``value_fn(X (K, P), rows (K,)) → f (K,)`` and ``value_and_grad(X, rows) →
(f (K,), g (K, P))``, so an objective whose lanes differ (a sub-vector
embedded in each start's own full vector, a window per lane) can look its
lanes up.  The objective values must be finite (clamp ±Inf/NaN to a penalty
first, as ``optimize._finite_objective`` does).

``run_lbfgs`` is optax 0.2.6's ``lbfgs(memory_size=10,
scale_init_precond=True)`` with ``scale_by_backtracking_linesearch(
max_backtracking_steps=80, store_grad=True)`` driven through
``value_and_grad_from_state``: the first direction is −g scaled by
min(1, 1/‖g‖₂), later ones the two-loop recursion on every stored pair from
the identity scaled by ⟨s, y⟩/⟨y, y⟩; every search starts at min(1.5 × the
last accepted rate, 1) and shrinks by 0.8 until f(x + ηd) ≤ f(x) +
1e-4·η·⟨d, g⟩, at most 81 probes, the gradient taken at the probe that ends
the search.  ``run_adam`` is ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8
outside the square root, bias-corrected).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


Objective = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

#: optax.lbfgs(memory_size=10) with scale_by_backtracking_linesearch(
#: max_backtracking_steps=80), its slope_rtol, decrease_factor,
#: increase_factor and max_learning_rate defaults
MEMORY, MAX_BACKTRACKS = 10, 80
SLOPE_RTOL, DECREASE, INCREASE, MAX_RATE = 1e-4, 0.8, 1.5, 1.0
#: optax.adam's b1, b2 and eps
B1, B2, EPS = 0.9, 0.999, 1e-8


class PerStartResult(NamedTuple):
    x: torch.Tensor          # (S, P) final iterates
    f: torch.Tensor          # (S,) objective values, as each runner reports them
    iters: torch.Tensor      # (S,) iterations each lane took
    converged: torch.Tensor  # (S,) bool


def _dot(a, b):
    return (a * b).sum(-1)


def run_lbfgs(value_fn: Objective, value_and_grad: Objective, x0: torch.Tensor,
              max_iters: int, g_tol: float = 1e-6, f_abstol: float = 1e-6
              ) -> PerStartResult:
    """Each lane's L-BFGS from its row of ``x0`` (S, P).

    A lane runs while ``((max|g| > g_tol) & (|f − f_prev| > f_abstol)) |
    (it < 2)`` holds, with ``it < max_iters`` and a finite x; ``f`` is then
    re-evaluated at the final x (one value call for every lane), and a lane
    has converged when it stopped before ``max_iters`` at a finite x."""
    S, P = x0.shape
    dtype, device = x0.dtype, x0.device
    m = MEMORY
    lanes = torch.arange(S, device=device)
    x = x0.clone()
    it = torch.zeros(S, dtype=torch.int64, device=device)
    # scale_by_lbfgs' state
    last_x = torch.zeros_like(x)
    last_g = torch.zeros_like(x)
    dw = torch.zeros(S, m, P, dtype=dtype, device=device)
    du = torch.zeros(S, m, P, dtype=dtype, device=device)
    rho = torch.zeros(S, m, dtype=dtype, device=device)
    # the line search's state: the last accepted rate, and the value and
    # gradient at the current point (store_grad)
    rate = torch.ones(S, dtype=dtype, device=device)
    st_f = torch.full((S,), math.inf, dtype=dtype, device=device)
    st_g = torch.zeros_like(x)
    running = (it < max_iters) & torch.isfinite(x).all(-1)
    while bool(running.any()):
        R = lanes[running]
        xr = x[R]
        # value_and_grad_from_state: the stored pair where its value is finite
        f0, g0 = st_f[R], st_g[R]
        redo = ~torch.isfinite(f0)
        if bool(redo.any()):
            f0[redo], g0[redo] = value_and_grad(xr[redo], R[redo])
        d = _lbfgs_direction(xr, g0, it[R], last_x[R], last_g[R], dw, du, rho, R, m)
        last_x[R], last_g[R] = xr, g0
        slope = _dot(d, g0)
        lr = torch.clamp(INCREASE * rate[R], max=MAX_RATE)
        new_f, new_g, err, lr = _backtrack(value_fn, value_and_grad, xr, f0, d, slope, lr, R)
        lr = torch.where(torch.isinf(err), torch.zeros_like(lr), lr)
        x[R] = xr + lr[:, None] * d
        rate[R] = lr
        st_f[R], st_g[R] = new_f, new_g
        it[R] += 1
        moving = ((new_g.abs().amax(-1) > g_tol) & ((new_f - f0).abs() > f_abstol)) \
            | (it[R] < 2)
        running[R] = (it[R] < max_iters) & moving & torch.isfinite(x[R]).all(-1)
    f = value_fn(x, lanes)
    conv = (it < max_iters) & torch.isfinite(x).all(-1)
    return PerStartResult(x, f, it, conv)


def _lbfgs_direction(x, g, count, last_x, last_g, dw, du, rho, R, m):
    """scale_by_lbfgs' update for the lanes ``R`` at iteration ``count``:
    store the newest pair (zero at the first iteration), then −H·g by the
    two-loop recursion over the memory from the oldest slot."""
    slot = count % m
    prev = (count - 1) % m
    first = count == 0
    s = x - last_x
    y = g - last_g
    sy = _dot(y, s)
    w = torch.where(sy == 0, torch.zeros_like(sy), 1.0 / sy)
    s = torch.where(first[:, None], torch.zeros_like(s), s)
    y = torch.where(first[:, None], torch.zeros_like(y), y)
    w = torch.where(first, torch.zeros_like(w), w)
    dw[R, prev] = s
    du[R, prev] = y
    rho[R, prev] = w
    yy = _dot(y, y)
    scale = torch.where(yy > 0.0, _dot(y, s) / torch.where(yy > 0.0, yy, torch.ones_like(yy)),
                        torch.ones_like(yy))
    capped = torch.clamp(1.0 / torch.sqrt(_dot(g, g)), max=1.0)
    scale = torch.where(first, capped, scale)
    order = [(slot + k) % m for k in range(m)]  # oldest first
    vec = g
    alphas = [None] * m
    for k in reversed(range(m)):
        j = order[k]
        a = rho[R, j] * _dot(dw[R, j], vec)
        vec = vec + (-a)[:, None] * du[R, j]
        alphas[k] = a
    vec = scale[:, None] * vec
    for k in range(m):
        j = order[k]
        b = rho[R, j] * _dot(du[R, j], vec)
        vec = vec + (alphas[k] - b)[:, None] * dw[R, j]
    return -vec


def _backtrack(value_fn, value_and_grad, x, f, d, slope, lr, R):
    """The backtracking search of every lane in ``R`` in lockstep: each round
    is one value call for the lanes still searching; once every search has
    ended, one gradient call takes each lane's gradient at the probe that
    ended its search.  Returns the value and gradient at each lane's last
    probe, its decrease error and its last rate."""
    searching = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    step = 0
    err = torch.full_like(f, math.inf)
    new_f = f.clone()
    last = x.clone()
    while bool(searching.any()):
        if step > 0:
            lr = torch.where(searching, DECREASE * lr, lr)
        k = searching.nonzero()[:, 0]
        probe = x[k] + lr[k, None] * d[k]
        fp = value_fn(probe, R[k])
        e = fp - f[k] - lr[k] * SLOPE_RTOL * slope[k]
        e = torch.clamp(torch.where(torch.isnan(e), torch.full_like(e, math.inf), e), min=0.0)
        err[k], new_f[k], last[k] = e, fp, probe
        step += 1
        searching[k] = ~(e <= 0.0) & (step <= MAX_BACKTRACKS)
    _, new_g = value_and_grad(last, R)
    return new_f, new_g, err, lr


def run_adam(value_and_grad: Objective, x0: torch.Tensor, max_iters: int, lr: float,
             g_tol: float = 1e-8) -> PerStartResult:
    """Each lane's Adam from its row of ``x0`` (S, P): non-finite gradient
    entries count as 0; a lane stops once max|g| ≤ ``g_tol`` or at
    ``max_iters``.  ``f`` is each lane's last in-loop value, taken before
    that iteration's update; a lane has converged when it stopped before
    ``max_iters``."""
    S = x0.shape[0]
    device = x0.device
    lanes = torch.arange(S, device=device)
    x = x0.clone()
    mu = torch.zeros_like(x)
    nu = torch.zeros_like(x)
    it = torch.zeros(S, dtype=torch.int64, device=device)
    f_last = torch.full((S,), math.inf, dtype=x.dtype, device=device)
    running = it < max_iters
    while bool(running.any()):
        R = lanes[running]
        f, g = value_and_grad(x[R], R)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        mu[R] = (1 - B1) * g + B1 * mu[R]
        nu[R] = (1 - B2) * (g * g) + B2 * nu[R]
        n = (it[R] + 1).to(x.dtype)[:, None]
        mu_hat = mu[R] / (1 - B1 ** n)
        nu_hat = nu[R] / (1 - B2 ** n)
        x[R] = x[R] + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + EPS))
        it[R] += 1
        f_last[R] = f
        running[R] = (it[R] < max_iters) & (g.abs().amax(-1) > g_tol)
    return PerStartResult(x, f_last, it, it < max_iters)


def run_named(kind: str, value_fn: Objective, value_and_grad: Objective,
              x0: torch.Tensor, opts: dict) -> PerStartResult:
    """The gradient optimizer named by a group's table entry, "lbfgs" or
    "adam" (a Nelder–Mead group runs ``optimize._neldermead_group``)."""
    if kind == "lbfgs":
        return run_lbfgs(value_fn, value_and_grad, x0, **opts)
    if kind == "adam":
        return run_adam(value_and_grad, x0, **opts)
    raise ValueError(f"unknown optimizer kind {kind!r}")
