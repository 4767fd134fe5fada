"""Multi-start L-BFGS over a natively batched objective.

Counterpart of ``yieldfactormodels_jl_tpu/estimation/batched_lbfgs.py``: ONE
L-BFGS loop whose iterate is the whole (S, P) start matrix and whose
objective is a batched ``X (S, P) → (f (S,), g (S, P))``, so every
function/gradient evaluation (each Armijo probe included) is one batched
call covering all S starts — one fused-kernel launch on the card.

Semantics per start are the JAX package's: memory 10, Armijo backtracking
(c1 = 1e-4, shrink 0.8, at most 25 probes), the steepest-descent safeguard,
the history-skip rule, max-|g| ``g_tol`` plus |Δf| ``f_abstol`` stopping,
converged rows frozen while the batch iterates, and a row whose line search
fails marked done ("stuck").

JAX's ``while_loop``s are Python loops over device tensors here: each loop
test (one per outer iteration, one per Armijo probe) reads one boolean back
to the host, a device synchronisation.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch


class BatchedLBFGSResult(NamedTuple):
    x: torch.Tensor          # (S, P) final iterates
    f: torch.Tensor          # (S,) final objective values
    iters: torch.Tensor      # (S,) iterations each start actually took
    converged: torch.Tensor  # (S,) bool: g_tol/f_abstol met before max_iters


def _dot(a, b):
    return (a * b).sum(-1)  # (S,)


def batched_lbfgs(value_and_grad: Callable[[torch.Tensor],
                                           Tuple[torch.Tensor, torch.Tensor]],
                  x0: torch.Tensor,
                  max_iters: int,
                  g_tol: float = 1e-6,
                  f_abstol: float = 1e-6,
                  memory_size: int = 10,
                  max_backtracks: int = 25,
                  armijo_c1: float = 1e-4,
                  shrink: float = 0.8,
                  invalid_above: float | None = None,
                  value_fn: Callable[[torch.Tensor], torch.Tensor] | None = None
                  ) -> BatchedLBFGSResult:
    """Minimize S objectives simultaneously; every eval is one batched call.

    ``value_and_grad``: (S, P) → ((S,), (S, P)), finite-valued (clamp
    ±Inf/NaN to a penalty before calling).  ``invalid_above``: objective
    values ≥ this are the non-finite-loss penalty plateau; rows there are
    never reported ``converged``.  ``value_fn``: optional value-only
    objective for the Armijo probes, so only accepted points pay for a
    gradient."""
    S, P = x0.shape
    dtype, device = x0.dtype, x0.device
    m = memory_size
    rows = torch.arange(S, device=device)
    if invalid_above is None:
        invalid_above = math.inf

    def valid_row(f):
        return torch.isfinite(f) & (f < invalid_above)

    probe_value = value_fn if value_fn is not None else (
        lambda X: value_and_grad(X)[0])

    def two_loop(g, s_mem, y_mem, rho, n_hist):
        """Per-start two-loop recursion on stacked history (m, S, P)."""
        q = g
        alphas = []
        for i in range(m):
            # newest entry first: index (n_hist-1-i) mod m is valid for i < n_hist
            j = (n_hist - 1 - i) % m
            a = rho[j, rows] * _dot(s_mem[j, rows], q)
            a = torch.where(i < n_hist, a, torch.zeros_like(a))
            q = q - a[:, None] * y_mem[j, rows]
            alphas.append(a)
        # initial Hessian scale γ = s·y / y·y of the newest pair
        jn = (n_hist - 1) % m
        sy = _dot(s_mem[jn, rows], y_mem[jn, rows])
        yy = _dot(y_mem[jn, rows], y_mem[jn, rows])
        gamma = torch.where((n_hist > 0) & (yy > 0),
                            sy / torch.clamp(yy, min=1e-30),
                            torch.ones_like(sy))
        r = q * gamma[:, None]
        for i in reversed(range(m)):  # oldest first
            j = (n_hist - 1 - i) % m
            b = rho[j, rows] * _dot(y_mem[j, rows], r)
            corr = (alphas[i] - b)[:, None] * s_mem[j, rows]
            r = r + torch.where((i < n_hist)[:, None], corr, torch.zeros_like(corr))
        return r  # (S, P) ≈ H·g

    def linesearch(x, f, g, d, skip):
        """Per-start Armijo backtracking; each probe is ONE batched eval.
        ``skip`` rows count as accepted, so frozen starts cannot force the
        full backtracking budget."""
        slope = _dot(g, d)
        alpha = torch.ones(S, dtype=dtype, device=device)
        accepted = skip
        x_new = x
        k = 0
        while not bool(accepted.all()) and k < max_backtracks:
            probe = x + alpha[:, None] * d
            fp = probe_value(probe)
            ok = fp <= f + armijo_c1 * alpha * slope
            take = ok & ~accepted
            x_new = torch.where(take[:, None], probe, x_new)
            accepted = accepted | ok
            alpha = torch.where(accepted, alpha, alpha * shrink)
            k += 1
        f_new, g_new = value_and_grad(x_new)
        return x_new, f_new, g_new, accepted

    f, g = value_and_grad(x0)
    x = x0
    s_mem = torch.zeros(m, S, P, dtype=dtype, device=device)
    y_mem = torch.zeros(m, S, P, dtype=dtype, device=device)
    rho = torch.zeros(m, S, dtype=dtype, device=device)
    n_hist = torch.zeros(S, dtype=torch.int64, device=device)
    iters = torch.zeros(S, dtype=torch.int32, device=device)
    at_opt0 = (g.abs().amax(-1) <= g_tol) & valid_row(f)
    done = ~torch.isfinite(f) | at_opt0
    conv = at_opt0
    it = 0
    while it < max_iters and not bool(done.all()):
        d = -two_loop(g, s_mem, y_mem, rho, n_hist)
        # safeguard: if d is not a descent direction, fall back to -g
        d = torch.where((_dot(g, d) < 0)[:, None], d, -g)

        x_new, f_new, g_new, accepted = linesearch(x, f, g, d, done)

        move = accepted & ~done
        x_next = torch.where(move[:, None], x_new, x)
        f_next = torch.where(move, f_new, f)
        g_next = torch.where(move[:, None], g_new, g)

        # history update (skip when sy too small or row frozen)
        s = x_next - x
        y = g_next - g
        sy = _dot(s, y)
        store = move & (sy > 1e-12 * torch.clamp(_dot(y, y), min=1e-30))
        slot = n_hist % m
        s_mem[slot, rows] = torch.where(store[:, None], s, s_mem[slot, rows])
        y_mem[slot, rows] = torch.where(store[:, None], y, y_mem[slot, rows])
        rho[slot, rows] = torch.where(store, 1.0 / torch.clamp(sy, min=1e-30),
                                      rho[slot, rows])
        n_hist = torch.where(store, n_hist + 1, n_hist)

        gnorm = g_next.abs().amax(-1)
        df = (f_next - f).abs()
        newly_done = move & ((gnorm <= g_tol) | (df <= f_abstol))
        stuck = ~accepted & ~done  # line search failed: no progress possible
        done = done | newly_done | stuck
        conv = conv | (newly_done & valid_row(f_next))
        iters = iters + move.to(torch.int32)
        x, f, g = x_next, f_next, g_next
        it += 1
    return BatchedLBFGSResult(x, f, iters, conv)
