"""Nelder–Mead simplex optimizer, sequential and lockstep-batched.

Counterpart of ``yieldfactormodels_jl_tpu/estimation/neldermead.py``, with
the same conventions (Optim.jl's documented ones):

- adaptive parameters α=1, β=1+2/n, γ=0.75−1/(2n), δ=1−1/n,
- affine initial simplex x_j = x0 + (0.025 + 0.05·x0_j)·e_j,
- convergence when the simplex f-value standard deviation (population,
  NaN read as +Inf, +Inf as 1e30) is at most ``f_tol``.

The JAX while-loops become Python loops.  ``nelder_mead`` decides each
branch on the host; ``nelder_mead_batched`` keeps the S simplexes on their
device and reads one pair of booleans per iteration (whether any start
shrinks, whether all had converged before the iteration), so a fused-kernel
objective sees 2 batched calls per iteration plus a third when some start
shrinks.  Both minimize.
"""

from __future__ import annotations

from typing import Callable

import torch


def _coefficients(n: int):
    return 1.0, 1.0 + 2.0 / n, 0.75 - 1.0 / (2.0 * n), 1.0 - 1.0 / n


def _initial_simplex(x0, step=None):
    """(..., n+1, n): x0 and x0 + step_j·e_j."""
    n = x0.shape[-1]
    if step is None:
        step = 0.025 + 0.05 * x0
    step = torch.as_tensor(step, dtype=x0.dtype, device=x0.device) * torch.ones_like(x0)
    pts = x0.unsqueeze(-2) + torch.diag_embed(step)
    return torch.cat([x0.unsqueeze(-2), pts], dim=-2)


def _fstd(fv):
    """Population standard deviation over the last axis, NaN read as +Inf
    and +Inf as 1e30."""
    fv = torch.nan_to_num(fv, nan=float("inf"), posinf=1e30)
    return torch.std(fv, dim=-1, correction=0)


def nelder_mead(fun: Callable, x0, max_iters: int = 500, f_tol: float = 1e-8,
                step=None):
    """Minimize ``fun`` ((n,) → scalar tensor) from ``x0``; returns
    (x_best, f_best, n_iters).  ``step``: optional scalar or (n,) initial
    simplex offsets (default 0.025 + 0.05·x0)."""
    n = x0.shape[0]
    alpha, beta, gamma, delta = _coefficients(n)

    def ev(x):
        return torch.as_tensor(fun(x), dtype=x0.dtype, device=x0.device).reshape(())

    simplex = _initial_simplex(x0, step)
    fvals = torch.stack([ev(x) for x in simplex])
    it = 0
    while it < max_iters and bool(_fstd(fvals) > f_tol):
        order = torch.argsort(fvals, stable=True)
        simplex, fvals = simplex[order], fvals[order]
        best, worst = simplex[0], simplex[-1]
        f_best, f_second, f_worst = fvals[0], fvals[-2], fvals[-1]
        centroid = simplex[:-1].mean(0)
        xr = centroid + alpha * (centroid - worst)
        fr = ev(xr)
        if bool(fr < f_best):
            xe = centroid + beta * (xr - centroid)
            fe = ev(xe)
            x_new, f_new = (xe, fe) if bool(fe < fr) else (xr, fr)
            simplex, fvals = _replace_worst(simplex, fvals, x_new, f_new)
        elif bool(fr < f_second):
            simplex, fvals = _replace_worst(simplex, fvals, xr, fr)
        else:
            if bool(fr < f_worst):
                xc = centroid + gamma * (xr - centroid)
                fc = ev(xc)
                ok = bool(fc <= fr)
            else:
                xc = centroid - gamma * (xr - centroid)
                fc = ev(xc)
                ok = bool(fc < f_worst)
            if ok:
                simplex, fvals = _replace_worst(simplex, fvals, xc, fc)
            else:
                simplex = best + delta * (simplex - best)
                simplex[0] = best
                fvals = torch.stack([f_best] + [ev(x) for x in simplex[1:]])
        it += 1
    i_best = int(torch.argmin(fvals))
    return simplex[i_best], fvals[i_best], it


def _replace_worst(simplex, fvals, x, f):
    simplex, fvals = simplex.clone(), fvals.clone()
    simplex[-1], fvals[-1] = x, f
    return simplex, fvals


def nelder_mead_batched(batch_fun: Callable, X0, max_iters: int = 500,
                        f_tol: float = 1e-8, step=None):
    """Lockstep-batched Nelder–Mead: S independent simplexes advance together
    and every candidate evaluation across the batch is one ``batch_fun``
    call, (S, K, n) → (S, K).  The decisions are :func:`nelder_mead`'s per
    start; each start's second candidate (expansion, outside or inside
    contraction) is evaluated speculatively and selected afterwards.
    Converged starts freeze until all are done or ``max_iters``.

    Returns (X_best (S, n), f_best (S,), iters (S,))."""
    S, n = X0.shape
    alpha, beta, gamma, delta = _coefficients(n)
    simplex = _initial_simplex(X0, step)                # (S, n+1, n)
    fvals = batch_fun(simplex)
    done = _fstd(fvals) <= f_tol
    iters = torch.zeros(S, dtype=torch.int64, device=X0.device)
    it = 0
    while it < max_iters:
        order = torch.argsort(fvals, dim=1, stable=True)
        simplex_s = torch.take_along_dim(simplex, order[:, :, None], dim=1)
        fvals_s = torch.take_along_dim(fvals, order, dim=1)
        best, worst = simplex_s[:, 0], simplex_s[:, -1]
        f_best, f_second, f_worst = fvals_s[:, 0], fvals_s[:, -2], fvals_s[:, -1]
        centroid = simplex_s[:, :-1].mean(1)

        xr = centroid + alpha * (centroid - worst)
        fr = batch_fun(xr[:, None, :])[:, 0]            # call 1
        expand = fr < f_best
        reflect = ~expand & (fr < f_second)
        outside = ~expand & ~reflect & (fr < f_worst)
        xe = centroid + beta * (xr - centroid)
        xc_out = centroid + gamma * (xr - centroid)
        xc_in = centroid - gamma * (xr - centroid)
        x2 = torch.where(expand[:, None], xe, torch.where(outside[:, None], xc_out, xc_in))
        f2 = batch_fun(x2[:, None, :])[:, 0]            # call 2

        # predicate selects, as the sequential branches: a NaN f2 keeps (xr, fr)
        exp_take = f2 < fr
        exp_x = torch.where(exp_take[:, None], x2, xr)
        exp_f = torch.where(exp_take, f2, fr)
        ok_contract = torch.where(outside, f2 <= fr, f2 < f_worst)
        shrink = ~expand & ~reflect & ~ok_contract
        new_x = torch.where(expand[:, None], exp_x, torch.where(reflect[:, None], xr, x2))
        new_f = torch.where(expand, exp_f, torch.where(reflect, fr, f2))
        new_simplex = simplex_s.clone()
        new_simplex[:, -1] = new_x
        new_fvals = fvals_s.clone()
        new_fvals[:, -1] = new_f

        # the one host read of the iteration: had every start converged
        # before it (then nothing below changes a frozen start), and does an
        # active start shrink
        all_done, any_shrink = torch.stack([done.all(), (shrink & ~done).any()]).tolist()
        if all_done:
            break
        if any_shrink:
            shr = best[:, None, :] + delta * (simplex_s - best[:, None, :])
            shr[:, 0] = best
            shr_f = batch_fun(shr)                      # call 3
            shr_f[:, 0] = f_best
            new_simplex = torch.where(shrink[:, None, None], shr, new_simplex)
            new_fvals = torch.where(shrink[:, None], shr_f, new_fvals)

        simplex = torch.where(done[:, None, None], simplex, new_simplex)
        fvals = torch.where(done[:, None], fvals, new_fvals)
        iters = torch.where(done, iters, torch.full_like(iters, it + 1))
        done = done | (_fstd(fvals) <= f_tol)
        it += 1
    i_best = torch.argmin(fvals, dim=1)
    X_best = torch.take_along_dim(simplex, i_best[:, None, None], dim=1)[:, 0]
    f_best = torch.take_along_dim(fvals, i_best[:, None], dim=1)[:, 0]
    return X_best, f_best, iters
