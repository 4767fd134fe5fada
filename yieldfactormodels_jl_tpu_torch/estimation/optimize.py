"""Estimation: the multi-start MLE ``estimate``, its rolling-window form
``estimate_windows``, and the block-coordinate ``estimate_steps`` of the
Kalman, score-driven and static families.

Counterpart of ``yieldfactormodels_jl_tpu/estimation/optimize.py``.
``estimate`` has two objectives.  ``"fused"`` (the three Kalman families)
runs one batched L-BFGS loop over the (S, P) start matrix
(``batched_lbfgs``) whose Armijo probes run the value kernel (K1,
``ops/fused_kf``) and whose accepted points take one value-and-gradient
through the differentiable kernels (K2f/K2b for DNS/AFNS, K3f/K3b for TVλ,
``ops/fused_kf_grad``), then a trust-but-verify re-evaluation of the winner
by the plain univariate engine; a disagreement raises on the card and
re-runs ``"vmap"`` on the CPU.
``"vmap"`` (every family) runs each start's own L-BFGS, all starts in
lockstep (``per_start``), on the family's plain engine, its gradient by
autograd (through the inner score for the score-driven families).
``estimate_windows`` runs either over a (windows × starts) batch whose rows
carry their own windows.  ``estimate_steps`` alternates parameter groups:
Nelder–Mead blocks whose every candidate batch is one value-kernel call —
K1 for the Kalman families, K4 (``ops/fused_ssd``) for the score-driven
ones, which first evaluate the A×B initialization grid in one K4 call, and
the batched static loss (``models/static_model``, which has no kernel) for
the static families; the (δ, Φ) group of the score-driven and static
families in closed form on a fully observed window; and otherwise L-BFGS or
Adam per start on the plain engine, except the score-driven L-BFGS, whose
Armijo probes are K4 launches and whose gradients come from the scan.  The
winner is re-evaluated by the family's plain engine.  On the CPU the
kernels' plain versions run.

What is not ported yet raises ``NotImplementedError`` naming its ROADMAP
item: the ``"time_sharded"`` objective, the Newton polish (``second_order``
/ ``YFM_NEWTON``), the amortized warm start (``warm_start`` /
``YFM_AMORT``), the escalation ladder (``YFM_ESCALATE``) and checkpointed
``estimate_steps``.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, NamedTuple

import numpy as np
import torch

from .. import config
from ..models import api
from ..models.params import transform_params, untransform_params
from ..models.specs import ModelSpec
from ..models import score_driven, static_model
from ..models.params import get_new_initial_params, unpack_static
from ..ops import fused_kf, fused_kf_grad, fused_ssd
from ..ops.linalg import ols_solve_columns
from .batched_lbfgs import batched_lbfgs
from .neldermead import nelder_mead_batched
from .per_start import run_lbfgs, run_named

#: the non-finite-loss penalty, and the threshold at/above which an objective
#: value sits on its plateau: strictly below 1e12 because float32 rounds 1e12
#: down to 999_999_995_904 (the JAX package's ops/newton.py constants)
PENALTY = 1e12
PENALTY_THRESH = 0.999e12

#: families the differentiable fused kernels cover: all three Kalman families
_FUSED_FAMILIES = ("kalman_dns", "kalman_afns", "kalman_tvl")

_NOT_PORTED = {
    "time_sharded": "ROADMAP.md Queue 1 item 10 (parallel-in-time engines)",
    "second_order": "ROADMAP.md Queue 1 item 9 (ops/newton.py, the Newton "
                    "polish)",
    "warm_start": "ROADMAP.md Queue 1 item 9 (estimation/amortize.py, the "
                  "amortized warm start)",
    "ladder": "ROADMAP.md Queue 1 item 9 (robustness/ladder.py, the "
              "escalation ladder)",
    "checkpoint": "ROADMAP.md Queue 1 item 11 (orchestration/checkpoint.py)",
    "orchestrated": "ROADMAP.md Queue 1 item 11 (orchestration/supervisor.py, "
                    "the leased-queue driver)",
}


def _not_ported(what: str, key: str):
    return NotImplementedError(f"{what} is not ported to PyTorch yet; see "
                               f"{_NOT_PORTED[key]}")


# ---------------------------------------------------------------------------
# multi-start report
# ---------------------------------------------------------------------------

#: the last estimate() call's per-start outcome, per thread (as in the JAX
#: package): final loglik, iteration count, convergence flag and phase per
#: start, ladder traces (always empty here: no ladder), and the winner.
_REPORT_TLS = threading.local()
_EMPTY_REPORT: Dict = {"lls": [], "iters": [], "converged": [], "phase": [],
                       "ladder": [], "best": -1}


def last_multistart_report() -> Dict:
    """The calling thread's most recent multi-start report."""
    return getattr(_REPORT_TLS, "report", _EMPTY_REPORT)


def _record_report(lls, best: int, iters=None, converged=None,
                   phase=None) -> None:
    lls = np.asarray(lls).ravel()
    S = lls.shape[0]
    _REPORT_TLS.report = {
        "lls": [float(v) for v in lls],
        "iters": [int(v) for v in (np.zeros(S, np.int64) if iters is None
                                   else np.asarray(iters).ravel())],
        "converged": [bool(v) for v in (np.zeros(S, bool) if converged is None
                                        else np.asarray(converged).ravel())],
        "phase": list(phase) if phase is not None else ["lbfgs"] * S,
        "ladder": [],
        "best": int(best),
    }


class Convergence(NamedTuple):
    """Real optimizer exit state of the winning start."""
    converged: bool
    iterations: int

    def __bool__(self) -> bool:  # truthiness = "did it converge"
        return bool(self.converged)

    def __index__(self) -> int:
        return int(self.converged)


# ---------------------------------------------------------------------------
# objective
# ---------------------------------------------------------------------------

def compute_loss(spec: ModelSpec, data, raw_params, start=0, end=None):
    """Negative filter loss at unconstrained parameters."""
    constrained = transform_params(spec, raw_params)
    return -api.get_loss(spec, constrained, data, start, end)


def _sanitize(params):
    """NaN/Inf → 0."""
    p = np.asarray(params, dtype=np.float64).copy()
    p[~np.isfinite(p)] = 0.0
    return p


def _fused_check_mode() -> str:
    """Trust-but-verify policy for a kernel-reported optimum
    (``YFM_FUSED_CHECK``): after a disagreement "fallback" (the default)
    raises on the card and re-runs the estimation on the plain engines on
    the CPU; "warn" keeps the kernels' result and only writes the stderr
    line."""
    return os.environ.get("YFM_FUSED_CHECK", "fallback")


def _fused_disagrees(ll_engine: float, ll_scan: float) -> bool:
    """A finite engine-reported optimum whose one plain-engine re-evaluation
    is non-finite or off by more than 0.5% relative."""
    return bool(np.isfinite(ll_engine)
                and (not np.isfinite(ll_scan)
                     or abs(ll_scan - ll_engine) > 5e-3 * max(abs(ll_scan), 1.0)))


def _warn_fused_disagreement(tag: str, ll_engine: float, ll_scan: float):
    sys.stderr.write(
        f"# {tag}: fused-kernel optimum disagrees with the scan engine "
        f"(fused {ll_engine:.6f} vs scan {ll_scan:.6f}) — suspect "
        f"kernel/compiler fault; YFM_FUSED_CHECK={_fused_check_mode()}\n")


def _falls_back(tag: str, spec: ModelSpec, best, ll_kernel: float, data,
                start, end) -> bool:
    """ONE plain-engine evaluation of a kernel-reported optimum (constrained
    parameters ``best``), so a silent kernel fault cannot pass as a fit.
    Under ``YFM_FUSED_CHECK=fallback`` a disagreement on CUDA data raises:
    no path gives way to the plain engines on the card, so a kernel fault
    fails the call.  On the CPU, where the kernels' plain versions ran, it
    returns True and the caller re-runs on the plain engines, as the JAX
    package does."""
    ll_scan = float(api.get_loss(spec, best, data, start, end))
    if not _fused_disagrees(ll_kernel, ll_scan):
        return False
    _warn_fused_disagreement(tag, ll_kernel, ll_scan)
    if _fused_check_mode() != "fallback":
        return False
    if data.is_cuda:
        raise RuntimeError(
            f"{tag}: the kernel-reported optimum {ll_kernel!r} disagrees with "
            f"the plain engine's {ll_scan!r} by more than 0.5% on the card; "
            f"YFM_FUSED_CHECK=warn keeps the kernels' result")
    return True


def _values_and_grads(objective, X):
    """``objective(X)`` (S,) and its gradient (S, P) by ONE autograd pass
    over the batch's summed values: the rows are independent, so each row's
    gradient is its own.  Non-finite gradient entries are set to 0, and a
    gradient is 0 where the objective does not depend on X (the random
    walk's loss has no parameter in it)."""
    X = X.detach().requires_grad_(True)
    with torch.enable_grad():
        vals = objective(X)
        grads = None
        if vals.requires_grad:
            (grads,) = torch.autograd.grad(vals.sum(), X, allow_unused=True)
    if grads is None:
        return vals.detach(), torch.zeros_like(X)
    return vals.detach(), torch.where(torch.isfinite(grads), grads,
                                      torch.zeros_like(grads))


def fused_objectives(spec: ModelSpec, data, start, end, penalty=PENALTY,
                     win_starts=None, win_ends=None):
    """Batched MLE objectives through the fused kernels: returns
    (value_fn, value_and_grad) with X (B, P)-raw → f (B,) / (f, g (B, P)).

    ``value_fn`` is one K1 launch for all B rows (every Armijo probe);
    ``value_and_grad`` is one K2f/K2b (DNS/AFNS) or K3f/K3b (TVλ) pair (each
    accepted point).  The kernels work in the spec's float type: float32 by
    default, as the JAX package's fused kernels do on the TPU, and float64
    for a float64 spec, the type of the JAX package's own objective off the
    TPU.  Non-finite objective values are clamped to ``penalty`` and
    non-finite gradients set to 0.  ``win_starts``/``win_ends``: optional
    per-row windows."""

    def clamp(v):
        return torch.where(torch.isfinite(v), v, torch.full_like(v, penalty))

    def value_fn(X):
        cb = transform_params(spec, X)
        return clamp(-fused_kf._batched_loglik(spec, cb, data, start, end,
                                               win_starts, win_ends,
                                               dtype=spec.dtype))

    def vag(X):
        X = X.detach().requires_grad_(True)
        with torch.enable_grad():
            cb = transform_params(spec, X)
            vals = clamp(-fused_kf_grad.batched_loglik_diff(
                spec, cb, data, start, end, starts=win_starts, ends=win_ends,
                dtype=spec.dtype))
            (grads,) = torch.autograd.grad(vals, X, torch.ones_like(vals))
        vals = vals.detach().to(X.dtype)
        return vals, torch.where(torch.isfinite(grads), grads,
                                 torch.zeros_like(grads))

    return value_fn, vag


def vmapped_value_and_grad(spec: ModelSpec, data, start, end, penalty=PENALTY):
    """The per-start objective batched: ``X (S, P)`` raw → (values (S,) of
    :func:`_finite_objective`, gradients (S, P) with NaN set to 0), by one
    autograd pass over the batch on the family's plain engine — the
    univariate Kalman filter, the score-driven scan (its inner score
    differentiated with ``create_graph``) or the batched static loss."""
    return lambda X: _values_and_grads(
        lambda Y: _finite_objective(spec, data, Y, start, end, penalty), X)


def _lane_objectives(spec: ModelSpec, data, starts, ends):
    """(value_fn, value_and_grad) over lanes for ``per_start``: lane ``r``
    is the plain objective on the window [starts[r], ends[r]) (numpy ints);
    the lanes of one call that share a window are evaluated together."""
    starts, ends = np.asarray(starts), np.asarray(ends)

    def by_window(fn, X, rows):
        r = rows.cpu().numpy()
        wins = sorted(set(zip(starts[r].tolist(), ends[r].tolist())))
        if len(wins) == 1:
            return fn(X, *wins[0])
        parts = []
        for s, e in wins:
            sel = torch.as_tensor(np.flatnonzero((starts[r] == s) & (ends[r] == e)),
                                  device=X.device)
            parts.append((sel, fn(X[sel], s, e)))
        outs = tuple(torch.empty((X.shape[0],) + v.shape[1:], dtype=v.dtype,
                                 device=v.device) for v in parts[0][1])
        for sel, vals in parts:
            for o, v in zip(outs, vals):
                o[sel] = v
        return outs

    def value_fn(X, rows):
        with torch.no_grad():
            return by_window(lambda Y, s, e: (_finite_objective(spec, data, Y, s, e),),
                             X, rows)[0]

    def value_and_grad(X, rows):
        return by_window(lambda Y, s, e: vmapped_value_and_grad(spec, data, s, e)(Y),
                         X, rows)

    return value_fn, value_and_grad


def _resolve_objective(spec: ModelSpec, objective: str) -> str:
    """"auto" is "fused" for the three Kalman families and "vmap" for every
    other, as the JAX package picks on a TPU."""
    if objective not in ("auto", "fused", "vmap", "time_sharded"):
        raise ValueError(f"unknown objective {objective!r}; "
                         f"pick from ('auto', 'fused', 'vmap', "
                         f"'time_sharded')")
    if objective == "time_sharded":
        raise _not_ported(f"objective {objective!r}", objective)
    if objective == "auto":
        return "fused" if spec.family in _FUSED_FAMILIES else "vmap"
    if objective == "fused" and spec.family not in _FUSED_FAMILIES:
        raise ValueError(f"fused objective unavailable for family "
                         f"{spec.family!r}; use objective='vmap'")
    return objective


def _check_unported_knobs(second_order, warm_start) -> None:
    """Refuse every switch of the JAX ``estimate`` that the port has no
    code behind, whether given per call or armed in the environment."""
    if second_order is None:
        second_order = os.environ.get("YFM_NEWTON", "0") not in ("", "0")
    if second_order not in (False, ""):
        raise _not_ported("second_order (the Newton polish, YFM_NEWTON)",
                          "second_order")
    if warm_start is None:
        warm_start = os.environ.get("YFM_AMORT", "0") not in ("", "0")
    if warm_start is not False:
        raise _not_ported("warm_start (the amortized warm start, YFM_AMORT)",
                          "warm_start")
    if os.environ.get("YFM_ESCALATE", "0") not in ("", "0"):
        raise _not_ported("YFM_ESCALATE (the escalation ladder)", "ladder")


def estimate(spec: ModelSpec, data, all_params, start=0, end=None,
             max_iters: int = 1000, g_tol: float = 1e-6, f_abstol: float = 1e-6,
             printing: bool = False, objective: str = "auto",
             second_order=None, warm_start=None, device=None):
    """Multi-start L-BFGS MLE.  ``all_params``: (P, S) constrained starts.

    ``objective="fused"`` (the Kalman families; what ``"auto"`` picks for
    them): all S starts run ONE batched L-BFGS loop whose every
    function/gradient evaluation is one launch of the fused kernels covering
    all starts, and the winner is re-evaluated by the plain engine; a
    disagreement raises on the card and re-runs ``"vmap"`` on the CPU
    (``YFM_FUSED_CHECK``).  ``"vmap"``
    (every family; what ``"auto"`` picks for the others): each start's own
    L-BFGS on the plain engine, all starts in lockstep.  Numpy ``data``
    goes to ``device`` (``None`` means CUDA); with ``device="cpu"`` the
    kernels' plain versions run instead.

    Returns (init_params, ll, best_params, Convergence(converged, iterations))
    for the winning start, as the JAX package does."""
    kind = _resolve_objective(spec, objective)
    _check_unported_knobs(second_order, warm_start)
    data = config.as_tensor(data, device, spec.dtype)
    dev = data.device
    T = data.shape[1]
    if end is None:
        end = T
    all_params = np.asarray(all_params, dtype=np.float64)
    if all_params.ndim == 1:
        all_params = all_params[:, None]
    cols = torch.as_tensor(all_params.T)  # (S, P) constrained, float64 on the host
    raw = _sanitize(untransform_params(spec, cols).numpy())
    X0 = torch.as_tensor(raw, dtype=spec.dtype, device=dev)

    if kind == "fused":
        value_fn, vag = fused_objectives(spec, data, start, end)
        res = batched_lbfgs(vag, X0, max_iters, g_tol=g_tol, f_abstol=f_abstol,
                            invalid_above=PENALTY_THRESH, value_fn=value_fn)
    else:
        S = X0.shape[0]
        res = run_lbfgs(*_lane_objectives(spec, data, [start] * S, [end] * S), X0,
                        max_iters, g_tol, f_abstol)
    fs = res.f.double().cpu().numpy()
    xs = res.x.double().cpu().numpy()
    its = res.iters.cpu().numpy()
    convs = res.converged.cpu().numpy()
    lls = -fs
    j = int(np.nanargmax(np.where(np.isfinite(lls), lls, -np.inf)))
    best = transform_params(spec, torch.as_tensor(xs[j], dtype=spec.dtype, device=dev))
    if kind == "fused" and _falls_back("estimate()", spec, best, lls[j], data, start, end):
        return estimate(spec, data, all_params, start, end, max_iters, g_tol, f_abstol,
                        printing, objective="vmap", second_order=second_order,
                        warm_start=warm_start)
    _record_report(lls, j, iters=its, converged=convs)
    if printing:
        print(f"✓ Best LL = {lls[j]} from starting point {j + 1}/{len(lls)}")
    init = transform_params(spec, torch.as_tensor(raw[j], dtype=spec.dtype))
    # a start parked on the penalty plateau has zero clamped gradients: an
    # invalid run, not a converged one
    valid_j = np.isfinite(lls[j]) and fs[j] < PENALTY_THRESH
    conv = Convergence(bool(convs[j] and valid_j), int(its[j]))
    return (init.numpy(), float(lls[j]), best.detach().cpu().numpy(), conv)


def estimate_windows(spec: ModelSpec, data, raw_starts, window_starts, window_ends,
                     max_iters: int = 1000, g_tol: float = 1e-6,
                     f_abstol: float = 1e-6, objective: str = "auto",
                     second_order=None, warm_start=None, device=None):
    """Re-estimate over W rolling windows × S starts, all (W·S) as one batch.

    ``raw_starts`` (S, P) unconstrained starts, shared by every window;
    ``window_starts``/``window_ends`` (W,) the windows' [start, end).  With
    ``objective="fused"`` (the Kalman families' ``"auto"``) the rows run
    one batched L-BFGS whose every evaluation is one launch of the fused
    kernels with per-row windows — masked windows are exactly equivalent to
    truncation — and the first window's best start is re-evaluated by the
    plain engine; a disagreement raises on the card and re-runs ``"vmap"``
    on the CPU (``YFM_FUSED_CHECK``).
    With ``"vmap"`` each row runs its own L-BFGS on the plain engine, all
    rows in lockstep.  Numpy ``data`` goes to ``device`` (``None`` means
    CUDA).

    Returns (params (W, S, P) unconstrained, logliks (W, S)) as float64
    numpy arrays — higher is better; pick each window's start with argmax."""
    kind = _resolve_objective(spec, objective)
    _check_unported_knobs(second_order, warm_start)
    data = config.as_tensor(data, device, spec.dtype)
    dev = data.device
    raw = torch.as_tensor(raw_starts, dtype=spec.dtype, device=dev)
    S, Pn = raw.shape
    ws = torch.as_tensor(window_starts).reshape(-1).cpu().numpy().astype(np.int64)
    we = torch.as_tensor(window_ends).reshape(-1).cpu().numpy().astype(np.int64)
    W = ws.shape[0]
    if kind == "fused":
        value_fn, vag = fused_objectives(
            spec, data, 0, data.shape[1],
            win_starts=torch.as_tensor(ws, device=dev).repeat_interleave(S),
            win_ends=torch.as_tensor(we, device=dev).repeat_interleave(S))
        res = batched_lbfgs(vag, raw.repeat(W, 1), max_iters, g_tol=g_tol,
                            f_abstol=f_abstol, invalid_above=PENALTY_THRESH,
                            value_fn=value_fn)
    else:
        res = run_lbfgs(*_lane_objectives(spec, data, ws.repeat(S), we.repeat(S)),
                        raw.repeat(W, 1), max_iters, g_tol, f_abstol)
    xs = res.x.double().cpu().numpy().reshape(W, S, Pn)
    lls = -res.f.double().cpu().numpy().reshape(W, S)
    if kind == "fused":
        j0 = int(np.nanargmax(np.where(np.isfinite(lls[0]), lls[0], -np.inf)))
        best = transform_params(spec, torch.as_tensor(xs[0, j0], dtype=spec.dtype,
                                                      device=dev))
        if _falls_back("estimate_windows() window 0", spec, best, lls[0, j0], data,
                       int(ws[0]), int(we[0])):
            return estimate_windows(spec, data, raw_starts, window_starts, window_ends,
                                    max_iters, g_tol, f_abstol, objective="vmap",
                                    second_order=second_order, warm_start=warm_start)
    return xs, lls


# ---------------------------------------------------------------------------
# estimate_steps: block-coordinate descent
# ---------------------------------------------------------------------------

#: group → (optimizer, options), the JAX package's default table
DEFAULT_OPTIMIZERS: Dict[str, tuple] = {
    "1": ("neldermead", dict(max_iters=500)),
    "2": ("lbfgs", dict(max_iters=250, g_tol=1e-6, f_abstol=1e-6)),
    "3": ("adam", dict(max_iters=5000, lr=1e-3)),
    "4": ("neldermead", dict(max_iters=500)),
    "5": ("adam", dict(max_iters=10000, lr=1e-3)),
}


def _optimizer_for_group(g: str, table) -> tuple:
    return table.get(g, table["1"])


def _finite_objective(spec: ModelSpec, data, raw_params, start, end,
                      penalty=PENALTY):
    """The plain engine's objective −loss at raw parameters, non-finite
    values clamped to ``penalty``."""
    v = compute_loss(spec, data, raw_params, start, end)
    return torch.where(torch.isfinite(v), v, torch.full_like(v, penalty))


def _batch_loss(spec: ModelSpec, cons, data, start, end, plain: bool = False):
    """(B,) losses of constrained draws in the spec's float type: for a
    Kalman spec the loglik from K1 (``ops/fused_kf``); for a score-driven
    spec K4 for the detached-β̄ score it implements, and the reference's
    own scan over the draw axis for a ``detach_inner_beta=False`` spec, as
    the JAX package sends such specs to its vmapped scan; for a static spec
    the batched static loss on the draws' device (the static families have
    no kernel).  On the CPU the kernels' plain versions run.  ``plain``:
    the family's plain engine instead of a kernel (the univariate filter,
    the scan), as after a trust-but-verify disagreement."""
    if plain:
        return api.get_loss(spec, cons, data, start, end)
    if spec.is_kalman:
        return fused_kf._batched_loglik(spec, cons, data, start, end,
                                        dtype=spec.dtype)
    if spec.is_static:
        return static_model.get_loss(spec, cons, data, start, end)
    if spec.detach_inner_beta:
        return fused_ssd.batched_loss(spec, cons, data, start, end)
    return score_driven.get_loss(spec, cons, data, start, end)


def try_initializations(spec: ModelSpec, best_params, data, max_tries: int = 0,
                        start=0, end=None, device=None, _force_scan: bool = False):
    """A (P, S) matrix of constrained starting points.  For a score-driven
    spec: ``best_params`` and the A×B guess grid (256 candidates for
    1SSD-NNS) in ONE call of the score-driven value kernel (the plain scan
    for a ``detach_inner_beta=False`` spec), and the best
    candidate as the single start; for a static spec ``best_params`` and
    ``max_tries`` jittered starts (``get_new_initial_params``, seeded by the
    trial); for the random walk and a Kalman spec ``best_params`` itself.
    Numpy ``data`` goes to ``device`` (``None`` means CUDA); ``_force_scan``
    evaluates the grid on the plain scan."""
    best_params = np.asarray(best_params, dtype=np.float64).reshape(-1)
    if spec.is_static and spec.family != "random_walk":
        return np.stack([best_params] + [get_new_initial_params(spec, best_params, t)
                                         for t in range(1, max_tries + 1)], axis=1)
    if not spec.is_msed:
        return best_params[:, None]
    trials = []
    for t in range(1, 1001):
        cand = get_new_initial_params(spec, best_params, t)
        if cand is None:
            break
        trials.append(cand)
    cands = np.stack([best_params] + trials, axis=0)  # (S, P)
    data = config.as_tensor(data, device, spec.dtype)
    if end is None:
        end = data.shape[1]
    losses = _batch_loss(
        spec, torch.as_tensor(cands, dtype=spec.dtype, device=data.device),
        data, start, end, plain=_force_scan).double().cpu().numpy()
    best = int(np.nanargmax(np.where(np.isfinite(losses), losses, -np.inf)))
    return cands[best][:, None]


def _neldermead_group(spec: ModelSpec, X, inds, opts, data, start, end,
                      plain: bool = False):
    """All starts' Nelder–Mead over the group ``inds`` in lockstep; every
    candidate batch is one :func:`_batch_loss` call (K1 or K4; the plain
    engine with ``plain``), the objective −loss with non-finite values
    clamped to the penalty.  On the card a Kalman spec's one-candidate
    batches (two an iteration) replay a CUDA graph of the whole evaluation
    (``fused_kf.LoglikGraph``).  Returns (X', f (S,))."""
    S, Pn = X.shape
    idx = torch.as_tensor(inds, device=X.device)

    def values(Xs):  # (S, K, k) -> (S, K)
        K = Xs.shape[1]
        F = X[:, None, :].expand(S, K, Pn).clone()
        F[:, :, idx] = Xs
        v = -_batch_loss(spec, transform_params(spec, F.reshape(S * K, Pn)),
                         data, start, end, plain)
        return torch.where(torch.isfinite(v), v, torch.full_like(v, PENALTY)).reshape(S, K)

    graph = None

    def batch_fun(Xs):
        nonlocal graph
        if Xs.shape[1] > 1 or plain or not (spec.is_kalman and Xs.is_cuda):
            return values(Xs)
        if graph is None:
            graph = fused_kf.LoglikGraph(values, Xs)
        return graph(Xs)

    x, f, _ = nelder_mead_batched(batch_fun, X[:, idx], max_iters=opts["max_iters"],
                                  f_tol=opts.get("f_tol", 1e-8))
    out = X.clone()
    out[:, idx] = x
    return out, f


def _group_objective(spec: ModelSpec, X, inds, data, start, end):
    """The plain objective over the group ``inds`` of the (S, P) starts X:
    ``embed(Xs, rows)`` puts the (R, k) group entries ``Xs`` into the full
    vectors of the starts ``rows`` (all of them by default), and
    ``value_and_grad(Xs, rows)`` is :func:`_finite_objective` there with its
    gradient in the group, by one autograd pass.  Returns (embed,
    value_and_grad)."""
    idx = torch.as_tensor(inds, device=X.device)

    def embed(Xs, rows=slice(None)):
        F = X[rows].clone()
        F[:, idx] = Xs
        return F

    def value_and_grad(Xs, rows=slice(None)):
        return _values_and_grads(
            lambda Y: _finite_objective(spec, data, embed(Y, rows), start, end), Xs)

    return embed, value_and_grad


def _group_opt_batched(spec: ModelSpec, X, inds, kind, opts, data, start, end):
    """Every start's L-BFGS or Adam (``per_start.run_named``) over the group
    ``inds``, all starts in lockstep, each on its own full vector; the
    objective is :func:`_finite_objective` on the family's plain engine,
    its gradient by autograd.  Returns (X', f (S,))."""
    embed, value_and_grad = _group_objective(spec, X, inds, data, start, end)

    def value_fn(Xs, rows):
        with torch.no_grad():
            return _finite_objective(spec, data, embed(Xs, rows), start, end)

    res = run_named(kind, value_fn, value_and_grad, X[:, list(inds)], opts)
    return embed(res.x), res.f


def _group_opt_ssd(spec: ModelSpec, X, inds, opts, data, start, end):
    """The L-BFGS group of a score-driven spec that K4 serves
    (``detach_inner_beta``): ONE batched L-BFGS over all starts
    (``batched_lbfgs``) whose every Armijo probe is one K4 launch for all
    starts and whose accepted points take K4's values with the scan's
    gradients (by autograd through the inner score), as the JAX package
    splits them (its Nelder–Mead groups are :func:`_neldermead_group` on
    K4).  Returns (X', f (S,))."""
    embed, scan_value_and_grad = _group_objective(spec, X, inds, data, start, end)

    def value_fn(Xs):
        v = -_batch_loss(spec, transform_params(spec, embed(Xs)), data, start, end)
        return torch.where(torch.isfinite(v), v, torch.full_like(v, PENALTY))

    def value_and_grad(Xs):
        return value_fn(Xs), scan_value_and_grad(Xs)[1]

    res = batched_lbfgs(value_and_grad, X[:, list(inds)], opts["max_iters"],
                        g_tol=opts.get("g_tol", 1e-6), f_abstol=opts.get("f_abstol", 1e-6),
                        invalid_above=PENALTY_THRESH, value_fn=value_fn)
    return embed(res.x), res.f


def _msed_closed_applicable(spec: ModelSpec, inds, data, start, end) -> bool:
    """Whether the closed-form (δ, Φ) solve serves a group: a score-driven
    or static (not random-walk) spec with M = 3, the group exactly the
    contiguous (δ, Φ) tail, enough rows for the 12 unknowns, and a fully
    observed window (with missing columns β carries through Φ and the
    sub-objective is not quadratic).  ``YFM_MSED_CLOSED=0`` turns it off."""
    family_ok = spec.is_msed or spec.family in ("static_lambda", "static_neural")
    if not family_ok or spec.M != 3:
        return False
    if os.environ.get("YFM_MSED_CLOSED", "1") == "0":
        return False
    lo_d, _ = spec.layout["delta"]
    _, hi_p = spec.layout["phi"]
    if tuple(inds) != tuple(range(lo_d, hi_p)):
        return False
    N, T = data.shape
    if (T - 1) * N < spec.M + spec.M * spec.M:
        return False
    return bool(torch.isfinite(data[:, int(start):int(end)]).all())


def _solve_or_nan(A, b):
    """torch.linalg.solve with NaN where a matrix is singular (the JAX
    package's solve returns non-finite values there instead of raising)."""
    x, info = torch.linalg.solve_ex(A, b)
    return torch.where((info == 0).reshape(info.shape + (1,) * (x.dim() - info.dim())),
                       x, torch.full_like(x, float("nan")))


def _msed_closed_group(spec: ModelSpec, X, data, start, end):
    """The exact optimum of the (δ, Φ) block for each start.

    On a fully observed window the γ path and the post-update β̄ do not
    depend on (δ, Φ), so the loss is −Σ‖y_{t+1} − Z_{t+1}(μ + Φβ̄_t)‖², a
    12-unknown linear least squares in (μ, vec Φ): one trajectory pass of
    the plain scan (for a static spec, whose Z is constant, the per-column
    OLS instead), a QR solve (ridge normal equations where R is
    singular), δ = (I − Φ)⁻¹μ with Φ's diagonal clipped into (−1, 1).  A
    start takes the candidate only where it improves the plain objective.
    Returns (X', f (S,))."""
    S = X.shape[0]
    M = spec.M
    cons = transform_params(spec, X)
    N, T = data.shape
    t_idx = torch.arange(T - 1, device=X.device)
    keep = ((t_idx >= start) & (t_idx <= end - 2))[:, None, None]
    if spec.is_msed:
        _, _, outs = score_driven.scan_filter(spec, cons, data, start, end)
        Z2, Z3 = outs["Z2"][:, :-1], outs["Z3"][:, :-1]    # (S, T−1, N) at γ_{t+1}
        Zx = torch.stack([torch.ones_like(Z2), Z2, Z3], -1)  # (S, T−1, N, M)
        bo = outs["beta_obs"][:, :-1]                      # (S, T−1, M)
    else:
        Zc = static_model.loadings_fn(spec, unpack_static(spec, cons).gamma)  # (S, N, M)
        ysafe = torch.where(torch.isfinite(data), data, torch.zeros_like(data))
        bo = ols_solve_columns(Zc, ysafe[:, :-1])          # (S, T−1, M)
        Zx = Zc[:, None].expand(S, T - 1, N, M)
    # regressors of vec_rowmajor(Φ): column (m, k) is Z[:, :, m]·β̄[k]
    Dphi = (Zx[..., :, None] * bo[:, :, None, None, :]).reshape(S, T - 1, N, M * M)
    D = torch.cat([Zx, Dphi], -1)                          # (S, T−1, N, M+M²)
    # mask by where, never by multiplication: a NaN outside the window
    # must not poison the sums
    Dm = torch.where(keep, D, torch.zeros_like(D)).reshape(S, -1, M + M * M)
    y1 = data[:, 1:].T
    ym = torch.where(keep[:, :, 0], y1, torch.zeros_like(y1)).reshape(-1)
    ym = ym.expand(S, -1)
    Q, R = torch.linalg.qr(Dm)
    qty = (Q * ym[..., None]).sum(1)
    theta = torch.linalg.solve_triangular(R, qty[..., None], upper=True)[..., 0]
    G = Dm.transpose(1, 2) @ Dm
    lam = 1e-8 * torch.diagonal(G, dim1=1, dim2=2).sum(1) / G.shape[1]
    eye = torch.eye(G.shape[1], dtype=G.dtype, device=G.device)
    theta_r = _solve_or_nan(G + lam[:, None, None] * eye,
                            (Dm.transpose(1, 2) @ ym[..., None])[..., 0])
    ok = torch.isfinite(theta).all(1, keepdim=True)
    theta = torch.where(ok, theta, theta_r)
    mu = theta[:, :M]
    Phi = theta[:, M:].reshape(S, M, M)
    diag = torch.diagonal(Phi, dim1=1, dim2=2)
    Phi = Phi + torch.diag_embed(torch.clamp(diag, -0.999999, 0.999999) - diag)
    delta = _solve_or_nan(torch.eye(M, dtype=Phi.dtype, device=Phi.device) - Phi, mu)
    lo_d, hi_d = spec.layout["delta"]
    lo_p, hi_p = spec.layout["phi"]
    new_cons = cons.clone()
    new_cons[:, lo_d:hi_d] = delta
    new_cons[:, lo_p:hi_p] = Phi.transpose(1, 2).reshape(S, M * M)  # column-major vec
    new_raw = untransform_params(spec, new_cons)
    f_both = _finite_objective(spec, data, torch.cat([new_raw, X]), start, end)
    f_new, f_old = f_both[:S], f_both[S:]
    take = (f_new < f_old) & torch.isfinite(new_raw).all(1)
    return torch.where(take[:, None], new_raw, X), torch.minimum(f_new, f_old)


def estimate_steps(spec: ModelSpec, data, all_params, param_groups, max_group_iters: int = 10,
                   tol: float = 1e-8, optimizers=None, start=0, end=None,
                   max_tries: int = 0, printing: bool = False, checkpoint=None,
                   second_order=None, warm_start=None, device=None,
                   _force_scan: bool = False):
    """Block-coordinate estimation over parameter groups, for the Kalman,
    score-driven and static families.

    The control flow of the JAX package: for a score-driven spec the
    initialization grid replaces the starts by its best candidate (a Kalman
    spec keeps its starts); the first start is untransformed, sanitized and
    rescued (×0.95, up to 10 times) until its loss is finite; then each group
    iteration optimizes every group embedded in the full vector, all starts
    in lockstep, until the loss moves by less than ``tol``: the closed-form
    (δ, Φ) solve where it applies; Nelder–Mead with every candidate batch
    one value-kernel call (K1 for a Kalman spec, K4 for a score-driven one,
    the batched static loss for a static one, the scan for a
    ``detach_inner_beta=False`` score-driven one); for a score-driven spec
    that K4 serves, L-BFGS with K4's probes and the scan's gradients
    (:func:`_group_opt_ssd`); else L-BFGS or Adam per start on the plain
    engine (:func:`_group_opt_batched`).  An objective
    that is non-finite everywhere on the first group optimization raises;
    later, the start's group loop stops.  A winner whose loss came from a
    kernel (K1, K4) is re-evaluated by the family's plain engine
    (trust-but-verify); a disagreement raises on the card and re-runs the
    whole estimation on the plain engines on the CPU (``_force_scan``;
    ``YFM_FUSED_CHECK``).  ``all_params``
    (P, S) constrained; numpy ``data`` goes to ``device`` (``None`` means
    CUDA).

    Returns (init_params, ll, best_params, Convergence(converged,
    iterations)) for the winning start, as numpy arrays."""
    if checkpoint is not None:
        raise _not_ported("checkpointed estimate_steps", "checkpoint")
    _check_unported_knobs(second_order, warm_start)
    data = config.as_tensor(data, device, spec.dtype)
    dev = data.device
    T = data.shape[1]
    if end is None:
        end = T
    table = optimizers if optimizers is not None else DEFAULT_OPTIMIZERS
    param_groups = list(param_groups)
    group_ids = sorted(set(param_groups))
    inds_by_group = {g: tuple(i for i, gg in enumerate(param_groups) if gg == g)
                     for g in group_ids}
    closed_ok = {g: _msed_closed_applicable(spec, inds_by_group[g], data, start, end)
                 for g in group_ids}
    use_ssd = spec.is_msed and spec.detach_inner_beta and not _force_scan
    caller_params = all_params

    with torch.no_grad():
        all_params = np.asarray(all_params, dtype=np.float64)
        if all_params.ndim == 1:
            all_params = all_params[:, None]
        all_params = try_initializations(spec, all_params[:, 0], data, max_tries,
                                         start, end, _force_scan=_force_scan)
        raw = np.stack([_sanitize(untransform_params(spec, torch.as_tensor(c)).numpy())
                        for c in all_params.T], axis=1)  # (P, S)

        def loss_at(p):
            cons = transform_params(spec, torch.as_tensor(p, dtype=spec.dtype, device=dev))
            return float(_batch_loss(spec, cons[None], data, start, end, _force_scan)[0])

        # validity rescue of the first start: only whether its loss is
        # finite matters, so the value kernel evaluates it
        ll0 = loss_at(raw[:, 0])
        for _ in range(10):
            if np.isfinite(ll0):
                break
            raw[:, 0] *= 0.95
            ll0 = loss_at(raw[:, 0])

        X = torch.as_tensor(raw.T, dtype=spec.dtype, device=dev)  # (S, P)
        S = X.shape[0]
        prev_ll = np.full(S, -np.inf)
        done = np.zeros(S, dtype=bool)       # ΔLL met or aborted
        converged = np.zeros(S, dtype=bool)  # ΔLL met
        iters_done = np.zeros(S, dtype=np.int64)
        first_group_of_run = True
        for it in range(max_group_iters):
            if done.all():
                break
            aborted = np.zeros(S, dtype=bool)
            for g in group_ids:
                inds = inds_by_group[g]
                if g == "-1" or not inds:  # placeholder group: skipped
                    continue
                kind, opts = _optimizer_for_group(g, table)
                if closed_ok[g]:
                    X_new, f_g = _msed_closed_group(spec, X, data, start, end)
                elif kind == "neldermead":
                    X_new, f_g = _neldermead_group(spec, X, inds, opts, data, start, end,
                                                   _force_scan)
                elif use_ssd and kind == "lbfgs":
                    X_new, f_g = _group_opt_ssd(spec, X, inds, opts, data, start, end)
                else:
                    X_new, f_g = _group_opt_batched(spec, X, inds, kind, opts, data,
                                                    start, end)
                f_g = f_g.double().cpu().numpy()
                obj_broken = f_g >= PENALTY_THRESH
                if first_group_of_run:
                    first_group_of_run = False
                    if obj_broken[0] and not np.isfinite(ll0):
                        raise RuntimeError(
                            f"estimate_steps: objective is non-finite at every point "
                            f"of the first group optimization (group {g!r}) — "
                            f"model/data are structurally incompatible")
                frozen = torch.as_tensor(done | aborted, device=dev)
                X = torch.where(frozen[:, None], X, X_new)
                aborted = aborted | (obj_broken & ~done)
            active = ~done
            iters_done[active] = it + 1
            lls = _batch_loss(spec, transform_params(spec, X), data, start, end,
                              _force_scan).double().cpu().numpy()
            hit_tol = np.abs(lls - prev_ll) < tol
            converged |= active & hit_tol & ~aborted
            done = done | (active & (hit_tol | aborted))
            prev_ll = np.where(active & ~aborted, lls, prev_ll)
        if printing:
            for j in range(S):
                print(f"✓ LL = {prev_ll[j]} from start {j + 1}")

        best_j = int(np.argmax(np.where(np.isfinite(prev_ll), prev_ll, -np.inf)))
        X_np = X.double().cpu().numpy()
        best = transform_params(spec, torch.as_tensor(X_np[best_j], dtype=spec.dtype,
                                                      device=dev))
        kernel_values = not _force_scan and (spec.is_kalman or use_ssd)
        if kernel_values and _falls_back("estimate_steps()", spec, best, prev_ll[best_j],
                                         data, start, end):
            return estimate_steps(spec, data, caller_params, param_groups, max_group_iters,
                                  tol, optimizers, start, end, max_tries, printing,
                                  second_order=second_order, warm_start=warm_start,
                                  _force_scan=True)
        init = transform_params(spec, torch.as_tensor(raw[:, best_j], dtype=spec.dtype))
    _record_report(prev_ll, best_j, iters=iters_done, converged=converged)
    if printing:
        print(f"✓ Best overall LL = {prev_ll[best_j]} from start {best_j + 1}")
    return (init.numpy(), float(prev_ll[best_j]), best.cpu().numpy(),
            Convergence(bool(converged[best_j]), int(iters_done[best_j])))
