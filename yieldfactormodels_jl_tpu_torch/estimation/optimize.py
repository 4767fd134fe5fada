"""Multi-start MLE on the fused kernels: ``estimate`` and the rolling-window
``estimate_windows`` with the fused objective.

Counterpart of the fused path of ``yieldfactormodels_jl_tpu/estimation/
optimize.py``: one batched L-BFGS loop over the (S, P) start matrix
(``batched_lbfgs``) whose Armijo probes run the value kernel (K1,
``ops/fused_kf``) and whose accepted points take one value-and-gradient
through the differentiable kernels (K2f/K2b for DNS/AFNS, K3f/K3b for TVλ,
``ops/fused_kf_grad``), then a trust-but-verify re-evaluation of the winner
by the plain univariate engine.  ``estimate_windows`` runs the same loop
over a (windows × starts) batch whose rows carry their own windows.

What is not ported yet raises ``NotImplementedError`` naming its ROADMAP
item: the per-start ``"vmap"`` optimizer and ``"time_sharded"`` objective,
the Newton polish (``second_order`` / ``YFM_NEWTON``), the amortized warm
start (``warm_start`` / ``YFM_AMORT``) and the escalation ladder
(``YFM_ESCALATE``).
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
from ..ops import fused_kf, fused_kf_grad
from .batched_lbfgs import batched_lbfgs

#: the non-finite-loss penalty, and the threshold at/above which an objective
#: value sits on its plateau: strictly below 1e12 because float32 rounds 1e12
#: down to 999_999_995_904 (the JAX package's ops/newton.py constants)
PENALTY = 1e12
PENALTY_THRESH = 0.999e12

#: families the differentiable fused kernels cover: all three Kalman families
_FUSED_FAMILIES = ("kalman_dns", "kalman_afns", "kalman_tvl")

_NOT_PORTED = {
    "vmap": "ROADMAP.md Queue 1 item 4 (per-start optax L-BFGS, "
            "vmapped_value_and_grad)",
    "time_sharded": "ROADMAP.md Queue 1 item 10 (parallel-in-time engines)",
    "second_order": "ROADMAP.md Queue 1 item 9 (ops/newton.py, the Newton "
                    "polish)",
    "warm_start": "ROADMAP.md Queue 1 item 9 (estimation/amortize.py, the "
                  "amortized warm start)",
    "ladder": "ROADMAP.md Queue 1 item 9 (robustness/ladder.py, the "
              "escalation ladder)",
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
    """Trust-but-verify policy for the fused-kernel optimum
    (``YFM_FUSED_CHECK``): "fallback" (the default) raises on a
    disagreement, since the port has no per-start path to fall back to;
    "warn" only writes the stderr line."""
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


def _trust_but_verify(tag: str, spec: ModelSpec, x_raw, ll_fused: float, data,
                      start, end):
    """ONE plain-engine evaluation of a kernel-reported optimum (raw
    parameters ``x_raw``), so a silent kernel fault cannot pass as a fit;
    returns the constrained point.  A disagreement raises under the default
    ``YFM_FUSED_CHECK=fallback``: the port has no per-start path to fall
    back to."""
    best = transform_params(spec, torch.as_tensor(x_raw, dtype=spec.dtype,
                                                  device=data.device))
    ll_scan = float(api.get_loss(spec, best, data, start, end))
    if _fused_disagrees(ll_fused, ll_scan):
        _warn_fused_disagreement(tag, ll_fused, ll_scan)
        if _fused_check_mode() == "fallback":
            raise RuntimeError(
                f"{tag}: the fused-kernel optimum {ll_fused!r} disagrees "
                f"with the plain engine's {ll_scan!r} by more than 0.5%; the "
                f"port has no per-start path to fall back to "
                f"({_NOT_PORTED['vmap']}); YFM_FUSED_CHECK=warn keeps the "
                f"fused result")
    return best


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


def _resolve_objective(spec: ModelSpec, objective: str) -> str:
    if objective not in ("auto", "fused", "vmap", "time_sharded"):
        raise ValueError(f"unknown objective {objective!r}; "
                         f"pick from ('auto', 'fused', 'vmap', "
                         f"'time_sharded')")
    if objective in ("vmap", "time_sharded"):
        raise _not_ported(f"objective {objective!r}", objective)
    if spec.family not in _FUSED_FAMILIES:
        raise ValueError(f"fused objective unavailable for family "
                         f"{spec.family!r}")
    return "fused"


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

    All S starts run in ONE batched L-BFGS loop whose every function/gradient
    evaluation is one launch of the fused kernels covering all starts
    (``objective="fused"``; ``"auto"`` picks it for every Kalman family).
    Numpy ``data`` goes to ``device`` (``None`` means CUDA); with
    ``device="cpu"`` the kernels' plain versions run instead.

    Returns (init_params, ll, best_params, Convergence(converged, iterations))
    for the winning start, as the JAX package does."""
    api._require_kalman(spec)
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

    value_fn, vag = fused_objectives(spec, data, start, end)
    res = batched_lbfgs(vag, torch.as_tensor(raw, dtype=spec.dtype, device=dev),
                        max_iters, g_tol=g_tol, f_abstol=f_abstol,
                        invalid_above=PENALTY_THRESH, value_fn=value_fn)
    fs = res.f.double().cpu().numpy()
    xs = res.x.double().cpu().numpy()
    its = res.iters.cpu().numpy()
    convs = res.converged.cpu().numpy()
    lls = -fs
    j = int(np.nanargmax(np.where(np.isfinite(lls), lls, -np.inf)))
    best = _trust_but_verify("estimate()", spec, xs[j], lls[j], data, start, end)
    _record_report(lls, j, iters=its, converged=convs)
    if printing:
        print(f"✓ Best LL = {lls[j]} from starting point {j + 1}/{len(lls)}")
    init = transform_params(spec, torch.as_tensor(raw[j], dtype=spec.dtype))
    # a start parked on the penalty plateau has zero clamped gradients: an
    # invalid run, not a converged one
    valid_j = np.isfinite(lls[j]) and fs[j] < PENALTY_THRESH
    conv = Convergence(bool(convs[j]) and valid_j, int(its[j]))
    return (init.numpy(), float(lls[j]), best.detach().cpu().numpy(), conv)


def estimate_windows(spec: ModelSpec, data, raw_starts, window_starts, window_ends,
                     max_iters: int = 1000, g_tol: float = 1e-6,
                     f_abstol: float = 1e-6, objective: str = "auto",
                     second_order=None, warm_start=None, device=None):
    """Re-estimate over W rolling windows × S starts in ONE batched L-BFGS.

    ``raw_starts`` (S, P) unconstrained starts, shared by every window;
    ``window_starts``/``window_ends`` (W,) the windows' [start, end).  The
    (W·S) rows run one batched L-BFGS whose every evaluation is one launch
    of the fused kernels with per-row windows — masked windows are exactly
    equivalent to truncation.  The first window's best start is re-evaluated
    by the plain engine (trust-but-verify).  Numpy ``data`` goes to
    ``device`` (``None`` means CUDA).

    Returns (params (W, S, P) unconstrained, logliks (W, S)) as float64
    numpy arrays — higher is better; pick each window's start with argmax."""
    api._require_kalman(spec)
    _resolve_objective(spec, objective)
    _check_unported_knobs(second_order, warm_start)
    data = config.as_tensor(data, device, spec.dtype)
    dev = data.device
    raw = torch.as_tensor(raw_starts, dtype=spec.dtype, device=dev)
    S, Pn = raw.shape
    ws = torch.as_tensor(window_starts, device=dev).reshape(-1)
    we = torch.as_tensor(window_ends, device=dev).reshape(-1)
    W = ws.shape[0]
    value_fn, vag = fused_objectives(spec, data, 0, data.shape[1],
                                     win_starts=ws.repeat_interleave(S),
                                     win_ends=we.repeat_interleave(S))
    res = batched_lbfgs(vag, raw.repeat(W, 1), max_iters, g_tol=g_tol,
                        f_abstol=f_abstol, invalid_above=PENALTY_THRESH,
                        value_fn=value_fn)
    xs = res.x.double().cpu().numpy().reshape(W, S, Pn)
    lls = -res.f.double().cpu().numpy().reshape(W, S)
    j0 = int(np.nanargmax(np.where(np.isfinite(lls[0]), lls[0], -np.inf)))
    _trust_but_verify("estimate_windows() window 0", spec, xs[0, j0], lls[0, j0],
                      data, int(ws[0]), int(we[0]))
    return xs, lls
