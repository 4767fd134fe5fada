"""Rolling-window forecast/backtest driver.

Counterpart of ``yieldfactormodels_jl_tpu/forecasting.py`` (the reference's
forecasting.jl):

- ``run_rolling_forecasts`` dispatches on window_type ∈ {both, expanding,
  moving, no_windowing, simulation},
- the per-origin loop shuffles tasks so concurrent workers start at
  different places, skips existing shards, takes a per-task mkdir lock,
  optionally warm-starts from a simpler model's merged DB, re-estimates (or
  reuses params when ``reestimate=False``), forecasts by appending
  ``forecast_horizon−1`` NaN columns and saves a SQLite shard; when all
  shards exist they merge and export CSVs.
- Reference quirk kept: re-estimation uses the *expanding* sample
  ``data[:, :task_id]`` even for moving windows; only the forecast pass uses
  the moving span.

``run_forecast_window_batched`` re-estimates every missing origin in one
(windows × starts) batched L-BFGS (``estimate_windows``, on K2f/K2b or
K3f/K3b) and writes the same shard artifacts.  Every entry point here takes
``device=`` (``None`` means CUDA; ``config.resolve_device``): estimation and
``predict`` run there, the shards and CSVs are written from the host.
"""

from __future__ import annotations

import os
import secrets
from contextlib import nullcontext
from typing import Sequence

import numpy as np
import torch

from . import config
from .estimation import optimize as opt
from .models import api
from .models.params import transform_params, untransform_params
from .models.specs import ModelSpec
from .orchestration import chaos
from .orchestration.checkpoint import WindowCheckpoint
from .orchestration.retry import SentinelFailure
from .parallel.multihost import sweep_stale_locks
from .persistence import database as db
from .persistence.io import _np
from .persistence.locks import (acquire_task_lock, break_stale_lock,
                                release_task_lock, task_lock_path)
from .robustness import taxonomy
from .utils.profiling import StageTimer


def _forecast_db_base(spec: ModelSpec, window_type: str) -> str:
    return os.path.join(spec.results_location, "db", f"forecasts_{window_type}.sqlite3")


def _merged_path(spec: ModelSpec, window_type: str) -> str:
    return os.path.join(spec.results_location, "db", f"forecasts_{window_type}_merged.sqlite3")


def _lockroot(spec: ModelSpec) -> str:
    return os.path.join(spec.results_location, "db", "locks")


def default_checkpoint_root(spec: ModelSpec) -> str:
    return os.path.join(spec.results_location, "db", "checkpoints")


def _lock_ttl(stale_lock_ttl: float | None) -> float | None:
    """Effective TTL for breaking a held-but-stale task lock: the caller's
    ``stale_lock_ttl`` argument, else ``YFM_LOCK_TTL`` (seconds), else None
    (a held lock is always trusted)."""
    if stale_lock_ttl is not None:
        return stale_lock_ttl
    env = os.environ.get("YFM_LOCK_TTL", "")
    return float(env) if env else None


def _as_columns(init_params) -> np.ndarray:
    """(P, S) float64 start matrix from a (P,) vector or a (P, S) matrix."""
    all_params = np.asarray(init_params, dtype=np.float64)
    return all_params[:, None] if all_params.ndim == 1 else all_params


def _estimate_for_window(spec: ModelSpec, data, task_id: int, all_params,
                         param_groups, max_group_iters, group_tol,
                         checkpoint: WindowCheckpoint | None = None,
                         second_order=None, device=None):
    """The reference's run_estimation! on the expanding sample
    data[:, :task_id]: ``estimate_steps`` for a grouping, else ``estimate``."""
    if param_groups:
        _, loss, params, _ = opt.estimate_steps(
            spec, data, all_params, param_groups,
            max_group_iters=max_group_iters, tol=group_tol,
            start=0, end=task_id, checkpoint=checkpoint,
            second_order=second_order, device=device)
    else:
        _, loss, params, _ = opt.estimate(spec, data, all_params, start=0,
                                          end=task_id, second_order=second_order,
                                          device=device)
    return loss, params


def run_single_window_task(
    spec: ModelSpec, data, thread_id: str, task_id: int, window_type: str,
    in_sample_end: int, in_sample_start: int, forecast_horizon: int,
    all_params, *, param_groups=(), max_group_iters: int = 10,
    group_tol: float = 1e-8, reestimate: bool = True,
    timer: StageTimer | None = None, checkpoint_root: str | None = None,
    sentinel_policy: str = "save", second_order=None, device=None,
) -> str:
    """ONE origin's estimate → forecast → shard write; returns the shard path.

    Idempotent by the artifact contract (re-running overwrites the same
    keyed row).  ``sentinel_policy="save"`` persists a non-finite loss as
    NULL, as the reference does; ``"retry"`` raises a ``SentinelFailure``
    instead, its code the multi-start report's ladder code or else one
    coded evaluation at the returned point (``taxonomy.diagnose``; 0 if
    that fails too).  ``checkpoint_root`` builds a per-window checkpoint,
    which ``estimate_steps`` does not take yet."""
    if sentinel_policy not in ("save", "retry"):
        raise ValueError(f"sentinel_policy must be 'save' or 'retry'; "
                         f"got {sentinel_policy!r}")
    dev = config.resolve_device(device)
    data = np.asarray(data, dtype=np.float64)
    base = _forecast_db_base(spec, window_type)
    cur = db.read_static_params_from_db(spec, task_id, all_params,
                                        window_type=window_type)
    ckpt = None
    if reestimate:
        if checkpoint_root is not None and param_groups:
            ckpt = WindowCheckpoint(checkpoint_root, window_type, task_id)
        with timer.stage("estimation") if timer is not None else nullcontext():
            loss, params = _estimate_for_window(
                spec, data, task_id, cur, param_groups, max_group_iters,
                group_tol, checkpoint=ckpt, second_order=second_order,
                device=dev)
        if sentinel_policy == "retry" and not np.isfinite(loss):
            code = 0
            for t in opt.last_multistart_report().get("ladder", ()):
                code |= int(t.get("code", 0))
            if code == 0:
                try:
                    _, code = taxonomy.diagnose(spec, params, data, start=0,
                                                end=task_id, device=dev)
                except Exception:  # noqa: BLE001 — the diagnosis must not
                    code = 0       # hide the original failure
            raise SentinelFailure(
                f"estimation for {window_type} window {task_id} returned a "
                f"non-finite loss sentinel ({loss})", seam="estimate", code=code)
    else:
        params = db.read_params_from_db(spec, task_id, cur,
                                        window_type=window_type)[:, 0]
        loss = np.nan
    chaos.maybe_fail("shard_write")
    fdata = _window_forecast_data(spec, data, task_id, window_type,
                                  in_sample_end, in_sample_start,
                                  forecast_horizon)
    results = api.predict(spec, np.asarray(params, dtype=np.float64), fdata,
                          device=dev)
    path = db.save_oos_forecast_sharded(base, spec.model_string, thread_id,
                                        window_type, task_id, results, loss,
                                        params, forecast_horizon=forecast_horizon)
    if ckpt is not None:
        ckpt.clear()  # shard durable; a crash before this just replays fast
    return path


def merge_and_export(spec: ModelSpec, thread_id: str, tasks, window_type: str):
    """Shared final stage: fold shards into the merged DB, export CSVs.  The
    merge is idempotent until its final publish, so a killed merger's
    successor just re-runs it (the ``merge`` chaos seam)."""
    chaos.maybe_fail("merge")
    base = _forecast_db_base(spec, window_type)
    result = db.merge_forecast_shards(base, task_ids=list(tasks),
                                      delete_shards=True)
    db.export_all_csv(spec, thread_id, list(tasks), window_type=window_type)
    return result


def run_rolling_forecasts(
    spec: ModelSpec,
    data,
    thread_id: str,
    in_sample_end: int,
    in_sample_start: int,
    forecast_horizon: int,
    init_params,
    window_type: str = "both",
    param_groups: Sequence[str] = (),
    max_group_iters: int = 10,
    group_tol: float = 1e-8,
    reestimate: bool = True,
    batched: bool = False,
    stale_lock_ttl: float | None = None,
    second_order=None,
    device=None,
) -> None:
    window_fn = run_forecast_window_batched if batched else run_forecast_window_database
    kw = dict(
        param_groups=param_groups, max_group_iters=max_group_iters,
        group_tol=group_tol, reestimate=reestimate, stale_lock_ttl=stale_lock_ttl,
        second_order=second_order, device=device,
    )
    if window_type == "both":
        window_fn(spec, data, thread_id, in_sample_end, in_sample_start,
                  forecast_horizon, "expanding", init_params, **kw)
        window_fn(spec, data, thread_id, in_sample_end, in_sample_start,
                  forecast_horizon, "moving", init_params, **kw)
    elif window_type in ("expanding", "moving"):
        window_fn(spec, data, thread_id, in_sample_end, in_sample_start,
                  forecast_horizon, window_type, init_params, **kw)
    elif window_type in ("no_windowing", "simulation"):
        run_forecast_no_window_database(
            spec, data, thread_id, in_sample_end, in_sample_start,
            forecast_horizon, window_type, init_params, **kw)
    else:
        raise ValueError("Invalid window type")


def _window_lo(task_id: int, window_type: str, in_sample_end: int,
               in_sample_start: int) -> int:
    """First data column of the window (0-based): 0 for expanding; for
    moving, span−1 with span = task_id − (in_sample_end − in_sample_start)."""
    if window_type == "expanding":
        return 0
    if window_type == "moving":
        span = task_id - (in_sample_end - in_sample_start)
        if span < 1:  # the reference's 1-based precondition (in_sample_start >= 1)
            raise ValueError(
                f"moving window span={span} < 1; in_sample_start is 1-based "
                f"(got in_sample_start={in_sample_start}, in_sample_end={in_sample_end})")
        return span - 1
    raise ValueError("Invalid window type")


def _window_forecast_data(spec: ModelSpec, data, task_id: int, window_type: str,
                          in_sample_end: int, in_sample_start: int,
                          forecast_horizon: int):
    N = data.shape[0]
    pad = np.full((N, forecast_horizon - 1), np.nan)
    lo = _window_lo(task_id, window_type, in_sample_end, in_sample_start)
    return np.concatenate([data[:, lo:task_id], pad], axis=1)


def _batched_window_predicts(spec: ModelSpec, data, task_ids, window_type: str,
                             in_sample_end: int, in_sample_start: int,
                             forecast_horizon: int, params_batch, device=None):
    """Per-origin ``predict`` artifact dicts (numpy), each on ONE shared
    NaN-padded panel whose columns outside the window's [lo, hi) are masked
    to NaN (transition-only steps), as the JAX package's vmapped predict
    does; sliced to end at column task_id+h−2, so that
    ``save_oos_forecast_sharded``'s last-h-columns convention picks the
    columns of the per-task truncated call."""
    N, T = data.shape
    h = forecast_horizon
    data_ext = np.concatenate([np.asarray(data, dtype=np.float64),
                               np.full((N, h - 1), np.nan)], axis=1)
    data_t = config.as_tensor(data_ext, device, spec.dtype)
    t_idx = torch.arange(data_t.shape[1], device=data_t.device)
    out = []
    for params, tid in zip(params_batch, task_ids):
        lo = _window_lo(int(tid), window_type, in_sample_end, in_sample_start)
        inside = (t_idx >= lo) & (t_idx < int(tid))
        masked = torch.where(inside[None, :], data_t, torch.full_like(data_t, np.nan))
        res = api.predict(spec, np.asarray(params, dtype=np.float64), masked,
                          device=data_t.device)
        out.append({k: _np(v)[:, : int(tid) + h - 1] for k, v in res.items()})
    return out


def _acquire_or_break(lockroot: str, window_type: str, task_id: int,
                      ttl: float | None):
    """Task lock acquire with dead-worker recovery: a held lock whose mtime
    is older than ``ttl`` is broken and re-acquired atomically.  With
    ``ttl=None`` a held lock is trusted."""
    lockdir = acquire_task_lock(lockroot, window_type, task_id)
    if lockdir is not None or ttl is None:
        return lockdir
    if break_stale_lock(task_lock_path(lockroot, window_type, task_id), ttl):
        return acquire_task_lock(lockroot, window_type, task_id)
    return None


def run_forecast_window_database(
    spec: ModelSpec, data, thread_id: str, in_sample_end: int, in_sample_start: int,
    forecast_horizon: int, window_type: str, init_params,
    param_groups=(), max_group_iters: int = 10, group_tol: float = 1e-8,
    reestimate: bool = True, printing: bool = True,
    stale_lock_ttl: float | None = None,
    checkpoint_root: str | None = None,
    second_order=None, device=None,
) -> None:
    dev = config.resolve_device(device)
    data = np.asarray(data, dtype=np.float64)
    T = data.shape[1]
    tasks = list(range(in_sample_end, T + 1))
    rng = np.random.default_rng(secrets.randbits(63))  # the reference's RandomDevice shuffle
    rng.shuffle(tasks)

    base = _forecast_db_base(spec, window_type)
    merged = _merged_path(spec, window_type)
    lockroot = _lockroot(spec)
    ttl = _lock_ttl(stale_lock_ttl)
    if stale_lock_ttl is not None:
        sweep_stale_locks(lockroot, ttl_seconds=stale_lock_ttl)

    if os.path.isfile(merged):
        forecast_csv = db._legacy_path(
            spec.results_location, spec.model_string, thread_id, window_type, "forecasts")
        if os.path.isfile(forecast_csv):
            return
        lockdir = acquire_task_lock(lockroot, window_type, 0)
        if lockdir is None:
            return
        try:
            db.export_all_csv(spec, thread_id, tasks, window_type=window_type)
        finally:
            release_task_lock(lockdir)
        return

    all_params = _as_columns(init_params)
    timer = StageTimer()
    for task_id in tasks:
        if os.path.isfile(db.forecast_path(base, task_id)):
            continue
        lockdir = _acquire_or_break(lockroot, window_type, task_id, ttl)
        if lockdir is None:
            continue
        try:
            run_single_window_task(
                spec, data, thread_id, task_id, window_type, in_sample_end,
                in_sample_start, forecast_horizon, all_params,
                param_groups=param_groups, max_group_iters=max_group_iters,
                group_tol=group_tol, reestimate=reestimate, timer=timer,
                checkpoint_root=checkpoint_root, second_order=second_order,
                device=dev)
            if printing and timer.counts["estimation"]:
                print(f"Thread {thread_id}: {timer.counts['estimation']} estimations, "
                      f"avg {timer.mean('estimation'):.2f}s/task")
        finally:
            release_task_lock(lockdir)

    if all(os.path.isfile(db.forecast_path(base, t)) for t in tasks):
        lockdir = _acquire_or_break(lockroot, window_type, 0, ttl)
        if lockdir is None:
            return
        try:
            merge_and_export(spec, thread_id, tasks, window_type)
        finally:
            release_task_lock(lockdir)


def run_forecast_window_batched(
    spec: ModelSpec, data, thread_id: str, in_sample_end: int, in_sample_start: int,
    forecast_horizon: int, window_type: str, init_params,
    param_groups=(), max_group_iters: int = 10, group_tol: float = 1e-8,
    reestimate: bool = True, printing: bool = True,
    stale_lock_ttl: float | None = None,
    second_order=None, device=None,
) -> None:
    """All missing origins re-estimated in ONE (windows × starts) batched
    L-BFGS on the full parameter vector (``estimate_windows``, the batched
    analogue of the reference's estimate!), then written through the same
    shard/merge/export pipeline; the block-coordinate path is
    ``run_forecast_window_database``."""
    dev = config.resolve_device(device)
    data = np.asarray(data, dtype=np.float64)
    T = data.shape[1]
    tasks = list(range(in_sample_end, T + 1))
    base = _forecast_db_base(spec, window_type)
    merged = _merged_path(spec, window_type)
    lockroot = _lockroot(spec)
    if stale_lock_ttl is not None:
        sweep_stale_locks(lockroot, ttl_seconds=stale_lock_ttl)
    if os.path.isfile(merged):
        return run_forecast_window_database(
            spec, data, thread_id, in_sample_end, in_sample_start,
            forecast_horizon, window_type, init_params,
            param_groups=param_groups, reestimate=reestimate, printing=printing,
            device=dev)

    all_params = _as_columns(init_params)
    todo = [t for t in tasks if not os.path.isfile(db.forecast_path(base, t))]
    ttl = _lock_ttl(stale_lock_ttl)
    locks = {}
    claimed = []
    for t in todo:
        ld = _acquire_or_break(lockroot, window_type, t, ttl)
        if ld is not None:
            locks[t] = ld
            claimed.append(t)
    try:
        if claimed and reestimate:
            raw0 = untransform_params(spec, torch.as_tensor(all_params.T)).numpy()  # (S, P)
            raw0[~np.isfinite(raw0)] = 0.0
            w_ends = np.asarray(claimed)
            w_starts = np.zeros_like(w_ends)  # estimation quirk: expanding sample
            xs, lls = opt.estimate_windows(spec, data, raw0, w_starts, w_ends,
                                           second_order=second_order, device=dev)
            best = np.nanargmax(np.where(np.isfinite(lls), lls, -np.inf), axis=1)
        if claimed:
            params_rows, losses = [], []
            for i, task_id in enumerate(claimed):
                if reestimate:
                    raw_best = torch.as_tensor(xs[i, best[i]], dtype=spec.dtype)
                    params = transform_params(spec, raw_best).numpy()
                    loss = float(lls[i, best[i]])
                else:
                    cur = db.read_static_params_from_db(spec, task_id, all_params,
                                                        window_type=window_type)
                    params = db.read_params_from_db(spec, task_id, cur,
                                                    window_type=window_type)[:, 0]
                    loss = np.nan
                params_rows.append(np.asarray(params, dtype=np.float64))
                losses.append(loss)
            results_all = _batched_window_predicts(
                spec, data, claimed, window_type, in_sample_end,
                in_sample_start, forecast_horizon, params_rows, device=dev)
            for i, task_id in enumerate(claimed):
                db.save_oos_forecast_sharded(base, spec.model_string, thread_id,
                                             window_type, task_id,
                                             results_all[i], losses[i],
                                             params_rows[i],
                                             forecast_horizon=forecast_horizon)
    finally:
        for ld in locks.values():
            release_task_lock(ld)

    if all(os.path.isfile(db.forecast_path(base, t)) for t in tasks):
        lockdir = _acquire_or_break(lockroot, window_type, 0, ttl)
        if lockdir is None:
            return
        try:
            merge_and_export(spec, thread_id, tasks, window_type)
        finally:
            release_task_lock(lockdir)


def run_forecast_no_window_database(
    spec: ModelSpec, data, thread_id: str, in_sample_end: int, in_sample_start: int,
    forecast_horizon: int, window_type: str, init_params,
    param_groups=(), max_group_iters: int = 10, group_tol: float = 1e-8,
    reestimate: bool = True, stale_lock_ttl: float | None = None,
    second_order=None, device=None,
) -> None:
    """Estimate once on the in-sample span, forecast every origin, write one
    legacy CSV (the reference's no-window path)."""
    dev = config.resolve_device(device)
    data = np.asarray(data, dtype=np.float64)
    T = data.shape[1]
    loss, params = _estimate_for_window(
        spec, data, in_sample_end, _as_columns(init_params), param_groups,
        max_group_iters, group_tol, second_order=second_order, device=dev)

    tasks = list(range(in_sample_end, T + 1))
    M, L = spec.M, spec.L
    H = forecast_horizon
    all_results = np.zeros((2 + M + L + spec.N, H * len(tasks)))
    results_all = _batched_window_predicts(
        spec, data, tasks, "expanding", in_sample_end, in_sample_start, H,
        [params] * len(tasks), device=dev)
    for k, task_id in enumerate(tasks):
        res = results_all[k]
        cols = slice(k * H, (k + 1) * H)
        all_results[0, cols] = task_id
        all_results[1, cols] = np.arange(1, H + 1) + task_id
        all_results[2:2 + M, cols] = res["factors"][:, -H:]
        all_results[2 + M:2 + M + L, cols] = res["states"][:, -H:]
        all_results[2 + M + L:, cols] = res["preds"][:, -H:]

    order = np.lexsort((all_results[1], all_results[0]))
    all_results = np.round(all_results[:, order], 3)

    res_full = api.predict(spec, np.asarray(params, dtype=np.float64), data, device=dev)
    factors_oos = np.round(np.concatenate([_np(res_full["factors"]),
                                           _np(res_full["states"])], axis=0), 3)

    folder = spec.results_location
    os.makedirs(folder, exist_ok=True)
    ms = spec.model_string
    # the reference hard-codes "expanding" in this filename
    np.savetxt(os.path.join(
        folder, f"{ms}__thread_id__{thread_id}__expanding_window_forecasts.csv"),
        all_results.T, delimiter=",", fmt="%.18g")
    np.savetxt(os.path.join(
        folder, f"{ms}__thread_id__{thread_id}__out_params.csv"),
        np.asarray(params, dtype=np.float64), delimiter=",")
    np.savetxt(os.path.join(
        folder, f"{ms}__thread_id__{thread_id}__factors_filtered_outofsample.csv"),
        factors_oos, delimiter=",", fmt="%.18g")
