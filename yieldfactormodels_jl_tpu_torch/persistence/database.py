"""SQLite shard persistence for out-of-sample forecasts.

Counterpart of ``yieldfactormodels_jl_tpu/persistence/database.py``, with
the same schema, blob bytes and legacy CSV layout: one SQLite file per
(window, task) shard with a ``forecasts`` table keyed (model, thread,
window, task_id) holding loss, params and the five result blobs; WAL mode,
busy_timeout, IMMEDIATE transactions; shards merge into
``forecasts_<window>_merged.sqlite3``.  Values are rounded to 3 decimals
before saving.  Blobs are ``numpy .npy`` bytes of float64 arrays.
"""

from __future__ import annotations

import io as _io
import os
import sqlite3
import threading
import uuid
from typing import Dict, Optional, Sequence

import numpy as np

from ..models.api import get_static_model_type
from ..models.params import initialize_with_static_params
from .io import _np

_DB_INIT_LOCK = threading.Lock()
_DB_INIT_LOCKS: Dict[str, threading.Lock] = {}

SCHEMA = """
    CREATE TABLE IF NOT EXISTS forecasts(
        model  TEXT NOT NULL,
        thread TEXT NOT NULL,
        window TEXT NOT NULL,
        task_id INTEGER NOT NULL,
        loss   REAL,
        params BLOB NOT NULL,
        preds  BLOB NOT NULL,
        fl1    BLOB NOT NULL,
        fl2    BLOB NOT NULL,
        factors BLOB NOT NULL,
        states  BLOB NOT NULL,
        PRIMARY KEY(model,thread,window,task_id)
    );
"""


def ser(arr) -> bytes:
    buf = _io.BytesIO()
    np.save(buf, _np(arr))
    return buf.getvalue()


def deser(blob: bytes) -> np.ndarray:
    return np.load(_io.BytesIO(blob))


def forecast_path(base: str, k: int) -> str:
    """Shard path for task k (k=0 → base)."""
    return base if k == 0 else base.replace(".sqlite3", f"_{k}.sqlite3")


def open_wal_db(path: str, timeout: float = 10.0) -> sqlite3.Connection:
    """The one concurrent-SQLite open discipline (shards, merged DBs, the
    orchestration queue journal): busy_timeout, WAL with a DELETE fallback
    for filesystems that refuse it, synchronous=NORMAL."""
    db = sqlite3.connect(path, timeout=timeout)
    db.execute("PRAGMA busy_timeout=10000;")
    mode = db.execute("PRAGMA journal_mode=WAL;").fetchone()[0]
    if str(mode).lower() != "wal":
        db.execute("PRAGMA journal_mode=DELETE;")
    db.execute("PRAGMA synchronous=NORMAL;")
    return db


def init_forecast_db(path: str) -> sqlite3.Connection:
    """WAL + busy_timeout + schema, one initializer per path at a time."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _DB_INIT_LOCK:
        lock = _DB_INIT_LOCKS.setdefault(path, threading.Lock())
    with lock:
        db = open_wal_db(path)
        db.execute("PRAGMA temp_store=MEMORY;")
        db.execute(SCHEMA)
        db.commit()
        return db


def save_oos_forecast_sharded(
    base: str,
    model_string: str,
    thread: str,
    window: str,
    task_id: int,
    results: dict,
    loss: float,
    params,
    forecast_horizon: int,
) -> str:
    """Round, slice the last ``forecast_horizon`` columns, INSERT OR REPLACE in
    an IMMEDIATE transaction."""
    h = forecast_horizon
    rounded = {k: np.round(_np(v), 3) for k, v in results.items()}
    p = rounded["preds"][:, -h:]
    f = rounded["factors"][:, -h:]
    s = rounded["states"][:, -h:]
    fl1 = rounded["factor_loadings_1"][:, -h:]
    fl2 = rounded["factor_loadings_2"][:, -h:]

    # build the shard in a writer-unique temp file and publish it with one
    # atomic rename: ``os.path.isfile(shard)`` then IMPLIES a fully committed
    # shard, so concurrent mergers never observe a created-but-uncommitted DB
    # (an empty file with no ``forecasts`` table yet) and misread it as
    # corrupt; the unique suffix keeps a stalled writer and the thief that
    # stole its lease from interleaving in one temp file (last publish wins —
    # both hold identical rows)
    path = forecast_path(base, task_id)
    tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    db = init_forecast_db(tmp)
    try:
        db.execute("BEGIN IMMEDIATE;")
        db.execute(
            "INSERT OR REPLACE INTO forecasts("
            "model,thread,window,task_id,loss,params,preds,fl1,fl2,factors,states"
            ") VALUES(?,?,?,?,?,?,?,?,?,?,?)",
            (
                model_string, thread, window, int(task_id),
                float(loss) if np.isfinite(loss) else None,
                ser(params), ser(p), ser(fl1), ser(fl2), ser(f), ser(s),
            ),
        )
        db.commit()
    except Exception:
        db.rollback()
        db.close()
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    db.close()  # checkpoints + removes the -wal sidecar before the rename
    os.replace(tmp, path)
    with _DB_INIT_LOCK:  # tmp paths are single-use; don't accumulate locks
        _DB_INIT_LOCKS.pop(tmp, None)
    return path


class MergeResult(str):
    """The merged-DB path (still a plain ``str`` for every existing caller),
    carrying the merge summary: ``.merged`` (task ids folded in) and
    ``.skipped`` (``[(task_id, reason), ...]`` for corrupt/missing shards)."""

    merged: list
    skipped: list

    def __new__(cls, path: str, merged, skipped):
        self = super().__new__(cls, path)
        self.merged = list(merged)
        self.skipped = list(skipped)
        return self


def _shard_rows(shard: str, task_id: int):
    """All of one shard's rows for ``task_id``; raises sqlite3.DatabaseError
    on a truncated/corrupt file (detected on read, not just on connect).
    Opened read-only via URI so a reader NEVER creates a file at the shard
    path — a plain connect materializes an empty DB for a path that just
    went missing, which a later reader would misread as a corrupt shard."""
    from urllib.request import pathname2url

    new = sqlite3.connect(f"file:{pathname2url(os.path.abspath(shard))}"
                          "?mode=ro", uri=True, timeout=10.0)
    try:
        return new.execute(
            "SELECT model,thread,window,task_id,loss,params,preds,fl1,fl2,factors,states "
            "FROM forecasts WHERE task_id = ?", (int(task_id),)
        ).fetchall()
    finally:
        new.close()


def merge_forecast_shards(
    base: str,
    task_ids: Sequence[int],
    out: Optional[str] = None,
    delete_shards: bool = False,
) -> MergeResult:
    """Fold shards into the merged DB.

    Hardened for crash-tolerant fleets, where the same merge may run twice
    (a stalled merger's lease can be stolen while it is still alive):

    - The merged DB is BUILT in a merger-unique temp file from read-only
      shard opens, and PUBLISHED at most once: ``os.link`` to the final
      path fails if a concurrent merger already published, so a slow loser
      can never overwrite a complete merged DB with a partial one.  Shards
      are deleted only after a successful publish (or when the merged DB
      already exists — post-crash cleanup), so concurrent readers always
      find every row somewhere.
    - A truncated/corrupt shard (a worker killed mid-write on a non-WAL
      filesystem) is SKIPPED with a warning and recorded in the returned
      :class:`MergeResult` summary instead of aborting the whole merge —
      and corrupt shards are never deleted, so the data stays on disk for
      repair.
    """
    import sys as _sys

    if out is None:
        out = base.replace(".sqlite3", "_merged.sqlite3")
    task_ids = list(task_ids)
    skipped: list = []
    merged: list = []

    tmp = f"{out}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    dst = init_forecast_db(tmp)
    try:
        dst.execute("BEGIN IMMEDIATE;")
        for task_id in task_ids:
            shard = forecast_path(base, task_id)
            if not os.path.isfile(shard):
                skipped.append((task_id, "missing shard"))
                continue
            try:
                rows = _shard_rows(shard, task_id)
            except sqlite3.DatabaseError as e:
                skipped.append((task_id, f"corrupt shard: {e}"))
                _sys.stderr.write(f"# merge: skipping corrupt shard for task "
                                  f"{task_id} ({e}); file kept for repair\n")
                continue
            for row in rows:
                dst.execute(
                    "INSERT OR REPLACE INTO forecasts("
                    "model,thread,window,task_id,loss,params,preds,fl1,fl2,factors,states"
                    ") VALUES(?,?,?,?,?,?,?,?,?,?,?)", row
                )
            merged.append(task_id)
        dst.commit()
    except BaseException:
        dst.close()
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    dst.close()
    with _DB_INIT_LOCK:
        _DB_INIT_LOCKS.pop(tmp, None)

    if not merged and not os.path.isfile(out):
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise RuntimeError(
            f"merge_forecast_shards: no healthy shard among {len(task_ids)} "
            f"tasks of {base} — skipped: {skipped}")
    try:
        os.link(tmp, out)  # at-most-once publish: first merger wins
    except FileExistsError:
        # a concurrent/previous merger already published a complete merged
        # DB; ours (possibly partial — it may have read shards after the
        # winner deleted them) is discarded
        merged = []
    except OSError:
        os.replace(tmp, out)  # no-hardlink filesystem: atomic, last-wins
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass
    if delete_shards:
        corrupt = {t for t, why in skipped if "corrupt" in why}
        for task_id in task_ids:
            shard = forecast_path(base, task_id)
            if task_id not in corrupt and os.path.isfile(shard):
                for side in ("", "-wal", "-shm"):  # WAL sidecars too
                    try:
                        os.remove(shard + side)
                    except OSError:
                        pass
    if skipped and merged:
        _sys.stderr.write(f"# merge: {len(merged)} shards merged into {out}, "
                          f"{len(skipped)} skipped: {skipped}\n")
    return MergeResult(out, merged, skipped)


# ---------------------------------------------------------------------------
# warm-start / parameter-reuse reads
# ---------------------------------------------------------------------------

def _merged_db_path(results_folder: str, model_name: str, window_type: str) -> str:
    # results_folder is ".../results/thread_id__X/<model>/"; the sibling model's
    # DB lives at ".../results/thread_id__X/<model_name>/db/"
    results_dir = os.path.dirname(results_folder.rstrip("/"))
    return os.path.join(results_dir, model_name, "db", f"forecasts_{window_type}_merged.sqlite3")


def read_all_task_params(db_path: str) -> Dict[int, np.ndarray]:
    """Every task's fitted params from a merged DB in one query and one
    deserialization pass.  Returns {task_id: flat float64 params}; {} when
    the DB is absent."""
    if not os.path.isfile(db_path):
        return {}
    db = sqlite3.connect(db_path, timeout=10.0)
    try:
        rows = db.execute("SELECT task_id, params FROM forecasts").fetchall()
    finally:
        db.close()
    return {int(task_id): deser(blob).reshape(-1) for task_id, blob in rows}


def read_task_params(db_path: str, task_id: int) -> Optional[np.ndarray]:
    if not os.path.isfile(db_path):
        return None
    db = sqlite3.connect(db_path, timeout=10.0)
    try:
        row = db.execute(
            "SELECT params FROM forecasts WHERE task_id = ?", (int(task_id),)
        ).fetchone()
    finally:
        db.close()
    if row is None:
        return None
    return deser(row[0]).reshape(-1)


def read_static_params_from_db(spec, task_id: int, all_params: np.ndarray,
                               window_type: str = "expanding") -> np.ndarray:
    """Warm-start MSED params from the simpler static model's merged DB for the
    same task."""
    if not spec.is_msed:
        return all_params
    static_name = get_static_model_type(spec)
    db_path = _merged_db_path(spec.results_location, static_name, window_type)
    static_params = read_task_params(db_path, task_id)
    if static_params is None:
        return all_params
    all_params = np.asarray(all_params, dtype=np.float64).copy()
    all_params[:, 0] = initialize_with_static_params(spec, all_params[:, 0], static_params)
    return all_params


def read_params_from_db(spec, task_id: int, all_params: np.ndarray,
                        window_type: str = "expanding") -> np.ndarray:
    """Reuse this model's own past fitted params when reestimate=false."""
    db_path = _merged_db_path(spec.results_location, spec.model_string, window_type)
    params = read_task_params(db_path, task_id)
    if params is None:
        return all_params
    all_params = np.asarray(all_params, dtype=np.float64).copy()
    all_params[:, 0] = params
    return all_params


# ---------------------------------------------------------------------------
# legacy CSV export
# ---------------------------------------------------------------------------

def _legacy_path(results_folder, model_string, thread_id, window_type, kind):
    return os.path.join(
        results_folder,
        f"{model_string}__thread_id__{thread_id}__{window_type}_window_{kind}.csv",
    )


def _write_csv(path: str, rows: np.ndarray) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # torn-file-proof publish; pid+tid: worker threads share a pid
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    np.savetxt(tmp, rows, delimiter=",", fmt="%.18g")
    os.replace(tmp, path)
    return path


def _export_wide(db_path, results_folder, model_string, thread_id, tasks,
                 window_type, column, kind):
    """(origin, target, values...) long format, sorted by target then origin."""
    rows = []
    db = sqlite3.connect(db_path, timeout=10.0)
    try:
        for task_id in tasks:
            row = db.execute(
                f"SELECT task_id, {column} FROM forecasts WHERE task_id = ?",
                (int(task_id),),
            ).fetchone()
            if row is None:
                continue
            P = deser(row[1])
            K, H = P.shape
            for h in range(H):
                rows.append([float(task_id), float(task_id + h + 1)] + list(P[:, h]))
    finally:
        db.close()
    arr = np.asarray(rows, dtype=np.float64)
    if arr.size:
        arr = arr[np.lexsort((arr[:, 1],))]
        arr = arr[np.lexsort((arr[:, 0],))]
    return _write_csv(_legacy_path(results_folder, model_string, thread_id, window_type, kind), arr)


def _export_params(db_path, results_folder, model_string, thread_id, tasks, window_type):
    rows = []
    db = sqlite3.connect(db_path, timeout=10.0)
    try:
        for task_id in tasks:
            row = db.execute(
                "SELECT task_id, params FROM forecasts WHERE task_id = ?", (int(task_id),)
            ).fetchone()
            if row is None:
                continue
            p = deser(row[1]).reshape(-1)
            rows.append([float(task_id)] + list(p))
    finally:
        db.close()
    arr = np.asarray(rows, dtype=np.float64)
    if arr.size:
        arr = arr[np.argsort(arr[:, 0], kind="stable")]
    return _write_csv(
        _legacy_path(results_folder, model_string, thread_id, window_type, "fitted_params"), arr
    )


def export_all_csv(spec, thread_id: str, tasks: Sequence[int],
                   window_type: str = "expanding") -> dict:
    """forecasts / fitted_params / fl1 / fl2 / factors / states CSVs in the
    reference's legacy layout."""
    folder = spec.results_location
    db_path = os.path.join(folder, "db", f"forecasts_{window_type}_merged.sqlite3")
    ms = spec.model_string
    return {
        "forecasts": _export_wide(db_path, folder, ms, thread_id, tasks, window_type, "preds", "forecasts"),
        "fitted_params": _export_params(db_path, folder, ms, thread_id, tasks, window_type),
        "fl1": _export_wide(db_path, folder, ms, thread_id, tasks, window_type, "fl1", "fl1"),
        "fl2": _export_wide(db_path, folder, ms, thread_id, tasks, window_type, "fl2", "fl2"),
        "factors": _export_wide(db_path, folder, ms, thread_id, tasks, window_type, "factors", "factors"),
        "states": _export_wide(db_path, folder, ms, thread_id, tasks, window_type, "states", "states"),
    }
