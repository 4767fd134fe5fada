"""Filesystem task locks (the reference's forecasting.jl mkdir locks).

Counterpart of ``yieldfactormodels_jl_tpu/persistence/locks.py``: atomic
``mkdir`` task locks plus idempotent shard files are the whole
multi-process protocol, so a killed worker loses only its in-flight task.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Optional


def task_lock_path(lockroot: str, window_type: str, task_id: int) -> str:
    """The one place the lock-dir naming convention lives."""
    return os.path.join(lockroot, window_type, f"task_{task_id}.lock")


def acquire_task_lock(lockroot: str, window_type: str, task_id: int) -> Optional[str]:
    """Atomic mkdir lock; returns the lock dir if acquired, None if held."""
    lockdir = task_lock_path(lockroot, window_type, task_id)
    os.makedirs(os.path.dirname(lockdir), exist_ok=True)
    try:
        os.mkdir(lockdir)
        return lockdir
    except FileExistsError:
        return None


def release_task_lock(lockdir: Optional[str]) -> None:
    """Best-effort removal."""
    if lockdir and os.path.isdir(lockdir):
        shutil.rmtree(lockdir, ignore_errors=True)


def break_stale_lock(lockdir: str, ttl_seconds: float) -> bool:
    """Remove ``lockdir`` when its mtime is older than ``ttl_seconds``;
    True if removed.

    Live holders defend a lock by touching its mtime; ``os.rmdir`` removes
    only an empty dir and is atomic, so two sweepers racing lose nothing and
    the follow-up ``mkdir`` re-acquire stays atomic.  The worst case of an
    aggressive TTL is duplicated work on an idempotent shard."""
    try:
        if os.path.isdir(lockdir) and \
                time.time() - os.path.getmtime(lockdir) > ttl_seconds:
            os.rmdir(lockdir)
            return True
    except OSError:
        pass
    return False
