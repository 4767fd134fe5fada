"""Multi-host coordination: the stale-lock sweep.

Counterpart of ``sweep_stale_locks`` in ``yieldfactormodels_jl_tpu/
parallel/multihost.py``.  Across independent jobs the port keeps the
reference's crash-only protocol (mkdir locks + idempotent shard files), and
this sweep removes the lock dirs a killed worker left behind, which would
otherwise starve their tasks forever; the forecast drivers run it at entry
when ``stale_lock_ttl`` is set.  Process-group set-up and host task slicing
wait for ROADMAP.md Queue 1 item 11.
"""

from __future__ import annotations

import os
from typing import List

from ..persistence.locks import break_stale_lock


def sweep_stale_locks(lockroot: str, ttl_seconds: float = 3600.0) -> List[str]:
    """Remove lock dirs older than ``ttl_seconds``; returns their paths."""
    removed = []
    if not os.path.isdir(lockroot):
        return removed
    for window in os.listdir(lockroot):
        wdir = os.path.join(lockroot, window)
        if not os.path.isdir(wdir):
            continue
        for name in os.listdir(wdir):
            if not name.endswith(".lock"):
                continue
            path = os.path.join(wdir, name)
            if break_stale_lock(path, ttl_seconds):
                removed.append(path)
    return removed
