"""Per-window multi-start estimation checkpoints (preemption resume).

Counterpart of ``yieldfactormodels_jl_tpu/orchestration/checkpoint.py``.
``WindowCheckpoint`` persists a block-coordinate cascade's lockstep state
(start batch, per-start LLs, convergence flags) after every group
iteration, atomically (tmp + ``os.replace``), so a successor worker can
resume the remaining iterations instead of refitting; the saved arrays keep
their native dtype.  A checkpoint is trusted only when its *signature*
(model string, data length, window bounds, grouping, start-batch shape)
matches the live call — a stale or foreign file is ignored, never
half-applied.  The forecast task clears it after its shard is durably
written.  The port's ``estimate_steps`` does not take a checkpoint yet
(ROADMAP.md Queue 1 item 11), so the forecast driver builds one only when
a caller sets ``checkpoint_root``.
"""

from __future__ import annotations

import os
import uuid
from typing import Dict, Optional, Tuple

import numpy as np

#: Process-wide ledger of group iterations actually *executed* per
#: (window_type, task_id).
ITERS_EXECUTED: Dict[Tuple[str, int], int] = {}

_FORMAT_VERSION = 1


class WindowCheckpoint:
    """Atomic npz-backed checkpoint for one (window_type, task_id) cascade."""

    def __init__(self, root: str, window_type: str, task_id: int):
        self.window_type = window_type
        self.task_id = int(task_id)
        self.path = os.path.join(root, window_type,
                                 f"task_{int(task_id)}.ckpt.npz")
        #: group iterations run by THIS process (excludes resumed ones)
        self.executed_iters = 0
        #: group iterations skipped thanks to a predecessor's checkpoint
        self.resumed_iters = 0

    # -- signature ----------------------------------------------------------

    @staticmethod
    def _sig_arrays(signature: dict) -> dict:
        return {f"sig_{k}": np.asarray(str(v))
                for k, v in dict(signature, _v=_FORMAT_VERSION).items()}

    def load(self, signature: dict) -> Optional[dict]:
        """Return the saved state dict, or None if absent/stale/corrupt."""
        if not os.path.isfile(self.path):
            return None
        try:
            with np.load(self.path, allow_pickle=False) as z:
                blob = {k: z[k] for k in z.files}
        except Exception:  # truncated/corrupt file: refit, don't crash
            return None
        want = self._sig_arrays(signature)
        if set(k for k in blob if k.startswith("sig_")) != set(want):
            return None
        if any(str(blob[k]) != str(v) for k, v in want.items()):
            return None
        state = {k: blob[k] for k in blob if not k.startswith("sig_")}
        self.resumed_iters = int(state["next_it"])
        return state

    def save(self, signature: dict, state: dict) -> None:
        """Atomic write: a reader sees the old state or the new, never a
        torn file — writer-unique tmp + ``os.replace``, the same discipline
        as the shard DBs (a stalled worker whose lease was stolen and the
        thief may both checkpoint this window; a shared tmp name would let
        them interleave in one inode)."""
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = f"{self.path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as fh:
            np.savez(fh, **self._sig_arrays(signature),
                     **{k: np.asarray(v) for k, v in state.items()})
        os.replace(tmp, self.path)

    def clear(self) -> None:
        """Remove the checkpoint (task durably finished)."""
        try:
            os.remove(self.path)
        except OSError:
            pass

    # -- call-count ledger --------------------------------------------------

    def record_executed(self) -> None:
        self.executed_iters += 1
        key = (self.window_type, self.task_id)
        ITERS_EXECUTED[key] = ITERS_EXECUTED.get(key, 0) + 1
