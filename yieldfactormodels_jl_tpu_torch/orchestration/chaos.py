"""Deterministic fault injection at the forecast driver's seams.

Counterpart of the worker-death seams of ``yieldfactormodels_jl_tpu/
orchestration/chaos.py``.  The forecast driver calls :func:`maybe_fail` at
``shard_write`` (before a task's shard insert) and ``merge`` (before the
shard merge); an armed seam raises :class:`ChaosInjected`, a simulated
worker death whose recovery (idempotent shards, re-merge) a test can then
exercise.  ``estimate`` is the seam of the checkpointed ``estimate_steps``,
which is not ported yet.

Arming is env-gated and off by default:

- ``YFM_CHAOS``: comma-separated ``seam:trigger`` specs.  A trigger is either
  ``@N`` (raise on the N-th hit of that seam) or a probability in (0, 1]
  drawn from a seeded RNG, e.g. ``YFM_CHAOS="shard_write:@3,merge:0.05"``.
- ``YFM_CHAOS_SEED``: seed for probability triggers (default ``0``).

Seam names are checked against :data:`KNOWN_SEAMS` when armed: a typo'd seam
would arm nothing and never fire.  Tests arm programmatically via
:func:`configure` / :func:`reset` (reset also re-reads the environment on
the next hit).
"""

from __future__ import annotations

import os
import random
import threading
from typing import Dict, Optional, Tuple


class ChaosInjected(RuntimeError):
    """Simulated worker death injected at a seam."""


#: every seam the forecast code calls into
KNOWN_SEAMS = frozenset({"estimate", "shard_write", "merge"})


class _Config:
    def __init__(self, spec: str, seed: int):
        #: seam -> ("count", N) | ("prob", p)
        self.arms: Dict[str, Tuple[str, float]] = {}
        for tok in filter(None, (t.strip() for t in spec.split(","))):
            seam, _, trig = tok.partition(":")
            if not trig:
                raise ValueError(f"YFM_CHAOS entry {tok!r} lacks a trigger "
                                 f"(want 'seam:@N' or 'seam:prob')")
            if seam not in KNOWN_SEAMS:
                raise ValueError(
                    f"YFM_CHAOS entry {tok!r} names unknown seam {seam!r} "
                    f"(want one of: {', '.join(sorted(KNOWN_SEAMS))})")
            if trig.startswith("@"):
                self.arms[seam] = ("count", int(trig[1:]))
            else:
                p = float(trig)
                if not 0.0 < p <= 1.0:
                    raise ValueError(f"YFM_CHAOS probability {p} not in (0, 1]")
                self.arms[seam] = ("prob", p)
        self.rng = random.Random(seed)


_lock = threading.Lock()
_config: Optional[_Config] = None
_env_checked = False
_hits: Dict[str, int] = {}
_fired: Dict[str, int] = {}


def configure(spec: Optional[str], seed: int = 0) -> None:
    """Arm chaos programmatically (``spec`` as in ``YFM_CHAOS``; ``None``
    disarms) and reset the hit/fired counters."""
    global _config, _env_checked
    with _lock:
        _config = _Config(spec, seed) if spec else None
        _env_checked = True  # programmatic config overrides the environment
        _hits.clear()
        _fired.clear()


def reset() -> None:
    """Disarm and forget counters; the environment is re-read on next hit."""
    global _config, _env_checked
    with _lock:
        _config = None
        _env_checked = False
        _hits.clear()
        _fired.clear()


def hits(seam: str) -> int:
    """How many times ``seam`` was reached since the last configure/reset."""
    with _lock:
        return _hits.get(seam, 0)


def fired(seam: str) -> int:
    """How many times ``seam`` fired since the last configure/reset."""
    with _lock:
        return _fired.get(seam, 0)


def _fires(seam: str) -> bool:
    """Count the hit and decide whether the armed seam fires (deterministic
    for ``@N``, a seeded draw for probability triggers)."""
    global _config, _env_checked
    with _lock:
        if not _env_checked:
            spec = os.environ.get("YFM_CHAOS", "")
            seed = int(os.environ.get("YFM_CHAOS_SEED", "0"))
            _config = _Config(spec, seed) if spec else None
            _env_checked = True
        _hits[seam] = _hits.get(seam, 0) + 1
        if _config is None:
            return False
        arm = _config.arms.get(seam)
        if arm is None:
            return False
        kind, val = arm
        decision = (_hits[seam] == val) if kind == "count" \
            else (_config.rng.random() < val)
        if decision:
            _fired[seam] = _fired.get(seam, 0) + 1
        return decision


def maybe_fail(seam: str) -> None:
    """Raise :class:`ChaosInjected` if ``seam`` is armed and triggers; a dict
    lookup when chaos is disarmed."""
    if _fires(seam):
        raise ChaosInjected(f"chaos: injected fault at seam {seam!r} "
                            f"(hit {hits(seam)})")
