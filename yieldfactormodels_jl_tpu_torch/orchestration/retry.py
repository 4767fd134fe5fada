"""The retry policy's sentinel failure and backoff parameters.

Counterpart of ``SentinelFailure`` and ``RetryPolicy`` in
``yieldfactormodels_jl_tpu/orchestration/retry.py``: failures stay silent
inside the numerics (losses go to −Inf) and become a retriable task failure
at the task boundary.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from ..robustness import taxonomy


class SentinelFailure(RuntimeError):
    """A sentinel value (−Inf loss / NaN moments) surfaced at the task
    boundary.  Carries the ``seam`` it surfaced at and the taxonomy ``code``
    diagnosing why the sentinel fired."""

    def __init__(self, message: str, seam: Optional[str] = None,
                 code: int = 0):
        self.seam = seam
        self.code = int(code)
        detail = message
        if seam:
            detail += f" [seam={seam}]"
        if self.code:
            detail += f" [cause={taxonomy.describe(self.code)}]"
        super().__init__(detail)


class RetryPolicy(NamedTuple):
    """Bounded exponential backoff with multiplicative jitter: the delay
    before attempt ``k`` (1-based) is ``min(max_delay, base_delay *
    factor**(k-1)) * (1 + U(0, jitter))``."""
    max_attempts: int = 3
    base_delay: float = 0.5
    factor: float = 2.0
    max_delay: float = 30.0
    jitter: float = 0.5
