"""Stage timing.

Counterpart of ``StageTimer`` in ``yieldfactormodels_jl_tpu/utils/
profiling.py``: the reference's only timing signal is ``@elapsed`` around
per-window re-estimation with a printed running mean; here that is a
reusable wall-clock timer by named stage.  The timer reads the host clock:
a stage that ends in CUDA work must synchronize before it closes to count
that work.
"""

from __future__ import annotations

import contextlib
import json
import math
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List


def _nearest_rank(sorted_samples: List[float], q: float) -> float:
    """Nearest-rank percentile (no interpolation): the ⌈q·n⌉-th smallest."""
    n = len(sorted_samples)
    return sorted_samples[min(n - 1, max(0, math.ceil(q * n) - 1))]


class StageTimer:
    """Accumulates wall-clock per named stage; prints reference-style running
    means.  Durations are also kept in ``samples`` (a bounded sliding window
    of the most recent ``max_samples`` per stage) so ``summary()`` can
    report percentiles; ``totals``/``counts``/``mean`` stay exact over the
    full history."""

    def __init__(self, max_samples: int = 65536):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.maxima: Dict[str, float] = defaultdict(float)
        self.samples: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=max_samples))

    def record(self, name: str, seconds: float) -> None:
        """Record one duration directly (what ``stage`` does on exit)."""
        self.totals[name] += seconds
        self.counts[name] += 1
        self.maxima[name] = max(self.maxima[name], seconds)
        self.samples[name].append(seconds)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def mean(self, name: str) -> float:
        c = self.counts[name]
        return self.totals[name] / c if c else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-stage dict: count / total / mean / p50 / p99 / max (seconds;
        nearest-rank percentiles over the retained sample window; count /
        total / mean / max over the FULL history — a worst-case spike must
        not age out of the ledger)."""
        out: Dict[str, Dict[str, float]] = {}
        for name in sorted(self.totals):
            s = sorted(self.samples[name])
            out[name] = {
                "count": self.counts[name],
                "total": self.totals[name],
                "mean": self.mean(name),
                "p50": _nearest_rank(s, 0.50) if s else 0.0,
                "p99": _nearest_rank(s, 0.99) if s else 0.0,
                "max": self.maxima[name],
            }
        return out

    def to_json(self, **extra) -> str:
        """``summary()`` as one JSON line; ``extra`` keys are merged at the
        top level (e.g. config labels)."""
        return json.dumps({**extra, "stages": self.summary()}, sort_keys=True)

    def report(self) -> str:
        lines = [f"{name}: {self.totals[name]:.3f}s total, "
                 f"{self.mean(name):.3f}s avg over {self.counts[name]}"
                 for name in sorted(self.totals)]
        return "\n".join(lines)
