"""Structured logging, per-stage timing, and counters.

The reference has print-only observability (config.py:82-99, oldapp.py:1979);
here metrics are first-class because the BASELINE targets (images/sec,
query p50/p99) must be measurable in production.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"
_setup_lock = __import__("threading").Lock()


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"evossearch.{name}")
    # locked check-then-add: two request threads racing the first call
    # would otherwise both install handlers and double every log line
    with _setup_lock:
        if not logging.getLogger("evossearch").handlers:
            root = logging.getLogger("evossearch")
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(_FORMAT))
            root.addHandler(handler)
            root.setLevel(logging.INFO)
            root.propagate = False
    return logger


class StageTimer:
    """Accumulates wall-clock per named stage; thread-safe.

    Used to break request latency into decode/encode/search/thumbnail stages
    (SURVEY.md §5 tracing plan). Besides totals/means, each stage keeps a
    bounded reservoir of recent samples so the BASELINE latency metrics
    (query p50/p99) are readable from ``/stats`` — a sliding window rather
    than a classic uniform reservoir, because serving percentiles should
    reflect current behavior, not the cold-start compile spikes forever.
    """

    WINDOW = 512  # samples kept per stage; p99 resolves above ~100 samples

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._samples: dict[str, deque[float]] = defaultdict(
            lambda: deque(maxlen=self.WINDOW)
        )

    @contextmanager
    def stage(self, name: str):
        # While EVOSSEARCH_PROFILE_DIR is set, every timed stage doubles
        # as a torch.profiler record_function span so decode/prepare/encode/search
        # regions line up on the captured timeline; zero overhead when
        # profiling is off (one env lookup).
        from . import profiling

        t0 = time.perf_counter()
        try:
            if profiling.enabled():
                with profiling.annotate(name):
                    yield
            else:
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1
                self._samples[name].append(dt)

    def snapshot(self) -> dict[str, dict[str, float]]:
        with self._lock:
            out = {}
            for name in self.totals:
                entry = {
                    "total_s": self.totals[name],
                    "count": self.counts[name],
                    "mean_ms": 1e3 * self.totals[name] / max(1, self.counts[name]),
                }
                window = sorted(self._samples[name])
                if window:
                    entry["p50_ms"] = 1e3 * _percentile(window, 0.50)
                    entry["p99_ms"] = 1e3 * _percentile(window, 0.99)
                    entry["window"] = len(window)
                out[name] = entry
            return out


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated percentile of an already-sorted list."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


class Counters:
    """Monotonic named counters (images indexed, queries served, ...)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: dict[str, float] = defaultdict(float)

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._values[name] += value

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._values)
