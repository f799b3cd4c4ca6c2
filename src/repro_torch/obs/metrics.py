"""Typed metrics registry (the port's copy of ``repro/obs/metrics.py``).

One :class:`MetricsRegistry` per engine owns counters, gauges and
fixed-bucket histograms behind a single lock.  The registry can *share*
its lock with the owning engine (``MetricsRegistry(lock=eng._lock)``), so
``ServeEngine.telemetry()`` is one lock acquisition for everything —
scheduler state, engine counters, pipeline counters and host-tier counters
all land in the same consistent cut.

:meth:`MetricsRegistry.snapshot` returns a deep copy: plain ints, floats
and fresh lists only, so mutating a snapshot never perturbs live metrics.
Pure Python: no torch, safe to call under the engine lock.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any

# Shared bucket edges (seconds).  Log-spaced 100µs..10s: covers a CPU
# decode step at the low end and a watchdog-scale stall at the top.
LATENCY_EDGES_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Bucket edges for DMA sizes (bytes): 4KiB pages up through GiB bursts.
BYTES_EDGES = tuple(float(1 << s) for s in range(12, 31, 2))


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def read(self) -> int:
        return self.value


class Gauge:
    """Last-value gauge that also tracks its high-water mark."""

    __slots__ = ("value", "max")

    def __init__(self) -> None:
        self.value = 0.0
        self.max = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)
        if self.value > self.max:
            self.max = self.value


class Histogram:
    """Fixed-bucket histogram with cumulative-le bucket semantics.

    ``edges`` are upper bounds: an observation lands in the first bucket
    whose edge is >= the value (``bisect_left`` on the sorted edges);
    values above the last edge go to the overflow bucket, so
    ``len(counts) == len(edges) + 1``.
    """

    __slots__ = ("edges", "counts", "count", "sum")

    def __init__(self, edges: tuple[float, ...]) -> None:
        if not edges or list(edges) != sorted(edges):
            raise ValueError(f"histogram edges must be sorted and non-empty: {edges!r}")
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v


class MetricsRegistry:
    """Get-or-create registry of named metrics behind one lock.

    ``lock`` may be any context-manager lock (an engine's ``RLock``); when
    omitted the registry owns a private one.  Metric *creation* and
    *snapshotting* take the lock; per-metric mutation helpers
    (:meth:`inc`, :meth:`observe`, :meth:`gauge_set`) also take it, so
    callers already holding the shared engine lock must use re-entrant
    locks (the engine's ``RLock`` qualifies) or mutate the returned metric
    objects directly inside their own critical sections.
    """

    def __init__(self, lock: Any = None) -> None:
        self._lock = lock if lock is not None else threading.RLock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    @property
    def lock(self) -> Any:
        """The registry's lock — for callers batching direct metric
        mutations into one critical section."""
        return self._lock

    # -- get-or-create ---------------------------------------------------

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str, edges: tuple[float, ...] = LATENCY_EDGES_S) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(edges)
            return h

    # -- convenience mutators (lock-taking) -------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counter(name).inc(n)

    def gauge_set(self, name: str, v: float) -> None:
        with self._lock:
            self.gauge(name).set(v)

    def observe(self, name: str, v: float, edges: tuple[float, ...] = LATENCY_EDGES_S) -> None:
        with self._lock:
            self.histogram(name, edges).observe(v)

    # -- reads -----------------------------------------------------------

    def total(self, prefix: str = "") -> int:
        """Sum of all counters under ``prefix``, in one consistent cut."""
        with self._lock:
            return sum(c.value for k, c in self._counters.items() if k.startswith(prefix))

    def counters(self, prefix: str = "") -> dict[str, int]:
        """Counter values under ``prefix``, prefix stripped, one cut."""
        with self._lock:
            n = len(prefix)
            return {
                k[n:]: c.value for k, c in self._counters.items() if k.startswith(prefix)
            }

    def snapshot(self) -> dict[str, Any]:
        """Deep, point-in-time copy of every metric under one acquisition."""
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {
                    k: {"value": g.value, "max": g.max} for k, g in self._gauges.items()
                },
                "histograms": {
                    k: {
                        "edges": list(h.edges),
                        "counts": list(h.counts),
                        "count": h.count,
                        "sum": h.sum,
                    }
                    for k, h in self._histograms.items()
                },
            }

    def reset(self) -> None:
        """Zero every metric in place (benches reset between reps)."""
        with self._lock:
            for c in self._counters.values():
                c.value = 0
            for g in self._gauges.values():
                g.value = 0.0
                g.max = 0.0
            for h in self._histograms.values():
                h.counts = [0] * (len(h.edges) + 1)
                h.count = 0
                h.sum = 0.0


__all__ = [
    "LATENCY_EDGES_S",
    "BYTES_EDGES",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]
