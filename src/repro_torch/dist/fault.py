"""Fault tolerance primitives: crash injection + straggler/dead detection,
a plain-Python copy of ``repro/dist/fault.py``.

``FaultInjector`` raises a ``RuntimeError`` at configured steps — exactly
once per step value — so the Trainer's crash→restore→resume loop can be
exercised deterministically.

``StragglerDetector`` keeps per-host step-report timestamps and flags hosts
whose average step time exceeds ``factor ×`` the median across hosts
(stragglers) or that have fallen more than ``timeout`` seconds behind the
freshest report (dead).  Timestamps come from ``clock`` (``time.monotonic``
by default; the port has no injectable clock module yet), or an explicit
``now=`` per call.
"""
from __future__ import annotations

import time
from collections.abc import Callable, Iterable


class FaultInjector:
    """Deterministic crash injection for the training loop."""

    def __init__(self, fail_at: Iterable[int] = (), message: str = "injected fault"):
        self.pending = set(fail_at)
        self.fired: list[int] = []
        self.message = message

    def maybe_fail(self, step: int) -> None:
        """Raise once when ``step`` is scheduled; subsequent passes through
        the same step (post-restore replay) proceed normally."""
        if step in self.pending:
            self.pending.discard(step)
            self.fired.append(step)
            raise RuntimeError(f"{self.message} at step {step}")


class StragglerDetector:
    """Flags slow and dead hosts from per-step progress reports."""

    def __init__(self, n_hosts: int, factor: float = 1.5, timeout: float = 600.0,
                 clock: Callable[[], float] | None = None):
        self.n_hosts = n_hosts
        self.factor = factor
        self.timeout = timeout
        self._clock = time.monotonic if clock is None else clock
        self._first: dict[int, float] = {}
        self._last: dict[int, float] = {}
        self._count: dict[int, int] = {}

    def report(self, host: int, step: int, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        self._first.setdefault(host, now)
        self._last[host] = now
        self._count[host] = self._count.get(host, 0) + 1

    def forget(self, host: int) -> None:
        """Drop a host's report history (a retired host stops dominating the
        dead/straggler queries)."""
        self._first.pop(host, None)
        self._last.pop(host, None)
        self._count.pop(host, None)

    # -- queries ------------------------------------------------------------

    def _step_times(self) -> dict[int, float]:
        """Average seconds per step for every host with ≥2 reports."""
        out = {}
        for h, n in self._count.items():
            if n >= 2:
                out[h] = (self._last[h] - self._first[h]) / (n - 1)
        return out

    def stragglers(self) -> list[int]:
        """Hosts strictly slower than ``factor ×`` the median step time."""
        times = self._step_times()
        if len(times) < 2:
            return []
        vals = sorted(times.values())
        mid = len(vals) // 2
        median = vals[mid] if len(vals) % 2 else 0.5 * (vals[mid - 1] + vals[mid])
        return sorted(h for h, t in times.items() if t > self.factor * median)

    def dead(self, now: float | None = None) -> list[int]:
        """Hosts more than ``timeout`` seconds behind.  ``now`` defaults to
        the freshest report seen."""
        if not self._last:
            return []
        now = max(self._last.values()) if now is None else now
        return sorted(h for h, t in self._last.items() if now - t > self.timeout)
