"""One injectable monotonic time source for everything observable (the
port's copy of ``repro/obs/clock.py``).

Every timestamp the serve layer records — tracer events, step-latency and
queue-wait histograms, the decode loop's deadlock watchdog — reads the
clock through :func:`monotonic` instead of calling ``time.monotonic()``
directly, so a test can swap in a :class:`ManualClock` and drive a fully
deterministic timeline (histogram buckets and trace timestamps become
exact assertions, not tolerances).

The source is module-global on purpose: the serve engine, the admission
worker thread, and the tracer must all agree on one timeline, and the
swap happens at test setup, never concurrently with recording.
"""
from __future__ import annotations

import time
from collections.abc import Callable

_source: Callable[[], float] = time.monotonic


def monotonic() -> float:
    """Seconds from the current source (``time.monotonic`` by default)."""
    return _source()


def set_source(fn: Callable[[], float]) -> None:
    """Install a replacement time source (tests: a :class:`ManualClock`)."""
    global _source
    _source = fn


def reset_source() -> None:
    """Restore the real ``time.monotonic``."""
    global _source
    _source = time.monotonic


class ManualClock:
    """A hand-advanced time source for deterministic tests."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += float(dt)
        return self.now


__all__ = ["monotonic", "set_source", "reset_source", "ManualClock"]
