"""Preallocated ring-buffer tracer for the two-loop serve engine (the port's
copy of ``repro/obs/trace.py``).

Design constraints (enforced by the port's `obs-hot-path` repro-lint rule,
``repro_torch.analysis.rules.obs_hot_path``, on every function marked
:func:`hot_path`):

- **No allocation on the hot path.**  Events land in parallel preallocated
  numpy arrays (timestamp, thread id, event id, phase, two integer args,
  sequence number) — a record is seven scalar stores, no objects, no
  strings, no containers.
- **No lock acquisition on the hot path.**  A slot is claimed with
  ``next(self._seq)`` — a single CPython bytecode on an ``itertools.count``,
  atomic under the GIL — then written without coordination.  Two threads
  never share a slot; a reader only runs after recording stops.
- **No torch on the hot path.**  Timestamps come from
  :mod:`repro_torch.obs.clock` (host monotonic time); device timing stays
  in ``chip_smoke.py``.

When the buffer wraps, the oldest events are overwritten and counted as
``dropped`` — tracing degrades by forgetting history, never by blocking
the decode loop.

:class:`ServeTracer` pre-registers the serve-layer event schema (engine
steps, prefill chunks, swap DMA, admission, preemption, router dispatch,
request phase spans) so every hot call site records by integer id.
``NULL_TRACER`` is a disabled singleton used as the default everywhere —
call sites stay unconditional (no ``if tracer:`` branches in serve code)
and the disabled check is a single attribute test inside the record call.
"""
from __future__ import annotations

import itertools
import threading
from collections.abc import Callable
from typing import Any, TypeVar

import numpy as np

from . import clock

# Phase codes for the `ph` column (mirror Chrome-trace phases).
PH_BEGIN = 0
PH_END = 1
PH_INSTANT = 2
PH_COUNTER = 3

# Sentinel for "no value" in the integer arg columns.  Large-negative so
# real payloads (uids, page counts, byte counts) can never collide.
NOARG = -(1 << 62)

_F = TypeVar("_F", bound=Callable)


def hot_path(fn: _F) -> _F:
    """Mark a tracer method as hot-path.

    The marker is consumed by the port's `obs-hot-path` and
    `tune-lookup-in-hot-path` repro-lint rules
    (``python -m repro_torch.analysis.lint``), which forbid allocation-heavy
    and lock-taking constructs and tuned-table reads inside any function
    carrying it.  At runtime it is a no-op.
    """
    fn.__obs_hot_path__ = True  # type: ignore[attr-defined]
    return fn


class Tracer:
    """Lock-free ring-buffer event recorder.

    Events are fixed-width rows across parallel numpy arrays; the only
    shared mutable state touched while recording is an ``itertools.count``
    whose ``next()`` is atomic under the GIL.
    """

    def __init__(self, capacity: int = 1 << 15, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._on = bool(enabled)
        self._seq = itertools.count()
        self._ts = np.zeros(self.capacity, np.float64)
        self._tid = np.zeros(self.capacity, np.int64)
        self._ev = np.zeros(self.capacity, np.int32)
        self._ph = np.zeros(self.capacity, np.int8)
        self._a0 = np.zeros(self.capacity, np.int64)
        self._a1 = np.zeros(self.capacity, np.int64)
        # -1 marks a never-written slot; valid rows carry their global
        # sequence number so a reader can order and count drops.
        self._sn = np.full(self.capacity, -1, np.int64)
        # Event schema: id -> (name, argnames).  Registration is cold.
        self._names: list[str] = []
        self._argnames: list[tuple[str, ...]] = []
        self._reg_lock = threading.Lock()
        self._thread_names: dict[int, str] = {}

    # -- cold path: schema + control ------------------------------------

    def register(self, name: str, argnames: tuple[str, ...] = ()) -> int:
        """Register an event type; returns the integer id hot paths use."""
        with self._reg_lock:
            self._names.append(str(name))
            self._argnames.append(tuple(argnames))
            return len(self._names) - 1

    def name_thread(self, label: str) -> None:
        """Label the calling thread's track in the exported timeline."""
        with self._reg_lock:
            self._thread_names[threading.get_ident()] = str(label)

    def ensure_thread_name(self, label: str) -> None:
        """``name_thread`` once per thread — callable from a loop (the
        lock is only taken on the first call from a given thread)."""
        if not self._on:
            return
        if threading.get_ident() not in self._thread_names:
            self.name_thread(label)

    @property
    def enabled(self) -> bool:
        return self._on

    def enable(self) -> None:
        self._on = True

    def disable(self) -> None:
        self._on = False

    # -- hot path: recording --------------------------------------------

    @hot_path
    def _record(self, ev: int, ph: int, a0: int, a1: int) -> None:
        if not self._on:
            return
        sn = next(self._seq)
        i = sn % self.capacity
        self._ts[i] = clock.monotonic()
        self._tid[i] = threading.get_ident()
        self._ev[i] = ev
        self._ph[i] = ph
        self._a0[i] = a0
        self._a1[i] = a1
        self._sn[i] = sn

    @hot_path
    def begin(self, ev: int, a0: int = NOARG, a1: int = NOARG) -> None:
        self._record(ev, PH_BEGIN, a0, a1)

    @hot_path
    def end(self, ev: int, a0: int = NOARG, a1: int = NOARG) -> None:
        self._record(ev, PH_END, a0, a1)

    @hot_path
    def instant(self, ev: int, a0: int = NOARG, a1: int = NOARG) -> None:
        self._record(ev, PH_INSTANT, a0, a1)

    @hot_path
    def counter(self, ev: int, value: int) -> None:
        self._record(ev, PH_COUNTER, value, NOARG)

    # -- cold path: ad-hoc events ---------------------------------------

    def instant_named(self, name: str, a0: int = NOARG) -> None:
        """Record an instant for a name not in the schema (cold path).

        Used for rare, message-bearing events — sanitizer findings — where
        registering a fresh event type per message is acceptable.
        """
        if not self._on:
            return
        self.instant(self.register(name), a0)

    # -- readers (only meaningful after recording stops) -----------------

    @property
    def total(self) -> int:
        """Events ever recorded (including any overwritten by wraparound)."""
        hi = int(self._sn.max())
        return hi + 1

    @property
    def dropped(self) -> int:
        """Events lost to ring wraparound."""
        return max(0, self.total - self.capacity)

    def events(self) -> list[dict[str, Any]]:
        """Surviving events in global order, decoded against the schema."""
        live = np.flatnonzero(self._sn >= 0)
        order = live[np.argsort(self._sn[live], kind="stable")]
        out: list[dict[str, Any]] = []
        for i in order:
            ev = int(self._ev[i])
            rec: dict[str, Any] = {
                "seq": int(self._sn[i]),
                "ts": float(self._ts[i]),
                "tid": int(self._tid[i]),
                "ev": ev,
                "name": self._names[ev] if ev < len(self._names) else f"ev{ev}",
                "ph": int(self._ph[i]),
                "args": {},
            }
            names = self._argnames[ev] if ev < len(self._argnames) else ()
            for k, v in zip(names, (int(self._a0[i]), int(self._a1[i]))):
                if v != NOARG:
                    rec["args"][k] = v
            if int(self._ph[i]) == PH_COUNTER:
                rec["args"]["value"] = int(self._a0[i])
            out.append(rec)
        return out

    def thread_names(self) -> dict[int, str]:
        return dict(self._thread_names)


class ServeTracer(Tracer):
    """Tracer with the serve engine's event schema pre-registered."""

    # Request lifecycle phases, in the scheduler's own vocabulary.  Kept
    # in sync with repro_torch.analysis.phases.PHASE_EDGES by a test.
    PHASES = ("waiting", "match", "prefill", "restore", "ready", "running",
              "done")

    def __init__(self, capacity: int = 1 << 15, enabled: bool = True):
        super().__init__(capacity=capacity, enabled=enabled)
        self.EV_STEP = self.register("engine.step", ("step",))
        self.EV_DECODE = self.register("decode.batch", ("lanes",))
        self.EV_PREFILL_CHUNK = self.register("prefill.chunk", ("uid", "tokens"))
        self.EV_STAGE_IN = self.register("swap_in.stage", ("uid", "pages"))
        self.EV_SWAP_OUT = self.register("swap_out.batch", ("victims", "pages"))
        self.EV_ADMIT = self.register("admission.reserve", ("uid", "pages"))
        self.EV_PREEMPT_SWAP = self.register("preempt.swap", ("uid",))
        self.EV_PREEMPT_RECOMPUTE = self.register("preempt.recompute", ("uid",))
        self.EV_DISPATCH = self.register("router.dispatch", ("uid", "cube"))
        self.EV_PAGES_FREE = self.register("pages.free", ())
        self.EV_PREFIX_HIT = self.register("prefix.hit", ("uid", "tokens"))
        self.EV_PREFIX_FORK = self.register("prefix.fork", ("uid", "page"))
        self.EV_PREFIX_RETIRE = self.register("prefix.retire", ("pages",))
        # Phase events are contiguous ids so `phase()` is one dict lookup
        # away from the right event id on the hot path.
        self._phase_ev = {p: self.register("phase." + p, ("uid",)) for p in self.PHASES}

    @hot_path
    def phase(self, uid: int, name: str) -> None:
        """Record a request phase edge as an instant on the uid's track."""
        if not self._on:
            return
        ev = self._phase_ev.get(name)
        if ev is None:
            return
        self._record(ev, PH_INSTANT, uid, NOARG)


# Shared disabled tracer: the default for every serve-layer tracer slot,
# so call sites never branch on "is tracing on".  capacity=1 keeps the
# idle footprint at seven scalars.
NULL_TRACER = ServeTracer(capacity=1, enabled=False)

__all__ = [
    "PH_BEGIN",
    "PH_END",
    "PH_INSTANT",
    "PH_COUNTER",
    "NOARG",
    "hot_path",
    "Tracer",
    "ServeTracer",
    "NULL_TRACER",
]
