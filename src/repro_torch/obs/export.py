"""Chrome-trace / Perfetto JSON export and lifecycle reconstruction (the
port's copy of ``repro/obs/export.py``).

``chrome_trace`` turns one or more :class:`~repro_torch.obs.trace.Tracer`
buffers into the Chrome trace-event JSON format (the ``traceEvents``
array form), loadable in Perfetto UI or ``chrome://tracing``:

- each tracer becomes one **process** track (one serve engine = one pid);
- each recording thread becomes a named **thread** track (the decode
  loop vs the admission worker), via ``M``-phase metadata events;
- span begin/end map to ``B``/``E``, instants to ``i`` (thread-scoped),
  counters to ``C``; timestamps are microseconds.

``request_phases`` / ``validate_lifecycles`` reconstruct every request's
phase history from the ``phase.*`` instants and check the edges against
the scheduler's declared state machine
(:data:`repro_torch.analysis.phases.PHASE_EDGES`) — the trace round-trip
tests and ``chip_smoke.py``'s traced runs go through them.
"""
from __future__ import annotations

import json
from typing import Any

from repro_torch.analysis.phases import PHASE_EDGES

from .trace import PH_BEGIN, PH_COUNTER, PH_END, PH_INSTANT, Tracer

_PH_CHR = {PH_BEGIN: "B", PH_END: "E", PH_INSTANT: "i", PH_COUNTER: "C"}


def chrome_trace(tracers: dict[str, Tracer]) -> dict[str, Any]:
    """Merge named tracers into one Chrome-trace JSON object.

    ``tracers`` maps a process label (e.g. ``"engine"`` or ``"pod0"``) to
    its tracer; iteration order assigns pids.
    """
    out: list[dict[str, Any]] = []
    for pid, (label, tr) in enumerate(tracers.items()):
        out.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": label},
        })
        # Map raw OS thread idents to small per-process tids, labelled
        # threads first (stable track order in the UI), then first-seen.
        tids: dict[int, int] = {}
        names = tr.thread_names()
        for ident in sorted(names):
            tids[ident] = len(tids)
        events = tr.events()
        for e in events:
            if e["tid"] not in tids:
                tids[e["tid"]] = len(tids)
        for ident, tid in tids.items():
            out.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": names.get(ident, f"thread-{tid}")},
            })
        for e in events:
            rec: dict[str, Any] = {
                "name": e["name"],
                "ph": _PH_CHR[e["ph"]],
                "ts": e["ts"] * 1e6,
                "pid": pid,
                "tid": tids[e["tid"]],
                "args": e["args"],
            }
            if e["ph"] == PH_INSTANT:
                rec["s"] = "t"
            out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracers: dict[str, Tracer]) -> dict[str, Any]:
    trace = chrome_trace(tracers)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def load_chrome_trace(path: str) -> dict[str, Any]:
    with open(path) as f:
        trace = json.load(f)
    if "traceEvents" not in trace:
        raise ValueError(f"{path}: not a Chrome-trace JSON (no traceEvents)")
    return trace


def request_phases(trace: dict[str, Any]) -> dict[int, list[str]]:
    """uid -> ordered phase history, reconstructed from ``phase.*`` instants.

    Events are already emitted in per-tracer sequence order and a
    request's lifecycle lives on a single engine, so arrival order is
    history order.
    """
    hist: dict[int, list[str]] = {}
    for e in trace["traceEvents"]:
        name = e.get("name", "")
        if e.get("ph") == "i" and name.startswith("phase."):
            hist.setdefault(e["args"]["uid"], []).append(name[len("phase."):])
    return hist


def validate_lifecycles(
    trace: dict[str, Any], require_done: bool = True
) -> dict[int, list[str]]:
    """Check every reconstructed lifecycle against the state machine.

    Raises ``ValueError`` on the first violation; returns the phase
    histories on success.  Only valid for traces whose ring buffer did
    not wrap (a wrapped buffer legitimately forgets early edges).
    """
    hist = request_phases(trace)
    if not hist:
        raise ValueError("trace contains no phase.* events")
    for uid, phases in hist.items():
        if phases[0] != "waiting":
            raise ValueError(f"uid {uid}: lifecycle starts at {phases[0]!r}, not 'waiting'")
        if require_done and phases[-1] != "done":
            raise ValueError(f"uid {uid}: lifecycle ends at {phases[-1]!r}, not 'done'")
        for old, new in zip(phases, phases[1:]):
            if (old, new) not in PHASE_EDGES:
                raise ValueError(
                    f"uid {uid}: illegal phase edge {old!r} -> {new!r} in {phases}"
                )
    return hist


__all__ = [
    "chrome_trace",
    "write_chrome_trace",
    "load_chrome_trace",
    "request_phases",
    "validate_lifecycles",
]
