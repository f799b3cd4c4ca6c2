"""The declared ``RequestState.phase`` state machine — single source of truth
(the port's copy of ``repro/analysis/phases.py``).

Both halves of the port's repro-lint consume this table:

* the static rule (``repro_torch.analysis.rules.phase_transitions``, run by
  ``python -m repro_torch.analysis.lint``) checks every
  ``<obj>.phase = "<literal>"`` assignment in the port's ``serve`` modules
  against ``PHASE_WRITERS`` — each phase value may only be written by its
  declared owner function, so moving/adding a phase write forces an edit
  here;
* the runtime sanitizer validates each actual transition against
  ``PHASE_EDGES`` via ``check_phase_edge`` (wired into
  ``RequestState.__setattr__`` when ``REPRO_SANITIZE=1``).

The machine (see ``serve/scheduler.py``'s module docstring)::

    waiting ──admit──▶ prefill ──finish──▶ ready ──lane──▶ running
        │                 │                  ▲                │
        │                 └───early EOS──▶ done ◀──retire─────┤
        ├──admit──▶ restore ────stage───────┤        ▲        │
        │                                   │        │        │
        └──admit──▶ match ───hit──────------┴─early EOS       │
        ▲                                                     │
        └───────────────────preempt───────────────────────────┘

``match`` is the prefix-cache hit path: the whole prompt (and its first
greedy token) was already resident, so the request skips prefill and goes
straight to ready once any host-resident prefix pages are staged back in.
"""
from __future__ import annotations

# (old, new) pairs; "waiting" -> "waiting" covers dataclass construction
# (the class-level default is already "waiting" when __setattr__ first runs)
PHASE_EDGES: frozenset[tuple[str, str]] = frozenset({
    ("waiting", "waiting"),      # construction
    ("waiting", "prefill"),      # Scheduler.admit_next (fresh / recompute)
    ("waiting", "restore"),      # Scheduler.admit_next (swapped)
    ("waiting", "match"),        # Scheduler.admit_next (full prefix hit)
    ("prefill", "ready"),        # Scheduler.to_ready (prefill finished)
    ("restore", "ready"),        # Scheduler.to_ready (restore staged)
    ("match", "ready"),          # Scheduler.to_ready (match finished)
    ("ready", "running"),        # ServeEngine._fill_lanes (lane assigned)
    ("running", "waiting"),      # Scheduler.preempt_batch (evicted)
    ("prefill", "done"),         # ServeEngine._retire (early EOS, no lane)
    ("match", "done"),           # ServeEngine._retire (stored token is EOS)
    ("running", "done"),         # ServeEngine._retire (max tokens / EOS)
})

# phase value -> the only functions ("Class.method") allowed to assign it.
# The static rule flags any other assignment site as an illegal edge.
PHASE_WRITERS: dict[str, frozenset[str]] = {
    "waiting": frozenset({"Scheduler.preempt_batch"}),
    "prefill": frozenset({"Scheduler.admit_next"}),
    "restore": frozenset({"Scheduler.admit_next"}),
    "match": frozenset({"Scheduler.admit_next"}),
    "ready": frozenset({"Scheduler.to_ready"}),
    "running": frozenset({"ServeEngine._fill_lanes"}),
    "done": frozenset({"ServeEngine._retire"}),
}

PHASES: frozenset[str] = frozenset(PHASE_WRITERS)


def check_phase_edge(old: str | None, new: str) -> str | None:
    """Return an error message for an illegal transition, else None."""
    if new not in PHASES:
        return f"unknown phase {new!r} (declared: {sorted(PHASES)})"
    if old is None:
        old = "waiting"
    if (old, new) not in PHASE_EDGES:
        return (
            f"illegal phase edge {old!r} -> {new!r} "
            f"(declared edges: {sorted(PHASE_EDGES)})"
        )
    return None
