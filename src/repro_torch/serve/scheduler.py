"""Request scheduler for the paged serving engine (the port's copy of
``repro/serve/scheduler.py``, without the host tier and prefix sharing).

Requests move through an explicit state machine::

    waiting ──admit──▶ admitting(phase='prefill') ──▶ ready ──▶ running
        ▲                                                          │
        └──────────────────────preempt─────────────────────────────┘

Admission *reserves* pages up front (the whole prompt + one decode slot),
so an admitted request can always finish its prefill and the admission
pipeline never races the decode loop on the free list.

Every method here mutates shared queues and the page allocator, so the
engine calls them under its bookkeeping lock; the scheduler itself stays
lock-free and synchronous.  Preemption is ``recompute``: the victim's pages
are freed and prompt + generated tokens are prefilled again on resume.

Queue-ordering policies order the waiting queue only: ``fcfs`` (arrival
order) or ``spf`` (shortest prompt first).  A preempted request re-enters
at the front whatever the policy.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.analysis.ownership import admission_api, decode_loop_only

# backpressure: requests admitted or ready but not yet decoding
MAX_INFLIGHT_PREFILLS = 2


@dataclass
class SchedulerConfig:
    policy: str = "fcfs"            # fcfs | spf
    prefill_chunk: int = 0          # 0 = whole-prompt prefill


@dataclass
class RequestState:
    """Scheduler-side shadow of one request."""

    req: object                     # serve.engine.Request
    resume_tokens: np.ndarray       # tokens to (re)prefill: prompt [+generated]
    phase: str = "waiting"          # waiting|prefill|ready|running|done
    pages: list = field(default_factory=list)
    lane: int = -1
    prefilled: int = 0              # resume_tokens already written
    length: int = 0                 # kv entries valid in pages
    pending_token: int = -1         # next decode input (last sampled token)
    is_resume: bool = False         # re-prefill after preemption
    last_logits: object = None      # final prefill logits (one vocab row)
    prefill_cache: object = None    # private prefill cache tree, held until a
    #                                 lane is assigned (only the decode loop
    #                                 writes pools)

    @property
    def remaining_prefill(self) -> int:
        return len(self.resume_tokens) - self.prefilled


class Scheduler:
    """Admission / chunking / preemption policy over the queue state
    machine: waiting → admitting (prefill) → ready → running."""

    def __init__(self, cfg: SchedulerConfig):
        if cfg.policy not in ("fcfs", "spf"):
            raise ValueError(f"unknown scheduler policy: {cfg.policy!r}")
        self.cfg = cfg
        self.waiting: list[RequestState] = []
        self.admitting: list[RequestState] = []
        self.ready: list[RequestState] = []
        self.running: dict[int, RequestState] = {}     # lane → state
        self.n_preemptions = 0

    def add(self, req) -> None:
        self.waiting.append(RequestState(
            req=req, resume_tokens=np.asarray(req.prompt, np.int32)))

    @property
    def load(self) -> int:
        return (len(self.waiting) + len(self.admitting) + len(self.ready)
                + len(self.running))

    def queue_depth(self) -> int:
        return len(self.waiting)

    def _next_waiting_index(self) -> int:
        if self.cfg.policy == "spf":
            return int(np.argmin([len(s.resume_tokens) for s in self.waiting]))
        return 0

    @admission_api
    def admit_next(self, cache) -> RequestState | None:
        """Reserve pages for the next admissible waiting request and move it
        to ``admitting`` (phase ``prefill``).  None when nothing can be
        admitted: queue empty, in-flight bound hit, or the reservation does
        not fit the free pool.  Pure bookkeeping, under the engine lock."""
        if not self.waiting:
            return None
        if len(self.admitting) + len(self.ready) >= MAX_INFLIGHT_PREFILLS:
            return None
        i = self._next_waiting_index()
        pages = cache.acquire(len(self.waiting[i].resume_tokens) + 1)
        if pages is None:
            return None
        st = self.waiting.pop(i)
        st.pages = pages
        st.prefilled = 0
        st.phase = "prefill"
        self.admitting.append(st)
        return st

    def admissions(self, cache, budget: int) -> list[RequestState]:
        """Admit while pages, the token budget and the in-flight bound allow
        (the sync-mode batch form of ``admit_next``)."""
        admitted = []
        while budget > 0:
            st = self.admit_next(cache)
            if st is None:
                break
            admitted.append(st)
            budget -= min(self.chunk_for(st), budget)
        return admitted

    @admission_api
    def to_ready(self, st: RequestState) -> None:
        """Admission pipeline hand-off: prefill finished."""
        self.admitting.remove(st)
        st.phase = "ready"
        self.ready.append(st)

    def chunk_for(self, st: RequestState) -> int:
        if self.cfg.prefill_chunk <= 0:
            return st.remaining_prefill
        return min(self.cfg.prefill_chunk, st.remaining_prefill)

    @decode_loop_only
    def preempt_batch(self, victims: list[RequestState], cache) -> None:
        """Evict a victim set by recompute: free the pages and requeue each
        victim at the front to re-prefill prompt + generated tokens."""
        for st in victims:
            cache.clear_lane(st.lane)
            cache.allocator.release(st.pages)
            del self.running[st.lane]
            st.pages = []
            st.lane = -1
            st.resume_tokens = np.concatenate([
                np.asarray(st.req.prompt, np.int32),
                np.asarray(st.req.out_tokens[:-1], np.int32),
            ])
            st.prefilled = 0
            st.length = 0
            st.is_resume = True
            st.phase = "waiting"
            self.n_preemptions += 1
            self.waiting.insert(0, st)
