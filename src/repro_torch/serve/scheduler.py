"""Request scheduler for the paged serving engine (the port's copy of
``repro/serve/scheduler.py``).

Requests move through an explicit state machine::

    waiting ──admit──▶ admitting(phase='prefill')  ──▶ ready ──▶ running
        │                 (prefill chunks run)           ▲
        ├──admit──▶ admitting(phase='restore') ──stage───┤
        │             (host-tier copy, no compute)       │
        └──admit──▶ admitting(phase='match') ──hit───────┘
                      (full prefix hit: prefill skipped; only
                       host-resident prefix pages need staging)

Admission *reserves* pages up front (the whole prompt + one decode slot, or
the swapped page count), so an admitted request can always finish its
prefill or restore and the admission pipeline never races the decode loop
on the free list.

Every method here mutates shared queues and the page allocators, so the
engine calls them under its bookkeeping lock; the scheduler itself stays
lock-free and synchronous.

Eviction is a policy (``SchedulerConfig.preempt_policy``):

* ``swap``      — move the victim's pages to the host tier and restore them
  on resume.  Per victim a cost model compares pages to move against
  tokens to recompute (``swap_token_cost``: the cost of moving one token of
  KV relative to recomputing it) and falls back to recompute when that is
  cheaper or the host tier is exhausted.
* ``recompute`` — free the pages and re-prefill prompt + generated tokens
  on resume.

``preempt_batch`` evicts a whole victim set with one page read for every
seq leaf (``cache.swap_out_batch``).

Queue-ordering policies order the waiting queue only: ``fcfs`` (arrival
order) or ``spf`` (shortest prompt first).  A preempted request re-enters
at the front whatever the policy, and a swapped one is admitted first.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.analysis import sanitizer
from repro_torch.analysis.ownership import admission_api, decode_loop_only
from repro_torch.analysis.phases import check_phase_edge
from repro_torch.obs import clock as obs_clock
from repro_torch.obs.trace import NULL_TRACER, ServeTracer


@dataclass
class SchedulerConfig:
    policy: str = "fcfs"            # fcfs | spf
    prefill_chunk: int = 0          # 0 = whole-prompt prefill
    # backpressure: requests admitted (prefilling, restoring or matching) or
    # ready but not yet decoding.  Bounds the admission pipeline's in-flight
    # work and, with it, the pages and held prefill caches admissions pin
    max_inflight_prefills: int = 2
    preempt_policy: str = "swap"    # swap | recompute
    # cost of moving one token of KV through the host tier relative to
    # recomputing it (the swap-vs-recompute cost model; 0 = always swap)
    swap_token_cost: float = 0.25


@dataclass
class RequestState:
    """Scheduler-side shadow of one request."""

    req: object                     # serve.engine.Request
    resume_tokens: np.ndarray       # tokens to (re)prefill: prompt [+generated]
    # the tracer rides the state so phase writes record themselves; declared
    # BEFORE ``phase``: the dataclass __init__ assigns in declaration order and
    # the construction-time phase write already records through it
    tracer: ServeTracer = NULL_TRACER
    submit_ts: float = 0.0          # queue-wait clock: (re)entered waiting
    phase: str = "waiting"          # waiting|match|prefill|restore|ready|running|done
    pages: list = field(default_factory=list)
    lane: int = -1
    prefilled: int = 0              # resume_tokens already written
    length: int = 0                 # kv entries valid in pages
    pending_token: int = -1         # next decode input (last sampled token)
    is_resume: bool = False         # re-prefill after preemption
    preemptions: int = 0
    last_logits: object = None      # final prefill logits (one vocab row)
    prefill_cache: object = None    # private prefill cache tree, held until a
    #                                 lane is assigned (only the decode loop
    #                                 writes pools)
    prefill_slot: int = -1          # the engine's prefill slot holding that
    #                                 tree (chunked prefill), or -1
    state_cache: object = None      # restored recurrent state awaiting a lane
    staged: object = None           # host→device staged page rows awaiting
    #                                 the decode loop's scatter (swap-in)
    swapped: bool = False           # pages live in the host tier
    swap_handle: object = None      # host_tier.SwapHandle (survives resume:
    #                                 its clean prefix skips recopies)
    prefix_claim: object = None     # paged_cache.PrefixClaim (pages shared /
    #                                 restores booked at admission)
    prefix_staged: object = None    # (staged rows, device_pages) awaiting the
    #                                 decode loop's scatter (prefix restore)

    @property
    def remaining_prefill(self) -> int:
        return len(self.resume_tokens) - self.prefilled

    def __setattr__(self, name: str, value) -> None:
        if name == "phase":
            # sanitizer mode: every phase write is checked against the
            # declared edges (analysis.phases), the runtime twin of the
            # static phase-transitions rule of the port's repro-lint
            if sanitizer.enabled():
                err = check_phase_edge(getattr(self, "phase", None), value)
                if err is not None:
                    uid = getattr(getattr(self, "req", None), "uid", "?")
                    self.tracer.instant_named(
                        f"sanitizer: illegal phase edge -> {value} uid={uid}")
                    raise sanitizer.SanitizerError(f"request uid={uid}: {err}")
            object.__setattr__(self, name, value)
            # every phase edge lands in the trace as an instant on the
            # request's lifecycle track (a no-op through NULL_TRACER)
            self.tracer.phase(self.req.uid, value)
            return
        object.__setattr__(self, name, value)


class Scheduler:
    """Admission / chunking / preemption policy over the queue state
    machine: waiting → admitting (prefill|restore|match) → ready → running."""

    def __init__(self, cfg: SchedulerConfig, tracer: ServeTracer = NULL_TRACER):
        if cfg.policy not in ("fcfs", "spf"):
            raise ValueError(f"unknown scheduler policy: {cfg.policy!r}")
        if cfg.preempt_policy not in ("swap", "recompute"):
            raise ValueError(f"unknown preempt policy: {cfg.preempt_policy!r}")
        self.cfg = cfg
        self.tracer = tracer
        self.waiting: list[RequestState] = []
        self.admitting: list[RequestState] = []
        self.ready: list[RequestState] = []
        self.running: dict[int, RequestState] = {}     # lane → state
        self.n_preemptions = 0
        self.n_swap_preemptions = 0
        self.n_recompute_preemptions = 0
        # live per-uid counters only, cleared on retire (a long-lived engine
        # must not grow an entry per request it ever served); the high-water
        # mark survives in max_preemptions_per_request
        self.preemptions_by_uid: dict[int, int] = {}
        self.max_preemptions_per_request = 0
        # prefix hits, with the same retire-folded lifecycle
        self.prefix_hit_tokens_by_uid: dict[int, int] = {}
        self.max_prefix_hit_tokens = 0

    # -- queue accounting ---------------------------------------------------

    def add(self, req) -> None:
        self.waiting.append(RequestState(
            req=req, resume_tokens=np.asarray(req.prompt, np.int32),
            tracer=self.tracer, submit_ts=obs_clock.monotonic()))

    @property
    def load(self) -> int:
        return (len(self.waiting) + len(self.admitting) + len(self.ready)
                + len(self.running))

    def queue_depth(self) -> int:
        return len(self.waiting)

    def retire_uid(self, uid: int) -> None:
        """Fold the per-uid counters into their high-water marks and drop
        them."""
        n = self.preemptions_by_uid.pop(uid, 0)
        if n > self.max_preemptions_per_request:
            self.max_preemptions_per_request = n
        t = self.prefix_hit_tokens_by_uid.pop(uid, 0)
        if t > self.max_prefix_hit_tokens:
            self.max_prefix_hit_tokens = t

    # -- admission ----------------------------------------------------------

    def _next_waiting_index(self) -> int:
        # swapped requests resume first whatever the ordering policy: they
        # hold host pages, and starving them would pin the host tier
        swapped = [i for i, s in enumerate(self.waiting) if s.swapped]
        if swapped:
            return swapped[0]
        if self.cfg.policy == "spf":
            return int(np.argmin([len(s.resume_tokens) for s in self.waiting]))
        return 0

    @admission_api
    def admit_next(self, cache) -> RequestState | None:
        """Reserve pages for the next admissible waiting request and move it
        to ``admitting`` (phase ``prefill``, ``restore`` or ``match``).  None
        when nothing can be admitted: queue empty, in-flight bound hit, or
        the reservation does not fit the free pool.  Pure bookkeeping, under
        the engine lock."""
        if not self.waiting:
            return None
        if len(self.admitting) + len(self.ready) >= self.cfg.max_inflight_prefills:
            return None
        i = self._next_waiting_index()
        nxt = self.waiting[i]
        if nxt.swapped:
            # reserve a decode slot beside the restored pages when the last
            # page came back full: otherwise a restored lane needs a growth
            # page before its first decode step, and on a dry pool the
            # evict/assign cycle could spin without a token of progress
            n = len(nxt.swap_handle.host_pages)
            extra = 1 if n * cache.page_size <= nxt.length else 0
            pages = cache.allocator.acquire(n + extra)
            if pages is None:
                return None
            st = self.waiting.pop(i)
            st.pages = pages
            sanitizer.note_grant(st, pages, cache.allocator)
            st.phase = "restore"
        else:
            claim = cache.claim_match(nxt.resume_tokens, self.cfg.prefill_chunk)
            if claim is not None:
                st = self.waiting.pop(i)
                st.pages = claim.pages
                st.prefix_claim = claim
                sanitizer.note_grant(st, claim.pages, cache.allocator)
                self._note_prefix_hit(st, claim.matched_tokens)
                if claim.kind == "full":
                    st.prefilled = len(st.resume_tokens)
                    st.phase = "match"
                else:
                    st.prefilled = claim.matched_tokens
                    st.phase = "prefill"
            else:
                pages = cache.acquire(len(nxt.resume_tokens) + 1)
                if pages is None:
                    return None
                st = self.waiting.pop(i)
                st.pages = pages
                sanitizer.note_grant(st, pages, cache.allocator)
                st.prefilled = 0
                st.phase = "prefill"
        self.admitting.append(st)
        self.tracer.instant(self.tracer.EV_ADMIT, st.req.uid, len(st.pages))
        return st

    def _note_prefix_hit(self, st: RequestState, tokens: int) -> None:
        uid = st.req.uid
        self.prefix_hit_tokens_by_uid[uid] = self.prefix_hit_tokens_by_uid.get(uid, 0) + tokens
        self.tracer.instant(self.tracer.EV_PREFIX_HIT, uid, tokens)

    def admissions(self, cache, budget: int) -> list[RequestState]:
        """Admit while pages, the token budget and the in-flight bound allow
        (the sync-mode batch form of ``admit_next``).  Restores and matches
        cost no budget: they run no prefill."""
        admitted = []
        while budget > 0:
            st = self.admit_next(cache)
            if st is None:
                break
            admitted.append(st)
            if st.phase == "prefill":
                budget -= min(self.chunk_for(st), budget)
        return admitted

    @admission_api
    def to_ready(self, st: RequestState) -> None:
        """Admission pipeline hand-off: prefill, restore or match finished."""
        self.admitting.remove(st)
        st.phase = "ready"
        self.ready.append(st)

    def chunk_for(self, st: RequestState) -> int:
        if self.cfg.prefill_chunk <= 0:
            return st.remaining_prefill
        return min(self.cfg.prefill_chunk, st.remaining_prefill)

    # -- preemption ---------------------------------------------------------

    def pick_victim(self, exclude_lane: int = -1, exclude=()) -> RequestState | None:
        """Longest-running request (most generated tokens); prefer not to
        evict ``exclude_lane`` (the lane asking for the page) and never one
        of ``exclude`` (already picked)."""
        cands = [s for l, s in self.running.items() if l != exclude_lane and s not in exclude]
        if not cands:
            cands = [s for s in self.running.values() if s not in exclude]
        if not cands:
            return None
        return max(cands, key=lambda s: len(s.req.out_tokens))

    def swap_beats_recompute(self, st: RequestState, cache) -> bool:
        """The eviction cost model: pages to move against tokens to
        recompute.  Swapping moves the dirty pages out now and every page
        back in on resume; recomputing re-runs prefill over prompt +
        generated tokens.  Both in token units: ``swap_token_cost`` is the
        relative cost of moving one page slot of KV (0: swap always wins)."""
        clean = st.swap_handle.clean_pages if st.swap_handle else 0
        pages_to_move = (len(st.pages) - clean) + len(st.pages)   # out + in
        swap_cost = pages_to_move * cache.page_size * self.cfg.swap_token_cost
        recompute_tokens = len(st.req.prompt) + len(st.req.out_tokens) - 1
        return swap_cost < recompute_tokens

    @decode_loop_only
    def preempt_batch(self, victims: list[RequestState], cache) -> list[str]:
        """Evict a victim set by the configured policy, with one page read
        for all swap-mode victims (``swap_out_batch``).  Per victim the cost
        model and the host-tier reservation decide ``swap`` or
        ``recompute``; returns the per-victim modes.  Runs (copy included)
        under the engine lock, as in the JAX package: a preemption storm
        briefly blocks the admission pipeline for the one batched read."""
        plan = []                       # (st, mode)
        swap_items = []                 # (st, dirty-index-list)
        for st in victims:
            mode = "recompute"
            if (self.cfg.preempt_policy == "swap"
                    and self.swap_beats_recompute(st, cache)):
                reserved = cache.swap_reserve(st)
                if reserved is not None:
                    st.swap_handle, dirty = reserved
                    swap_items.append((st, dirty))
                    mode = "swap"
            plan.append((st, mode))
        if swap_items:
            self.tracer.begin(self.tracer.EV_SWAP_OUT, len(swap_items),
                              sum(len(d) for _st, d in swap_items))
            cache.swap_out_batch(swap_items)
            self.tracer.end(self.tracer.EV_SWAP_OUT)
        modes = []
        for st, mode in plan:
            cache.clear_lane(st.lane)
            # shared prefix pages survive the victim: release drops one owner
            # and only sole-owned pages return to the free list
            cache.allocator.release(st.pages)
            sanitizer.note_release(st)
            del self.running[st.lane]
            st.pages = []
            st.lane = -1
            if mode == "swap":
                st.swapped = True           # length/pending_token survive
                self.n_swap_preemptions += 1
            else:
                # the host copy (if any) is invalidated by re-prefill
                cache.host_free(st.swap_handle)
                st.swap_handle = None
                st.swapped = False
                st.resume_tokens = np.concatenate([
                    np.asarray(st.req.prompt, np.int32),
                    np.asarray(st.req.out_tokens[:-1], np.int32)])
                st.prefilled = 0
                st.length = 0
                st.is_resume = True
                self.n_recompute_preemptions += 1
            self.tracer.instant(self.tracer.EV_PREEMPT_SWAP if mode == "swap"
                                else self.tracer.EV_PREEMPT_RECOMPUTE, st.req.uid)
            st.submit_ts = obs_clock.monotonic()   # queue wait restarts
            st.phase = "waiting"
            st.preemptions += 1
            self.n_preemptions += 1
            uid = st.req.uid
            self.preemptions_by_uid[uid] = self.preemptions_by_uid.get(uid, 0) + 1
            self.waiting.insert(0, st)
            modes.append(mode)
        return modes

    @decode_loop_only
    def preempt(self, st: RequestState, cache) -> str:
        """Single-victim eviction (the batch of one)."""
        return self.preempt_batch([st], cache)[0]
