"""Paged continuous-batching serving engine, two-loop form (the port of
``repro/serve/engine.py``).

* The **decode loop** (``step``/``run``, the caller's thread) owns the page
  pools and block tables exclusively: lane assignment, page growth,
  recompute preemption and the batched decode step.  The decode path is
  ``CacheConfig.decode_path``: ``"paged"`` (default) runs
  ``DecoderLM.decode_step_paged`` (the paged-decode kernel for GQA
  attention layers, ``paged_gather`` and a plain read for the hybrid's
  local attention layers and for MLA's latent pages, per-lane state steps
  for the ssm and RG-LRU layers), ``"gather"`` gathers the
  pools into dense per-lane views (the ``paged_gather`` kernel), runs the
  dense ``DecoderLM.decode_step`` and folds its updates back
  (``absorb_decode``): the oracle the paged path is held against.
* The **admission pipeline** (``serve.admission.AdmissionPipeline``) runs
  prefill (whole prompt, or chunks through ``extend_step``; both run the
  flash kernel, the ``ssd_scan`` kernel for ssm layers and the plain
  RG-LRU scan for rec layers) on a worker
  thread (``AdmissionConfig.async_prefill``, default on) or inline,
  computing into *private* per-request caches and handing finished requests
  to the decode loop through the ready queue.

Shared bookkeeping (queues, free list, counters) lives under one engine
lock; no tensor work runs inside it.  Both pipeline modes give identical
tokens.

The engine runs on the card unless ``device="cpu"`` is passed (then every
kernel runs its plain PyTorch version); the parameters must already live on
that device.  Not ported yet: the host tier and swap preemption, prefix
sharing, tracing and inter-cube migration.  The engine is generic over
the model's cache tree: any mix of seq leaves (pages) and per-lane state
leaves, over any number of segments.  A state-only model (ssm)
still acquires pages per token, as in the JAX package, so page accounting,
preemption and step counts match it.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.analysis.ownership import admission_api, decode_loop_only, pool_mutator
from repro_torch.device import resolve
from repro_torch.models.common import tree_map

from .admission import AdmissionPipeline, prefill_logits_token
from .paged_cache import PagedKVCache, absorb_decode, gather_views
from .scheduler import Scheduler, SchedulerConfig

_COUNTERS = ("steps", "prefill_tokens", "decode_tokens", "lane_step_sum",
             "lane_slot_sum", "pipeline.admitted", "pipeline.chunks_run",
             "pipeline.prefills_done")


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    out_tokens: list = field(default_factory=list)
    done: bool = False


@dataclass
class CacheConfig:
    """Paged-KV memory.  Preemption frees a victim's pages and recomputes
    its prefill on resume (the host tier for swapping is not ported)."""

    page_size: int = 16
    n_pages: int | None = None      # None → batch_slots * max_len / page_size
    # 'paged' hands block tables straight to the model (decode_step_paged);
    # 'gather' materializes dense per-lane views, decodes and scatters the
    # written column back: the oracle the paged path is held against
    decode_path: str = "paged"


@dataclass
class AdmissionConfig:
    """Scheduler + admission-pipeline policy knobs."""

    policy: str = "fcfs"            # fcfs | spf
    # per-step token budget (decode + prefill), 0 = unbounded; paces the
    # sync pipeline's inline prefill, bounds decode lanes only in async mode
    max_step_tokens: int = 0
    prefill_chunk: int = 0          # 0 = whole-prompt prefill
    # True runs prefill on a worker thread feeding the ready queue; False
    # runs the identical pipeline inline each step
    async_prefill: bool = True


@dataclass
class EngineConfig:
    batch_slots: int = 4            # decode lanes
    max_len: int = 256              # per-request context capacity
    cache: CacheConfig = field(default_factory=CacheConfig)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)


class ServeEngine:
    """Greedy decoding over the DecoderLM serving API, backed by a paged KV
    cache, a request scheduler and an admission pipeline."""

    def __init__(self, model, params, ecfg: EngineConfig, device=None):
        if ecfg.cache.decode_path not in ("paged", "gather"):
            raise ValueError(f"unknown decode_path: {ecfg.cache.decode_path!r}")
        self.device = resolve(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"parameters live on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        self.model = model
        self.params = params
        self.ecfg = ecfg
        self.cfg = model.cfg
        # ONE bookkeeping lock shared by the decode loop and the admission
        # pipeline; no tensor work runs under it.  The condition variable
        # signals hand-offs both ways so neither loop spins.
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._counters = dict.fromkeys(_COUNTERS, 0)
        self._occ_sum = 0.0
        self._occ_max = 0.0
        cc, ac = ecfg.cache, ecfg.admission
        n_pages = (cc.n_pages if cc.n_pages is not None
                   else ecfg.batch_slots * -(-ecfg.max_len // cc.page_size))
        self.cache = PagedKVCache(model, lanes=ecfg.batch_slots, n_pages=n_pages,
                                  page_size=cc.page_size, max_len=ecfg.max_len,
                                  device=self.device)
        chunk = ac.prefill_chunk if model.supports_chunked_prefill else 0
        self.sched = Scheduler(SchedulerConfig(policy=ac.policy, prefill_chunk=chunk))
        self.completed: list[Request] = []
        self.pipeline = AdmissionPipeline(self, ac.async_prefill)
        self._idle_since: float | None = None
        self._idle_pipe_mark = -1

    def __del__(self):
        pipeline = getattr(self, "pipeline", None)
        if pipeline is not None:
            pipeline.shutdown()

    def _inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    # -- request handling ------------------------------------------------------

    def submit(self, req: Request):
        need = self.cache.pages_for(len(req.prompt) + 1)
        if len(req.prompt) >= self.ecfg.max_len - 1:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens exceeds the "
                f"{self.ecfg.max_len}-token context limit")
        if need > self.cache.n_pages:
            raise ValueError(f"prompt needs {need} pages, pool has {self.cache.n_pages}")
        with self._lock:
            self.sched.add(req)
            self._cv.notify_all()
        self.pipeline.kick()

    # -- prefill (called by the admission pipeline, OUTSIDE the lock) ---------

    @admission_api
    def _fresh_prefill_tree(self):
        """Private single-request cache a chunked prefill computes into (seq
        leaves at full per-lane capacity); written into the reserved pages
        by the decode loop at lane assignment."""
        return tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=self.device),
            self.model.cache_specs(1, self.cache.capacity))

    @admission_api
    def run_prefill(self, st, chunk: int) -> bool:
        """Advance ``st``'s prefill by one work unit (a chunk, or the whole
        prompt when chunking is off).  Pure compute on private state;
        returns True when the prefill is complete."""
        if self.sched.cfg.prefill_chunk <= 0:
            toks = torch.as_tensor(st.resume_tokens, dtype=torch.long,
                                   device=self.device)[None]
            logits, st.prefill_cache = self.model.prefill(self.params, toks)
            st.prefilled = len(st.resume_tokens)
            st.last_logits = logits[0, -1]
            return True
        if st.prefill_cache is None:
            st.prefill_cache = self._fresh_prefill_tree()
        toks = st.resume_tokens[st.prefilled: st.prefilled + chunk]
        logits, st.prefill_cache = self.model.extend_step(
            self.params, st.prefill_cache,
            torch.as_tensor(toks, dtype=torch.long, device=self.device)[None],
            st.prefilled)
        st.prefilled += len(toks)
        st.last_logits = logits[0, -1]
        return st.remaining_prefill == 0

    @admission_api
    def sample_prefill_token(self, st) -> int:
        """The prefill's one host-blocking read (on the pipeline's thread in
        async mode, so it never stalls a decode step)."""
        if st.is_resume:
            # recompute-resume: the continuation token was sampled before
            # preemption — the re-derived logits are discarded
            return int(st.req.out_tokens[-1])
        return prefill_logits_token(st.last_logits)

    @admission_api
    def finish_prefill(self, st, tok: int) -> bool:
        """Queue bookkeeping after a finished prefill (under the lock):
        requests that end on their first token retire without a lane;
        everything else goes to ready.  Returns True if retired."""
        st.length = len(st.resume_tokens)
        req = st.req
        st.pending_token = tok
        if st.is_resume:
            self.sched.to_ready(st)
            return False
        req.out_tokens.append(tok)
        if len(req.out_tokens) >= req.max_new_tokens:
            self.sched.admitting.remove(st)
            self._retire(st)
            return True
        self.sched.to_ready(st)
        return False

    @admission_api
    def _retire(self, st):
        """Retirement bookkeeping shared by both threads: queues, free list,
        held buffers — never lane or pool state (``_retire_lane`` releases
        those first for a request that held a lane)."""
        with self._lock:
            assert st.lane < 0, "retiring a laned request: use _retire_lane"
            st.req.done = True
            self.cache.allocator.release(st.pages)
            st.pages = []
            st.prefill_cache = None
            st.last_logits = None
            st.phase = "done"
            self.completed.append(st.req)
            self._cv.notify_all()        # freed pages: admissions may resume

    @decode_loop_only
    def _retire_lane(self, st):
        with self._lock:
            self.cache.clear_lane(st.lane)
            self.sched.running.pop(st.lane, None)
            st.lane = -1
        self._retire(st)

    # -- lane assignment and decode (decode loop only) -------------------------

    @decode_loop_only
    def _fill_lanes(self) -> bool:
        """Drain the ready queue into free decode lanes and fold the
        pipeline's private prefill caches into the pools."""
        s = self.sched
        with self._lock:
            free_lanes = [l for l in range(self.ecfg.batch_slots) if l not in s.running]
            take = []
            while s.ready and free_lanes:
                st = s.ready.pop(0)
                st.lane = free_lanes.pop(0)
                st.phase = "running"
                s.running[st.lane] = st
                take.append(st)
            if take:
                self._cv.notify_all()    # ready drained: backpressure lifts
        for st in take:
            self.cache.assign_lane(st.lane, st.pages)
            self.cache.write_prefill(st.pages, st.prefill_cache, lane=st.lane)
            st.prefill_cache = None
        return bool(take)

    @decode_loop_only
    def _ensure_pages(self):
        """Every running lane needs a page slot for its next write position.
        Reserve what the free pool covers, pick victims for the shortfall
        (longest-running first), evict them as one batch, then grow the
        surviving lanes.  Under the engine lock."""
        s, cache = self.sched, self.cache
        alloc = cache.allocator
        ps = cache.page_size
        with self._lock:
            grow = {lane: max(0, st.length // ps + 1 - len(st.pages))
                    for lane, st in s.running.items()}
            if not any(grow.values()):
                return
            hold = alloc.acquire(min(sum(grow.values()), alloc.n_free)) or []
            victims: list = []

            def shortfall() -> int:
                want = sum(n for lane, n in grow.items()
                           if s.running[lane] not in victims)
                freed = sum(len(v.pages) for v in victims)
                return want - len(hold) - alloc.n_free - freed

            while shortfall() > 0:
                cands = [st for st in s.running.values() if st not in victims]
                # evicting the last running lane only helps when an admitted
                # or ready request holds the missing pages
                if len(cands) <= 1 and not (s.ready or s.admitting):
                    alloc.release(hold)
                    raise RuntimeError(
                        "page pool exhausted with no preemptible request — "
                        "grow CacheConfig.n_pages")
                if not cands:
                    break
                victims.append(max(cands, key=lambda st: len(st.req.out_tokens)))
            if victims:
                s.preempt_batch(victims, cache)
                self._cv.notify_all()    # freed pages: admissions may resume
            for lane in sorted(s.running):
                st = s.running[lane]
                for _ in range(grow.get(lane, 0)):
                    page = hold.pop() if hold else alloc.acquire(1)[0]
                    cache.extend_lane(lane, page, len(st.pages))
                    st.pages.append(page)
            if hold:
                alloc.release(hold)

    @decode_loop_only
    @pool_mutator("pools")
    def _decode_lanes(self):
        s, b = self.sched, self.ecfg.batch_slots
        tokens = np.zeros((b, 1), np.int64)
        positions = np.zeros((b,), np.int64)
        active = np.zeros((b,), bool)
        for lane, st in s.running.items():
            tokens[lane, 0] = st.pending_token
            positions[lane] = st.length
            active[lane] = True
        n_active = int(active.sum())
        dev = self.device
        bt = torch.from_numpy(self.cache.block_tables).to(dev)
        tokens = torch.from_numpy(tokens).to(dev)
        positions = torch.from_numpy(positions).to(dev)
        active = torch.from_numpy(active).to(dev)
        if self.ecfg.cache.decode_path == "gather":
            views = gather_views(self.cache.pools, bt)
            logits, new_views = self.model.decode_step(self.params, views, tokens, positions)
            self.cache.pools = absorb_decode(self.cache.pools, new_views, bt, positions,
                                             active, self.cache.page_size)
        else:
            logits, self.cache.pools = self.model.decode_step_paged(
                self.params, self.cache.pools, bt, tokens, positions, active)
        # greedy tokens come off the device as B ints, not B vocab rows
        greedy = logits[:, 0].argmax(-1).cpu().numpy()
        done = 0
        for lane in sorted(s.running):
            st = s.running[lane]
            req = st.req
            tok = int(greedy[lane])
            req.out_tokens.append(tok)
            st.length += 1
            st.pending_token = tok
            done += 1
            if (len(req.out_tokens) >= req.max_new_tokens
                    or st.length >= self.ecfg.max_len - 1):
                self._retire_lane(st)
        with self._lock:
            self._counters["decode_tokens"] += done
            self._counters["lane_step_sum"] += n_active

    # -- step loop -------------------------------------------------------------

    @decode_loop_only
    def step(self) -> bool:
        """One decode-loop round: (sync mode: pump the admission pipeline) →
        drain ready into lanes → one batched decode step.  Returns False when
        the engine is drained."""
        if self.pipeline.error is not None:
            err, self.pipeline.error = self.pipeline.error, None
            raise RuntimeError("admission pipeline died") from err
        s, ac = self.sched, self.ecfg.admission
        with self._lock:
            idle = s.load == 0
        if idle:
            # park the worker OUTSIDE the lock: the join waits for the worker,
            # which needs the lock to leave its cv.wait
            self.pipeline.shutdown()
            return False
        budget = max((ac.max_step_tokens or (1 << 30)) - len(s.running), 0)
        if ac.async_prefill:
            self.pipeline.kick()
            progressed = False
        else:
            progressed = self.pipeline.pump(budget)
        progressed = self._fill_lanes() or progressed
        if s.running:
            self._ensure_pages()
            if s.running:        # _ensure_pages may have evicted every lane
                self._decode_lanes()
            progressed = True
        with self._lock:
            self._counters["steps"] += 1
            self._counters["lane_slot_sum"] += self.ecfg.batch_slots
            occ = self.cache.occupancy()
            self._occ_sum += occ
            self._occ_max = max(self._occ_max, occ)
        if progressed:
            self._idle_since = None
            return True
        if not ac.async_prefill:
            if s.load:
                raise RuntimeError(
                    "scheduler stalled: waiting requests cannot be admitted "
                    "(page pool too small for the oldest request?)")
            return True
        # async: the pipeline holds all in-flight work — wait for a hand-off
        # instead of spinning; the watchdog resets whenever the pipeline
        # progresses
        now = time.monotonic()
        with self._lock:
            pipe_mark = sum(v for k, v in self._counters.items()
                            if k.startswith("pipeline."))
        if self._idle_since is None or pipe_mark != self._idle_pipe_mark:
            self._idle_since = now
            self._idle_pipe_mark = pipe_mark
        elif now - self._idle_since > 60.0:
            raise RuntimeError(
                "decode loop idle >60s with no admission-pipeline progress "
                f"(load={s.load}, admitting={len(s.admitting)})")
        with self._lock:
            if s.load and not s.ready and not s.running:
                self._cv.wait(timeout=0.01)
        return True

    @decode_loop_only
    def run(self) -> list[Request]:
        done_mark = len(self.completed)
        while self.load:
            self.step()
        self.pipeline.shutdown()
        return self.completed[done_mark:]

    # -- telemetry -------------------------------------------------------------

    @property
    def load(self) -> int:
        with self._lock:
            return self.sched.load

    @property
    def stats(self) -> dict:
        """The JAX engine's ``stats`` keys, from one lock cut (a copy)."""
        with self._lock:
            c = self._counters
            return {
                "steps": c["steps"],
                "prefill_tokens": c["prefill_tokens"],
                "decode_tokens": c["decode_tokens"],
                "occupancy_sum": self._occ_sum,
                "occupancy_max": self._occ_max,
                "lane_step_sum": c["lane_step_sum"],
                "lane_slot_sum": c["lane_slot_sum"],
            }

    def telemetry(self) -> dict:
        with self._lock:
            c = dict(self._counters)
            st = {
                "steps": c["steps"],
                "prefill_tokens": c["prefill_tokens"],
                "decode_tokens": c["decode_tokens"],
                "queue_depth": self.sched.queue_depth(),
                "admitting": len(self.sched.admitting),
                "ready": len(self.sched.ready),
                "running": len(self.sched.running),
                "preemptions": self.sched.n_preemptions,
                "occupancy_mean": self._occ_sum / c["steps"] if c["steps"] else 0.0,
                "occupancy_max": self._occ_max,
                "page_occupancy": self.cache.occupancy(),
            }
        st["lane_utilization"] = (c["lane_step_sum"] / c["lane_slot_sum"]
                                  if c["lane_slot_sum"] else 0.0)
        st["async_prefill"] = self.ecfg.admission.async_prefill
        st["pipeline"] = {k[len("pipeline."):]: v for k, v in c.items()
                          if k.startswith("pipeline.")}
        st["device"] = str(self.device)
        return st
