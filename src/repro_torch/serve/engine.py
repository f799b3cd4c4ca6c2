"""Paged continuous-batching serving engine, two-loop form (the port of
``repro/serve/engine.py``).

* The **decode loop** (``step``/``run``, the caller's thread) owns the page
  pools and block tables exclusively: lane assignment (with the scatter of
  restored and prefix pages), page growth, copy-on-write forks, batched
  preemption (swap to the host tier, or recompute) and the batched decode
  step.  The decode path is
  ``CacheConfig.decode_path``: ``"paged"`` (default) runs
  ``DecoderLM.decode_step_paged`` (the paged-decode kernel for GQA
  attention layers, ``paged_gather`` and a plain read for the hybrid's
  local attention layers and for MLA's latent pages, per-lane state steps
  for the ssm and RG-LRU layers), ``"gather"`` gathers the
  pools into dense per-lane views (the ``paged_gather`` kernel), runs the
  dense ``DecoderLM.decode_step`` and folds its updates back
  (``absorb_decode``): the oracle the paged path is held against.  A
  ``VLM`` serves text requests as the dense family does (the engine takes
  no image input, as the reference's takes none); a model without
  ``decode_step_paged`` (the audio family's ``EncDecLM``) is refused on
  the paged path with the reference's ``TypeError``.
* The **admission pipeline** (``serve.admission.AdmissionPipeline``) runs
  prefill (whole prompt, or chunks through ``extend_step``; both run the
  flash kernel, the ``ssd_scan`` kernel for ssm layers and the plain
  RG-LRU scan for rec layers), host-tier restores and prefix matches on a
  worker thread (``AdmissionConfig.async_prefill``, default on) or inline,
  computing into *private* per-request tensors and handing finished
  requests to the decode loop through the ready queue.

Memory tiers (``CacheConfig``): ``preempt_policy="swap"`` (the default, as
in the JAX package) moves a victim's pages to a host tier of
``host_pages`` (default twice the device pool) and restores them on
resume, the swap-out read through one ``paged_gather`` launch;
``"recompute"`` frees them and prefills again.  ``prefix_sharing`` (off by
default) indexes finished prompts page by page, so a request whose prompt
starts with a resident prefix shares its pages (copy-on-write at the first
divergent write) and prefills only the rest; cold prefix pages retire into
the host tier.

Shared bookkeeping (queues, free lists, counters in a ``MetricsRegistry``
sharing the engine lock) lives under one engine lock; no tensor work runs
inside it, except the batched swap-out and the fork copy, as in the JAX
package.  Both pipeline modes give identical tokens.

Sampling: a decode step draws the token of a lane whose request has
``temperature > 0`` from ``softmax(logits / temperature)`` under the
``torch.Generator`` that ``step``/``run`` are given (on the generator's
device, in sorted lane order); with no generator every lane is greedy, and
the prefill's token is greedy whatever the temperature, as in the JAX
package.  ``EngineConfig.eos_id`` ends a request at that token, at prefill
or in decode.

Observability (``ObsConfig``): ``trace=True`` records engine steps, decode
batches, prefill chunks, swaps, admissions, preemptions, prefix events and
every request's phase edges into a ring-buffer tracer (``save_trace``
writes Perfetto JSON); ``trace_annotations=True`` wraps each decode call in
a ``torch.profiler.record_function("decode.batch")`` range.  With
``REPRO_SANITIZE=1`` (or ``analysis.sanitizer.enable()``) the ownership
markers check threads, the engine lock and page epochs at run time.

The decode step (``_decode_impl``, the reference's jitted function) runs
on static buffers (``serve.captured.CapturedDecode``): on the card it is
captured once per engine, at construction, as one CUDA graph and replayed
each step (``EngineConfig.cuda_graph=False`` runs the same buffers
eagerly); the step reads nothing back (idle lanes' cache writes are dropped
on the card by ``paged_write``), and sampling runs after it on its logits
rows.  Chunked prefill (the reference's jitted ``_extend``) computes into
one of ``admission_inflight`` prefill slots, private cache trees allocated
once (``serve.captured.CapturedExtend``): each full chunk is a replay of the
slot's CUDA graph, captured at construction too, the tail chunk of a prompt
runs eagerly on the slot, and the moe family runs every chunk eagerly.

The engine runs on the card unless ``device="cpu"`` is passed (then every
kernel runs its plain PyTorch version); the parameters must already live on
that device.  Inter-cube migration is put-then-signal, as in the JAX
package: ``export_request`` (withdraw) or ``checkpoint_request`` (a
non-destructive read, the running lane's pages through one ``paged_gather``
launch) gives a payload; ``migrate_put``/``migrate_signal`` land it in
another engine's host tier and commit it, and ``poll_migrations`` (top of
every step) schedules it as a swapped request, whose restore writes the
pools in place; ``shadow_put``/``shadow_signal``/``adopt_shadow`` keep and
promote standby checkpoints.  The
engine is generic over the model's cache tree: any mix of seq leaves (pages)
and per-lane state leaves, over any number of segments.  A state-only model (ssm)
still acquires pages per token, as in the JAX package, so page accounting,
preemption and step counts match it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.analysis import sanitizer
from repro_torch.analysis.ownership import (
    admission_api,
    captured_step,
    decode_loop_only,
    pool_mutator,
)
from repro_torch.device import resolve
from repro_torch.obs import clock as obs_clock
from repro_torch.obs.export import write_chrome_trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, ServeTracer

from .admission import AdmissionPipeline, prefill_logits_token
from .captured import CapturedDecode, CapturedExtend
from .paged_cache import PagedKVCache, absorb_decode, gather_views
from .scheduler import RequestState, Scheduler, SchedulerConfig


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0         # > 0: sampled in decode under a generator
    out_tokens: list = field(default_factory=list)
    done: bool = False


@dataclass
class CacheConfig:
    """Paged-KV memory: device pool, host tier, preemption, decode path,
    prefix sharing."""

    page_size: int = 16
    n_pages: int | None = None      # None → batch_slots * max_len / page_size
    host_pages: int | None = None   # host-tier size; None → 2x n_pages when
    #                                 preempt_policy='swap', else 0 (no tier)
    # 'swap' moves a victim's pages to the host tier and restores them on
    # resume (recompute when the tier is exhausted or the cost model says
    # so); 'recompute' frees them and prefills prompt + generated again
    preempt_policy: str = "swap"
    swap_token_cost: float = 0.25   # moving one token of KV relative to
    #                                 recomputing it (0: always swap)
    # 'paged' hands block tables straight to the model (decode_step_paged);
    # 'gather' materializes dense per-lane views, decodes and scatters the
    # written column back: the oracle the paged path is held against
    decode_path: str = "paged"
    # a radix index over page-sized prompt chunks: admissions share resident
    # prefix pages (refcounted, copy-on-write); cold prefixes retire into the
    # host tier.  Off by default, so throughput runs don't include cache hits
    prefix_sharing: bool = False


@dataclass
class AdmissionConfig:
    """Scheduler + admission-pipeline policy knobs."""

    policy: str = "fcfs"            # fcfs | spf
    # per-step token budget (decode + prefill), 0 = unbounded; paces the
    # sync pipeline's inline prefill, bounds decode lanes only in async mode
    max_step_tokens: int = 0
    prefill_chunk: int = 0          # 0 = whole-prompt prefill
    # True runs prefill and restores on a worker thread feeding the ready
    # queue; False runs the identical pipeline inline each step
    async_prefill: bool = True
    # backpressure: admissions (pages reserved, private tensors held) not
    # yet decoding; raise it to keep a deeper ready queue
    admission_inflight: int = 2


@dataclass
class ObsConfig:
    """Observability knobs."""

    # record engine, admission, swap and phase events into a preallocated
    # ring buffer (``ServeEngine.save_trace`` writes Perfetto JSON); off,
    # every record call is one flag check through the shared NULL_TRACER
    trace: bool = False
    trace_capacity: int = 1 << 15   # ring slots; wraparound drops the oldest
    # wrap each decode call in a torch.profiler.record_function range, so a
    # device profile lines up with the host-side trace
    trace_annotations: bool = False


def _flat_map() -> dict[str, str]:
    return {
        **{f.name: "cache" for f in dataclasses.fields(CacheConfig)},
        **{f.name: "admission" for f in dataclasses.fields(AdmissionConfig)},
        **{f.name: "obs" for f in dataclasses.fields(ObsConfig)},
    }


_FLAT_MAP = _flat_map()
_warned_flat: set[str] = set()


@dataclass(init=False)
class EngineConfig:
    """Engine configuration: four top-level knobs and the three groups.
    Flat keywords (``EngineConfig(page_size=4)``) are still taken, as the
    reference takes them: each is routed onto its group with a
    ``DeprecationWarning`` once per knob, and every flat name is a property
    that reads and writes the group, so ``dataclasses.replace(ecfg,
    n_pages=8)`` works.  An unknown keyword raises ``TypeError``."""

    batch_slots: int = 4            # decode lanes
    max_len: int = 256              # per-request context capacity
    eos_id: int | None = None       # a request ends at this token
    # a card engine replays its decode step and its full prefill chunks as
    # CUDA graphs captured at construction (the reference jits them); False
    # runs the same static-buffer steps eagerly (an A/B baseline, or a
    # profile that wants record_function ranges inside a step).  A CPU
    # engine ignores it
    cuda_graph: bool = True
    cache: CacheConfig = field(default_factory=CacheConfig)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)

    def __init__(self, batch_slots: int = 4, max_len: int = 256, eos_id: int | None = None,
                 cuda_graph: bool = True, cache: CacheConfig | None = None,
                 admission: AdmissionConfig | None = None, obs: ObsConfig | None = None,
                 **flat):
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.cuda_graph = cuda_graph
        self.cache = cache if cache is not None else CacheConfig()
        self.admission = admission if admission is not None else AdmissionConfig()
        self.obs = obs if obs is not None else ObsConfig()
        groups: dict[str, dict] = {"cache": {}, "admission": {}, "obs": {}}
        for k, v in flat.items():
            g = _FLAT_MAP.get(k)
            if g is None:
                raise TypeError(f"EngineConfig got an unexpected keyword argument {k!r}")
            if k not in _warned_flat:
                _warned_flat.add(k)
                warnings.warn(f"EngineConfig({k}=...) is deprecated; use "
                              f"EngineConfig({g}={g.capitalize()}Config({k}=...))",
                              DeprecationWarning, stacklevel=2)
            groups[g][k] = v
        for g, knobs in groups.items():
            if knobs:
                setattr(self, g, dataclasses.replace(getattr(self, g), **knobs))


def _flat_property(group: str, name: str):
    def get(self):
        return getattr(getattr(self, group), name)

    def set_(self, value):
        setattr(getattr(self, group), name, value)

    return property(get, set_)


for _name, _group in _FLAT_MAP.items():
    setattr(EngineConfig, _name, _flat_property(_group, _name))
del _name, _group


class ServeEngine:
    """Greedy and temperature sampling over the DecoderLM serving API, backed
    by a paged KV cache, a request scheduler and an admission pipeline."""

    def __init__(self, model, params, ecfg: EngineConfig, device=None):
        cc, ac = ecfg.cache, ecfg.admission
        if cc.decode_path not in ("paged", "gather"):
            raise ValueError(f"unknown decode_path: {cc.decode_path!r}")
        if cc.preempt_policy not in ("swap", "recompute"):
            raise ValueError(f"unknown preempt_policy: {cc.preempt_policy!r}")
        if cc.decode_path == "paged" and not hasattr(model, "decode_step_paged"):
            raise TypeError(f"{type(model).__name__} has no decode_step_paged; serve it "
                            "with decode_path='gather'")
        self.device = resolve(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"parameters live on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        self.model = model
        self.params = params
        self.ecfg = ecfg
        self.cfg = model.cfg
        # ONE bookkeeping lock shared by the decode loop and the admission
        # pipeline; the condition variable signals hand-offs both ways so
        # neither loop spins.  Created first: the metrics registry shares it
        # (one-lock telemetry cuts) and the cache and host tier count
        # through the registry.
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self.metrics = MetricsRegistry(lock=self._lock)
        oc = ecfg.obs
        self.tracer: ServeTracer = (ServeTracer(capacity=oc.trace_capacity) if oc.trace
                                    else NULL_TRACER)
        self._annot = ((lambda: torch.profiler.record_function("decode.batch"))
                       if oc.trace_annotations else contextlib.nullcontext)
        n_pages = (cc.n_pages if cc.n_pages is not None
                   else ecfg.batch_slots * -(-ecfg.max_len // cc.page_size))
        host_pages = cc.host_pages
        if host_pages is None:
            # host memory is the big tier: twice the device pool, so swap
            # preemption rarely hits the exhaustion fallback
            host_pages = 2 * n_pages if cc.preempt_policy == "swap" else 0
        self.cache = PagedKVCache(model, lanes=ecfg.batch_slots, n_pages=n_pages,
                                  page_size=cc.page_size, max_len=ecfg.max_len,
                                  device=self.device, host_pages=host_pages,
                                  metrics=self.metrics, prefix_sharing=cc.prefix_sharing)
        chunk = ac.prefill_chunk if model.supports_chunked_prefill else 0
        # the decode step and the prefill slots' extend on static buffers,
        # captured before the admission pipeline's thread exists (nothing
        # else runs on the card meanwhile)
        capture = self.device.type == "cuda" and ecfg.cuda_graph
        self.decode_graph = CapturedDecode(
            lambda *inputs: self._decode_impl(self.params, self.cache.pools, *inputs)[0],
            self.cache.pools, ecfg.batch_slots, self.cache.pages_per_lane,
            model.cfg.padded_vocab, model.cfg.torch_dtype, self.device, capture=capture)
        self.prefill_slots: CapturedExtend | None = None
        if chunk > 0:
            # the moe family's extend sizes its dispatch slab by a host read
            # (MOE_DISPATCH["extend"]'s trim; untrimmed, every expert would
            # run a chunk-long slab), which a graph cannot hold: its chunks
            # run eagerly on the same slots
            static = model.cfg.family != "moe"
            self.prefill_slots = CapturedExtend(
                lambda params, tree, tokens, position: model.extend_step(
                    params, tree, tokens, position, last_only=True)[0],
                params, model.cache_specs(1, self.cache.capacity), ac.admission_inflight,
                chunk, model.cfg.padded_vocab, model.cfg.torch_dtype, self.device,
                static=static, capture=capture and static)
        self.sched = Scheduler(SchedulerConfig(
            policy=ac.policy, prefill_chunk=chunk,
            max_inflight_prefills=ac.admission_inflight,
            preempt_policy=cc.preempt_policy, swap_token_cost=cc.swap_token_cost),
            tracer=self.tracer)
        self.completed: list[Request] = []
        # engine counters, made up front so hot paths inc without a registry
        # lookup; lane_step/lane_slot: active lanes against capacity, summed
        # per step (1 - their ratio is the decode idle fraction)
        m = self.metrics
        self._c_steps = m.counter("steps")
        self._c_prefill = m.counter("prefill_tokens")
        self._c_decode = m.counter("decode_tokens")
        self._c_lane_step = m.counter("lane_step_sum")
        self._c_lane_slot = m.counter("lane_slot_sum")
        self._h_occ = m.histogram("occupancy", tuple(i / 10 for i in range(1, 11)))
        self._g_occ = m.gauge("occupancy")
        self._h_step = m.histogram("step_latency_s")
        self._h_queue = m.histogram("queue_wait_s")
        sanitizer.register_engine(self)
        self.pipeline = AdmissionPipeline(self, ac.async_prefill)
        self._idle_since: float | None = None
        self._idle_pipe_mark = -1
        # inter-cube migration landing zones (serve/cube_proc.py), both
        # put-then-signal: the put (migrate_put / shadow_put) lands page
        # payloads in the host tier while the decode loop keeps stepping, the
        # signal (migrate_signal / shadow_signal) flips ``committed``, and
        # only committed entries are acted on (poll_migrations /
        # adopt_shadow), so a sender killed mid-transfer leaves nothing half
        # adopted.  _shadows are standby checkpoints of requests running on
        # ANOTHER cube, adopted only if that cube dies
        self._migrations: dict[object, dict] = {}
        self._shadows: dict[int, dict] = {}
        self._c_migr_in = m.counter("migrate.landed")
        self._c_migr_resumed = m.counter("migrate.resumed")
        self._c_migr_fresh = m.counter("migrate.fresh_fallbacks")

    def __del__(self):
        pipeline = getattr(self, "pipeline", None)
        if pipeline is not None:
            pipeline.shutdown()

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

    # -- inter-cube migration (put-then-signal; see serve/cube_proc.py) -------

    def _land_payload(self, payload: dict) -> dict:
        """Land a migration payload's data half in the host tier and return
        the internal entry.  A ``kind='pages'`` payload degrades to ``fresh``
        (prompt resubmission, token-identical under greedy decoding) when the
        host tier is absent or exhausted."""
        entry = {
            "uid": int(payload["uid"]),
            "prompt": np.asarray(payload["prompt"], np.int32),
            "max_new_tokens": int(payload["max_new_tokens"]),
            "temperature": float(payload["temperature"]),
            "out_tokens": [int(t) for t in payload["out_tokens"]],
            "handle": None,
            "committed": False,
        }
        if payload["kind"] == "pages":
            handle = self.cache.host_import(payload["seq"], payload["state"],
                                            int(payload["length"]), int(payload["n_pages"]))
            if handle is not None:
                entry["handle"] = handle
                entry["pending_token"] = int(payload["pending_token"])
            else:
                self._c_migr_fresh.inc()
        self._c_migr_in.inc()
        return entry

    def migrate_put(self, token, payload: dict) -> str:
        """The *put* half of an inter-cube request migration: land the
        payload (page rows → host tier) under ``token``, invisible to the
        scheduler until :meth:`migrate_signal` commits it.  Returns the
        landed kind (``'pages'``, or ``'fresh'`` after a degrade)."""
        with self._lock:
            old = self._migrations.pop(token, None)
            if old is not None and old["handle"] is not None:
                self.cache.host_free(old["handle"])
            entry = self._land_payload(payload)
            self._migrations[token] = entry
        return "pages" if entry["handle"] is not None else "fresh"

    def migrate_signal(self, token) -> None:
        """The *signal* half: commit a landed migration; the decode loop's
        :meth:`poll_migrations` (top of every step) schedules it."""
        with self._lock:
            entry = self._migrations.get(token)
            if entry is None:
                raise KeyError(f"migrate_signal({token!r}): no landed put")
            entry["committed"] = True
            self._cv.notify_all()

    def pending_migrations(self) -> int:
        """Committed but unscheduled migrations (a cube worker's cheap
        should-I-step signal)."""
        with self._lock:
            return sum(1 for m in self._migrations.values() if m["committed"])

    def _schedule_entry(self, entry: dict) -> None:
        """Turn a committed migration entry into a scheduled request at the
        FRONT of the waiting queue (it already holds progress, as a
        preemption requeue does).  Under the lock."""
        req = Request(uid=entry["uid"], prompt=entry["prompt"],
                      max_new_tokens=entry["max_new_tokens"],
                      temperature=entry["temperature"], out_tokens=list(entry["out_tokens"]))
        state = RequestState(req=req, resume_tokens=np.asarray(req.prompt, np.int32),
                             tracer=self.tracer, submit_ts=obs_clock.monotonic())
        if entry["handle"] is not None:
            # the page path: a local swap-preempted request to the scheduler,
            # so the ordinary swapped restore (stage_in, then commit_swap_in
            # into the existing pool storage) takes over
            state.swapped = True
            state.swap_handle = entry["handle"]
            state.length = entry["handle"].length
            state.pending_token = entry["pending_token"]
            self._c_migr_resumed.inc()
        elif req.out_tokens:
            # fresh fallback with progress: the recompute restart (prefill
            # prompt + generated again, keep the sampled tokens)
            state.resume_tokens = np.concatenate([
                np.asarray(req.prompt, np.int32), np.asarray(req.out_tokens[:-1], np.int32)])
            state.is_resume = True
        self.sched.waiting.insert(0, state)

    @decode_loop_only
    def poll_migrations(self) -> int:
        """Schedule every committed migration (the top of each decode step,
        and a cube worker's loop).  Returns the number scheduled."""
        with self._lock:
            ready = [t for t, m in self._migrations.items() if m["committed"]]
            for t in ready:
                self._schedule_entry(self._migrations.pop(t))
            if ready:
                self._cv.notify_all()
        if ready:
            self.pipeline.kick()
        return len(ready)

    # shadow checkpoints: standby copies of requests running elsewhere ------

    def shadow_put(self, uid: int, payload: dict) -> str:
        """Land a standby checkpoint for ``uid`` (a request running on another
        cube), replacing any earlier shadow of the uid and freeing its host
        pages."""
        uid = int(uid)
        with self._lock:
            old = self._shadows.pop(uid, None)
            if old is not None and old["handle"] is not None:
                self.cache.host_free(old["handle"])
            entry = self._land_payload(payload)
            self._shadows[uid] = entry
        return "pages" if entry["handle"] is not None else "fresh"

    def shadow_signal(self, uid: int) -> None:
        with self._lock:
            entry = self._shadows.get(int(uid))
            if entry is None:
                raise KeyError(f"shadow_signal({uid}): no landed put")
            entry["committed"] = True

    @decode_loop_only
    def adopt_shadow(self, uid: int) -> bool:
        """Schedule a COMMITTED shadow (its cube died).  False when no
        committed shadow exists: the caller resubmits the prompt instead."""
        with self._lock:
            entry = self._shadows.get(int(uid))
            if entry is None or not entry["committed"]:
                return False
            self._shadows.pop(int(uid))
            self._schedule_entry(entry)
            self._cv.notify_all()
        self.pipeline.kick()
        return True

    def drop_shadow(self, uid: int) -> None:
        """Discard a shadow (its request completed) and free its pages."""
        with self._lock:
            entry = self._shadows.pop(int(uid), None)
            if entry is not None and entry["handle"] is not None:
                self.cache.host_free(entry["handle"])

    @staticmethod
    def _fresh_payload(req) -> dict:
        return {"kind": "fresh", "uid": req.uid, "prompt": np.asarray(req.prompt, np.int32),
                "max_new_tokens": req.max_new_tokens, "temperature": req.temperature,
                "out_tokens": [int(t) for t in req.out_tokens]}

    def _pages_payload(self, st, seq, state, length: int, n_pages: int) -> dict:
        return {**self._fresh_payload(st.req), "kind": "pages", "length": length,
                "n_pages": n_pages, "pending_token": int(st.pending_token),
                "seq": seq, "state": state}

    def _handle_payload(self, st) -> dict:
        seq, state, length, n_pages = self.cache.host_export(st.swap_handle)
        return self._pages_payload(st, seq, state, length, n_pages)

    @decode_loop_only
    def checkpoint_request(self, uid: int) -> dict | None:
        """Non-destructive migration payload of an in-flight request (the
        shadow-checkpoint read): a running request's pages and lane state
        are read off the device (no preemption, no state change), a swapped
        one's off its host pages, a queued one travels as a fresh prompt.
        None when ``uid`` is not in flight."""
        with self._lock:
            for st in self.sched.running.values():
                if st.req.uid == uid:
                    # a router's shadow checkpoint, on the decode loop that owns the pages:
                    # repro-lint: skip[no-device-work-under-lock] as the reference reads them
                    rows, state = self.cache.export_pages(st.pages, st.lane, st.length)
                    return self._pages_payload(st, rows, state, st.length, len(st.pages))
            for st in self.sched.waiting:
                if st.req.uid == uid:
                    return self._handle_payload(st) if st.swapped else self._fresh_payload(st.req)
        return None

    @decode_loop_only
    def export_request(self, uid: int) -> dict | None:
        """WITHDRAW an in-flight request and return its migration payload (a
        router draining a straggler).  A running request is swap-preempted
        first, so its pages land in the host tier; a request mid-admission
        (the pipeline computing into its private tensors) is left alone and
        None returned: it finishes where it is."""
        with self._lock:
            st = None
            for cand in self.sched.running.values():
                if cand.req.uid == uid:
                    st = cand
                    break
            if st is not None:
                self.sched.preempt(st, self.cache)
            for cand in self.sched.waiting:
                if cand.req.uid == uid:
                    st = cand
                    break
            else:
                return None
            if st.swapped:
                payload = self._handle_payload(st)
                self.cache.host_free(st.swap_handle)
                st.swap_handle = None
                st.swapped = False
            else:
                payload = self._fresh_payload(st.req)
            self.sched.waiting.remove(st)
            self.sched.retire_uid(uid)
            return payload

    # -- prefill (called by the admission pipeline, OUTSIDE the lock) ---------

    @admission_api
    def _take_prefill_slot(self, st) -> None:
        """Give ``st`` a prefill slot, zeroed: the private single-request
        cache its chunked prefill computes into (seq leaves at full per-lane
        capacity), written into its reserved pages by the decode loop at
        lane assignment."""
        with self._lock:
            # the scheduler's bound counts admitting + ready requests, and a
            # request leaves ready before the decode loop has written its
            # slot into the pages: in async mode wait for that write (sync
            # mode writes before it admits again)
            while self.pipeline.async_mode and not self.prefill_slots.n_free:
                self._cv.wait()
            st.prefill_slot = self.prefill_slots.take()
        st.prefill_cache = self.prefill_slots.trees[st.prefill_slot]
        self.prefill_slots.zero(st.prefill_slot)

    @admission_api
    def _drop_prefill_cache(self, st) -> None:
        """Let go of ``st``'s prefill tree, and of its slot: after the
        decode loop has written it into the pages, or when the request
        retires."""
        st.prefill_cache = None
        if st.prefill_slot >= 0:
            with self._lock:
                self.prefill_slots.release(st.prefill_slot)
                self._cv.notify_all()
            st.prefill_slot = -1

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
            self._take_prefill_slot(st)
            claim = st.prefix_claim
            if claim is not None and claim.seed_pages:
                # partial prefix hit: the shared pages' rows go into the
                # slot's tree, so the extend resumes at the matched offset
                # (st.prefilled was set to it at admission)
                self.cache.seed_prefix(st.prefill_cache, st.pages[: claim.seed_pages])
        toks = st.resume_tokens[st.prefilled: st.prefilled + chunk]
        # a full chunk replays the slot's graph; a shorter one runs eagerly
        st.last_logits = self.prefill_slots(st.prefill_slot, st.prefill_cache, self.params,
                                            toks, st.prefilled)
        st.prefilled += len(toks)
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
        if len(req.out_tokens) >= req.max_new_tokens or tok == self.ecfg.eos_id:
            self.sched.admitting.remove(st)
            self._retire(st)
            return True
        self.sched.to_ready(st)
        return False

    @admission_api
    def finish_match(self, st) -> bool:
        """Queue bookkeeping for a full prefix hit (under the lock): the
        prompt's pages and its stored first greedy token are in hand, so
        the request skips prefill and goes straight to ready, or retires
        when the stored token already ends it.  Returns True if retired."""
        st.length = len(st.resume_tokens)
        st.prefilled = len(st.resume_tokens)
        req = st.req
        if st.is_resume:
            # recompute-resume: the continuation token was sampled before
            # preemption — the terminal's stored token does not apply
            st.pending_token = int(req.out_tokens[-1])
            self.sched.to_ready(st)
            return False
        tok = int(st.prefix_claim.first_token)
        st.pending_token = tok
        req.out_tokens.append(tok)
        if len(req.out_tokens) >= req.max_new_tokens or tok == self.ecfg.eos_id:
            self.sched.admitting.remove(st)
            self._retire(st)
            return True
        self.sched.to_ready(st)
        return False

    @admission_api
    def _retire(self, st):
        """Retirement bookkeeping shared by both threads: queues, free lists,
        held tensors — never lane or pool state (``_retire_lane`` releases
        those first for a request that held a lane)."""
        with self._lock:
            assert st.lane < 0, "retiring a laned request: use _retire_lane"
            st.req.done = True
            # release, not free: pages shared with the prefix index (or
            # another lane) survive; only sole-owned pages hit the free list
            self.cache.allocator.release(st.pages)
            sanitizer.note_release(st)
            st.pages = []
            if st.prefix_claim is not None:
                self.cache.abort_match(st.prefix_claim)
                st.prefix_claim = None
            st.prefix_staged = None
            if st.swap_handle is not None:
                self.cache.host_free(st.swap_handle)
                st.swap_handle = None
            # a retired request pins no device memory (prefill caches,
            # staged restores, logits rows), and its per-uid counters fold
            # into their high-water marks
            self._drop_prefill_cache(st)
            st.state_cache = st.staged = None
            st.last_logits = None
            self.sched.retire_uid(st.req.uid)
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
        pipeline's private results (prefill caches, staged restores, prefix
        pages) into the pools; the decode loop is the only pools writer."""
        s = self.sched
        now = obs_clock.monotonic()
        with self._lock:
            free_lanes = [l for l in range(self.ecfg.batch_slots) if l not in s.running]
            take = []
            while s.ready and free_lanes:
                st = s.ready.pop(0)
                st.lane = free_lanes.pop(0)
                st.phase = "running"
                s.running[st.lane] = st
                # submit (or preemption requeue) → lane assignment
                self._h_queue.observe(now - st.submit_ts)
                take.append(st)
            if take:
                self._cv.notify_all()    # ready drained: backpressure lifts
        inserts: list = []
        for st in take:
            # use-after-free / ABA check: every page id the request holds is
            # live and still of the generation granted at admission
            sanitizer.verify_grant(st, self.cache.allocator)
            self.cache.assign_lane(st.lane, st.pages)
            if st.prefix_staged is not None:
                # host-retired prefix pages staged by the pipeline: scatter
                # them into their (freshly acquired) device pages
                staged, dev_pages = st.prefix_staged
                self.cache.commit_swap_in(staged, dev_pages)
                st.prefix_staged = None
            if st.staged is not None:                 # swap-in restore
                self.cache.commit_swap_in(st.staged, st.pages)
                st.staged = None
            elif st.prefill_cache is not None:        # held prefill cache
                claim = st.prefix_claim
                skip = claim.seed_pages if claim is not None else 0
                if self.cache.prefix is not None and not st.is_resume:
                    # snapshot the recurrent state OUTSIDE the lock (a device
                    # read) before the private tree is dropped, so the index
                    # can serve full-terminal hits for state families
                    inserts.append((st, self.cache.snapshot_state(st.prefill_cache)))
                self.cache.write_prefill(st.pages, st.prefill_cache, lane=st.lane,
                                         skip_pages=skip)
                self._drop_prefill_cache(st)
            if st.state_cache is not None:            # restored lane state
                self.cache.write_state(st.lane, st.state_cache)
                st.state_cache = None
        if self.cache.prefix is not None:
            post = [st for st in take if st.prefix_claim is not None]
            if post or inserts:
                with self._lock:
                    for st in post:
                        if st.prefix_claim.restore:
                            self.cache.prefix_finish_restore(st.prefix_claim)
                        st.prefix_claim = None
                    for st, state in inserts:
                        self.cache.prefix_insert(st.resume_tokens, st.pages, state,
                                                 st.pending_token)
        return bool(take)

    @decode_loop_only
    def _ensure_pages(self):
        """Every running lane needs a page slot for its next write position.

        Plans the step's page demand at once: reserve what the free pool
        covers, reclaim cold prefix pages, pick victims for the rest
        (longest-running first), evict them as one batch (one page read for
        the swap-outs), grow the surviving lanes, then fork the shared pages
        lanes are about to write (copy-on-write).  Under the engine lock:
        the admission pipeline can neither take the reserved pages nor race
        the victim bookkeeping."""
        s, cache = self.sched, self.cache
        alloc = cache.allocator
        ps = cache.page_size
        with self._lock:
            grow = {lane: max(0, st.length // ps + 1 - len(st.pages))
                    for lane, st in s.running.items()}
            # copy-on-write: a lane whose next write position lands in a page
            # it shares (with the prefix index or another lane) forks it
            # before the decode step writes into it
            forks: dict[int, int] = {}
            for lane, st in s.running.items():
                i = st.length // ps
                if i < len(st.pages) and alloc.refcount(st.pages[i]) > 1:
                    forks[lane] = i
            if not any(grow.values()) and not forks:
                return
            hold = alloc.acquire(min(sum(grow.values()), alloc.n_free)) or []
            victims: list = []

            def shortfall() -> int:
                want = sum(n for lane, n in grow.items() if s.running[lane] not in victims)
                want += sum(1 for lane in forks if s.running[lane] not in victims)
                # a victim's shared pages survive its eviction: only
                # sole-owned pages come back to the free list
                freed = sum(1 for v in victims for p in v.pages if alloc.refcount(p) == 1)
                return want - len(hold) - alloc.n_free - freed

            # before evicting a live lane, reclaim cold prefix-index pages:
            # the prefix cache always yields to running requests
            if shortfall() > 0 and cache.prefix is not None:
                reclaimed = cache.prefix_retire(shortfall())
                if reclaimed:
                    self.tracer.instant(self.tracer.EV_PREFIX_RETIRE, reclaimed)
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
                    sanitizer.note_grant(st, [page], alloc)
            if hold:
                alloc.release(hold)
            # forks last, from the replenished pool: remap the lane to a
            # private copy, leaving the shared original with its co-owners
            copies: list[tuple[int, int]] = []
            for lane, i in forks.items():
                st = s.running.get(lane)
                if st is None:                  # the lane was evicted above
                    continue
                old = st.pages[i]
                if alloc.refcount(old) <= 1:    # its co-owner went meanwhile
                    continue
                new = alloc.fork_for_write(old)
                if new is None:
                    raise RuntimeError(
                        "page pool exhausted during copy-on-write fork — "
                        "grow CacheConfig.n_pages")
                st.pages[i] = new
                cache.assign_lane(lane, st.pages)
                sanitizer.note_grant(st, [new], alloc)
                copies.append((old, new))
                if cache.prefix is not None:
                    cache.prefix.note_fork()
                self.tracer.instant(self.tracer.EV_PREFIX_FORK, st.req.uid, old)
            if copies:
                # one batched copy of the forked rows under the lock, as the
                # swap-out (the decode loop owns the pools: nothing races it)
                # repro-lint: skip[no-device-work-under-lock] copy-on-write, as the reference
                cache.fork_pages(copies)

    @captured_step
    def _decode_impl(self, params, pools, bt, tokens, positions, active):
        """One decode token per lane over the pools, in place → (logits
        (B, 1, V), pools): the reference's ``_decode_impl``, which the card
        engine captures and replays (``CapturedDecode``).  No host read and
        no allocation that outlives the step."""
        if self.ecfg.cache.decode_path == "gather":
            # the oracle: materialize the dense per-lane views, decode,
            # scatter the written column back into the pools
            views = gather_views(pools, bt)
            logits, new_views = self.model.decode_step(params, views, tokens, positions)
            return logits, absorb_decode(pools, new_views, bt, positions, active,
                                         self.cache.page_size)
        # the model reads and writes the page pools through the block table
        return self.model.decode_step_paged(params, pools, bt, tokens, positions, active)

    @decode_loop_only
    @pool_mutator("pools")
    def _decode_lanes(self, generator):
        s, g = self.sched, self.decode_graph
        # the previous step's host read synchronised the stream, so its
        # staging copies are done: the views are free to rewrite
        tokens, positions, active = g.np_tokens, g.np_positions, g.np_active
        tokens.fill(0)
        positions.fill(0)
        active.fill(False)
        for lane, st in s.running.items():
            tokens[lane, 0] = st.pending_token
            positions[lane] = st.length
            active[lane] = True
        g.np_bt[...] = self.cache.block_tables
        n_active = int(active.sum())
        lanes = sorted(s.running)
        sampled = ([lane for lane in lanes if s.running[lane].req.temperature > 0]
                   if generator is not None else [])
        temps = [s.running[lane].req.temperature for lane in sampled]
        dev = self.device
        self.tracer.begin(self.tracer.EV_DECODE, n_active)
        with self._annot():
            toks, rows = g(self.cache.pools)
            if sampled:
                # drawn from the step's logits rows after it; the greedy
                # buffer is the step's output, rewritten by the next step
                idx = torch.tensor(sampled, device=dev)
                toks[idx] = sample_tokens(
                    rows[idx], torch.tensor(temps, dtype=torch.float32, device=dev), generator)
        # the step's one host read: B ints, never B vocab rows; the span ends
        # after it, so it holds the device's work and not only the launches
        toks = toks.cpu().numpy()
        self.tracer.end(self.tracer.EV_DECODE, n_active)
        done = 0
        for lane in lanes:
            st = s.running[lane]
            req = st.req
            tok = int(toks[lane])
            req.out_tokens.append(tok)
            st.length += 1
            st.pending_token = tok
            done += 1
            if (len(req.out_tokens) >= req.max_new_tokens
                    or tok == self.ecfg.eos_id
                    # cap at max_len, not the page-rounded capacity, as the
                    # JAX engine does
                    or st.length >= self.ecfg.max_len - 1):
                self._retire_lane(st)
        with self._lock:
            self._c_decode.inc(done)
            self._c_lane_step.inc(n_active)

    # -- step loop -------------------------------------------------------------

    def _check_generator(self, generator) -> None:
        if generator is not None and generator.device.type != self.device.type:
            raise ValueError(f"the generator lives on {generator.device}, the engine "
                             f"samples on {self.device}")

    @decode_loop_only
    def step(self, generator: torch.Generator | None = None) -> bool:
        """One decode-loop round: (sync mode: pump the admission pipeline) →
        drain ready into lanes → one batched decode step, sampling the lanes
        whose temperature is > 0 under ``generator`` (greedy without one).
        Returns False when the engine is drained."""
        self._check_generator(generator)
        self.tracer.ensure_thread_name("decode-loop")
        t0 = obs_clock.monotonic()
        self.tracer.begin(self.tracer.EV_STEP)
        try:
            return self._step_inner(generator)
        finally:
            self.tracer.end(self.tracer.EV_STEP)
            with self._lock:
                self._h_step.observe(obs_clock.monotonic() - t0)

    @decode_loop_only
    def _step_inner(self, generator) -> bool:
        if self.pipeline.error is not None:
            err, self.pipeline.error = self.pipeline.error, None
            raise RuntimeError("admission pipeline died") from err
        # committed migrations enter the scheduler BEFORE the idle check: a
        # drained engine that just received one schedules it this step
        self.poll_migrations()
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
                self._decode_lanes(generator)
            progressed = True
        with self._lock:
            self._c_steps.inc()
            self._c_lane_slot.inc(self.ecfg.batch_slots)
            occ = self.cache.occupancy()
            self._h_occ.observe(occ)     # mean = sum/count (count == steps)
            self._g_occ.set(occ)         # last value + high-water max
            self.tracer.counter(self.tracer.EV_PAGES_FREE, self.cache.allocator.n_free)
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
        # progresses (one coherent cut of its counters)
        now = obs_clock.monotonic()
        pipe_mark = self.metrics.total("pipeline.")
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
    def run(self, generator: torch.Generator | None = None) -> list[Request]:
        """Step until drained; ``generator`` (on the engine's device) draws
        every sampled token, one generator for the whole run."""
        self._check_generator(generator)
        done_mark = len(self.completed)
        while self.load:
            self.step(generator)
        self.pipeline.shutdown()         # park the worker until resubmit
        return self.completed[done_mark:]

    # -- telemetry -------------------------------------------------------------

    @property
    def load(self) -> int:
        with self._lock:
            return self.sched.load

    def inflight_uids(self) -> list[int]:
        """Uids of every request in the engine (waiting, admitting, ready or
        running): a cube worker's checkpoint set."""
        with self._lock:
            s = self.sched
            return sorted({st.req.uid for st in s.waiting} | {st.req.uid for st in s.admitting}
                          | {st.req.uid for st in s.ready}
                          | {st.req.uid for st in s.running.values()})

    def prefix_match_tokens(self, prompt) -> int:
        """Resident-prefix coverage of a prompt in tokens (a router's
        prefix-affinity signal); 0 when prefix sharing is off."""
        if self.cache.prefix is None:
            return 0
        with self._lock:
            return self.cache.prefix.preview(np.asarray(prompt, np.int32))

    @property
    def stats(self) -> dict:
        """The JAX engine's ``stats`` keys, from one metrics snapshot (a
        copy: mutating it never touches live metrics)."""
        snap = self.metrics.snapshot()
        c = snap["counters"]
        occ = snap["histograms"]["occupancy"]
        return {
            "steps": c["steps"],
            "prefill_tokens": c["prefill_tokens"],
            "decode_tokens": c["decode_tokens"],
            "occupancy_sum": occ["sum"],
            "occupancy_max": snap["gauges"]["occupancy"]["max"],
            "lane_step_sum": c["lane_step_sum"],
            "lane_slot_sum": c["lane_slot_sum"],
        }

    def reset_stats(self) -> None:
        """Zero every metric (engine + pipeline + host tier + prefix) in
        place."""
        self.metrics.reset()

    def save_trace(self, path: str) -> dict:
        """Export the engine's ring buffer as Perfetto-loadable JSON."""
        return write_chrome_trace(path, {"engine": self.tracer})

    def telemetry(self) -> dict:
        """The JAX engine's ``telemetry()`` layout, from one lock cut; a deep
        copy.  Adds ``device``."""
        with self._lock:
            snap = self.metrics.snapshot()
            sched = {
                "queue_depth": self.sched.queue_depth(),
                "admitting": len(self.sched.admitting),
                "ready": len(self.sched.ready),
                "running": len(self.sched.running),
                "preemptions": self.sched.n_preemptions,
                "swap_preemptions": self.sched.n_swap_preemptions,
                "recompute_preemptions": self.sched.n_recompute_preemptions,
                "max_request_preemptions": max(
                    [self.sched.max_preemptions_per_request]
                    + list(self.sched.preemptions_by_uid.values())),
                "max_request_prefix_hit_tokens": max(
                    [self.sched.max_prefix_hit_tokens]
                    + list(self.sched.prefix_hit_tokens_by_uid.values())),
            }
            page_occ = self.cache.occupancy()
            host_occ = self.cache.host_occupancy()
            has_host = self.cache.host is not None
            has_prefix = self.cache.prefix is not None
            migr = {"pending": len(self._migrations), "shadows": len(self._shadows)}
        c = snap["counters"]
        st: dict = {
            "steps": c["steps"],
            "prefill_tokens": c["prefill_tokens"],
            "decode_tokens": c["decode_tokens"],
        }
        st.update(sched)
        occ = snap["histograms"]["occupancy"]
        st["occupancy_mean"] = occ["sum"] / occ["count"] if occ["count"] else 0.0
        st["occupancy_max"] = snap["gauges"]["occupancy"]["max"]
        lane_cap = c["lane_slot_sum"]
        st["lane_utilization"] = c["lane_step_sum"] / lane_cap if lane_cap else 0.0
        st["decode_idle_fraction"] = 1.0 - st["lane_utilization"]
        st["async_prefill"] = self.ecfg.admission.async_prefill
        st["pipeline"] = {k[len("pipeline."):]: v for k, v in c.items()
                          if k.startswith("pipeline.")}
        st["page_occupancy"] = page_occ
        st["host_page_occupancy"] = host_occ
        migr.update({k[len("migrate."):]: v for k, v in c.items() if k.startswith("migrate.")})
        st["migrations"] = migr
        if has_host:
            st["host_tier"] = {k[len("host."):]: v for k, v in c.items()
                               if k.startswith("host.")}
        if has_prefix:
            pr = {k[len("prefix."):]: v for k, v in c.items() if k.startswith("prefix.")}
            lookup = pr.get("lookup_tokens", 0)
            pr["hit_rate"] = pr.get("hit_tokens", 0) / lookup if lookup else 0.0
            st["prefix"] = pr
        st["histograms"] = snap["histograms"]
        st["device"] = str(self.device)
        return st


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """One token per row of ``logits`` (n, V), drawn from ``softmax(row /
    temperature[row])`` in float32 under ``generator``, on the rows' device
    (the generator must live there).  Rows draw in order, so a seeded
    generator gives the same tokens again."""
    probs = torch.softmax(logits.float() / temperature[:, None], dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
