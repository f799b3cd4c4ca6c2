"""Admission pipeline: prefill chunks, host-tier restores and prefix matches
beside the decode loop (the port's copy of ``repro/serve/admission.py``).

* **async mode** (``AdmissionConfig.async_prefill=True``): one worker thread
  pulls work items — stage a restore, finish a prefix match, run one
  prefill chunk, admit the next waiting request — and hands finished
  requests to the decode loop through the scheduler's ready queue.
* **sync mode**: ``pump`` runs the same code inline once per engine step.

Both modes give identical tokens: the pipeline computes and stages into
*private* per-request tensors (``RequestState.prefill_cache``, ``staged``,
``prefix_staged``) and only the decode loop writes the shared page pools.

Thread discipline:

1. all queue/allocator/counter mutation happens under ``engine._lock``;
2. compute and copies happen outside it, on private state;
3. the decode loop owns ``cache.pools`` and the block tables exclusively;
4. hand-offs signal ``engine._cv`` so neither loop spins.

On the card both threads launch on the device's default stream, so their
kernels and copies run in issue order: a restore's host→device copy is
issued before the request reaches the ready queue, and so before the
decode loop's scatter of it.  A prefill's hand-off is ordered besides:
``sample_prefill_token`` reads the last logits on the host first.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.analysis import sanitizer
from repro_torch.analysis.ownership import admission_api


class AdmissionPipeline:
    """Prefill/restore pipeline feeding a ``ServeEngine``'s ready queue."""

    _STAT_KEYS = ("admitted", "chunks_run", "restores_staged", "prefills_done", "matches")

    def __init__(self, engine, async_mode: bool):
        self.engine = engine
        self.async_mode = async_mode
        self._thread: threading.Thread | None = None
        self._stop = False
        self.error: BaseException | None = None
        # pipeline counters live in the engine's registry, whose lock is the
        # engine lock: the decode loop's progress check and telemetry read
        # them as one coherent cut
        self._c = {k: engine.metrics.counter("pipeline." + k) for k in self._STAT_KEYS}

    @property
    def stats(self) -> dict[str, int]:
        """Point-in-time copy of the pipeline counters (one lock cut)."""
        return self.engine.metrics.counters("pipeline.")

    # -- shared work items (compute and copies outside the lock) ------------

    @admission_api
    def _stage(self, st) -> None:
        """Host→device copy of a swapped-out request, then hand to ready.
        Touches the host buffers and fresh device tensors only, never the
        pools."""
        eng = self.engine
        tr = eng.tracer
        tr.begin(tr.EV_STAGE_IN, st.req.uid, len(st.swap_handle.host_pages))
        staged, state = eng.cache.stage_in(st.swap_handle)
        tr.end(tr.EV_STAGE_IN, st.req.uid)
        with eng._lock:
            st.staged, st.state_cache = staged, state
            st.swapped = False
            # restore-resume: length/pending_token survived the swap —
            # straight to ready, no prefill re-run
            eng.sched.to_ready(st)
            self._c["restores_staged"].inc()
            eng._cv.notify_all()

    @admission_api
    def _chunk(self, st, chunk: int) -> None:
        """One prefill work unit (a chunk, or the whole prompt when chunking
        is off) into the request's private cache."""
        eng = self.engine
        tr = eng.tracer
        tr.begin(tr.EV_PREFILL_CHUNK, st.req.uid, chunk)
        done = eng.run_prefill(st, chunk)
        tok = eng.sample_prefill_token(st) if done else None
        tr.end(tr.EV_PREFILL_CHUNK, st.req.uid)
        with eng._lock:
            self._c["chunks_run"].inc()
            eng._c_prefill.inc(chunk)
            if done:
                self._c["prefills_done"].inc()
                eng.finish_prefill(st, tok)
            eng._cv.notify_all()

    @admission_api
    def _match(self, st) -> None:
        """Full prefix hit: stage any host-retired prefix pages (a
        host→device copy outside the lock), take the terminal's state
        snapshot onto the device, and hand the request straight to ready —
        no prefill compute at all."""
        eng = self.engine
        tr = eng.tracer
        claim = st.prefix_claim
        staged = None
        if claim.restore:
            tr.begin(tr.EV_STAGE_IN, st.req.uid, len(claim.restore))
            staged = eng.cache.host.get_pages([hp for _h, hp, _d in claim.restore])
            tr.end(tr.EV_STAGE_IN, st.req.uid)
        state = ({path: s.to(eng.device) for path, s in claim.state.items()}
                 if claim.state is not None else None)
        with eng._lock:
            if staged is not None:
                st.prefix_staged = (staged, [d for _h, _hp, d in claim.restore])
            if state is not None:
                st.state_cache = state
            self._c["matches"].inc()
            eng.finish_match(st)
            eng._cv.notify_all()

    # -- sync mode ----------------------------------------------------------

    @admission_api
    def pump(self, budget: int) -> bool:
        """Run the pipeline inline for one engine step (sync mode): admit
        under the token budget, stage every pending restore, finish every
        match, advance each in-flight prefill by one chunk."""
        eng, s = self.engine, self.engine.sched
        with eng._lock:
            progressed = bool(s.admissions(eng.cache, budget))
        for st in [x for x in s.admitting if x.phase == "restore"]:
            self._stage(st)
            progressed = True
        for st in [x for x in s.admitting if x.phase == "match"]:
            self._match(st)
            progressed = True
        for st in list(s.admitting):
            if st.phase != "prefill":
                continue
            chunk = s.chunk_for(st)
            if s.cfg.prefill_chunk > 0:
                chunk = min(chunk, budget)
            elif budget <= 0:
                chunk = 0                      # whole-prompt: chunk-granular
            if chunk <= 0:
                continue
            self._chunk(st, chunk)
            budget -= chunk
            progressed = True
        return progressed

    # -- async mode ---------------------------------------------------------

    def kick(self) -> None:
        """Ensure the worker thread is running (started lazily on submit,
        parked again when the engine drains)."""
        if not self.async_mode:
            return
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(
                target=self._worker, daemon=True, name="serve-admission-pipeline")
            self._thread.start()

    def shutdown(self) -> None:
        """Stop and join the worker (idempotent)."""
        t = self._thread
        if t is None:
            return
        with self.engine._lock:
            self._stop = True
            self.engine._cv.notify_all()
        if t.is_alive():
            t.join(timeout=10)
        self._thread = None

    @admission_api
    def _select(self):
        """The next work item, under the engine lock.  Restores first (a
        copy, unblocks a decode lane soonest), then matches, then in-flight
        prefill chunks in admission order, then a fresh admission."""
        s = self.engine.sched
        for phase in ("restore", "match", "prefill"):
            for st in s.admitting:
                if st.phase == phase:
                    return phase, st, s.chunk_for(st)
        st = s.admit_next(self.engine.cache)
        if st is not None:
            self._c["admitted"].inc()
            return st.phase, st, s.chunk_for(st)
        return None

    @admission_api
    def _worker(self) -> None:
        eng = self.engine
        eng.tracer.ensure_thread_name("admission-pipeline")
        # sanitizer mode: this thread may never write the pools or block
        # tables, nor enter a @decode_loop_only method
        if sanitizer.enabled():
            sanitizer.register_admission_thread(eng)
        try:
            if eng.device.type == "cuda":
                torch.cuda.set_device(eng.device)
            while True:
                with eng._lock:
                    if self._stop:
                        return
                    work = self._select()
                    if work is None:
                        # nothing admissible: wait for a submit, a page free
                        # or shutdown (every state change notifies; the
                        # timeout is a backstop)
                        eng._cv.wait(timeout=0.5)
                        if self._stop:
                            return
                        continue
                phase, st, chunk = work
                if phase == "restore":
                    self._stage(st)
                elif phase == "match":
                    self._match(st)
                else:
                    self._chunk(st, chunk)
        except BaseException as e:  # noqa: B036 - surfaced in the decode loop
            with eng._lock:
                self.error = e
                eng._cv.notify_all()
        finally:
            # the OS reuses thread idents: a dead worker's must not taint a
            # later decode thread
            if sanitizer.enabled():
                sanitizer.unregister_admission_thread(eng)


def prefill_logits_token(last_logits: torch.Tensor) -> int:
    """Greedy prefill token (argmax of the final-position logits row): the
    one host-blocking read a prefill needs.  Greedy whatever the request's
    temperature, as in the JAX package: only decode steps sample."""
    return int(torch.argmax(last_logits))
