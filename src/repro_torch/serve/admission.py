"""Admission pipeline: prefill beside the decode loop (the port's copy of
``repro/serve/admission.py``, without host-tier restores and prefix matches).

* **async mode** (``AdmissionConfig.async_prefill=True``): one worker thread
  pulls work items — run one prefill chunk, admit the next waiting request —
  and hands finished requests to the decode loop through the scheduler's
  ready queue.
* **sync mode**: ``pump`` runs the same code inline once per engine step.

Both modes give identical tokens: the pipeline computes into *private*
per-request caches (``RequestState.prefill_cache``) and only the decode
loop writes the shared page pools.

Thread discipline:

1. all queue/allocator/stats mutation happens under ``engine._lock``;
2. compute happens outside it, on private state;
3. the decode loop owns ``cache.pools`` and the block tables exclusively;
4. hand-offs signal ``engine._cv`` so neither loop spins.

On the card both threads launch on the device's default stream, so their
kernels run in issue order.  The hand-off is ordered besides:
``sample_prefill_token`` reads the prefill's last logits on the host (a
synchronisation) before the request reaches the ready queue.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.analysis.ownership import admission_api


class AdmissionPipeline:
    """Prefill pipeline feeding a ``ServeEngine``'s ready queue."""

    def __init__(self, engine, async_mode: bool):
        self.engine = engine
        self.async_mode = async_mode
        self._thread: threading.Thread | None = None
        self._stop = False
        self.error: BaseException | None = None

    @admission_api
    def _chunk(self, st, chunk: int) -> None:
        """One prefill work unit (a chunk, or the whole prompt when chunking
        is off) into the request's private cache."""
        eng = self.engine
        done = eng.run_prefill(st, chunk)
        tok = eng.sample_prefill_token(st) if done else None
        with eng._lock:
            eng._inc("pipeline.chunks_run")
            eng._inc("prefill_tokens", chunk)
            if done:
                eng._inc("pipeline.prefills_done")
                eng.finish_prefill(st, tok)
            eng._cv.notify_all()

    @admission_api
    def pump(self, budget: int) -> bool:
        """Run the pipeline inline for one engine step (sync mode): admit
        under the token budget, advance each in-flight prefill by one chunk."""
        eng, s = self.engine, self.engine.sched
        with eng._lock:
            progressed = bool(s.admissions(eng.cache, budget))
        for st in list(s.admitting):
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
        """The next work item, under the engine lock: in-flight prefill
        chunks in admission order, then a fresh admission."""
        s = self.engine.sched
        if s.admitting:
            return s.admitting[0], s.chunk_for(s.admitting[0])
        st = s.admit_next(self.engine.cache)
        if st is not None:
            self.engine._inc("pipeline.admitted")
            return st, s.chunk_for(st)
        return None

    @admission_api
    def _worker(self) -> None:
        eng = self.engine
        try:
            if eng.device.type == "cuda":
                torch.cuda.set_device(eng.device)
            while True:
                with eng._lock:
                    if self._stop:
                        return
                    work = self._select()
                    if work is None:
                        eng._cv.wait(timeout=0.5)
                        if self._stop:
                            return
                        continue
                self._chunk(*work)
        except BaseException as e:  # noqa: B036 - surfaced in the decode loop
            with eng._lock:
                self.error = e
                eng._cv.notify_all()


def prefill_logits_token(last_logits: torch.Tensor) -> int:
    """Greedy prefill token (argmax of the final-position logits row): the
    one host-blocking read a prefill needs."""
    return int(torch.argmax(last_logits))
