"""Ownership markers for the two-loop serving engine (the port's copy of
``repro/analysis/ownership.py``) and the marker of the steps the card
captures in CUDA graphs.

The port's repro-lint (``python -m repro_torch.analysis.lint``) matches
them by name: ``sole-writer`` and ``cube-boundary`` read the first four,
``capture-safety`` (``analysis/rules/capture_safety.py``) the last:

* ``@pool_mutator(kind)`` — mutates engine-shared state: ``"pools"`` (page
  pools, block tables and host-tier page buffers, owned by the decode loop)
  or ``"free_list"`` (page allocators and host-tier handles, shared across
  threads under the engine lock);
* ``@decode_loop_only`` — runs on the decode-loop thread only;
* ``@admission_api`` — in the admission pipeline's call graph: may reserve
  and free pages under the lock and compute into private buffers, never
  write the pools;
* ``@cube_transport`` — on the inter-cube wire path (``serve/cube_proc.py``):
  it frames and ships messages between processes and never touches
  engine-owned device state (no pools mutation, no ``@decode_loop_only``
  entry).  Landing a migration in the host tier (``migrate_put``, under the
  lock) is engine work, not transport: the wire moves bytes, the engine
  moves pages.
* ``@captured_step`` — a step body the card records into a CUDA graph and
  replays (``ServeEngine._decode_impl``, ``DecoderLM.extend_step``): it and
  everything it calls must not read the device back or branch on a
  tensor's value.  A marker only, as ``obs.trace.hot_path`` is.

The runtime sanitizer (``REPRO_SANITIZE=1``, ``repro_torch.analysis.
sanitizer``) enforces them with thread, lock and page-epoch tracking.  When
it is disabled the wrappers cost one boolean check per call.
"""
from __future__ import annotations

import functools
import inspect
from collections.abc import Callable
from typing import Any, TypeVar

from . import sanitizer

__all__ = ["pool_mutator", "decode_loop_only", "admission_api", "cube_transport",
           "captured_step", "MUTATOR_KINDS"]

F = TypeVar("F", bound=Callable[..., Any])

MUTATOR_KINDS = ("pools", "free_list")


def _page_args_extractor(fn: Callable[..., Any]):
    """Build a (args, kwargs) -> list[int]|None extractor for parameters
    named ``pages``/``page``: the page-id arguments the sanitizer checks for
    liveness and epochs."""
    params = list(inspect.signature(fn).parameters)

    def extract(args, kwargs):
        out: list[int] = []
        bound = dict(zip(params[1:], args))  # skip self
        bound.update(kwargs)
        pages = bound.get("pages")
        if pages:
            out.extend(int(p) for p in pages)
        page = bound.get("page")
        if page is not None:
            out.append(int(page))
        return out or None

    return extract


def pool_mutator(kind: str) -> Callable[[F], F]:
    """Declare a method that mutates pools/block tables (``"pools"``) or a
    lock-protected free list (``"free_list"``)."""
    if kind not in MUTATOR_KINDS:
        raise ValueError(f"unknown pool_mutator kind: {kind!r}")

    def deco(fn: F) -> F:
        extract = _page_args_extractor(fn)

        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            if not sanitizer.enabled():
                return fn(self, *args, **kwargs)
            pages = extract(args, kwargs)
            sanitizer.pre_mutate(self, kind, fn.__name__, pages)
            result = fn(self, *args, **kwargs)
            sanitizer.post_mutate(self, kind, fn.__name__, pages, result)
            return result

        wrapper._repro_pool_mutator = kind          # type: ignore[attr-defined]
        return wrapper                              # type: ignore[return-value]

    return deco


def decode_loop_only(fn: F) -> F:
    """Declare a method that must run on the decode-loop thread only."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if sanitizer.enabled():
            sanitizer.on_decode_loop_entry(self, fn.__name__)
        return fn(self, *args, **kwargs)

    wrapper._repro_decode_loop_only = True          # type: ignore[attr-defined]
    return wrapper                                  # type: ignore[return-value]


def admission_api(fn: F) -> F:
    """Declare a method in the admission pipeline's call graph (staging and
    private-buffer API).  A marker only: the static sole-writer rule uses it
    as a taint root; runtime enforcement rides the pool_mutator hooks."""
    fn._repro_admission_api = True                  # type: ignore[attr-defined]
    return fn


def cube_transport(fn: F) -> F:
    """Declare a function on the inter-cube wire path: while it runs (on this
    thread), a pools mutation or a ``@decode_loop_only`` entry is a
    cross-process ownership violation, which the sanitizer records.  The
    scope is tracked per thread."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not sanitizer.enabled():
            return fn(*args, **kwargs)
        sanitizer.on_transport_entry(fn.__name__)
        try:
            return fn(*args, **kwargs)
        finally:
            sanitizer.on_transport_exit()

    wrapper._repro_cube_transport = True            # type: ignore[attr-defined]
    return wrapper                                  # type: ignore[return-value]


def captured_step(fn: F) -> F:
    """Declare a step body that is recorded into a CUDA graph and replayed
    (``serve/captured.py``).  A marker only: the static ``capture-safety``
    rule takes its call closure and checks it for host reads and for Python
    control flow on tensor values.  At runtime it is a no-op."""
    fn._repro_captured_step = True                  # type: ignore[attr-defined]
    return fn
