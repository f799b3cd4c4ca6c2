"""Runtime concurrency/ownership sanitizer for the serving engine (the port's
copy of ``repro/analysis/sanitizer.py``).

Enabled by ``REPRO_SANITIZE=1`` (or :func:`enable` from a test).  Pure
stdlib, zero work when disabled beyond one flag check per decorated call.

What it tracks, per engine (the decorators in ``repro_torch.analysis.ownership``
call in here):

* **writer discipline** — pools/block-table mutators (``@pool_mutator
  ("pools")``) must all run on one thread (first writer binds it), and never
  on a registered admission-pipeline thread; ``@decode_loop_only`` methods
  likewise must never run on an admission thread;
* **lock discipline** — free-list/host-allocator mutators (``@pool_mutator
  ("free_list")``) must hold the engine's bookkeeping lock;
* **epoch-checked acquire/release** — every page acquisition bumps a
  per-page generation; releases and uses of freed page ids are caught
  immediately (double-release, release-of-unallocated, use-after-free),
  and the grant/verify lease API catches the ABA case: a page id freed by
  preemption, re-issued to another request, then written through a stale
  list.  The refcounted ownership API (``acquire``/``share``/``release``/
  ``fork_for_write``) is mirrored in a per-page reference count that is
  cross-checked against the allocator's own ``refs`` map after every op —
  a shared page only becomes "freed" when its last owner releases it;
* **invariants** — ``check_invariant()`` runs after every mutating op on an
  object that has one (``PagedKVCache``/``PageAllocator``/``HostPagePool``),
  not just at explicit test checkpoints.

Violations raise :class:`SanitizerError` carrying the recent access history
(thread, op, pages) so the interleaving that broke the invariant is visible
in the traceback, not reconstructed from token corruption steps later.
"""
from __future__ import annotations

import contextlib
import os
import threading
import weakref
from collections import deque
from collections.abc import Iterable
from typing import Any

__all__ = [
    "SanitizerError",
    "enabled",
    "enable",
    "disable",
    "register_engine",
    "register_admission_thread",
    "unregister_admission_thread",
    "on_transport_entry",
    "on_transport_exit",
    "in_transport",
    "note_grant",
    "note_release",
    "verify_grant",
]

_HISTORY = 128


class SanitizerError(RuntimeError):
    """An ownership/lock/page-lifetime invariant was violated at runtime."""


_enabled: bool = os.environ.get("REPRO_SANITIZE", "0") not in ("", "0")


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


class _Record:
    """Shared sanitizer state for one engine (or one standalone object)."""

    __slots__ = ("lock", "admission_idents", "writer_ident", "writer_name",
                 "history", "tracer", "__weakref__")

    def __init__(self) -> None:
        self.lock: Any = None                 # the engine bookkeeping RLock
        self.admission_idents: set[int] = set()
        self.writer_ident: int | None = None  # bound on first pools mutation
        self.writer_name: str = ""
        self.history: deque[str] = deque(maxlen=_HISTORY)
        self.tracer: Any = None               # engine's obs tracer (optional)


class _PageTable:
    """Per-allocator page lifetime table (epochs + live/freed sets + an
    independent refcount mirror for the share/release ownership API)."""

    __slots__ = ("live", "freed", "gen", "ref", "__weakref__")

    def __init__(self) -> None:
        self.live: set[int] = set()
        self.freed: set[int] = set()
        self.gen: dict[int, int] = {}
        self.ref: dict[int, int] = {}


_records: "weakref.WeakKeyDictionary[Any, _Record]" = (
    weakref.WeakKeyDictionary())
_pages: "weakref.WeakKeyDictionary[Any, _PageTable]" = (
    weakref.WeakKeyDictionary())
_reg_lock = threading.Lock()


def _record_for(obj: Any) -> _Record:
    with _reg_lock:
        rec = _records.get(obj)
        if rec is None:
            rec = _records[obj] = _Record()
        return rec


def _table_for(alloc: Any) -> _PageTable:
    with _reg_lock:
        tab = _pages.get(alloc)
        if tab is None:
            tab = _pages[alloc] = _PageTable()
        return tab


def _anchor(obj: Any) -> Any:
    """Resolve the object whose _Record governs ``obj`` (engine -> cache)."""
    return getattr(obj, "cache", obj)


def _log(rec: _Record, op: str, detail: str = "") -> None:
    t = threading.current_thread()
    rec.history.append(f"[{t.name}#{t.ident}] {op} {detail}".rstrip())


def _raise(rec: _Record, msg: str) -> None:
    # mirror the finding into the engine's trace (cold path — a finding is
    # about to abort the run) so a Perfetto timeline shows WHERE the
    # invariant tripped relative to steps/chunks/swaps
    if rec.tracer is not None:
        # tracing must never mask the error itself
        with contextlib.suppress(Exception):
            rec.tracer.instant_named("sanitizer: " + msg.splitlines()[0])
    hist = "\n    ".join(rec.history) or "(empty)"
    raise SanitizerError(f"{msg}\n  access history (most recent last):\n"
                         f"    {hist}")


# -- registration (called unconditionally from serve; cheap) ----------------


def register_engine(engine: Any) -> None:
    """Bind an engine's lock + cache/host/allocator objects to one shared
    sanitizer record, so thread/lock checks know which lock guards what."""
    rec = _record_for(engine.cache)
    rec.lock = engine._lock
    rec.tracer = getattr(engine, "tracer", None)
    with _reg_lock:
        _records[engine.cache.allocator] = rec
        host = getattr(engine.cache, "host", None)
        if host is not None:
            _records[host] = rec
            _records[host.allocator] = rec
        slots = getattr(engine, "prefill_slots", None)
        if slots is not None:
            _records[slots] = rec


def register_admission_thread(engine: Any) -> None:
    """Mark the current thread as an admission-pipeline thread: it may never
    mutate pools/block tables or enter ``@decode_loop_only`` methods."""
    rec = _record_for(engine.cache)
    ident = threading.get_ident()
    rec.admission_idents.add(ident)
    _log(rec, "register_admission_thread")


def unregister_admission_thread(engine: Any) -> None:
    rec = _record_for(engine.cache)
    rec.admission_idents.discard(threading.get_ident())


# -- cube-transport scope (the cross-process ownership boundary) ------------

# per-thread nesting depth of @cube_transport frames: while > 0, this
# thread is moving wire bytes between cube processes and must not touch
# engine-owned device state (pools writes, decode-loop entries)
_transport = threading.local()


def on_transport_entry(name: str) -> None:
    _transport.depth = getattr(_transport, "depth", 0) + 1
    _transport.name = name


def on_transport_exit() -> None:
    _transport.depth = max(0, getattr(_transport, "depth", 1) - 1)


def in_transport() -> bool:
    return getattr(_transport, "depth", 0) > 0


# -- decorator hooks (ownership.py calls these when enabled) ----------------


def on_decode_loop_entry(obj: Any, name: str) -> None:
    rec = _record_for(_anchor(obj))
    if in_transport():
        _log(rec, f"VIOLATION {name}")
        _raise(rec, f"@decode_loop_only method {name!r} entered from inside "
                    f"cube-transport frame {getattr(_transport, 'name', '?')!r}"
                    " — the wire layer must never drive the decode loop")
    if threading.get_ident() in rec.admission_idents:
        _log(rec, f"VIOLATION {name}")
        _raise(rec, f"@decode_loop_only method {name!r} called from an "
                    "admission-pipeline thread")


def pre_mutate(obj: Any, kind: str, name: str,
               pages: list[int] | None) -> None:
    rec = _record_for(_anchor(obj))
    ident = threading.get_ident()
    _log(rec, f"{kind}:{name}", f"pages={pages}" if pages else "")
    if kind == "pools":
        if in_transport():
            _raise(rec, f"pool mutation {name!r} from inside cube-transport "
                        f"frame {getattr(_transport, 'name', '?')!r} — the "
                        "wire layer moves bytes, never pages")
        if ident in rec.admission_idents:
            _raise(rec, f"pool mutation {name!r} from admission-pipeline "
                        "thread (decode loop is the sole pools writer)")
        if rec.writer_ident is None:
            rec.writer_ident = ident
            rec.writer_name = threading.current_thread().name
        elif rec.writer_ident != ident:
            _raise(rec, f"pool mutation {name!r} from thread "
                        f"{threading.current_thread().name!r} but the pools "
                        f"writer is {rec.writer_name!r} — two threads are "
                        "writing pools/block tables")
    elif (kind == "free_list" and rec.lock is not None
          and not _lock_owned(rec.lock)):
        _raise(rec, f"free-list mutation {name!r} without holding the "
                    "engine bookkeeping lock")
    alloc = _page_alloc_of(obj)
    if alloc is not None and pages:
        tab = _table_for(alloc)
        if name in ("free", "release"):
            for p in pages:
                if p in tab.freed:
                    _raise(rec, f"double free of page {p}")
        else:
            # share / fork_for_write / every pools op with page args:
            # touching a freed page id is a use-after-free regardless of
            # whether the op would have bumped or dropped a refcount
            for p in pages:
                if p in tab.freed:
                    _raise(rec, f"use-after-free: {name!r} touches freed "
                                f"page {p}")


def post_mutate(obj: Any, kind: str, name: str, pages: list[int] | None,
                result: Any) -> None:
    rec = _record_for(_anchor(obj))
    alloc = _page_alloc_of(obj)
    if alloc is not None:
        tab = _table_for(alloc)
        truth = getattr(alloc, "refs", None)   # allocator's own refcounts
        if name in ("alloc", "acquire") and result:
            for p in result:
                if p in tab.live:
                    _raise(rec, f"page {p} double-allocated")
                tab.live.add(p)
                tab.freed.discard(p)
                tab.gen[p] = tab.gen.get(p, 0) + 1
                tab.ref[p] = 1
            _log(rec, f"{kind}:{name} ->", f"pages={list(result)}")
        elif name == "share" and pages:
            for p in pages:
                cur = tab.ref.get(p)
                if cur is None:    # page predates sanitizer enable
                    cur = (truth.get(p, 1) - 1) if truth is not None else 0
                tab.ref[p] = cur + 1
        elif name == "release" and pages:
            returned = set(result) if result else set()
            for p in pages:
                if p in returned:
                    tab.live.discard(p)
                    tab.freed.add(p)
                    tab.ref.pop(p, None)
                    continue
                cur = tab.ref.get(p)
                if cur is None:
                    tab.ref[p] = (truth.get(p, 1) if truth is not None
                                  else 1)
                elif cur <= 1:
                    _raise(rec, f"refcount underflow: page {p} released "
                                f"below one owner without being freed")
                else:
                    tab.ref[p] = cur - 1
        elif name == "free" and pages:   # legacy single-owner surface
            for p in pages:
                tab.live.discard(p)
                tab.freed.add(p)
                tab.ref.pop(p, None)
        if truth is not None and name in ("acquire", "share", "release"):
            for p in list(pages or ()) + (list(result)
                                          if isinstance(result, list)
                                          else []):
                if p in tab.ref and tab.ref[p] != truth.get(p, 0):
                    _raise(rec, f"refcount mirror diverged for page {p}: "
                                f"sanitizer saw {tab.ref[p]} owners, "
                                f"allocator says {truth.get(p, 0)}")
    check = getattr(obj, "check_invariant", None)
    if check is None:
        check = getattr(getattr(obj, "cache", None), "check_invariant", None)
    if check is not None:
        check()


def _page_alloc_of(obj: Any) -> Any:
    """The PageAllocator whose page-id namespace ``obj``'s page args use."""
    if hasattr(obj, "_free_set"):            # is a PageAllocator
        return obj
    return getattr(obj, "allocator", None)   # PagedKVCache / HostPagePool


def _lock_owned(lock: Any) -> bool:
    owned = getattr(lock, "_is_owned", None)
    if owned is not None:
        return bool(owned())
    if lock.acquire(blocking=False):         # best-effort fallback
        lock.release()
        return False
    return True


# -- grant/lease API (epoch check across preemption/swap) -------------------


def note_grant(st: Any, pages: Iterable[int], alloc: Any) -> None:
    """Record the generation of each page id granted to a request, so a
    later use through a stale list (freed + re-issued to another request)
    is detectable even though the page is live again."""
    if not _enabled:
        return
    tab = _table_for(alloc)
    lease = getattr(st, "_san_lease", None)
    if lease is None:
        lease = {}
        st._san_lease = lease
    for p in pages:
        lease[p] = tab.gen.get(p, 0)


def note_release(st: Any) -> None:
    if not _enabled:
        return
    if getattr(st, "_san_lease", None):
        st._san_lease = {}


def verify_grant(st: Any, alloc: Any) -> None:
    """Assert every page id a request holds is live and still of the
    generation it was granted — the use-after-free / ABA check."""
    if not _enabled:
        return
    tab = _table_for(alloc)
    rec = _records.get(alloc) or _record_for(alloc)
    lease = getattr(st, "_san_lease", None) or {}
    for p in getattr(st, "pages", []):
        if p in tab.freed:
            _raise(rec, f"use-after-free: request holds freed page {p}")
        if p in lease and tab.gen.get(p, 0) != lease[p]:
            _raise(rec, f"stale page id {p}: granted at generation "
                        f"{lease[p]} but the page was re-allocated since "
                        f"(now generation {tab.gen.get(p, 0)}) — page list "
                        "survived a preemption/swap free")
