"""Host-memory page tier behind the device page pools (the port of
``repro/serve/host_tier.py``).

Preemption that throws a victim's pages away and recomputes them re-runs
prefill; this second tier makes eviction a *move* instead.  It is a pool of
host pages keyed by the same block-table abstraction as the device pools,
so the scheduler swaps a victim's pages out to host memory and restores
them on resume without re-running prefill; the prefix index retires cold
prefix pages into it too (``put_pages`` / ``get_pages``).

Layout mirrors ``paged_cache``: every seq leaf ``(layers, n_pages, PS,
*row)`` gets a host twin ``(layers, n_host_pages, PS, *row)``, a CPU tensor,
pinned when the pools live on the card, allocated at the first copy-out
(an engine that never swaps pins no host memory).  Recurrent-state leaves
(ssm state, RG-LRU ``h`` and ``conv``) have no pages: a swap captures the
victim lane's rows into the request's ``SwapHandle`` (they change every
decode step, so they are always dirty).

Dirty pages: decode appends, so a page that was full at swap-out can never
change after resume and its host copy stays valid.  The handle keeps its
host pages across a resume and records that clean prefix; a second
preemption of the same request copies only the pages written since.

Each direction is split into a bookkeeping half and a copy half:

* swap-out: ``reserve`` (host pages + dirty list, under the engine lock),
  then ``commit_many``: every victim's dirty pages of every seq leaf come
  off the card in ONE ``paged_gather_many`` launch through a ``(1, n_dirty)``
  table (more only past the table a block keeps in shared memory), then one
  device→host copy per leaf into pinned staging and a host scatter into the
  host pages;
* swap-in: ``stage_in`` (host rows gathered into a pinned staging tensor of
  the request's own, then an asynchronous host→device copy; pools
  untouched, so it runs on the admission thread), then
  ``PagedKVCache.commit_swap_in`` (the scatter into the pools, decode loop).

Inter-cube migration (``serve/cube_proc.py``) lands on the same handles:
``export_handle`` reads a swapped request's host pages as a payload and
``import_pages`` writes a landed payload into fresh host pages, returning a
``SwapHandle`` that the ordinary swapped restore consumes.

Ordering on the card: both threads issue on the device's default stream,
so the decode loop's scatter runs after the staging copy.  Each restore
copies from a staging tensor of its own (the caching host allocator keeps
it until the copy completes), never from the host pages themselves, so a
host page freed and reused by a later swap-out cannot race an in-flight
restore.  The swap-in scatter and the fork copy are plain indexing, as the
JAX package leaves them to XLA.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

import torch

from repro_torch.analysis.ownership import admission_api, pool_mutator
from repro_torch.models.common import tree_items
from repro_torch.obs.metrics import BYTES_EDGES, MetricsRegistry

from .paged_cache import PageAllocator, _is_seq, read_pages


@dataclass
class SwapHandle:
    """Per-request record of where its pages live in the host tier."""

    host_pages: list[int] = field(default_factory=list)  # logical order
    clean_pages: int = 0        # prefix whose host copy is still valid
    length: int = 0             # kv tokens valid at last swap-out
    state: object = None        # captured recurrent state {path: CPU tensor}


class HostPagePool:
    """Host-memory twin of the device seq-leaf pools + a free list.

    Thread safety: allocator and handle mutation (``reserve``/``free``)
    happens under the engine lock; the copy halves touch disjoint host rows
    per handle (a request is either admitting or running, never both), so
    ``commit_many`` on the decode loop may overlap ``stage_in`` on the
    admission thread.
    """

    _STAT_KEYS = (
        "swap_outs", "swap_ins",
        "pages_out", "pages_in",
        "bytes_out", "bytes_in",
        "device_gets",                      # device→host reads (one per leaf)
        "dirty_pages_skipped",              # clean-prefix reuse
        "exhausted_fallbacks",              # host pool couldn't cover a swap
        # inter-cube page migration (serve/cube_proc.py put-then-signal):
        # payloads exported from and landed into this tier
        "migrations_out", "migrations_in",
        "migration_pages_out", "migration_pages_in",
    )

    def __init__(self, device_pools, n_pages: int, page_size: int,
                 metrics: MetricsRegistry | None = None):
        self.n_pages = n_pages
        self.page_size = page_size
        self.allocator = PageAllocator(n_pages)
        leaves = list(tree_items(device_pools))
        self.device = leaves[0][1].device
        self._pin = self.device.type == "cuda"
        # seq leaf path -> (host buffer shape, dtype); the buffers come at
        # the first copy-out
        self._specs = {path: ((pool.shape[0], n_pages) + tuple(pool.shape[2:]), pool.dtype)
                       for path, pool in leaves if _is_seq(path)}
        self._buffers: dict | None = None
        self._alloc_lock = threading.Lock()
        # staging (admission thread) and batched swap-out (decode loop) may
        # overlap: counters live in a registry whose (shared engine) lock
        # makes bumps atomic and telemetry reads coherent
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c = {k: self.metrics.counter("host." + k) for k in self._STAT_KEYS}
        self.metrics.histogram("host.swap_bytes", BYTES_EDGES)

    @property
    def buffers(self) -> dict:
        """Seq leaf path -> host buffer (layers, n_host_pages, PS, *row)."""
        with self._alloc_lock:
            if self._buffers is None:
                # the host pages' one-time pinned allocation, under the tier's own lock:
                # repro-lint: skip[no-device-work-under-lock] both threads wait for it anyway
                self._buffers = {path: torch.empty(shape, dtype=dtype, pin_memory=self._pin)
                                 for path, (shape, dtype) in self._specs.items()}
            return self._buffers

    @property
    def stats(self) -> dict[str, int]:
        """Point-in-time copy of the host-tier counters (one lock cut)."""
        return self.metrics.counters("host.")

    def _bump(self, **kv) -> None:
        with self.metrics.lock:
            for k, v in kv.items():
                self._c[k].inc(v)

    def _observe_bytes(self, nbytes: int) -> None:
        self.metrics.observe("host.swap_bytes", float(nbytes), BYTES_EDGES)

    @property
    def n_free(self) -> int:
        return self.allocator.n_free

    def occupancy(self) -> float:
        return 1.0 - self.allocator.n_free / self.n_pages if self.n_pages else 0.0

    # -- the copies ----------------------------------------------------------

    def _stage(self, buf: torch.Tensor, host_idx: torch.Tensor) -> torch.Tensor:
        """Host pages ``host_idx`` of ``buf`` on the device: gathered into a
        staging tensor of their own (pinned on the card), then copied
        asynchronously."""
        staging = torch.empty((buf.shape[0], len(host_idx)) + tuple(buf.shape[2:]),
                              dtype=buf.dtype, pin_memory=self._pin)
        torch.index_select(buf, 1, host_idx, out=staging)
        return staging.to(self.device, non_blocking=True)

    # -- swap-out ----------------------------------------------------------

    @pool_mutator("free_list")
    def reserve(self, handle: SwapHandle | None, n_logical: int):
        """Bookkeeping half of a swap-out: grow the handle's host pages to
        ``n_logical`` and return ``(handle, dirty_logical_indices)``, or None
        (no host allocation held) when the pool cannot cover the growth:
        the caller falls back to recompute preemption."""
        if handle is None:
            handle = SwapHandle()
        grow = n_logical - len(handle.host_pages)
        if grow > 0:
            got = self.allocator.acquire(grow)
            if got is None:
                self._bump(exhausted_fallbacks=1)
                self.free(handle)
                return None
            handle.host_pages.extend(got)
        dirty = list(range(handle.clean_pages, n_logical))
        self._bump(dirty_pages_skipped=handle.clean_pages)
        return handle, dirty

    @pool_mutator("pools")
    def commit_many(self, device_pools, items) -> None:
        """Copy half of a swap-out for a whole victim set: ``items`` is a
        list of ``(handle, device_pages, dirty, lane, length)``.  Every
        victim's dirty pages come off the card in one page read for all seq
        leaves, and their lane states in one indexed read per state leaf.
        ``device_gets`` counts one per seq leaf and one per state leaf, as
        in the JAX package."""
        if not items:
            return
        dev_flat, host_flat = [], []
        for handle, device_pages, dirty, _lane, _length in items:
            dev_flat.extend(device_pages[i] for i in dirty)
            host_flat.extend(handle.host_pages[i] for i in dirty)
        if dev_flat and self._specs:
            host_idx = torch.tensor(host_flat, dtype=torch.long)
            bufs = self.buffers
            for path, chunk in read_pages(device_pools, dev_flat).items():
                self._bump(device_gets=1, bytes_out=chunk.nbytes)
                self._observe_bytes(chunk.nbytes)
                bufs[path].index_copy_(1, host_idx, chunk)
        state_leaves = [(path, pool) for path, pool in tree_items(device_pools)
                        if not _is_seq(path)]
        states = {}
        if state_leaves:
            lanes = torch.tensor([it[3] for it in items], dtype=torch.long, device=self.device)
            states = {path: pool.index_select(1, lanes).cpu() for path, pool in state_leaves}
            self._bump(device_gets=len(state_leaves))
        for vi, (handle, device_pages, dirty, _lane, length) in enumerate(items):
            # (layers, 1, *tail): the shape write_state takes back
            handle.state = ({path: s[:, vi: vi + 1] for path, s in states.items()}
                            if states else None)
            handle.length = length
            # pages full at swap time can never change after resume (decode
            # appends): they form the clean prefix for the next preemption
            handle.clean_pages = min(length // self.page_size, len(device_pages))
            self._bump(swap_outs=1, pages_out=len(dirty))

    @pool_mutator("pools")
    def swap_out(self, device_pools, device_pages: list[int], lane: int, length: int,
                 handle: SwapHandle | None = None):
        """Single-victim swap-out (``reserve`` + ``commit_many`` of one).
        The (possibly reused) handle, or None when the host tier is
        exhausted."""
        reserved = self.reserve(handle, len(device_pages))
        if reserved is None:
            return None
        handle, dirty = reserved
        self.commit_many(device_pools, [(handle, list(device_pages), dirty, lane, length)])
        return handle

    # -- prefix tier (page-granular, handle-free) --------------------------

    @pool_mutator("pools")
    def put_pages(self, device_pools, device_pages: list[int]):
        """Copy device pages into freshly acquired host pages (the prefix
        index retiring cold prefixes), one page read for every seq leaf.
        The host page list (the caller owns it), or None, with nothing held,
        when the host pool cannot cover it.  Decode loop only: reads the
        pools."""
        got = self.allocator.acquire(len(device_pages))
        if got is None:
            self._bump(exhausted_fallbacks=1)
            return None
        host_idx = torch.tensor(got, dtype=torch.long)
        if self._specs:
            bufs = self.buffers
            for path, chunk in read_pages(device_pools, device_pages).items():
                self._bump(device_gets=1, bytes_out=chunk.nbytes)
                self._observe_bytes(chunk.nbytes)
                bufs[path].index_copy_(1, host_idx, chunk)
        self._bump(pages_out=len(device_pages))
        return got

    @admission_api
    def get_pages(self, host_pages: list[int]) -> dict:
        """Host→device staging of individual host pages (prefix restore):
        pools untouched, so safe on the admission thread.  ``{path: (layers,
        n, PS, *row)}`` for ``PagedKVCache.commit_swap_in``; the host pages
        stay allocated (the prefix stays host-resident)."""
        host_idx = torch.tensor(host_pages, dtype=torch.long)
        staged = {}
        for path, buf in self.buffers.items():
            chunk = staged[path] = self._stage(buf, host_idx)
            self._bump(bytes_in=chunk.nbytes)
            self._observe_bytes(chunk.nbytes)
        self._bump(pages_in=len(host_pages))
        return staged

    # -- swap-in -----------------------------------------------------------

    @admission_api
    def stage_in(self, handle: SwapHandle):
        """Host→device half of a restore: every host page of ``handle`` (and
        its captured state) onto the device WITHOUT touching any pool, so
        it runs on the admission thread while the decode loop owns the
        pools.  ``(staged, state)`` for ``commit_swap_in`` and
        ``write_state``.  The host pages stay allocated: the clean prefix is
        reused if the request is preempted again."""
        host_idx = torch.tensor(handle.host_pages, dtype=torch.long)
        staged = {}
        for path, buf in self.buffers.items():
            chunk = staged[path] = self._stage(buf, host_idx)
            self._bump(bytes_in=chunk.nbytes)
            self._observe_bytes(chunk.nbytes)
        self._bump(swap_ins=1, pages_in=len(handle.host_pages))
        state = ({path: s.to(self.device) for path, s in handle.state.items()}
                 if handle.state is not None else None)
        return staged, state

    @pool_mutator("pools")
    def swap_in(self, device_pools, handle: SwapHandle, device_pages: list[int]):
        """Single-shot restore (``stage_in`` + scatter into ``device_pools``,
        in place).  Returns the state for ``write_state``, or None."""
        assert len(device_pages) == len(handle.host_pages)
        staged, state = self.stage_in(handle)
        pools = dict(tree_items(device_pools))
        idx = torch.as_tensor(device_pages, dtype=torch.long, device=self.device)
        for path, chunk in staged.items():
            pools[path][:, idx] = chunk
        return state

    # -- inter-cube migration (the data half of put-then-signal) -----------

    def export_handle(self, handle: SwapHandle):
        """Read of a request's host-resident pages for inter-cube migration:
        ``(seq_rows, state, length, n_pages)``, ``seq_rows`` ``{path: CPU
        tensor (layers, n_pages, PS, *row)}`` in logical page order (empty
        when the handle holds no page).  A copy: the handle stays valid
        until the caller frees it; no allocator state changes."""
        rows = {}
        if handle.host_pages and self._specs:
            idx = torch.tensor(handle.host_pages, dtype=torch.long)
            rows = {path: buf.index_select(1, idx) for path, buf in self.buffers.items()}
        self._bump(migrations_out=1, migration_pages_out=len(handle.host_pages))
        return rows, handle.state, handle.length, len(handle.host_pages)

    @pool_mutator("free_list")
    def import_pages(self, seq_rows, state, length: int, n_pages: int):
        """Allocation half of a migration landing (the "put"): ``n_pages``
        host pages take the payload's rows, and the returned ``SwapHandle``
        is indistinguishable from a local swap-out's, so the ordinary
        swapped restore takes it from here.  None (nothing held) when the
        pool cannot cover it: the caller degrades to prompt resubmission."""
        got = self.allocator.acquire(n_pages) if n_pages else []
        if got is None:
            self._bump(exhausted_fallbacks=1)
            return None
        if got and seq_rows:
            idx = torch.tensor(got, dtype=torch.long)
            bufs = self.buffers
            for path, rows in seq_rows.items():
                bufs[path].index_copy_(1, idx, rows.to(bufs[path].dtype))
                self._bump(bytes_in=rows.nbytes)
        self._bump(migrations_in=1, migration_pages_in=n_pages)
        return SwapHandle(host_pages=list(got), clean_pages=min(length // self.page_size, n_pages),
                          length=length, state=state)

    @pool_mutator("free_list")
    def free(self, handle: SwapHandle | None) -> None:
        """Release a request's host pages (retire, or a recompute fallback
        invalidating the copy)."""
        if handle is None or not handle.host_pages:
            return
        self.allocator.release(handle.host_pages)
        handle.host_pages = []
        handle.clean_pages = 0
        handle.state = None


__all__ = ["HostPagePool", "SwapHandle"]
