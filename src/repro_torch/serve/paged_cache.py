"""Block-table paged KV cache: the port of ``repro/serve/paged_cache.py``.

The cache is a pool of fixed-size pages plus a per-lane block table.  Seq
leaves of the model's cache (attention k/v, MLA's latent and k_rope) become
pools ``(layers, n_pages, page_size, *row)`` shared by all lanes; the block
tables are host int32 arrays ``(lanes, pages_per_lane)`` with -1 for an
unallocated slot.  Recurrent-state leaves (ssm, and the hybrid's RG-LRU
``h`` and ``conv``) keep a per-lane row ``(layers, lanes, ...)``: the one
"page" of each request.  Every function here walks the whole cache tree,
so one tree may mix both kinds of leaf over several segments.  The decode loop
is the only writer of all of them.

``gather_views`` and ``absorb_decode`` are the gather decode path's tree
transforms: pools → dense per-lane views (through the ``paged_gather``
kernel on the card) and one decode step's updates back into the pools.

The allocator is refcounted (``fork_for_write`` is copy-on-write's
bookkeeping), a :class:`PrefixIndex` (a radix trie over page-sized prompt
chunks) lets admissions share resident prefix pages, and a host tier
(``host_tier.HostPagePool``) takes swapped-out pages and retired prefix
pages; ``host_import``/``host_export``/``export_pages`` carry a request's
pages from one engine to another (inter-cube migration).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.analysis.ownership import admission_api, pool_mutator
from repro_torch.kernels import ops as kops
from repro_torch.models.common import SEQ_CACHE_KEYS, tree_items, tree_map, tree_map_with_path
from repro_torch.obs.metrics import MetricsRegistry


def _is_seq(path) -> bool:
    return path[-1] in SEQ_CACHE_KEYS


def read_pages(device_pools, device_pages: list[int]) -> dict:
    """Device pages of every seq leaf → ``{path: host tensor (layers, n, PS,
    *row)}``, pinned when the pools live on the card.  One
    ``paged_gather_many`` launch through a ``(1, n)`` table reads every leaf
    (a table longer than a block keeps in shared memory is cut into several
    launches), then one device→host copy per leaf; returns once the copies
    have landed.  The decode loop's only device→host page path: swap-out,
    prefix retire and a migration checkpoint's read."""
    seq = [(path, pool) for path, pool in tree_items(device_pools) if _is_seq(path)]
    if not seq:
        return {}
    device = seq[0][1].device
    pin = device.type == "cuda"
    n = len(device_pages)
    table = torch.tensor([device_pages], dtype=torch.int32).to(device)
    flat = [pool.reshape(pool.shape[0], pool.shape[1], -1) for _, pool in seq]
    out = {path: torch.empty((pool.shape[0], n) + tuple(pool.shape[2:]), dtype=pool.dtype,
                             pin_memory=pin)
           for path, pool in seq}
    step = kops.paged_gather_table_cache() if pin else n
    for lo in range(0, n, max(step, 1)):
        rows = kops.paged_gather_many(flat, table[:, lo:lo + step])   # (layers, 1, m, F)
        for (path, pool), r in zip(seq, rows):
            m = r.shape[2]
            out[path][:, lo:lo + m].copy_(
                r.reshape((pool.shape[0], m) + tuple(pool.shape[2:])), non_blocking=True)
    if pin:
        torch.cuda.current_stream(device).synchronize()
    return out


def gather_views(pools, block_tables: torch.Tensor):
    """Per-lane contiguous views of the page pools: seq leaves
    (layers, n_pages, PS, *t) and table (lanes, P) → (layers, lanes, P*PS, *t),
    every seq leaf of the tree in one ``paged_gather`` launch; unallocated
    (-1) pages read as zeros.  State leaves pass through (the same
    tensors)."""
    bt = block_tables.to(torch.int32).contiguous()
    lanes, p = bt.shape
    seq = [(path, x) for path, x in tree_items(pools) if _is_seq(path)]
    rows = kops.paged_gather_many([x.reshape(x.shape[0], x.shape[1], -1) for _, x in seq], bt)
    views = {path: view.reshape((x.shape[0], lanes, p * x.shape[2]) + tuple(x.shape[3:]))
             for (path, x), view in zip(seq, rows)}       # (layers, lanes, P, row) each
    return tree_map_with_path(lambda path, x: views.get(path, x), pools)


def absorb_decode(pools, new_views, block_tables: torch.Tensor, positions: torch.Tensor,
                  active: torch.Tensor, page_size: int):
    """Fold one decode step's cache updates back into the pools, in place
    (returns ``pools``).  Seq leaves: the column each active lane wrote at
    its position goes into that position's page, every seq leaf in one
    ``paged_write`` launch (idle lanes and lanes whose page is unallocated
    write nothing).  State leaves: the new state is kept for active lanes
    only.  Nothing is read back to the host.  ``page_size`` is the pools'
    own (the reference's signature); the write reads it from their shape."""
    positions = positions.long()
    lanes = torch.arange(positions.shape[0], device=positions.device)
    bt = block_tables.to(torch.int32).contiguous()
    views = dict(tree_items(new_views))
    seq_pools, seq_rows = [], []
    for path, pool in tree_items(pools):
        view = views[path]
        if _is_seq(path):
            seq_pools.append(pool)
            seq_rows.append(view[:, lanes, positions].to(pool.dtype).contiguous())
        else:
            keep = active.view((1, -1) + (1,) * (pool.ndim - 2))
            pool.copy_(torch.where(keep, view.to(pool.dtype), pool))
    kops.paged_write(seq_pools, seq_rows, bt, positions, active)
    return pools


class PageAllocator:
    """LIFO free list + per-page refcounts over ``n_pages`` physical pages.

    * ``acquire(n)``        — n pages out of the free list at refcount 1;
    * ``share(pages)``      — one more owner per (live) page (the prefix
      index adopting a lane's pages, a request matching a resident prefix);
    * ``release(pages)``    — one owner less per page; pages reaching zero
      go back to the free list (the return value);
    * ``fork_for_write(p)`` — copy-on-write bookkeeping: the caller's
      reference to a *shared* page is exchanged for a fresh private page
      (the caller copies the bytes, ``PagedKVCache.fork_pages``).

    Callers serialize access (the engine's bookkeeping lock).  Over-release
    trips an assert the moment it happens.
    """

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))
        self._free_set = set(self._free)
        # page -> live reference count; a page is in exactly one of
        # (_free_set, refs) at all times
        self.refs: dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        """Live owners of ``page`` (0 = free)."""
        return self.refs.get(page, 0)

    @pool_mutator("free_list")
    def acquire(self, n: int) -> list[int] | None:
        """n fresh pages at refcount 1, or None (and no allocation) if the
        pool can't cover it."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(pages)
        for p in pages:
            self.refs[p] = 1
        return pages

    @pool_mutator("free_list")
    def share(self, pages: list[int]) -> None:
        for p in pages:
            assert 0 <= p < self.n_pages
            n = self.refs.get(p, 0)
            assert n >= 1 and p not in self._free_set, f"page {p} shared while free"
            self.refs[p] = n + 1

    @pool_mutator("free_list")
    def release(self, pages: list[int]) -> list[int]:
        freed = []
        for p in pages:
            assert 0 <= p < self.n_pages
            n = self.refs.get(p, 0)
            assert n >= 1 and p not in self._free_set, (
                f"page {p} released while free (double release)")
            if n == 1:
                del self.refs[p]
                self._free.append(p)
                self._free_set.add(p)
                freed.append(p)
            else:
                self.refs[p] = n - 1
        return freed

    @pool_mutator("free_list")
    def fork_for_write(self, page: int) -> int | None:
        """Copy-on-write bookkeeping: a private page id for the caller in
        exchange for its reference to ``page``.  ``page`` itself when the
        caller is already the sole owner, a fresh page (whose bytes the
        caller must copy) when it is shared, or None when the pool cannot
        cover the fork."""
        if self.refs.get(page, 0) <= 1:
            return page
        got = self.acquire(1)
        if got is None:
            return None
        self.release([page])
        return got[0]

    def check_invariant(self) -> None:
        """Free list + refcounts sane: no duplicates, every entry in range,
        set and list agree, and every non-free page has a live owner."""
        assert len(self._free) == len(self._free_set), "free list/set diverged"
        assert self._free_set <= set(range(self.n_pages))
        assert set(self.refs) == set(range(self.n_pages)) - self._free_set, (
            "refcount map out of sync with the free list")
        assert all(n >= 1 for n in self.refs.values())


# ---------------------------------------------------------------------------
# Prefix index (radix trie over page-sized token chunks)
# ---------------------------------------------------------------------------


@dataclass
class PrefixClaim:
    """Result of a successful prefix match at admission.

    ``kind == "full"``: the whole prompt (and its first greedy token) is
    known, prefill is skipped; ``kind == "partial"``: the leading
    ``matched_tokens`` (a page- and chunk-aligned span) are shared device
    pages and the prefill seeds from them.  ``pages`` is the request's
    complete logical page list (shared + fresh); ``restore`` carries
    ``(holder, host_page, device_page)`` triples for host-resident prefix
    pages that still need a host→device copy.
    """

    kind: str
    matched_tokens: int
    pages: list[int]
    restore: list = field(default_factory=list)
    first_token: int = -1
    state: object = None        # host copy of the recurrent state (full match)
    seed_pages: int = 0         # partial: leading shared device pages


class _PrefixNode:
    """One page-sized chunk of some prompt.  ``page`` is the resident device
    page holding that chunk's rows (the index owns one allocator reference
    to it), ``host_page`` a retired host-tier copy; either, both or neither
    may be set.  ``pending`` counts in-flight restores."""

    __slots__ = ("children", "terminals", "page", "host_page", "pending", "last_used")

    def __init__(self):
        self.children: dict[bytes, _PrefixNode] = {}
        self.terminals: dict[bytes, _Terminal] = {}
        self.page: int | None = None
        self.host_page: int | None = None
        self.pending = 0
        self.last_used = 0


class _Terminal:
    """A complete prompt ending at a node: the sub-page tail (``rem``
    tokens on ``page``), the greedy first token and, for recurrent
    families, a host copy of the post-prefill state."""

    __slots__ = ("page", "host_page", "pending", "last_used", "rem", "first_token",
                 "state", "length")

    def __init__(self, rem: int, first_token: int, length: int, state):
        self.page: int | None = None
        self.host_page: int | None = None
        self.pending = 0
        self.last_used = 0
        self.rem = rem
        self.first_token = first_token
        self.state = state
        self.length = length


class PrefixIndex:
    """Radix trie over per-page prompt content → resident device pages.

    All mutation happens under the owning engine's lock: the decode loop
    inserts finished prefills (:meth:`insert`), admission claims matches
    (:meth:`claim`: shares device pages, books host restores), and
    reclaim runs from both sides (:meth:`drop` releases only and is safe
    on the admission thread; the cache's ``prefix_retire`` also copies
    cold pages into the host tier and reads the pools, so it belongs to
    the decode loop).

    A family without seq leaves (the ssm) indexes prompts structurally and
    shares by state snapshot at the terminal: every claimed page is fresh.
    A hybrid (RG-LRU) shares the seq pages and restores state on full
    terminal matches only.  The trie's keys are the int64 bytes of each
    page-sized chunk, as in the JAX package.
    """

    _STAT_KEYS = ("hits", "misses", "hit_tokens", "lookup_tokens", "forks",
                  "retired_pages", "restored_pages", "dropped_pages")

    def __init__(self, allocator: PageAllocator, page_size: int, has_seq: bool,
                 has_state: bool = False, host=None, metrics=None, max_terminals: int = 512):
        self.allocator = allocator
        self.page_size = page_size
        self.has_seq = has_seq
        self.has_state = has_state
        self.host = host
        self.max_terminals = max_terminals
        self.root = _PrefixNode()
        self.by_page: dict[int, object] = {}   # device page -> holder
        self._terminals: list[tuple[_PrefixNode, bytes, _Terminal]] = []
        self._clock = 0
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c = {k: self.metrics.counter("prefix." + k) for k in self._STAT_KEYS}

    # -- plumbing ----------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _keys(self, tokens) -> tuple[list[bytes], bytes]:
        toks = np.asarray(tokens, np.int64)
        ps = self.page_size
        full = len(toks) // ps
        chunks = [toks[i * ps:(i + 1) * ps].tobytes() for i in range(full)]
        return chunks, toks[full * ps:].tobytes()

    def _walk(self, tokens):
        """Longest structurally matched chain (content-resident for seq
        families) plus the exact terminal when the whole prompt is known."""
        chunk_keys, rem_key = self._keys(tokens)
        node, chain = self.root, []
        for k in chunk_keys:
            child = node.children.get(k)
            if child is None:
                return chain, None
            if self.has_seq and child.page is None and child.host_page is None:
                return chain, None          # content dropped: unreachable
            chain.append(child)
            node = child
        term = node.terminals.get(rem_key)
        if (term is not None and self.has_seq and term.rem
                and term.page is None and term.host_page is None):
            term = None
        return chain, term

    def preview(self, tokens) -> int:
        """Resident-prefix tokens for ``tokens`` (no side effects)."""
        chain, term = self._walk(tokens)
        if term is not None and len(chain) == len(tokens) // self.page_size:
            return len(tokens)
        if not self.has_seq or self.has_state:
            return 0                # partial matches need seq-only caches
        return len(chain) * self.page_size

    # -- admission side (claim / drop) -------------------------------------

    def _acquire_fresh(self, n: int) -> list[int] | None:
        """Acquire with one drop-reclaim retry: admission must be able to
        shrink the index itself, or a pool full of cold prefixes deadlocks
        an idle engine (nothing running, so no decode-side reclaim)."""
        if n == 0:
            return []
        got = self.allocator.acquire(n)
        if got is None and self.drop(n):
            got = self.allocator.acquire(n)
        return got

    def claim(self, tokens, chunk: int) -> PrefixClaim | None:
        """Match ``tokens`` against the index and take ownership for one
        request: shares resident pages, acquires fresh ones for host
        restores and the unmatched tail.  None (no side effects) on a miss
        or when the pool can't cover the fresh pages."""
        n = len(tokens)
        self._c["lookup_tokens"].inc(n)
        claim = self._claim_inner(tokens, chunk) if n else None
        if claim is None:
            self._c["misses"].inc()
        else:
            self._c["hits"].inc()
            self._c["hit_tokens"].inc(claim.matched_tokens)
        return claim

    def _claim_inner(self, tokens, chunk: int) -> PrefixClaim | None:
        n_tok = len(tokens)
        ps = self.page_size
        chain, term = self._walk(tokens)
        full, rem = n_tok // ps, n_tok % ps
        total = -(-(n_tok + 1) // ps)          # pages incl. the decode slot
        if term is not None and len(chain) == full:
            holders = (list(chain) + ([term] if rem else []) if self.has_seq else [])
            if any(h.page is None for h in holders) and self.host is None:
                term = None                 # host copy gone with the tier
            else:
                n_fresh = total - sum(1 for h in holders if h.page is not None)
                # pin the claim's own holders across the acquire: on a
                # shortfall _acquire_fresh reclaims through drop(), which
                # would otherwise evict exactly these cold pages
                for h in holders:
                    h.pending += 1
                try:
                    got = self._acquire_fresh(n_fresh)
                finally:
                    for h in holders:
                        h.pending -= 1
                if got is None:
                    return None
                pages, restore, gi = [], [], 0
                for h in holders:
                    h.last_used = self._tick()
                    if h.page is not None:
                        self.allocator.share([h.page])
                        pages.append(h.page)
                    else:
                        dev = got[gi]
                        gi += 1
                        h.pending += 1
                        restore.append((h, h.host_page, dev))
                        pages.append(dev)
                pages.extend(got[gi:])
                term.last_used = self._tick()
                return PrefixClaim(kind="full", matched_tokens=n_tok, pages=pages,
                                   restore=restore, first_token=term.first_token,
                                   state=term.state)
        # partial: leading device-resident pages seed a chunked prefill.  A
        # hybrid's recurrent state at token m is not reconstructable from the
        # seq pages alone, so state-carrying families match full terminals only
        if not self.has_seq or self.has_state or chunk <= 0:
            return None
        dev_chain = 0
        for node in chain:
            if node.page is None:
                break
            dev_chain += 1
        m = min(dev_chain * ps, n_tok - 1)
        m -= m % ps
        while m > 0 and m % chunk:
            m -= ps
        if m < ps:
            return None
        k = m // ps
        # the same pin as the full path
        for i in range(k):
            chain[i].pending += 1
        try:
            got = self._acquire_fresh(total - k)
        finally:
            for i in range(k):
                chain[i].pending -= 1
        if got is None:
            return None
        shared = [chain[i].page for i in range(k)]
        self.allocator.share(shared)
        for i in range(k):
            chain[i].last_used = self._tick()
        return PrefixClaim(kind="partial", matched_tokens=m, pages=shared + got, seed_pages=k)

    def abort(self, claim: PrefixClaim) -> None:
        """Undo the restore bookkeeping of an unconsumed claim (early
        retire): holders stay host-resident, the fresh device pages ride the
        request's page list into its release."""
        for h, _hp, _dev in claim.restore:
            h.pending -= 1

    def finish_restore(self, claim: PrefixClaim) -> None:
        """Device residency restored: adopt the fresh page into each holder
        still without one (keeping the host copy: a later retire is then
        free).  Under the lock, after ``commit_swap_in``."""
        for h, _hp, dev in claim.restore:
            h.pending -= 1
            if h.page is None:
                self.allocator.share([dev])
                h.page = dev
                self.by_page[dev] = h
            h.last_used = self._tick()
        self._c["restored_pages"].inc(len(claim.restore))

    def drop(self, n: int) -> int:
        """Release up to ``n`` cold device-resident pages outright (content
        without a ``host_page`` is lost).  Touches only the free list."""
        freed = 0
        for p, h in sorted(self.by_page.items(), key=lambda kv: kv[1].last_used):
            if freed >= n:
                break
            if h.pending or self.allocator.refcount(p) != 1:
                continue
            self.allocator.release([p])
            del self.by_page[p]
            h.page = None
            freed += 1
        self._c["dropped_pages"].inc(freed)
        return freed

    # -- decode side (insert / retire) -------------------------------------

    def insert(self, tokens, pages: list[int], state, first_token: int) -> None:
        """Adopt a finished prefill's pages: walk/extend the trie, share
        each chunk page into a node that lacks one, and register the
        terminal (tail page + first greedy token + state snapshot).  Decode
        loop, under the lock, after ``write_prefill``."""
        n_tok = len(tokens)
        ps = self.page_size
        full, rem = n_tok // ps, n_tok % ps
        chunk_keys, rem_key = self._keys(tokens)
        node = self.root
        for i, key in enumerate(chunk_keys):
            child = node.children.get(key)
            if child is None:
                child = node.children[key] = _PrefixNode()
            if (self.has_seq and child.page is None and child.host_page is None
                    and child.pending == 0):
                p = pages[i]
                self.allocator.share([p])
                child.page = p
                self.by_page[p] = child
            child.last_used = self._tick()
            node = child
        term = node.terminals.get(rem_key)
        if term is None:
            if len(self._terminals) >= self.max_terminals:
                self._evict_terminal()
            term = _Terminal(rem=rem, first_token=first_token, length=n_tok, state=state)
            node.terminals[rem_key] = term
            self._terminals.append((node, rem_key, term))
            if rem and self.has_seq:
                p = pages[full]
                self.allocator.share([p])
                term.page = p
                self.by_page[p] = term
        term.last_used = self._tick()

    def _evict_terminal(self) -> None:
        """LRU-evict one idle terminal (cap on state snapshots held)."""
        idx = None
        for i, (_node, _key, t) in enumerate(self._terminals):
            if t.pending:
                continue
            if idx is None or t.last_used < self._terminals[idx][2].last_used:
                idx = i
        if idx is None:
            return
        node, key, t = self._terminals.pop(idx)
        del node.terminals[key]
        if t.page is not None:
            del self.by_page[t.page]
            self.allocator.release([t.page])
        if t.host_page is not None and self.host is not None:
            self.host.allocator.release([t.host_page])

    def retire_candidates(self, n: int) -> list[tuple[int, object]]:
        """Up to ``n`` cold sole-owned device pages without a host copy,
        LRU first: the decode loop copies these out through ``put_pages``."""
        cands = [(p, h) for p, h in self.by_page.items()
                 if not h.pending and h.host_page is None
                 and self.allocator.refcount(p) == 1]
        cands.sort(key=lambda kv: kv[1].last_used)
        return cands[:n]

    def release_host_backed(self, n: int) -> int:
        """Free up to ``n`` cold device pages that already have a host copy
        (residency can come back later at no copy-out cost)."""
        freed = 0
        for p, h in sorted(self.by_page.items(), key=lambda kv: kv[1].last_used):
            if freed >= n:
                break
            if h.pending or h.host_page is None or self.allocator.refcount(p) != 1:
                continue
            self.allocator.release([p])
            del self.by_page[p]
            h.page = None
            freed += 1
        self._c["retired_pages"].inc(freed)
        return freed

    def note_retired(self, entries) -> None:
        """Commit a ``put_pages`` copy-out: mark the holders host-resident
        and release their device pages."""
        for (p, h), hp in entries:
            h.host_page = hp
            self.allocator.release([p])
            del self.by_page[p]
            h.page = None
        self._c["retired_pages"].inc(len(entries))

    def note_fork(self, n: int = 1) -> None:
        self._c["forks"].inc(n)


# ---------------------------------------------------------------------------
# The cache object (pools + tables + allocator)
# ---------------------------------------------------------------------------


class PagedKVCache:
    """Page pools on ``device`` + per-lane host block tables + free list.

    ``host_pages > 0`` attaches a host tier (``host_tier.HostPagePool``):
    host-memory twins of the seq-leaf pools that preemption swaps victim
    pages out to instead of freeing them (``swap_out`` / ``swap_in``), and
    that cold prefix pages retire into.  ``prefix_sharing`` attaches a
    :class:`PrefixIndex` over the pool."""

    def __init__(self, model, lanes: int, n_pages: int, page_size: int,
                 max_len: int, device, host_pages: int = 0, metrics=None,
                 prefix_sharing: bool = False):
        self.model = model
        self.lanes = lanes
        self.page_size = page_size
        self.n_pages = n_pages
        self.pages_per_lane = math.ceil(max_len / page_size)
        self.capacity = self.pages_per_lane * page_size   # per-lane view length
        self.pools = tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
            model.cache_page_specs(lanes, n_pages, page_size))
        self.allocator = PageAllocator(n_pages)
        self.block_tables = np.full((lanes, self.pages_per_lane), -1, np.int32)
        self.host = None
        if host_pages:
            from .host_tier import HostPagePool

            self.host = HostPagePool(self.pools, host_pages, page_size, metrics=metrics)
        self.prefix = None
        if prefix_sharing:
            self.prefix = PrefixIndex(
                self.allocator, page_size, has_seq=self._has_seq_leaves(),
                has_state=self.has_state_leaves(), host=self.host, metrics=metrics)

    def _has_seq_leaves(self) -> bool:
        return any(_is_seq(path) for path, _ in tree_items(self.pools))

    def has_state_leaves(self) -> bool:
        return any(not _is_seq(path) for path, _ in tree_items(self.pools))

    # -- host-side bookkeeping ---------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.page_size)

    def acquire(self, n_tokens: int) -> list[int] | None:
        return self.allocator.acquire(self.pages_for(n_tokens))

    @pool_mutator("pools")
    def assign_lane(self, lane: int, pages: list[int]) -> None:
        self.block_tables[lane] = -1
        self.block_tables[lane, : len(pages)] = pages

    @pool_mutator("pools")
    def extend_lane(self, lane: int, page: int, n_owned: int) -> None:
        self.block_tables[lane, n_owned] = page

    @pool_mutator("pools")
    def clear_lane(self, lane: int) -> None:
        self.block_tables[lane] = -1

    def occupancy(self) -> float:
        return 1.0 - self.allocator.n_free / self.n_pages

    def check_invariant(self) -> None:
        """Pool/table consistency: the free lists are sane, no page is mapped
        by more lanes than it has owners, no mapped page is free, and the
        prefix index holds only live pages."""
        self.allocator.check_invariant()
        mapped = self.block_tables[self.block_tables >= 0].tolist()
        counts: dict[int, int] = {}
        for p in mapped:
            counts[p] = counts.get(p, 0) + 1
        for p, c in counts.items():
            assert c <= self.allocator.refcount(p), (
                f"page {p} mapped by {c} lanes with refcount "
                f"{self.allocator.refcount(p)}")
        stale = set(mapped) & self.allocator._free_set
        assert not stale, f"free pages still mapped by a lane: {sorted(stale)}"
        if self.prefix is not None:
            for p, h in self.prefix.by_page.items():
                assert h.page == p, "prefix index reverse map out of sync"
                assert self.allocator.refcount(p) >= 1, f"prefix index holds freed page {p}"
        if self.host is not None:
            self.host.allocator.check_invariant()

    # -- per-request writes (decode loop) ------------------------------------

    @pool_mutator("pools")
    def write_prefill(self, pages: list[int], cache, lane: int | None = None,
                      skip_pages: int = 0) -> None:
        """Scatter a prefill cache (seq leaves (layers, 1, s, *row)) into
        ``pages``, in place; state leaves go to ``lane``'s row when given.
        Seq leaves shorter than the page span are zero-padded; longer ones (a
        chunked prefill's capacity-length private tree) are cut — rows past
        the reserved pages are unwritten zeros.

        ``skip_pages`` leading pages are left untouched: a partial prefix
        match seeded the prefill from those *shared* pages, whose pool rows
        are already bit-identical (and co-owned by other lanes)."""
        ps = self.page_size
        dst = pages[skip_pages:]
        if not dst and lane is None:
            return
        cap = len(dst) * ps
        pool_leaves = dict(tree_items(self.pools))
        for path, pc in tree_items(cache):
            pool = pool_leaves[path]
            if not _is_seq(path):
                if lane is not None:
                    pool[:, lane] = pc[:, 0].to(pool.dtype)
                continue
            if not dst:
                continue
            pc = pc[:, 0, skip_pages * ps: skip_pages * ps + cap]
            s = pc.shape[1]
            if s < cap:       # pad the seq dim, whatever the row's rank
                pc = torch.nn.functional.pad(pc, (0, 0) * (pc.ndim - 2) + (0, cap - s))
            idx = torch.as_tensor(dst, dtype=torch.long, device=pool.device)
            pool[:, idx] = pc.reshape(
                (pc.shape[0], len(dst), ps) + pc.shape[2:]).to(pool.dtype)

    @pool_mutator("pools")
    def write_state(self, lane: int, state) -> None:
        """Copy recurrent-state rows ``{path: (layers, 1, *tail)}`` (a
        swap's captured state, or a prefix terminal's snapshot) into
        ``lane``'s row."""
        pool_leaves = dict(tree_items(self.pools))
        for path, s in state.items():
            pool = pool_leaves[path]
            pool[:, lane] = s[:, 0].to(device=pool.device, dtype=pool.dtype)

    # -- host tier (swap-vs-recompute preemption) --------------------------

    def swap_reserve(self, st):
        """Bookkeeping half of a swap-out for one victim: reserve host pages
        and compute the dirty list.  ``(handle, dirty)``, or None (host tier
        absent or exhausted: recompute instead).  Under the engine lock."""
        if self.host is None:
            return None
        return self.host.reserve(st.swap_handle, len(st.pages))

    @pool_mutator("pools")
    def swap_out_batch(self, swap_items) -> None:
        """Copy half for a victim set: ``swap_items`` is ``[(st, dirty)]``
        with host pages already reserved.  One page read covers every
        victim's dirty pages of every seq leaf."""
        self.host.commit_many(self.pools, [
            (st.swap_handle, list(st.pages), dirty, st.lane, st.length)
            for st, dirty in swap_items])

    @pool_mutator("pools")
    def swap_out(self, pages: list[int], lane: int, length: int, handle=None):
        """Copy a victim's pages + lane state to the host tier.  A
        ``SwapHandle``, or None (host tier absent or exhausted; no host
        pages held)."""
        if self.host is None:
            return None
        return self.host.swap_out(self.pools, pages, lane, length, handle)

    @admission_api
    def stage_in(self, handle):
        """Host→device staging for a restore: pools untouched (safe on the
        admission pipeline thread).  ``(staged, state)`` for
        ``commit_swap_in`` and ``write_state``."""
        return self.host.stage_in(handle)

    @pool_mutator("pools")
    def commit_swap_in(self, staged, pages: list[int]) -> None:
        """Scatter staged rows ``{path: (layers, n, PS, *row)}`` into device
        ``pages`` (the decode loop is the only pools writer).  ``pages`` may
        carry one growth page past the staged rows (``Scheduler.admit_next``):
        only the staged prefix is written."""
        pool_leaves = dict(tree_items(self.pools))
        for path, chunk in staged.items():
            pool = pool_leaves[path]
            idx = torch.as_tensor(pages[: chunk.shape[1]], dtype=torch.long,
                                  device=pool.device)
            pool[:, idx] = chunk

    @pool_mutator("pools")
    def swap_in(self, handle, pages: list[int]):
        """Restore a swapped request into device ``pages``; returns its
        captured recurrent state (None for stateless models), to be written
        once a lane is assigned."""
        return self.host.swap_in(self.pools, handle, pages)

    def host_free(self, handle) -> None:
        if self.host is not None:
            self.host.free(handle)

    # -- inter-cube migration (serve/cube_proc.py) -------------------------

    def host_import(self, seq_rows, state, length: int, n_pages: int):
        """Land a migration payload in the host tier: a ``SwapHandle`` the
        ordinary swapped restore consumes, or None (host tier absent or
        exhausted: the caller degrades to prompt resubmission)."""
        if self.host is None:
            return None
        return self.host.import_pages(seq_rows, state, length, n_pages)

    def host_export(self, handle):
        """A swapped request's host pages as a migration payload ``(seq_rows,
        state, length, n_pages)``; a read, the handle stays valid until
        freed."""
        return self.host.export_handle(handle)

    def export_pages(self, pages: list[int], lane, length: int):
        """Non-destructive device→host read of a request's pages (and its
        lane's recurrent state when ``lane`` is given) as a migration or
        shadow payload ``(seq_rows, state)``: ``{path: CPU tensor (layers,
        n, PS, *row)}`` through one ``paged_gather_many`` launch, as the
        swap-out reads, and ``{path: CPU tensor (layers, 1, *tail)}`` or
        None.  Decode loop only: it reads the pools after the loop's last
        step on the same stream."""
        rows = read_pages(self.pools, list(pages))
        state = None
        if lane is not None and self.has_state_leaves():
            state = {path: pool[:, lane:lane + 1].cpu() for path, pool in tree_items(self.pools)
                     if not _is_seq(path)}
        return rows, state

    def host_occupancy(self) -> float:
        return self.host.occupancy() if self.host is not None else 0.0

    # -- prefix sharing (radix index + copy-on-write) ----------------------

    @admission_api
    def claim_match(self, tokens, chunk: int):
        """Admission-side prefix lookup: a :class:`PrefixClaim` whose pages
        the request already owns (shared + fresh), or None.  Under the
        engine lock."""
        if self.prefix is None or not len(tokens):
            return None
        return self.prefix.claim(tokens, chunk)

    @admission_api
    def seed_prefix(self, tree, pages: list[int]):
        """Copy ``pages``' pool rows into positions ``[0, len(pages) * PS)``
        of a private prefill tree (admission thread), in place; returns the
        tree.  Shared prefix pages are never written in place (copy-on-
        write), so the read races with no pools write."""
        ps = self.page_size
        span = len(pages) * ps
        pool_leaves = dict(tree_items(self.pools))
        for path, pc in tree_items(tree):
            if not _is_seq(path):
                continue
            pool = pool_leaves[path]
            idx = torch.as_tensor(pages, dtype=torch.long, device=pool.device)
            take = pool[:, idx]                        # (layers, P, PS, *row)
            pc[:, :, :span] = take.reshape(
                (take.shape[0], 1, span) + take.shape[3:]).to(pc.dtype)
        return tree

    def snapshot_state(self, cache):
        """Host copy ``{path: (layers, 1, *tail)}`` of the recurrent-state
        leaves of a prefill tree, for the prefix index; None for stateless
        families.  A device read: call outside the lock."""
        if not self.has_state_leaves():
            return None
        return {path: x.to("cpu", copy=True) for path, x in tree_items(cache)
                if not _is_seq(path)}

    @pool_mutator("pools")
    def fork_pages(self, copies: list[tuple[int, int]]) -> None:
        """Device half of copy-on-write: duplicate each ``(src, dst)`` page's
        rows in every seq-leaf pool (one indexed copy per leaf for the whole
        fork batch)."""
        if not copies:
            return
        for path, pool in tree_items(self.pools):
            if not _is_seq(path):
                continue
            src = torch.as_tensor([a for a, _ in copies], dtype=torch.long, device=pool.device)
            dst = torch.as_tensor([b for _, b in copies], dtype=torch.long, device=pool.device)
            pool[:, dst] = pool[:, src]

    def prefix_insert(self, tokens, pages, state, first_token: int) -> None:
        """Adopt a finished prefill into the index (decode loop, under the
        lock, after ``write_prefill``)."""
        if self.prefix is not None:
            self.prefix.insert(tokens, pages, state, first_token)

    def prefix_drop(self, n: int) -> int:
        """Admission-safe index shrink: release cold pages outright."""
        if self.prefix is None:
            return 0
        return self.prefix.drop(n)

    def prefix_retire(self, n: int) -> int:
        """Decode-side index shrink: free host-backed cold pages first (no
        copy), then copy the coldest unbacked pages into the host tier (one
        page read for every seq leaf); drop content when the host tier is
        absent or exhausted.  Returns the pages returned to the free list."""
        if self.prefix is None:
            return 0
        freed = self.prefix.release_host_backed(n)
        if freed >= n:
            return freed
        if self.host is None or not self.prefix.has_seq:
            return freed + self.prefix.drop(n - freed)
        cands = self.prefix.retire_candidates(n - freed)
        if cands:
            host_pages = self.host.put_pages(self.pools, [p for p, _h in cands])
            if host_pages is None:
                return freed + self.prefix.drop(n - freed)
            self.prefix.note_retired(list(zip(cands, host_pages)))
            freed += len(cands)
        if freed < n:
            freed += self.prefix.drop(n - freed)
        return freed

    def prefix_finish_restore(self, claim) -> None:
        """Flip restored holders back to device-resident (under the lock,
        after ``commit_swap_in`` of the staged prefix pages)."""
        if self.prefix is not None:
            self.prefix.finish_restore(claim)

    def abort_match(self, claim) -> None:
        """Drop the restore bookkeeping of a claim that retires before its
        lane fill (the stored first token ends it)."""
        if self.prefix is not None:
            self.prefix.abort(claim)
