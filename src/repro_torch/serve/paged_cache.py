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

Not ported yet: the host tier (swap preemption) and the prefix index.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.analysis.ownership import pool_mutator
from repro_torch.kernels import ops as kops
from repro_torch.models.common import SEQ_CACHE_KEYS, tree_items, tree_map, tree_map_with_path


def _is_seq(path) -> bool:
    return path[-1] in SEQ_CACHE_KEYS


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
    its position goes into that position's page (idle lanes and lanes whose
    page is unallocated write nothing).  State leaves: the new state is kept
    for active lanes only."""
    positions = positions.long()
    page = block_tables.long().gather(1, (positions // page_size)[:, None])[:, 0]
    lanes = torch.nonzero(active & (page >= 0)).squeeze(1)
    w_page, w_off = page[lanes], (positions % page_size)[lanes]
    w_pos = positions[lanes]
    keep = torch.nonzero(active).squeeze(1)
    views = dict(tree_items(new_views))
    for path, pool in tree_items(pools):
        view = views[path]
        if _is_seq(path):
            pool[:, w_page, w_off] = view[:, lanes, w_pos].to(pool.dtype)
        else:
            pool[:, keep] = view[:, keep].to(pool.dtype)
    return pools


class PageAllocator:
    """LIFO free list + per-page refcounts over ``n_pages`` physical pages.

    * ``acquire(n)``        — n pages out of the free list at refcount 1;
    * ``share(pages)``      — one more owner per (live) page;
    * ``release(pages)``    — one owner less per page; pages reaching zero
      go back to the free list (the return value).

    Callers serialize access (the engine's bookkeeping lock).  Over-release
    trips an assert the moment it happens.
    """

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))
        self._free_set = set(self._free)
        self.refs: dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
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

    def check_invariant(self) -> None:
        assert len(self._free) == len(self._free_set), "free list/set diverged"
        assert self._free_set <= set(range(self.n_pages))
        assert set(self.refs) == set(range(self.n_pages)) - self._free_set, (
            "refcount map out of sync with the free list")
        assert all(n >= 1 for n in self.refs.values())


class PagedKVCache:
    """Page pools on ``device`` + per-lane host block tables + free list."""

    def __init__(self, model, lanes: int, n_pages: int, page_size: int,
                 max_len: int, device):
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
        """Free list sane, no page mapped by more lanes than it has owners,
        no mapped page in the free list."""
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

    @pool_mutator("pools")
    def write_prefill(self, pages: list[int], cache, lane: int | None = None) -> None:
        """Scatter a prefill cache (seq leaves (layers, 1, s, *row)) into
        ``pages``, in place; state leaves go to ``lane``'s row when given.
        Seq leaves shorter than the page span are zero-padded; longer ones (a
        chunked prefill's capacity-length private tree) are cut — rows past
        the reserved pages are unwritten zeros."""
        if not pages and lane is None:
            return
        ps = self.page_size
        cap = len(pages) * ps
        pool_leaves = dict(tree_items(self.pools))
        for path, pc in tree_items(cache):
            pool = pool_leaves[path]
            if not _is_seq(path):
                if lane is not None:
                    pool[:, lane] = pc[:, 0].to(pool.dtype)
                continue
            if not pages:
                continue
            pc = pc[:, 0, :cap]
            s = pc.shape[1]
            if s < cap:       # pad the seq dim, whatever the row's rank
                pc = torch.nn.functional.pad(pc, (0, 0) * (pc.ndim - 2) + (0, cap - s))
            idx = torch.as_tensor(pages, dtype=torch.long, device=pool.device)
            pool[:, idx] = pc.reshape(
                (pc.shape[0], len(pages), ps) + pc.shape[2:]).to(pool.dtype)

    def has_state_leaves(self) -> bool:
        return any(not _is_seq(path) for path, _ in tree_items(self.pools))
