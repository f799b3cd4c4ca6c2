"""Block-table paged KV cache: the port of ``repro/serve/paged_cache.py``.

The cache is a pool of fixed-size pages plus a per-lane block table.  Seq
leaves of the model's cache (attention k/v) become pools
``(layers, n_pages, page_size, Hkv, hd)`` shared by all lanes; the block
tables are host int32 arrays ``(lanes, pages_per_lane)`` with -1 for an
unallocated slot.  The decode loop is the only writer of both.

Not ported yet: the host tier (swap preemption), the prefix index and the
gather decode path.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.analysis.ownership import pool_mutator
from repro_torch.models.common import SEQ_CACHE_KEYS, tree_items, tree_map


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
    def write_prefill(self, pages: list[int], cache) -> None:
        """Scatter a prefill cache (seq leaves (layers, 1, s, Hkv, hd)) into
        ``pages``, in place.  Leaves shorter than the page span are
        zero-padded; longer ones (a chunked prefill's capacity-length private
        tree) are cut — rows past the reserved pages are unwritten zeros."""
        if not pages:
            return
        ps = self.page_size
        cap = len(pages) * ps
        pool_leaves = dict(tree_items(self.pools))
        for path, pc in tree_items(cache):
            if path[-1] not in SEQ_CACHE_KEYS:
                continue
            pool = pool_leaves[path]
            pc = pc[:, 0, :cap]
            s = pc.shape[1]
            if s < cap:
                pc = torch.nn.functional.pad(pc, (0, 0, 0, 0, 0, cap - s))
            idx = torch.as_tensor(pages, dtype=torch.long, device=pool.device)
            pool[:, idx] = pc.reshape(
                (pc.shape[0], len(pages), ps) + pc.shape[2:]).to(pool.dtype)
