"""Positive fixture: declared mutators called from their owning thread's
call graph; admission sticks to the free-list/staging API."""
from repro_torch.analysis.ownership import (
    admission_api,
    decode_loop_only,
    pool_mutator,
)


class Cache:
    def __init__(self):
        self.pools = None                   # construction is exempt

    @pool_mutator("pools")
    def fold_results(self, pages):
        self.pools = pages

    @pool_mutator("free_list")
    def reserve(self, n):
        return self._free.pop()


class Engine:
    @decode_loop_only
    def fill(self):
        self.cache.fold_results([0])        # decode loop owns pools — fine

    @admission_api
    def admit(self):
        self.cache.reserve(1)               # free list under the lock — fine
