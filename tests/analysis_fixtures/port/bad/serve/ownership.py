"""Negative fixture: one of every sole-writer violation class."""
from repro_torch.analysis.ownership import (
    admission_api,
    decode_loop_only,
    pool_mutator,
)


class Cache:
    @pool_mutator("pools")
    def write_pools(self, pages):
        self.pools = pages                  # declared mutator — fine

    def rogue_write(self):
        self.pools = None                   # BAD: undeclared pools mutation
        self.block_tables[0] = -1           # BAD: undeclared table mutation
        self._free.append(3)                # BAD: undeclared free-list mutation


class Engine:
    @decode_loop_only
    def decode_step(self):
        self.cache.write_pools([1])         # decode loop owns pools — fine

    @admission_api
    def admission_entry(self):
        self.helper()

    def helper(self):
        # reachable from the admission pipeline's call graph:
        self.cache.write_pools([2])         # BAD: admission-writes-pools
        self.decode_step()                  # BAD: admission-calls-decode-only


class AdmissionPipeline:
    def worker(self):
        self.engine.cache.write_pools([3])  # BAD: pipeline-pools-call
        #                                     (+ unowned-pools-call: worker
        #                                      declares no ownership at all)
