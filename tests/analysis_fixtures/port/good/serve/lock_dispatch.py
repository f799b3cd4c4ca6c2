"""Positive fixture: lock blocks hold bookkeeping only; device work runs
outside, and the one justified exception carries a skip marker."""
import torch


class Engine:
    def step(self, rows):
        with self._lock:
            self.sched.ready.append(1)              # bookkeeping only — fine
            lanes = sorted(self.sched.running)
            self._cv.notify_all()
        toks, rows = self.decode_graph(self.cache.pools)   # outside — fine
        return lanes, toks.cpu().numpy()


class HostPool:
    @property
    def buffers(self):
        with self._alloc_lock:
            if self._buffers is None:
                # the host pages' one-time pinned allocation, under the tier's own lock:
                # repro-lint: skip[no-device-work-under-lock] both threads wait for it anyway
                self._buffers = {p: torch.empty(s, pin_memory=True) for p, s in self._specs}
            return self._buffers
