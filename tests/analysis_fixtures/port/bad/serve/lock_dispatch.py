"""Negative fixture: device work lexically under the engine lock."""
import torch
import torch.nn.functional as F


class Engine:
    def step(self, rows):
        with self._lock:
            toks = torch.argmax(rows, -1)           # BAD: torch launch under lock
            first = int(toks[0].item())             # BAD: read-back under lock
            self.cache.write_prefill([0], rows)     # BAD: page copy under lock
        return first

    def replay_locked(self):
        with self._cv:
            self.decode_graph(self.cache.pools)     # BAD: the captured step
            self.graph.replay()                     # BAD: a graph replay
            probs = F.softmax(self.rows, -1)        # BAD: F launch under lock
        return probs

    def checkpoint(self, st):
        with self._alloc_lock:
            host = self.cache.export_pages(st.pages, st.lane, st.length)  # BAD
            torch.cuda.current_stream().synchronize()                     # BAD
        return host
