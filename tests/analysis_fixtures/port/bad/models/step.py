"""Negative fixture: host reads and control flow on tensor values in the
closure of a captured step (the root, a helper one call away, and a launch
wrapper in ``kernels/ops.py``)."""
import torch

from repro_torch.analysis.ownership import captured_step
from repro_torch.kernels import ops


class LM:
    @captured_step
    def decode_step(self, params, cache, tokens, positions, active):
        x = self._embed(params, tokens)
        n_active = int(active.sum())                    # BAD: graph-tensor-cast
        if positions.max() > 100:                       # BAD: graph-tensor-branch
            x = x * 0
        while x.abs().max() > 1e4:                      # BAD: graph-tensor-branch
            x = x / 2
        scale = 0.5 if active.any() else 1.0            # BAD: graph-tensor-branch
        for row in tokens[0]:                           # BAD: graph-tensor-loop
            x = x + row
        for _ in range(positions[0]):                   # BAD: graph-tensor-loop
            x = x * scale
        last = positions[-1].item()                     # BAD: graph-host-read
        lanes = active.nonzero()                        # BAD: graph-host-read
        idle = torch.where(~active)                     # BAD: graph-host-read
        out = ops.paged_decode(x, cache, positions + 1)
        return _finish(out, positions), n_active, last, lanes, idle

    def _embed(self, params, tokens):
        return params["embed"][tokens]


def _finish(x, positions):
    # tainted one call away: the parameters receive the step's tensors
    if bool(positions[0] > 0):                          # BAD: graph-tensor-cast
        x = x.masked_select(x > 0)                      # BAD: graph-host-read
    host = x.to("cpu")                                  # BAD: graph-host-read
    torch.cuda.synchronize()                            # BAD: graph-host-read
    return host, torch.equal(x, x), x.tolist()          # BAD: graph-host-read x2
