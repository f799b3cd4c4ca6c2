"""The serving engine's decode step on static buffers, replayed on the card
as one CUDA graph: the port of the JAX engine's compiled decode step
(``self._decode = jax.jit(self._decode_impl, donate_argnums=(1,))`` in
``repro/serve/engine.py``).

A :class:`CapturedDecode` holds the step's inputs in persistent tensors on
the engine's device (tokens (B, 1) int64, positions (B,) int64, active (B,)
bool, the block table (B, P) int32) with host staging beside them (pinned
on the card) whose numpy views the engine fills in place, and its outputs
in persistent tensors too: each lane's greedy token (B,) and the logits
rows of the last position (B, V).  A call copies the staging into the
inputs on the current stream and runs the step:

* on the card, by default, as the replay of one CUDA graph, captured once
  when the engine is built (the shapes are fixed by ``batch_slots`` and
  ``pages_per_lane``, as the reference has one jit signature).  Warm-up and
  capture run with every lane idle on a side stream, so no pool row is
  written: the decode step drops the writes of idle lanes
  (``kernels.ops.paged_write``) and keeps their recurrent states.  The
  warm-up is a real step (it builds the kernels and warms cuBLAS on that
  stream); the capture runs nothing.  A failed capture raises: there is no
  eager fallback;
* on the CPU, or with ``capture=False`` on the card, by calling the step
  on the same buffers.

The graph holds the addresses of the page pools and the parameters, so
these are written in place and never reallocated; each call checks the
pools' first leaf.  ``ops.LAUNCHES`` counts a replay as the launches the
captured step made (``ops.captured_launches``), and ``runs`` counts the
step's runs on the device (the warm-up, eager calls and replays).
Sampling stays outside: the caller reads ``rows`` after the call.
"""
from __future__ import annotations

import gc

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import tree_items


def _first_leaf(pools) -> torch.Tensor:
    return next(tree_items(pools))[1]


class CapturedDecode:
    """One engine's decode step on static buffers (see the module's
    docstring).  ``step(bt, tokens, positions, active)`` runs the step on
    the pools ``pools`` and returns logits (B, 1, V)."""

    def __init__(self, step, pools, lanes: int, slots: int, vocab: int, dtype: torch.dtype,
                 device: torch.device, capture: bool):
        self._step = step
        self._pool_ptr = _first_leaf(pools).data_ptr()
        self.device = device
        pin = device.type == "cuda"

        def staged(shape, dtype, fill=0):
            host = torch.full(shape, fill, dtype=dtype, pin_memory=pin)
            return host, torch.full(shape, fill, dtype=dtype, device=device)

        # every lane idle and every slot unallocated: the warm-up and the
        # capture run the step without writing a pool row
        self._host_bt, self.bt = staged((lanes, slots), torch.int32, -1)
        self._host_tokens, self.tokens = staged((lanes, 1), torch.int64)
        self._host_positions, self.positions = staged((lanes,), torch.int64)
        self._host_active, self.active = staged((lanes,), torch.bool)
        self.np_bt = self._host_bt.numpy()
        self.np_tokens = self._host_tokens.numpy()
        self.np_positions = self._host_positions.numpy()
        self.np_active = self._host_active.numpy()
        self.rows = torch.zeros((lanes, vocab), dtype=dtype, device=device)
        self.greedy = torch.zeros((lanes,), dtype=torch.int64, device=device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] = {}      # one replay's launches, by kernel
        self.runs = 0
        if capture:
            self._capture()

    def _run(self) -> None:
        logits = self._step(self.bt, self.tokens, self.positions, self.active)
        self.rows.copy_(logits[:, 0])
        self.greedy.copy_(logits[:, 0].argmax(-1))

    def _capture(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._run()
        self.runs += 1
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: the admission pipeline's thread (prefill, host reads)
        # cannot invalidate the capture.  No collection may run meanwhile:
        # one that frees another engine's graph (engines are reference
        # cycles) destroys it on this thread, which is not permitted while a
        # stream captures and invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with ops.captured_launches() as counts, torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                self._run()
        finally:
            if collecting:
                gc.enable()
        self.graph, self.launches = graph, counts

    def __call__(self, pools) -> tuple[torch.Tensor, torch.Tensor]:
        """One decode step over the inputs the caller wrote into the numpy
        views: → (greedy tokens (B,), logits rows (B, V)), both persistent
        (the next call overwrites them)."""
        if _first_leaf(pools).data_ptr() != self._pool_ptr:
            raise RuntimeError("the page pools were reallocated after the decode step was "
                               "captured; they must be written in place")
        # the staging is rewritten by the caller only after the previous
        # step's host read synchronised the stream, so these copies never
        # race the ones before them
        for host, dev in ((self._host_bt, self.bt), (self._host_tokens, self.tokens),
                          (self._host_positions, self.positions),
                          (self._host_active, self.active)):
            dev.copy_(host, non_blocking=True)
        if self.graph is not None:
            self.graph.replay()
            ops.add_launches(self.launches)
        else:
            self._run()
        self.runs += 1
        return self.greedy, self.rows
