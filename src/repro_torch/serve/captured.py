"""The serving engine's decode step and chunked-prefill step on static
buffers, replayed on the card as CUDA graphs: the port of the JAX engine's
compiled decode step (``self._decode = jax.jit(self._decode_impl,
donate_argnums=(1,))`` in ``repro/serve/engine.py``) and of its compiled
extend (``self._extend = jax.jit(self._extend_impl, donate_argnums=(1,))``).

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

A :class:`CapturedExtend` holds the engine's prefill slots: ``slots``
private cache trees (``model.cache_specs(1, capacity)``) allocated once, at
most as many as requests may be admitted and not yet decoding
(``AdmissionConfig.admission_inflight``), taken (and zeroed) for a chunked
prefill and given back once the decode loop has written the tree into the
pages or the request retired.  Each slot has static inputs (its chunk's
tokens and position, one int64 buffer on the device) and a persistent
last-row logits output (V,).  A full chunk (``prefill_chunk`` tokens) runs
the extend step with the position as a 0-d device tensor
(``DecoderLM.extend_step``'s device form), so one capture serves every chunk
of every request, as the reference's one ``_extend`` compile (its ``start``
traced) does:

* on the card, by default, as the replay of the slot's CUDA graph, captured
  when the engine is built (one warm-up run first; every graph in one memory
  pool of their own, apart from the decode graph's: they run one at a time,
  on the admission pipeline's thread).  A failed capture raises: there is
  no eager fallback.  The warm-up and the captures write garbage into the
  slots, which taking a slot zeroes;
* on the CPU, with ``capture=False``, or for a family whose extend reads the
  device back (``static=False``: the moe family's trimmed dispatch), by
  calling the step on the same buffers or, for the last, eagerly.

A chunk shorter than ``prefill_chunk`` (a prompt's tail: its length changes
from request to request) runs the extend eagerly on the slot's tree with an
int position.  The graphs hold the addresses of the slot trees and the
parameters: each call checks them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.ownership import pool_mutator
from repro_torch.capture import capturing, leaf_ptrs
from repro_torch.kernels import ops
from repro_torch.models.common import tree_items, tree_map


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
        with ops.captured_launches() as counts, capturing(graph, side):
            self._run()
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


class CapturedExtend:
    """One engine's prefill slots and its chunked-prefill step on them (see
    the module's docstring).  ``step(params, tree, tokens, position)`` runs
    the extend on ``tree`` and returns logits (1, 1, V) of the last
    position.  ``static``: full chunks run on the static buffers (with the
    position on the device); ``capture``: and as graph replays."""

    def __init__(self, step, params, specs, slots: int, chunk: int, vocab: int,
                 dtype: torch.dtype, device: torch.device, static: bool, capture: bool):
        if capture and not static:
            raise ValueError("CapturedExtend: only the static-buffer step can be captured")
        self._step = step
        self.chunk = chunk
        self.device = device
        self.static = static
        self.trees = [tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                               specs) for _ in range(slots)]
        self._tree_ptrs = [leaf_ptrs(t) for t in self.trees]
        self._param_ptr = _first_leaf(params).data_ptr()
        # per slot: the chunk's tokens then its position, one int64 buffer,
        # and the last position's logits row
        self._inputs = [torch.zeros(chunk + 1, dtype=torch.int64, device=device)
                        for _ in range(slots)]
        self.rows = [torch.zeros(vocab, dtype=dtype, device=device) for _ in range(slots)]
        self._free = list(range(slots))         # the engine's lock guards it
        self.graphs: list[torch.cuda.CUDAGraph | None] = [None] * slots
        self.launches: dict[str, int] = {}      # one replay's launches, by kernel
        self.runs = 0          # runs of the static step: warm-up, eager calls, replays
        self.eager_runs = 0    # chunks run eagerly with an int position (tails, moe)
        if capture:
            self._capture(params)

    # -- slots ------------------------------------------------------------------

    @pool_mutator("free_list")
    def take(self) -> int:
        """A free slot (under the engine's lock); ``zero`` it before use.
        The scheduler's in-flight bound keeps a slot for every prefill it
        admits, once the decode loop has given back those of the requests
        it took off the ready queue."""
        if not self._free:
            raise RuntimeError("no free prefill slot: more prefills in flight than "
                               "AdmissionConfig.admission_inflight")
        return self._free.pop(0)

    def zero(self, slot: int) -> None:
        """Zero a taken slot's tree (outside the lock, on the current stream,
        after every earlier use of the slot there): it stands in for a
        fresh tree, and clears the recurrent states, the rows a chunk's
        attention reads past its kv_len, and the warm-up's writes."""
        for _, t in tree_items(self.trees[slot]):
            t.zero_()

    @pool_mutator("free_list")
    def release(self, slot: int) -> None:
        """Give a slot back (under the engine's lock)."""
        if slot in self._free:
            raise RuntimeError(f"prefill slot {slot} released twice")
        self._free.append(slot)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self.trees) - len(self._free)

    # -- the step ---------------------------------------------------------------

    def _run(self, slot: int, params) -> None:
        inp = self._inputs[slot]
        logits = self._step(params, self.trees[slot], inp[:self.chunk][None], inp[self.chunk])
        self.rows[slot].copy_(logits[0, -1])

    def _capture(self, params) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        # one warm-up (builds the kernels, warms cuBLAS on the side stream)
        with torch.cuda.stream(side):
            self._run(0, params)
        self.runs += 1
        torch.cuda.current_stream(self.device).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        for slot in range(len(self.trees)):
            graph = torch.cuda.CUDAGraph()
            with ops.captured_launches() as counts, capturing(graph, side, pool):
                self._run(slot, params)
            self.graphs[slot], self.launches = graph, counts

    def __call__(self, slot: int, tree, params, tokens: np.ndarray,
                 position: int) -> torch.Tensor:
        """One chunk of ``tokens`` at ``position`` into slot ``slot``'s tree
        (``tree``, which must be that slot's) → the last position's logits
        row (V,), persistent for a full chunk (the slot's next chunk
        overwrites it)."""
        if leaf_ptrs(tree) != self._tree_ptrs[slot] \
                or _first_leaf(params).data_ptr() != self._param_ptr:
            raise RuntimeError("a prefill slot's tree or the parameters were reallocated "
                               "after the extend step was captured; they must stay in place")
        n = len(tokens)
        if not self.static or n != self.chunk:
            self.eager_runs += 1
            toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
            logits = self._step(params, tree, toks[None], int(position))
            return logits[0, -1]
        host = torch.from_numpy(np.append(np.asarray(tokens, np.int64), np.int64(position)))
        if self.device.type == "cuda":
            # a pinned copy per chunk: the host allocator keeps it until the
            # copy has run, so the next chunk cannot overwrite it early
            self._inputs[slot].copy_(host.pin_memory(), non_blocking=True)
        else:
            self._inputs[slot].copy_(host)
        graph = self.graphs[slot]
        if graph is not None:
            graph.replay()
            ops.add_launches(self.launches)
        else:
            self._run(slot, params)
        self.runs += 1
        return self.rows[slot]
