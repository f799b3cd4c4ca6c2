"""The training step on static buffers, replayed on the card as one CUDA
graph: the port of the JAX package's compiled step
(``jax.jit(make_train_step(...))`` in ``repro/train/trainer.py``, the
``@jax.jit`` step of ``examples/train_convnet.py``).

A :class:`CapturedTrainStep` wraps a step ``step(params, opt_state, batch)
-> (params, opt_state, metrics)`` that updates ``params`` and
``opt_state`` in place (``train_step.TrainStep``, the ConvNet example's
step) and returns a dict of scalar metrics.  It keeps, per batch
signature (keys, shapes and dtypes: one per run, as jit keeps one compile
per signature), the batch in static tensors on the device and the metrics
in persistent tensors.  A call copies the batch into the static tensors on
the current stream and runs the step:

* on the card, by default, as the replay of a CUDA graph.  The first call
  of a signature is the warm-up: a real training step, run eagerly on a
  side stream (it builds the kernels and makes autograd's device thread
  its cuBLAS handle and workspace on that stream), whose update is kept.
  ``torch.cuda.empty_cache()`` then returns the blocks it freed, and the
  step is captured on the same stream (the capture runs nothing, so N
  calls are exactly N updates).  The backward's kernels, launched from
  autograd's device thread onto the capture stream, are in the graph
  (``capture.capturing``).  Calls 2 onward replay.  A failed capture
  raises: there is no eager fallback;
* on the CPU, or with ``capture=False`` on the card, by calling the step on
  the same buffers.

The graph holds the addresses of ``params`` and ``opt_state``; the step
holds their leaves, so the addresses stay theirs, and each call checks them
and raises if the caller passes other tensors (a restart, a restore from a
checkpoint: ``holds`` tells the caller to build a new step).
``ops.LAUNCHES`` counts a replay as the launches the captured step made
(``ops.captured_launches``): an ``sgd`` or ``momentum`` update's one
``stream_gd`` launch per step.  The metrics returned are the persistent
tensors: the next call overwrites them.
"""
from __future__ import annotations

import time

import torch

from repro_torch.capture import capturing, leaf_ptrs
from repro_torch.kernels import ops
from repro_torch.models.common import tree_items


def _signature(batch: dict) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))


class _Graph:
    """One batch signature's static batch, persistent metrics and graph."""

    def __init__(self, batch: dict, device: torch.device):
        self.batch = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                      for k, v in batch.items()}
        self.metrics: dict[str, torch.Tensor] = {}
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] = {}      # one replay's launches, by kernel


class CapturedTrainStep:
    """A training step on static buffers (see the module's docstring)."""

    def __init__(self, step, params, opt_state, device: torch.device, capture: bool):
        if capture and device.type != "cuda":
            raise ValueError("CapturedTrainStep: only a step on the card is captured")
        self._step = step
        self.device = device
        self.capture = capture
        self._held = [t for _, t in tree_items([params, opt_state])]
        self._ptrs = leaf_ptrs([params, opt_state])
        self._graphs: dict[tuple, _Graph] = {}
        self._side = torch.cuda.Stream(device) if capture else None
        self.runs = 0          # steps run: the warm-ups, eager calls and replays
        self.replays = 0
        self.capture_s = 0.0   # wall seconds of the captures (instantiation included)

    def holds(self, params, opt_state) -> bool:
        """Whether ``params`` and ``opt_state`` are the trees the step was
        built on, leaf for leaf at the same addresses."""
        return leaf_ptrs([params, opt_state]) == self._ptrs

    @property
    def graphs(self) -> int:
        return sum(g.graph is not None for g in self._graphs.values())

    def _step_into(self, g: _Graph, params, opt_state) -> None:
        _, _, metrics = self._step(params, opt_state, g.batch)
        if not g.metrics:
            g.metrics = {k: torch.empty_like(v) for k, v in metrics.items()}
        for k, v in metrics.items():
            g.metrics[k].copy_(v)

    def _capture(self, g: _Graph, params, opt_state) -> None:
        side = self._side
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._step_into(g, params, opt_state)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with ops.captured_launches() as counts, capturing(graph, side):
            self._step_into(g, params, opt_state)
        self.capture_s += time.perf_counter() - t0
        g.graph, g.launches = graph, counts

    def __call__(self, params, opt_state, batch: dict):
        """One training step on ``batch`` → (params, opt_state, metrics),
        the trees updated in place and the metrics persistent."""
        if not self.holds(params, opt_state):
            raise RuntimeError("the parameters or the optimizer state are not the tensors "
                               "the training step was built on; build a new step for them")
        sig = _signature(batch)
        g = self._graphs.get(sig)
        first = g is None
        if first:
            g = self._graphs[sig] = _Graph(batch, self.device)
        for k, v in batch.items():
            g.batch[k].copy_(v, non_blocking=True)
        if first and self.capture:
            self._capture(g, params, opt_state)
        elif g.graph is not None:
            g.graph.replay()
            ops.add_launches(g.launches)
            self.replays += 1
        else:
            self._step_into(g, params, opt_state)
        self.runs += 1
        return params, opt_state, g.metrics
