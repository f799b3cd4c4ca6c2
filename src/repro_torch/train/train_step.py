"""Training step: microbatched gradient accumulation + optimizer, the port
of ``repro/train/train_step.py``.

``make_train_step`` builds ``step(params, opt_state, batch)`` for a model
of the port.  With one microbatch the gradients come back in the
parameters' types (bf16 for bf16 parameters, as ``jax.grad`` returns
them); with more, each microbatch's gradients are added into a float32
accumulator (``accum_dtype``) and divided by the count, and so is the loss.
The optimizer then updates ``params`` and ``opt_state`` in place (see
``optim.optimizer``), so the trees passed in are the trees returned.  One
card: no sharding constraints.  The phases carry
``torch.profiler.record_function`` names (``train_step.forward_backward``,
``train_step.accumulate`` for the gradient sums, division and norm, and
``train_step.update``) so a profile can split a step; the backward's
kernels are launched from autograd's own thread, outside the first range.

The step is a :class:`TrainStep`, whose ``__call__`` is marked
``@captured_step``: it reads nothing back from the device and branches on
no tensor's value, so the card records it into a CUDA graph and replays it
(``train.captured.CapturedTrainStep``, the counterpart of
``jax.jit(make_train_step(...))``).
"""
from __future__ import annotations

import torch

from repro_torch.analysis.ownership import captured_step
from repro_torch.models.common import tree_items, tree_map_with_path
from repro_torch.optim.optimizer import Optimizer


def _split_microbatches(batch: dict, n: int):
    """The ``n`` microbatches of ``batch``, views along its first axis."""
    def sp(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} microbatches")
        return x.reshape(n, b // n, *x.shape[1:])

    split = {k: sp(v) for k, v in batch.items()}
    for i in range(n):
        yield {k: v[i] for k, v in split.items()}


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves (in sorted-path order) replaced."""
    by_path = dict(zip((path for path, _ in tree_items(tree)), leaves))
    return tree_map_with_path(lambda path, _: by_path[path], tree)


def value_and_grad(loss_fn, params, *args):
    """(loss, gradients) of ``loss_fn(params, *args)``, as ``jax.value_and_grad``
    gives them: the loss detached, the gradients in a tree of ``params``'
    structure, each dense in its leaf's layout (a gradient that comes back
    through a permuted view, as a ConvNet's HWIO weight does from
    ``F.conv2d``, is copied so), and zeros for a leaf the loss does not read
    (mamba2's ``dt_bias``).  Autograd reads detached leaves that share the
    parameters' storage, so an optimizer may then write that storage in
    place."""
    leaves = [t.detach().requires_grad_() for _, t in tree_items(params)]
    loss = loss_fn(_rebuild(params, leaves), *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), _rebuild(params, [torch.zeros_like(t) if g is None else g.contiguous()
                                            for t, g in zip(leaves, grads)])


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.linalg.vector_norm(g, dtype=torch.float32).square()
                          for _, g in tree_items(tree)))


class TrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"})``, both metrics float32 scalars on the device: the body
    the card captures as one CUDA graph (``train.captured``), as the JAX
    package jits ``make_train_step``'s step."""

    def __init__(self, model, optimizer: Optimizer, n_microbatches: int = 1,
                 impl: str = "xla", accum_dtype: torch.dtype = torch.float32):
        self.model = model
        self.optimizer = optimizer
        self.n_microbatches = n_microbatches
        self.impl = impl
        self.accum_dtype = accum_dtype

    def _forward_backward(self, params, batch):
        with torch.profiler.record_function("train_step.forward_backward"):
            return value_and_grad(self.model.loss, params, batch, self.impl)

    @captured_step
    def __call__(self, params, opt_state, batch):
        n = self.n_microbatches
        if n == 1:
            loss, grads = self._forward_backward(params, batch)
        else:
            acc, loss = None, None
            for mb in _split_microbatches(batch, n):
                l, g = self._forward_backward(params, mb)
                with torch.profiler.record_function("train_step.accumulate"):
                    g = [t for _, t in tree_items(g)]
                    if acc is None:
                        acc = [torch.zeros(t.shape, dtype=self.accum_dtype, device=t.device)
                               for t in g]
                        loss = torch.zeros((), dtype=torch.float32, device=l.device)
                    for a, gi in zip(acc, g):
                        a.add_(gi)
                    del g
                    loss = loss + l
            with torch.profiler.record_function("train_step.accumulate"):
                grads = _rebuild(params, [a.div_(n) for a in acc])
                loss = loss / n
        with torch.profiler.record_function("train_step.accumulate"):
            gnorm = global_norm(grads)
        with torch.profiler.record_function("train_step.update"):
            params, opt_state = self.optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}


def make_train_step(model, optimizer: Optimizer, n_microbatches: int = 1,
                    impl: str = "xla", accum_dtype: torch.dtype = torch.float32) -> TrainStep:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}), both metrics float32 scalars on the device."""
    return TrainStep(model, optimizer, n_microbatches, impl, accum_dtype)


def make_eval_step(model, impl: str = "xla"):
    @torch.no_grad()
    def step(params, batch):
        return model.loss(params, batch, impl)

    return step
