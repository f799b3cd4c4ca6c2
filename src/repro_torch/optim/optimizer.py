"""Optimizers over the port's parameter trees: the port of
``repro/optim/optimizer.py``.

``sgd`` and ``momentum`` are the paper's STREAM_GD form (Eq. 1), ``W = C0·W
+ C1·dW``, and a step's update is one ``kernels.ops.stream_gd_foreach``
call over every leaf (momentum's two stages, the moment and then the
weight, in one pass): one launch of the hand-written kernel on the card,
its plain version on the CPU.  ``adamw`` is not of that form and stays
plain torch elementwise ops, as the JAX package leaves it to XLA; its
moments may be kept in bfloat16 (``state_dtype``).

``update(grads, state, params)`` runs under ``torch.no_grad()`` and writes
the new parameters and state into the storage of ``params`` and ``state``,
which it returns: the caller must not reuse the old trees, as with a
donated buffer in JAX.  Every state tensor, the step count too, is written
in place and never rebound, so a CUDA graph that captured an update
(``train.captured``) reads and writes the same addresses on every replay.
The coefficients are Python floats rounded to float32, as JAX's weak-typed
scalars are.  ``state_axes_like`` (mesh
sharding) has no counterpart: the port runs on one card.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import tree_items, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]   # (grads, state, params)


def _count0(params) -> torch.Tensor:
    """The step counter, an int32 scalar on the parameters' device."""
    device = next(t for _, t in tree_items(params)).device
    return torch.zeros((), dtype=torch.int32, device=device)


def _leaves(*trees):
    """Matching leaves of trees of one structure, in sorted-path order."""
    yield from zip(*([t for _, t in tree_items(tree)] for tree in trees))


def sgd(lr: float = 1e-2, weight_decay: float = 0.0) -> Optimizer:
    """Paper Eq. 1 with C0 = (1 - lr·λ), C1 = -lr: one launch per step."""

    def init(params):
        return {"count": _count0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        ops.stream_gd_foreach([((w, (w, g)),) for w, g in _leaves(params, grads)],
                              [(1.0 - lr * weight_decay, -lr)])
        state["count"] += 1
        return params, state

    return Optimizer(init, update)


def momentum(lr: float = 1e-2, beta: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    """Heavy-ball momentum as two chained Eq. 1 stages, one launch per step:
    m ← β·m + 1·g into the float32 moment, then w ← (1 - lr·λ)·w - lr·m
    from the new m (the bits of two passes, in one)."""

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), params),
                "count": _count0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        ops.stream_gd_foreach(
            [((m, (m, g)), (w, (w, ops.STAGE1)))
             for w, g, m in _leaves(params, grads, state["m"])],
            [(beta, 1.0), (1.0 - lr * weight_decay, -lr)])
        state["count"] += 1
        return params, state

    return Optimizer(init, update)


def adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    state_dtype: torch.dtype = torch.float32,
    grad_clip: float | None = 1.0,
) -> Optimizer:
    """AdamW with optional compressed moment state (bf16), plain torch ops
    in the JAX package's order of roundings."""

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=state_dtype, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": _count0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        scale = None
        if grad_clip is not None:
            gnorm = torch.sqrt(sum(g.float().square().sum() for _, g in tree_items(grads)))
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        cnt = state["count"].add_(1)
        bc1 = 1.0 - b1 ** cnt.float()
        bc2 = 1.0 - b2 ** cnt.float()
        for w, g, m_, v_ in _leaves(params, grads, state["m"], state["v"]):
            if scale is not None:
                g = g * scale.to(g.dtype)
            g = g.float()
            m32 = b1 * m_.float() + (1 - b1) * g
            v32 = b2 * v_.float() + (1 - b2) * g.square()
            step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps) + weight_decay * w.float()
            w.copy_(w.float() - lr * step)
            m_.copy_(m32)
            v_.copy_(v32)
        return params, state

    return Optimizer(init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adamw": adamw}[name](**kw)
