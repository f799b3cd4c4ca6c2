"""Shared model building blocks: parameter specs and init, norms, RoPE,
activations, and small helpers over nested parameter/cache trees.

Parameters are nested dicts of tensors with the JAX package's names and
stacked layouts (``repro/models/common.py``), so a JAX parameter tree maps
onto the port leaf for leaf (``repro_torch.convert``).  ``AxisRules`` and
``constrain`` have no counterpart: the port runs on one device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

# decode-cache leaves whose dim after the batch dim is the sequence — the
# leaves the paged serving cache splits into pages (attention k/v, MLA's
# latent and rotary key)
SEQ_CACHE_KEYS = ("k", "v", "latent", "k_rope")
# a "normal" leaf is drawn in row blocks of at most this many elements, so
# the float32 draw beside a bf16 model stays small (a stacked expert weight
# of deepseek-v3 is 7.5 G elements: 30 GB in float32)
_DRAW_BLOCK = 1 << 30


@dataclass(frozen=True)
class PSpec:
    """Declarative parameter: shape, dtype, init."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    init: str = "normal"        # normal | zeros | ones
    scale: float | None = None  # stddev override


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a cache leaf."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists (``rest`` trees share
    ``tree``'s structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path=()):
    """Map ``fn(path, leaf)`` over the leaves of nested dicts/lists; ``path``
    is the tuple of keys and indices leading to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_items(tree, path=()):
    """(path, leaf) pairs of nested dicts/lists, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    else:
        yield path, tree


def init_params(specs, generator: torch.Generator, device) -> dict:
    """Initialize a PSpec tree from one generator: N(0, fan_in^-1/2) for
    "normal" leaves (fan_in as the JAX package takes it), in sorted-path
    order.  The numbers differ from ``jax.random``'s; parity tests convert
    the JAX tree instead (``repro_torch.convert``)."""
    out: dict = {}
    for path, s in tree_items(specs):
        if s.init == "zeros":
            t = torch.zeros(s.shape, dtype=s.dtype, device=device)
        elif s.init == "ones":
            t = torch.ones(s.shape, dtype=s.dtype, device=device)
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = s.scale if s.scale is not None else float(fan_in) ** -0.5
            t = _normal(s.shape, s.dtype, std, generator, device)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def _normal(shape, dtype, std: float, generator, device) -> torch.Tensor:
    """N(0, std) drawn in float32 and cast to ``dtype``, in blocks of at most
    ``_DRAW_BLOCK`` elements (whole rows of the last dim).  The generators
    fill by linear index, so a leaf of one block draws the numbers of one
    ``randn`` of its shape."""
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.view(-1, shape[-1])
    step = max(1, _DRAW_BLOCK // shape[-1])
    for i in range(0, rows.shape[0], step):
        block = rows[i:i + step]
        block.copy_(torch.randn(block.shape, generator=generator, dtype=torch.float32,
                                device=device).mul_(std))
    return out


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in float32 (weight ``1 + w`` with ``plus_one``), cast back."""
    w = w.float()
    return F.rms_norm(x.float(), w.shape, (1.0 + w) if plus_one else w, eps).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with a bias in float32 (population variance), cast back."""
    return F.layer_norm(x.float(), w.shape, w.float(), b.float(), eps).to(x.dtype)


def sinusoidal_positions(n: int, d: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (n, d) in float32: computed in
    numpy float64 and cast, as the JAX package computes its table, so the
    two tables are equal bit for bit."""
    half = d // 2
    log_timescale = np.log(10000.0) / max(half - 1, 1)
    inv = np.exp(-log_timescale * np.arange(half))
    scaled = np.arange(n)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)
    return torch.from_numpy(table.astype(np.float32))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """Rotary tables (..., S, 1, head_dim) for ``apply_rope``: [cos, cos] and
    [-sin, sin] over the two halves.  Every layer of a step shares them."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = (positions[..., None].float() * freqs).unsqueeze(-2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of x (..., S, H, D) in float32: with x = [x1, x2],
    [x1 cos - x2 sin, x2 cos + x1 sin] (the JAX package's rope)."""
    half = x.shape[-1] // 2
    xf = x.float()
    swapped = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return torch.addcmul(xf * cos, swapped, sin).to(x.dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv1d of width K over x (B, S, C) with w (K, C) and
    bias b; ``state`` (B, K-1, C) is the trailing context (zeros when None).
    Returns (conv + b, new state): the last K-1 rows of [state, x]."""
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
           if state is None else state)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(k))
    return y + b, (xp[:, -(k - 1):] if k > 1 else pad)


def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_exact": F.gelu,
        "relu": F.relu,
    }[name]
