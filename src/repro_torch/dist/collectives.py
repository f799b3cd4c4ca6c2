"""Compression codecs for inter-cube traffic and the wire format of the cube
processes (the port of ``repro/dist/collectives.py``).

``compress_tree``/``decompress_tree`` are the JAX package's two lossy schemes
over nested dicts and lists of tensors, bit for bit on float32 input:

* ``bf16``  — round-to-nearest-even cast to bfloat16 (2× fewer wire bytes);
* ``int8``  — per-tensor absmax affine quantization in float32, rounded
  half to even (4× fewer);
* ``none``  — identity (keeps call sites uniform).

The round trip keeps the tree's structure and restores each leaf to its
dtype (the scale leaf carries it).

``wire_pack``/``wire_unpack`` lower a tree to a picklable message of numpy
arrays.  The card's machine has numpy without ``ml_dtypes``, so a bfloat16
leaf travels as the uint16 view of its bits, tagged ``("bfloat16", bits)``;
``wire_unpack`` rebuilds it.  Mode ``none`` is bit-exact for every dtype
(the page payloads of a migration rely on it).

The JAX package's ``overlap_flags`` (XLA and libtpu flags) has no
counterpart: PyTorch has no such flags.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import tree_items, tree_map

MODES = ("none", "bf16", "int8")
_BF16 = "bfloat16"


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown compression mode {mode!r}; have {MODES}")


def _one(g) -> torch.Tensor:
    g = torch.as_tensor(g)
    return torch.ones((), dtype=g.dtype, device=g.device)


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale.to(g.dtype)


def compress_tree(tree, mode: str = "bf16"):
    """Compress every leaf; returns ``(compressed, scales)``.  ``scales`` has
    the tree's structure; its leaves are 0-d tensors in the ORIGINAL leaf
    dtype, which carry both the dequantization factor and the dtype to
    restore."""
    _check_mode(mode)
    if mode == "none":
        return tree, tree_map(_one, tree)
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), tree), tree_map(_one, tree)
    pairs = tree_map(_quantize, tree)            # (q, scale) tuples are leaves
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def decompress_tree(tree, scales, mode: str = "bf16"):
    """Exact-structure inverse of ``compress_tree``; restores leaf dtypes."""
    _check_mode(mode)
    if mode == "none":
        return tree
    return tree_map(lambda g, s: (g.float() * s.float()).to(s.dtype), tree, scales)


def _to_wire(t):
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return (_BF16, t.contiguous().view(torch.int16).numpy().view(np.uint16).copy())
    return t.numpy().copy()


def _from_wire(a) -> torch.Tensor:
    if isinstance(a, tuple):
        tag, bits = a
        if tag != _BF16:
            raise ValueError(f"unknown wire tag {tag!r}")
        return torch.from_numpy(np.array(bits).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def wire_pack(tree, mode: str = "none") -> dict:
    """Lower a tree of tensors to a self-describing, picklable message of
    numpy arrays (``compress_tree`` first).  Mode ``none`` is the exact
    identity, REQUIRED for token and page payloads; ``bf16``/``int8`` are for
    telemetry-grade traffic.  Inverse: :func:`wire_unpack`."""
    comp, scales = compress_tree(tree, mode)
    return {"mode": mode, "comp": tree_map(_to_wire, comp),
            "scales": tree_map(_to_wire, scales)}


def wire_unpack(msg: dict):
    """Decode a :func:`wire_pack` message back to a tree of CPU tensors."""
    return decompress_tree(tree_map(_from_wire, msg["comp"]),
                           tree_map(_from_wire, msg["scales"]), msg["mode"])


def wire_bytes(tree, mode: str = "bf16") -> int:
    """Bytes on the wire for one all-reduce of ``tree`` under ``mode``
    (scales included), as the JAX package counts them."""
    _check_mode(mode)
    per = {"none": None, "bf16": 2, "int8": 1}[mode]
    total = 0
    for _, g in tree_items(tree):
        g = torch.as_tensor(g)
        item = g.element_size()
        total += g.numel() * (item if per is None else per)
        if mode == "int8":
            total += item                    # the per-tensor scale
    return total


__all__ = ["MODES", "compress_tree", "decompress_tree", "wire_pack", "wire_unpack",
           "wire_bytes"]
