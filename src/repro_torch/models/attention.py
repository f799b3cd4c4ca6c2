"""Attention entry points of the model: whole-sequence / chunk attention and
the paged decode read, both through the kernels of ``kernels.ops``, and the
dense-cache decode read of the gather path in plain torch.

Layouts follow ``repro/models/attention.py``: q (B, Sq, H, D) and k/v
(B, Sk, Hkv, D) for ``attend``; one query per lane (B, H, D) against the
(n_pages, PS, Hkv, D) pools for ``paged_decode``; one query per lane
(B, 1, H, D) against per-lane caches (B, Smax, Hkv, D) for
``decode_attention``.  The kernels get strided views, never transposed
copies.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
           window: int | None = None, scale: float | None = None, q_offset: int = 0,
           kv_len: int | None = None) -> torch.Tensor:
    """Blocked GQA attention → (B, Sq, H, D).  ``q_offset`` is the absolute
    position of q[:, 0] and ``kv_len`` the number of valid cache rows, both
    run-time values (chunked prefill attends a chunk at an offset against a
    capacity-length cache)."""
    out = kops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
        window=window, scale=scale, q_offset=q_offset, kv_len=kv_len)
    return out.transpose(1, 2)


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_table: torch.Tensor, lengths: torch.Tensor,
                 scale: float | None = None) -> torch.Tensor:
    """One decode query per lane (B, H, D) over the pages its block table
    names; ``lengths`` (B,) counts each lane's valid tokens (0 = idle lane,
    which reads as zeros)."""
    return kops.paged_attention(q, k_pool, v_pool, block_table, lengths, scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor, scale: float | None = None) -> torch.Tensor:
    """Single-token attention of q (B, 1, H, D) over per-lane caches k/v
    (B, Smax, Hkv, D), lane b reading rows [0, positions[b]] → (B, 1, H, D).
    Plain torch, as ``repro/models/attention.py:decode_attention`` is XLA in
    the JAX package, with its roundings: the scaled query in the cache's
    type, scores and softmax in float32, probabilities in v's type."""
    b, _, h, d = q.shape
    smax, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else float(d) ** -0.5
    qf = (q.reshape(b, hkv, h // hkv, d) * scale).to(k.dtype)
    s = torch.einsum("bgrd,bkgd->bgrk", qf.float(), k.float())
    mask = torch.arange(smax, device=q.device)[None, :] <= positions.long()[:, None]
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
