"""Attention entry points of the model: whole-sequence / chunk attention and
the paged decode read, both through the kernels of ``kernels.ops``.

Layouts follow ``repro/models/attention.py``: q (B, Sq, H, D) and k/v
(B, Sk, Hkv, D) for ``attend``; one query per lane (B, H, D) against the
(n_pages, PS, Hkv, D) pools for ``paged_decode``.  Both hand the kernels
strided views, never transposed copies.
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
