"""Attention entry points of the model: whole-sequence / chunk attention
(through the flash kernel of ``kernels.ops`` for serving, or the
differentiable chunked scan ``flash_attention_xla`` for training), the
paged decode read through the paged kernel, the windowed paged decode
read through the ``paged_gather`` kernel, and the dense-cache decode read
of the gather path in plain torch.

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


NEG_INF = -1e30


def _mask(qpos, kpos, causal: bool, window: int | None, kv_len):
    m = kpos[None, :] < kv_len
    if causal:
        m = m & (qpos[:, None] >= kpos[None, :])
    if window is not None:
        m = m & ((qpos[:, None] - kpos[None, :]) < window)
    return m            # (Sq, Sk_chunk)


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None, q_offset: int = 0,
                        kv_len: int | None = None, chunk: int = 1024) -> torch.Tensor:
    """Nested-chunk streaming attention in plain, differentiable torch: the
    port of ``repro/models/attention.py:flash_attention_xla`` with its
    numerics.  q (B, Sq, H, D), k/v (B, Sk, Hkv, D) → (B, Sq, H, D).  Each q
    block of ``chunk`` rows runs an online softmax over kv blocks of
    ``chunk`` rows: the scaled query in q's type, scores, running max and
    sum and the accumulator in float32, masked scores ``NEG_INF`` (the
    causal / ``window`` / ``kv_len`` mask of ``_mask``), probabilities in
    v's type for the PV product, and a final division by max(l, 1e-30).
    The q blocks are not checkpointed one by one (JAX checkpoints them): the
    model's per-layer remat bounds what a training step keeps."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = h // hkv
    scale = scale if scale is not None else float(d) ** -0.5
    kv_len = kv_len if kv_len is not None else sk
    dev = q.device
    qpos = q_offset + torch.arange(sq, device=dev)
    kchunk = min(chunk, sk)
    nk = -(-sk // kchunk)
    kpad = nk * kchunk - sk
    if kpad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, kpad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, kpad))
    qchunk = min(chunk, sq)
    nq = -(-sq // qchunk)
    qpad = nq * qchunk - sq
    qf = (q.reshape(b, sq, hkv, rep, d) * scale).float()
    if qpad:
        qf = torch.nn.functional.pad(qf, (0, 0, 0, 0, 0, 0, 0, qpad))
        qpos = torch.nn.functional.pad(qpos, (0, qpad))
    outs = []
    for qi in range(nq):
        qc = qf[:, qi * qchunk:(qi + 1) * qchunk].to(k.dtype).float()   # (B,qc,Hkv,rep,D)
        qp = qpos[qi * qchunk:(qi + 1) * qchunk]
        m_run = torch.full((b, hkv, rep, qchunk), NEG_INF, dtype=torch.float32, device=dev)
        l_run = torch.zeros((b, hkv, rep, qchunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, rep, qchunk, d), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kb = k[:, ki * kchunk:(ki + 1) * kchunk]
            vb = v[:, ki * kchunk:(ki + 1) * kchunk]
            kpos = torch.arange(ki * kchunk, (ki + 1) * kchunk, device=dev)
            s = torch.einsum("bqgrd,bkgd->bgrqk", qc, kb.float())
            msk = _mask(qp, kpos, causal, window, kv_len)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(msk, p, 0.0)
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(dim=-1)
            pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(vb.dtype).float(), vb.float())
            acc = acc * alpha[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp(l_run[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))                         # (B,qc,Hkv,rep,D)
    out = torch.cat(outs, dim=1) if nq > 1 else outs[0]
    return out.reshape(b, nq * qchunk, h, d)[:, :sq].to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
           window: int | None = None, scale: float | None = None, q_offset: int = 0,
           kv_len: int | None = None, impl: str = "kernel",
           chunk: int = 1024) -> torch.Tensor:
    """Blocked GQA attention → (B, Sq, H, D).  ``q_offset`` is the absolute
    position of q[:, 0] and ``kv_len`` the number of valid cache rows, both
    run-time values (chunked prefill attends a chunk at an offset against a
    capacity-length cache).  ``impl="kernel"`` (serving) runs the flash
    kernel, which has no backward; ``impl="xla"`` (training, as JAX's train
    step attends) the differentiable ``flash_attention_xla`` in blocks of
    ``chunk``."""
    if impl == "xla":
        return flash_attention_xla(q, k, v, causal=causal, window=window, scale=scale,
                                   q_offset=q_offset, kv_len=kv_len, chunk=chunk)
    if impl != "kernel":
        raise ValueError(f"attend: impl must be 'kernel' or 'xla', got {impl!r}")
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
                     positions: torch.Tensor, window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """Single-token attention of q (B, 1, H, D) over per-lane caches k/v
    (B, Smax, Hkv, D), lane b reading rows [0, positions[b]] (with a
    ``window``, only the ``window`` rows up to it) → (B, 1, H, D).  Plain
    torch, as ``repro/models/attention.py:decode_attention`` is XLA in the
    JAX package, with its roundings: the scaled query in the cache's type,
    scores and softmax in float32, probabilities in v's type."""
    b, _, h, d = q.shape
    smax, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else float(d) ** -0.5
    qf = (q.reshape(b, hkv, h // hkv, d) * scale).to(k.dtype)
    s = torch.einsum("bgrd,bkgd->bgrk", qf.float(), k.float())
    kpos = torch.arange(smax, device=q.device)[None, :]
    positions = positions.long()[:, None]
    mask = kpos <= positions
    if window is not None:
        mask = mask & (positions - kpos < window)
    s = torch.where(mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def paged_lane_views(pools, block_table: torch.Tensor) -> list[torch.Tensor]:
    """Per-lane contiguous views of one layer's page pools, each
    (n_pages, PS, *t) of its own row, through table (B, P) int32 →
    (B, P*PS, *t) each, ``-1`` slots read as zeros: one ``paged_gather``
    launch over every pool, each seen as (n_pages, PS·prod(t)) rows, each
    view bit-identical to the JAX package's ``paged_lane_view``."""
    b, p = block_table.shape
    views = kops.paged_gather_many([pool.reshape(pool.shape[0], -1) for pool in pools],
                                   block_table)
    return [view.reshape((b, p * pool.shape[1]) + tuple(pool.shape[2:]))
            for pool, view in zip(pools, views)]


def paged_lane_view(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """``paged_lane_views`` of one pool."""
    return paged_lane_views([pool], block_table)[0]


def paged_write_slots(block_table: torch.Tensor, positions: torch.Tensor,
                      active: torch.Tensor, page_size: int):
    """Where one decode step writes its new cache rows: (lanes, pages,
    offsets) of the active lanes whose position's page is allocated.  torch
    has no ``mode="drop"`` scatter, so the writing lanes are picked up front
    (one host sync per step, shared by every layer)."""
    positions = positions.long()
    page = block_table.gather(1, (positions // page_size)[:, None])[:, 0]
    lanes = torch.nonzero(active & (page >= 0)).squeeze(1)
    return lanes, page[lanes].long(), (positions % page_size)[lanes]


def paged_decode_windowed(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                          block_table: torch.Tensor, positions: torch.Tensor,
                          window: int | None, scale: float | None = None) -> torch.Tensor:
    """Paged decode for windowed (local) attention layers, which the paged
    kernel does not mask: the port of ``paged_decode_attention_xla``.  Each
    lane's pages are gathered into transient views (``paged_lane_views``:
    one launch for k and v) and attended by ``decode_attention``
    with the window: q (B, 1, H, D) → (B, 1, H, D), bit-equal to the
    gather path's read.  As in the reference, a ``-1`` slot inside a lane's
    length reads as a zero row (the engine leaves no such holes)."""
    kc, vc = paged_lane_views([k_pool, v_pool], block_table)
    return decode_attention(q, kc, vc, positions, window=window, scale=scale)
