"""Plain PyTorch versions of the kernels.

They mirror the JAX oracles in ``repro/kernels/ref.py`` (same layouts, same
masks, float32 math) and are what ``kernels.ops`` runs for CPU tensors.  On
the card they are the reference each CUDA kernel is held against, so they
repeat the kernels' arithmetic with plain tensor ops and call no
convolution or pooling library (a float32 cuDNN convolution would run TF32).
``stream_gd`` takes the optimizer's separate streams (JAX's oracle takes
one stacked array; ``ops.stream_gd`` unstacks it), and
``stream_gd_foreach`` runs it over a list of leaves, stage by stage.
``paged_write`` is the drop-mode scatter that the JAX package leaves to
XLA (``.at[page, off].set(..., mode="drop")``), with the writing lanes
picked by ``nonzero``.
``ssd_scan`` is the chunked, factorized form of ``repro/models/ssm.py``'s
``ssd_chunked`` (the JAX oracle of the TPU kernel is the sequential
recurrence, which it equals up to rounding).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def flash_attention(
    q: torch.Tensor,              # (B, H, Sq, D)
    k: torch.Tensor,              # (B, Hkv, Sk, D)
    v: torch.Tensor,              # (B, Hkv, Sk, D)
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int | torch.Tensor = 0,          # absolute position of q[:, :, 0]
    kv_len: int | torch.Tensor | None = None,  # keys at or past kv_len are masked
) -> torch.Tensor:
    """Materialized-logits GQA attention; fully masked rows give zeros.
    ``q_offset`` and ``kv_len`` may be 0-d integer tensors on q's device
    (the kernel's device-offset form): the same mask, the same bits."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scale = scale if scale is not None else float(d) ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = kpos < (sk if kv_len is None else kv_len)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)          # fully masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,              # (B, Hkv, rep, D) one decode token per lane
    k_pool: torch.Tensor,         # (Hkv, n_pages, PS, D)
    v_pool: torch.Tensor,         # (Hkv, n_pages, PS, D)
    block_table: torch.Tensor,    # (B, P) int32, -1 = unallocated
    lengths: torch.Tensor,        # (B,) valid tokens per lane
    scale: float | None = None,
) -> torch.Tensor:
    """Gather-then-attend form of the fused paged decode read."""
    b, hkv, rep, d = q.shape
    ps = k_pool.shape[2]
    p = block_table.shape[1]
    scale = scale if scale is not None else float(d) ** -0.5
    idx = block_table.long().clamp(0, k_pool.shape[1] - 1)
    k = k_pool[:, idx]                                   # (Hkv, B, P, PS, D)
    v = v_pool[:, idx]
    k = k.permute(1, 0, 2, 3, 4).reshape(b, hkv, p * ps, d)
    v = v.permute(1, 0, 2, 3, 4).reshape(b, hkv, p * ps, d)
    s = torch.einsum("bgrd,bgkd->bgrk", q.float() * scale, k.float())
    kpos = torch.arange(p * ps, device=q.device)
    valid = (kpos[None] < lengths.long()[:, None]) & (
        block_table >= 0).repeat_interleave(ps, dim=1)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    a = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    return torch.einsum("bgrk,bgkd->bgrd", a, v.float()).to(q.dtype)


def tiled_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) in float32, cast to x's type."""
    return (x.float() @ y.float()).to(x.dtype)


def stream_mac_conv(
    x: torch.Tensor,              # (N, H, W, Ci)
    w: torch.Tensor,              # (KH, KW, Ci, Co)
    stride: tuple[int, int] = (1, 1),
    padding: tuple[int, int] = (0, 0),
    bias: torch.Tensor | None = None,   # (Co,)
    relu: bool = False,
) -> torch.Tensor:
    """Strided NHWC x HWIO convolution with symmetric zero padding: a loop
    over the taps (dy, dx) of ``strided patch @ w[dy, dx]`` in float32,
    cast to x's type; then, as asked, ``+ bias`` (in float32, rounded to
    x's type again, as a bf16 ``add_`` rounds) and ReLU."""
    n, h, wd, _ = x.shape
    kh, kw, _, co = w.shape
    sy, sx = stride
    py, px = padding
    yo = (h + 2 * py - kh) // sy + 1
    wo = (wd + 2 * px - kw) // sx + 1
    xp = F.pad(x.float(), (0, 0, px, px, py, py))
    wf = w.float()
    out = torch.zeros((n, yo, wo, co), dtype=torch.float32, device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            patch = xp[:, dy:dy + (yo - 1) * sy + 1:sy, dx:dx + (wo - 1) * sx + 1:sx]
            out += patch @ wf[dy, dx]
    out = out.to(x.dtype)
    if bias is not None:
        out = (out.float() + bias.float()).to(x.dtype)
    return torch.relu(out) if relu else out


def stream_maxpool(
    x: torch.Tensor,              # (N, H, W, C)
    window: tuple[int, int],
    stride: tuple[int, int],
) -> torch.Tensor:
    """VALID max-pooling as a loop of ``torch.maximum`` over the window's taps."""
    _, h, wd, _ = x.shape
    kh, kw = window
    sy, sx = stride
    yo = (h - kh) // sy + 1
    wo = (wd - kw) // sx + 1
    out = None
    for dy in range(kh):
        for dx in range(kw):
            tap = x[:, dy:dy + (yo - 1) * sy + 1:sy, dx:dx + (wo - 1) * sx + 1:sx]
            out = tap if out is None else torch.maximum(out, tap)
    return out.contiguous()


def paged_gather(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Block-table gather: pool (..., n_pages, F) and table (B, P) int32 →
    (..., B, P, F) with ``out[..., b, p, :] = pool[..., bt[b, p], :]`` and
    zeros where the entry is -1."""
    idx = block_table.long().clamp(0, pool.shape[-2] - 1)
    view = pool.index_select(-2, idx.reshape(-1)).unflatten(-2, tuple(block_table.shape))
    mask = (block_table >= 0)[..., None]
    return torch.where(mask, view, torch.zeros((), dtype=pool.dtype, device=pool.device))


def paged_gather_many(pools, block_table: torch.Tensor) -> list[torch.Tensor]:
    """``paged_gather`` of each pool through the one table."""
    return [paged_gather(pool, block_table) for pool in pools]


def paged_write(pools, rows, block_table: torch.Tensor, positions: torch.Tensor,
                active: torch.Tensor) -> None:
    """Drop-mode scatter of one decode step's rows, in place: for each lane
    b with ``active[b]`` whose position's table slot exists and names a page
    of the pool, ``pool[:, page, positions[b] % PS] = row[:, b]`` for every
    (pool (L, n_pages, PS, *t), row (L, B, *t)) pair; nothing else is
    written.  The writing lanes are picked with ``nonzero`` (a host read)."""
    ps = pools[0].shape[2]
    slots = block_table.shape[1]
    positions = positions.long()
    slot = positions // ps
    ok = active & (positions >= 0) & (slot < slots)
    page = block_table.long().gather(1, slot.clamp(0, slots - 1)[:, None])[:, 0]
    off = positions % ps
    for pool, row in zip(pools, rows):
        lanes = torch.nonzero(ok & (page >= 0) & (page < pool.shape[1])).squeeze(1)
        pool[:, page[lanes], off[lanes]] = row[:, lanes]


def ssd_scan(
    xh: torch.Tensor,             # (B, S, H, P)
    b: torch.Tensor,              # (B, S, N)
    c: torch.Tensor,              # (B, S, N)
    dt: torch.Tensor,             # (B, S, H) post-softplus
    a: torch.Tensor,              # (H,) negative decay rates
    chunk: int,
    init_state: torch.Tensor | None = None,   # (B, H, P, N)
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD sequence mix over chunks of ``min(chunk, S)`` tokens
    (S must be a multiple), in float32 → (y (B, S, H, P), final state
    (B, H, P, N)).  Per chunk: the log-decay cumsum ``seg``; the causal
    ``C·Bᵀ`` times ``dt·x·e_in``, times ``e_out`` (the decay factored at the
    chunk midpoint, exponents clipped to ±60); ``C·S·exp(seg)`` from the
    state before the chunk; then ``S' = exp(Σ dt·a)·S + Σ_j exp(seg_Q −
    seg_j)·dt_j·B_j⊗x_j``.  No D-skip.  ``dtype`` float64 evaluates the
    same function (the float32 products dt·a, then everything in float64)
    for checks where float32 rounding of the clipped decays matters."""
    bsz, sl, h, p = xh.shape
    n = b.shape[-1]
    q = min(chunk, sl)
    nc = sl // q
    xf = xh.to(dtype).reshape(bsz, nc, q, h, p)
    bc = b.to(dtype).reshape(bsz, nc, q, n)
    cc = c.to(dtype).reshape(bsz, nc, q, n)
    dtc = dt.float().to(dtype).reshape(bsz, nc, q, h)
    dac = (dt.float() * a.float()).to(dtype).reshape(bsz, nc, q, h)
    seg = torch.cumsum(dac, dim=2)                                  # (B, NC, Q, H)
    causal = torch.ones(q, q, dtype=torch.bool, device=xh.device).tril()
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)
    c_mid = 0.5 * (seg[:, :, :1] + seg[:, :, -1:])
    e_out = torch.exp(torch.clamp(seg - c_mid, -60.0, 60.0))
    e_in = torch.exp(torch.clamp(c_mid - seg, -60.0, 60.0))
    z = dtc[..., None] * xf * e_in[..., None]
    sm = torch.where(causal, scores, 0.0)
    y_diag = torch.einsum("bcij,bcjhp->bcihp", sm, z) * e_out[..., None]
    decay_to_end = torch.exp(seg[:, :, -1:] - seg)
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_to_end * dtc, bc, xf)
    chunk_decay = torch.exp(dac.sum(dim=2))                         # (B, NC, H)
    state = (torch.zeros((bsz, h, p, n), dtype=dtype, device=xh.device)
             if init_state is None else init_state.to(dtype))
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + states[:, ci]
    y_off = torch.einsum("bcin,bcih,bchpn->bcihp", cc, torch.exp(seg), torch.stack(prev, 1))
    return (y_diag + y_off).reshape(bsz, sl, h, p), state


def stream_gd(streams, coeffs, out_dtype: torch.dtype) -> torch.Tensor:
    """Paper Eq. 1, ``sum_j C_j * W^(j)``, as separate torch ops: each
    stream widened to float32 and multiplied by its float32 coefficient,
    the products added in stream order, the sum rounded once to
    ``out_dtype``."""
    acc = None
    for x, c in zip(streams, coeffs):
        term = x.float() * torch.tensor(c, dtype=torch.float32)
        acc = term if acc is None else acc + term
    return acc.to(out_dtype)


class _Stage1:
    """The type of ``STAGE1``."""

    def __repr__(self) -> str:
        return "STAGE1"


# a stage-2 stream of ``stream_gd_foreach``: stage 1's output of the same leaf
STAGE1 = _Stage1()


def stream_gd_foreach(leaves, stage_coeffs) -> None:
    """``stream_gd`` over a list of leaves, each one or two ``(out,
    streams)`` stages with one coefficient list per stage: stage 1 is
    computed and written into its output, then stage 2, which reads that
    output back wherever its streams name ``STAGE1``."""
    for leaf in leaves:
        written = None
        for (out, streams), coeffs in zip(leaf, stage_coeffs):
            streams = [written if s is STAGE1 else s for s in streams]
            out.copy_(stream_gd(streams, coeffs, out.dtype))
            written = out
