"""DeepSeek-V3 multi-head latent attention (MLA): the port of
``repro/models/mla.py``.

Q and KV are compressed to low-rank latents; the decode cache keeps only
the KV latent (B, S, kv_lora_rank) and the shared rotary key
(B, S, qk_rope_head_dim), which has no heads axis.  Rotary tables are built
at ``qk_rope_head_dim`` (``mla_rope_tables``), not at ``cfg.hd``.

* ``mla_attention`` (prefill and training) decompresses K and V, pads V
  from ``v_head_dim`` to ``qk_nope + qk_rope`` so one attention serves
  both, and attends through ``attention.attend``: in prefill the
  ``flash_attention`` kernel on the card (head_dim 192 at the published
  widths), its plain version on the CPU; in training (``impl="xla"``) the
  differentiable chunked scan, as the reference runs
  ``flash_attention_xla`` on both.
* Decode and chunked prefill use the published weight-absorption form
  (``_absorbed_attend``): queries are absorbed into latent space so the
  cache is never decompressed.  ``mla_decode`` reads dense per-lane views
  (the gather path), ``mla_decode_paged`` writes its new latents with one
  ``paged_write`` launch and gathers the lanes' pages through
  ``paged_lane_views`` (one ``paged_gather`` launch per layer) and then
  runs the same contraction, so the two are bit-equal.  The contraction is
  plain torch, as the reference leaves it to XLA.

Caches are written in place, as the port's attention layers write theirs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import NEG_INF, attend, paged_lane_views, paged_write_step
from .common import PSpec, TensorSpec, apply_rope, rms_norm, rope_tables


def mla_specs(cfg) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dt = cfg.torch_dtype
    qk, qr, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    return {
        "wq_a": PSpec((d, m.q_lora_rank), dt),
        "q_norm": PSpec((m.q_lora_rank,), torch.float32, "ones"),
        "wq_b": PSpec((m.q_lora_rank, h * (qk + qr)), dt),
        "wkv_a": PSpec((d, m.kv_lora_rank + qr), dt),
        "kv_norm": PSpec((m.kv_lora_rank,), torch.float32, "ones"),
        "wk_b": PSpec((m.kv_lora_rank, h * qk), dt),
        "wv_b": PSpec((m.kv_lora_rank, h * vd), dt),
        "wo": PSpec((h * vd, d), dt),
    }


def mla_rope_tables(cfg, positions: torch.Tensor):
    """Rotary tables (..., S, 1, qk_rope_head_dim) for positions (..., S):
    (1, S) for a sequence, (B, 1) for one token per lane."""
    return rope_tables(positions, cfg.mla.qk_rope_head_dim, cfg.rope_theta)


def _project_q_at(cfg, p, x, tables):
    """x (B, S, D) → q_nope (B, S, H, qk), q_rope (B, S, H, qr) rotated."""
    m = cfg.mla
    b, s, _ = x.shape
    qk, qr = m.qk_nope_head_dim, m.qk_rope_head_dim
    qa = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = (qa @ p["wq_b"]).view(b, s, cfg.n_heads, qk + qr)
    return q[..., :qk], apply_rope(q[..., qk:], *tables)


def _latent_kv_at(cfg, p, x, tables):
    """x (B, S, D) → latent (B, S, rank), k_rope (B, S, qr) rotated (no
    heads axis: the tables' head axis is dropped)."""
    rank = cfg.mla.kv_lora_rank
    kv = x @ p["wkv_a"]
    latent = rms_norm(kv[..., :rank], p["kv_norm"], cfg.norm_eps)
    cos, sin = tables
    return latent, apply_rope(kv[..., rank:], cos[..., 0, :], sin[..., 0, :])


def mla_attention(cfg, p, x, tables, impl: str = "kernel"):
    """Prefill or the training forward over a whole sequence: x (B, S, D)
    at positions 0..S-1 → (y (B, S, D), cache {"latent", "k_rope"}).
    ``impl="kernel"`` (serving) attends through the flash kernel, which
    refuses grad-requiring inputs; ``"xla"`` through the differentiable
    chunked scan in blocks of ``cfg.attn_chunk``, as the reference trains
    (``flash_attention_xla``), with the same scale and V padding."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    qk, qr, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q_nope, q_rope = _project_q_at(cfg, p, x, tables)
    latent, k_rope = _latent_kv_at(cfg, p, x, tables)
    k_nope = (latent @ p["wk_b"]).view(b, s, h, qk)
    v = (latent @ p["wv_b"]).view(b, s, h, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, qr)], dim=-1)
    # pad V's head dim up to qk + qr so one attention serves both
    vpad = F.pad(v, (0, qk + qr - vd))
    out = attend(q, k, vpad, causal=True, scale=float(qk + qr) ** -0.5, impl=impl,
                 chunk=cfg.attn_chunk)[..., :vd]
    y = out.reshape(b, s, h * vd) @ p["wo"]
    return y, {"latent": latent, "k_rope": k_rope}


def _absorbed_attend(cfg, p, q_nope, q_rope, latent, k_rope, mask):
    """The weight-absorbed attention shared by every MLA decode and extend
    path:

        scores_h(t) = q_abs_h · latent_t + q_rope_h · k_rope_t
        out_h       = (Σ_t a_t latent_t) · W_vb_h

    q_nope/q_rope (B, S, H, ·), latent/k_rope (B, T, ·), mask broadcastable
    to the (B, H, S, T) scores → out (B, S, H, v_head_dim) in float32.  The
    reference contracts its operands in their own type with float32 results
    (``preferred_element_type``) and casts each result to the next
    operand's type; here each contraction runs in float32 on operands
    rounded to that type, so no intermediate is rounded earlier than
    there (the latent is 512 wide per token: the float32 copies are small)."""
    m = cfg.mla
    h = cfg.n_heads
    qk, qr, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    rank = m.kv_lora_rank
    wk_b = p["wk_b"].view(rank, h, qk)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope.float(), wk_b.float())   # (B,S,H,rank)
    lat = latent.float()
    s_lat = torch.einsum("bshr,btr->bhst", q_abs.to(latent.dtype).float(), lat)
    s_rope = torch.einsum("bshq,btq->bhst", q_rope.to(k_rope.dtype).float(), k_rope.float())
    s = (s_lat + s_rope) * float(qk + qr) ** -0.5
    a = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", a.to(latent.dtype).float(), lat)
    wv_b = p["wv_b"].view(rank, h, vd)
    return torch.einsum("bshr,rhv->bshv", ctx.to(wv_b.dtype).float(), wv_b.float())


def _out(cfg, p, out, x):
    b, s = out.shape[:2]
    return out.reshape(b, s, cfg.n_heads * cfg.mla.v_head_dim).to(x.dtype) @ p["wo"]


def mla_decode(cfg, p, x, cache: dict, position, tables):
    """Absorbed decode of one token per lane against dense per-lane caches
    {"latent": (B, Smax, rank), "k_rope": (B, Smax, qr)}: ``position`` an
    int (every lane at the same depth) or a (B,) tensor (per-lane depths).
    The new latents are written into ``cache`` in place at the position;
    lane b reads rows [0, position_b].  → (y (B, 1, D), cache)."""
    b = x.shape[0]
    q_nope, q_rope = _project_q_at(cfg, p, x, tables)
    new_latent, new_krope = _latent_kv_at(cfg, p, x, tables)
    latent, k_rope = cache["latent"], cache["k_rope"]
    kpos = torch.arange(latent.shape[1], device=x.device)
    if isinstance(position, torch.Tensor) and position.ndim == 1:
        position = position.long()
        rows = torch.arange(b, device=x.device)
        latent[rows, position] = new_latent[:, 0].to(latent.dtype)
        k_rope[rows, position] = new_krope[:, 0].to(k_rope.dtype)
        mask = (kpos[None, :] <= position[:, None])[:, None, None, :]
    else:
        # repro-lint: skip[graph-tensor-cast] an int only: a (B,) tensor takes the branch above
        position = int(position)
        latent[:, position] = new_latent[:, 0].to(latent.dtype)
        k_rope[:, position] = new_krope[:, 0].to(k_rope.dtype)
        mask = (kpos <= position)[None, None, None]
    out = _absorbed_attend(cfg, p, q_nope, q_rope, latent, k_rope, mask)
    return _out(cfg, p, out, x), cache


def mla_decode_paged(cfg, p, x, pools: dict, block_table, positions, active, tables):
    """Absorbed decode straight over one layer's page pools
    {"latent": (n_pages, PS, rank), "k_rope": (n_pages, PS, qr)}.  The
    active lanes write their new latents at their positions in place
    (``attention.paged_write_step``, one ``paged_write`` launch for both:
    idle lanes and lanes whose page is unallocated write nothing).  Each
    lane's pages are then gathered into a transient view
    (``paged_lane_views``: one ``paged_gather`` launch for both) and
    attended as ``mla_decode`` attends its views, bit-equal to it.
    → (y (B, 1, D), pools)."""
    q_nope, q_rope = _project_q_at(cfg, p, x, tables)
    new_latent, new_krope = _latent_kv_at(cfg, p, x, tables)
    lp, kp = pools["latent"], pools["k_rope"]
    paged_write_step([lp, kp], [new_latent, new_krope], block_table, positions, active)
    latent, k_rope = paged_lane_views([lp, kp], block_table)  # (B, cap, rank), (B, cap, qr)
    kpos = torch.arange(latent.shape[1], device=x.device)
    mask = (kpos[None, :] <= positions.long()[:, None])[:, None, None, :]
    out = _absorbed_attend(cfg, p, q_nope, q_rope, latent, k_rope, mask)
    return _out(cfg, p, out, x), pools


def mla_extend(cfg, p, x, cache: dict, position: int, tables):
    """Chunked prefill in the absorbed form: the chunk x (B, C, D) at
    absolute positions [position, position + C) writes its latents into
    ``cache`` in place and scores every chunk query against the cached
    rows [0, position + C) (its own causal prefix by absolute position).
    The reference scores the whole capacity with the later rows masked;
    those rows weigh exactly 0, so they are left out.  → (y, cache)."""
    c = x.shape[1]
    q_nope, q_rope = _project_q_at(cfg, p, x, tables)
    new_latent, new_krope = _latent_kv_at(cfg, p, x, tables)
    end = position + c
    cache["latent"][:, position:end] = new_latent.to(cache["latent"].dtype)
    cache["k_rope"][:, position:end] = new_krope.to(cache["k_rope"].dtype)
    qpos = position + torch.arange(c, device=x.device)
    kpos = torch.arange(end, device=x.device)
    mask = (kpos[None, :] <= qpos[:, None])[None, None]             # (1, 1, C, T)
    out = _absorbed_attend(cfg, p, q_nope, q_rope, cache["latent"][:, :end],
                           cache["k_rope"][:, :end], mask)
    return _out(cfg, p, out, x), cache


def mla_cache_spec(cfg, batch: int, max_len: int) -> dict:
    m = cfg.mla
    dt = cfg.torch_dtype
    return {"latent": TensorSpec((batch, max_len, m.kv_lora_rank), dt),
            "k_rope": TensorSpec((batch, max_len, m.qk_rope_head_dim), dt)}
