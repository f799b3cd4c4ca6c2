"""Decoder-only LM, dense family: the port of ``repro/models/transformer.py``.

Parameters keep the JAX package's tree: ``embed``, ``final_norm``
[, ``lm_head``] and one stacked segment ``seg0 = {"s0_dense": {...}}`` whose
leaves carry a leading layers dim.  The port loops over layers in Python
(PyTorch runs eagerly; there is no scan to keep the graph small).

Each layer is pre-norm attention + residual, pre-norm gated MLP + residual.
Attention goes through ``models.attention``: ``attend`` (the flash kernel)
for prefill and chunked prefill, ``paged_decode`` (the paged-decode kernel)
for the serving engine's decode step.  Projections and the MLP stay
``torch.matmul``, as the JAX package leaves them to XLA.

Caches are written in place: ``extend_step`` into the caller's private
prefill tree, ``decode_step_paged`` into the page pools (the serving
engine's decode loop is their only writer).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve

from .attention import attend, paged_decode
from .common import (
    PSpec,
    TensorSpec,
    activation,
    apply_rope,
    init_params,
    rms_norm,
    rope_tables,
)

SEG = "s0_dense"      # the dense family's one segment pattern: ("dense",) x L


def attn_specs(cfg) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.torch_dtype
    s = {
        "wq": PSpec((d, h * hd), dt),
        "wk": PSpec((d, hkv * hd), dt),
        "wv": PSpec((d, hkv * hd), dt),
        "wo": PSpec((h * hd, d), dt),
    }
    if cfg.qkv_bias:
        s["bq"] = PSpec((h * hd,), dt, "zeros")
        s["bk"] = PSpec((hkv * hd,), dt, "zeros")
        s["bv"] = PSpec((hkv * hd,), dt, "zeros")
    if cfg.qk_norm:
        s["q_norm"] = PSpec((hd,), torch.float32, "ones")
        s["k_norm"] = PSpec((hd,), torch.float32, "ones")
    return s


def mlp_specs(cfg) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
    return {
        "w_gate": PSpec((d, f), dt),
        "w_up": PSpec((d, f), dt),
        "w_down": PSpec((f, d), dt),
    }


def layer_specs(cfg) -> dict:
    ln_init = "zeros" if cfg.rms_plus_one else "ones"
    return {
        "ln1": PSpec((cfg.d_model,), torch.float32, ln_init),
        "attn": attn_specs(cfg),
        "ln2": PSpec((cfg.d_model,), torch.float32, ln_init),
        "mlp": mlp_specs(cfg),
    }


def _stack(tree: dict, n: int) -> dict:
    return {k: _stack(v, n) if isinstance(v, dict)
            else PSpec((n,) + v.shape, v.dtype, v.init, v.scale)
            for k, v in tree.items()}


def _layer(tree: dict, r: int) -> dict:
    """Layer r's view of a stacked tree (no copies)."""
    return {k: _layer(v, r) if isinstance(v, dict) else v[r] for k, v in tree.items()}


def _proj(x, w, bias=None):
    """x @ w (+ bias, fused into the matmul as addmm)."""
    if bias is None:
        return x @ w
    y = torch.addmm(bias, x.reshape(-1, x.shape[-1]), w)
    return y.view(*x.shape[:-1], w.shape[-1])


def _qkv(cfg, p, x):
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _proj(x, p["wq"], p.get("bq"))
    k = _proj(x, p["wk"], p.get("bk"))
    v = _proj(x, p["wv"], p.get("bv"))
    q = q.view(b, s, h, hd)
    k = k.view(b, s, hkv, hd)
    v = v.view(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope_qk(q, k, tables):
    return apply_rope(q, *tables), apply_rope(k, *tables)


def mlp_apply(cfg, p, x):
    return (activation(cfg.act)(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


class DecoderLM:
    """Dense decoder-only LM over the JAX package's parameter layout."""

    supports_chunked_prefill = True

    def __init__(self, cfg):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (dense only)")
        if cfg.sliding_window is not None or cfg.learned_positions:
            raise NotImplementedError(
                "sliding-window and learned-position attention are not ported")
        self.cfg = cfg

    # -- parameters ---------------------------------------------------------

    def param_specs(self) -> dict:
        cfg = self.cfg
        dt = cfg.torch_dtype
        specs: dict = {
            "embed": PSpec((cfg.padded_vocab, cfg.d_model), dt, scale=1.0),
            "final_norm": PSpec((cfg.d_model,), torch.float32,
                                "zeros" if cfg.rms_plus_one else "ones"),
            "seg0": {SEG: _stack(layer_specs(cfg), cfg.n_layers)},
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = PSpec((cfg.d_model, cfg.padded_vocab), dt)
        return specs

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Random weights from ``generator`` (which lives on ``device``) on
        the card, or on the CPU when ``device="cpu"``."""
        return init_params(self.param_specs(), generator, resolve(device))

    # -- pieces -------------------------------------------------------------

    def _norm(self, w, x):
        return rms_norm(x, w, self.cfg.norm_eps, plus_one=self.cfg.rms_plus_one)

    def _embed(self, params, tokens):
        x = params["embed"][tokens]
        if self.cfg.embed_scale:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def _head(self, params, x):
        x = self._norm(params["final_norm"], x)
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return x @ w.to(x.dtype)

    def _rope(self, positions):
        """Rotary tables for (B or 1, S) positions, shared by every layer."""
        return rope_tables(positions, self.cfg.hd, self.cfg.rope_theta)

    def _mlp_block(self, p, x):
        return x + mlp_apply(self.cfg, p["mlp"], self._norm(p["ln2"], x))

    def _layers(self, params):
        seg = params["seg0"][SEG]
        return (_layer(seg, r) for r in range(self.cfg.n_layers))

    # -- serving API ----------------------------------------------------------

    @torch.no_grad()
    def prefill(self, params, tokens):
        """tokens (B, S) → (logits (B, 1, V) at the last position, cache).
        The cache has the ``cache_specs(B, S)`` layout: one segment dict with
        k/v leaves (layers, B, S, Hkv, hd)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        b, s, _ = x.shape
        tables = self._rope(torch.arange(s, device=x.device)[None])
        ks, vs = [], []
        for p in self._layers(params):
            q, k, v = _qkv(cfg, p["attn"], self._norm(p["ln1"], x))
            q, k = _rope_qk(q, k, tables)
            out = attend(q, k, v, causal=True)
            x = x + out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
            x = self._mlp_block(p, x)
            ks.append(k)
            vs.append(v)
        cache = [{SEG: {"k": torch.stack(ks), "v": torch.stack(vs)}}]
        return self._head(params, x[:, -1:]), cache

    @torch.no_grad()
    def extend_step(self, params, cache, tokens, position: int):
        """Chunked prefill: tokens (B, C) at absolute positions
        [position, position + C) → (logits (B, C, V), cache).  Writes the
        chunk's k/v into ``cache`` (the ``cache_specs(B, capacity)`` layout)
        in place and attends against rows [0, position + C) of it."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        b, c, _ = x.shape
        tables = self._rope(position + torch.arange(c, device=x.device)[None])
        seg = cache[0][SEG]
        for r, p in enumerate(self._layers(params)):
            q, k, v = _qkv(cfg, p["attn"], self._norm(p["ln1"], x))
            q, k = _rope_qk(q, k, tables)
            kc, vc = seg["k"][r], seg["v"][r]
            kc[:, position:position + c] = k
            vc[:, position:position + c] = v
            out = attend(q, kc, vc, causal=True, q_offset=position,
                         kv_len=position + c)
            x = x + out.reshape(b, c, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
            x = self._mlp_block(p, x)
        return self._head(params, x), cache

    @torch.no_grad()
    def decode_step_paged(self, params, pools, block_tables, tokens, positions,
                          active):
        """One decode token per lane straight against the page pools:
        tokens (B, 1), block_tables (B, P) int32, positions (B,), active (B,)
        bool → (logits (B, 1, V), pools).

        Each layer writes the new k/v into the lane's current page (idle
        lanes and lanes whose page is unallocated write nothing) and then
        runs the paged-decode kernel over the pages the block table names,
        reading ``positions + 1`` tokens per active lane and none for an idle
        one.  The pools are updated in place."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        b = x.shape[0]
        seg = pools[0][SEG]
        ps = seg["k"].shape[2]
        positions = positions.long()
        page = block_tables.gather(1, (positions // ps)[:, None])[:, 0]
        # torch has no mode="drop" scatter: pick the writing lanes up front
        # (one host sync per step, shared by every layer)
        lanes = torch.nonzero(active & (page >= 0)).squeeze(1)
        w_page, w_off = page[lanes].long(), (positions % ps)[lanes]
        lengths = torch.where(active, positions + 1, 0).to(torch.int32)
        block_tables = block_tables.to(torch.int32).contiguous()
        tables = self._rope(positions[:, None])
        for r, p in enumerate(self._layers(params)):
            q, k, v = _qkv(cfg, p["attn"], self._norm(p["ln1"], x))
            q, k = _rope_qk(q, k, tables)
            kp, vp = seg["k"][r], seg["v"][r]
            kp[w_page, w_off] = k[lanes, 0].to(kp.dtype)
            vp[w_page, w_off] = v[lanes, 0].to(vp.dtype)
            out = paged_decode(q.reshape(b, cfg.n_heads, cfg.hd), kp, vp,
                               block_tables, lengths)
            x = x + out.reshape(b, 1, cfg.n_heads * cfg.hd) @ p["attn"]["wo"]
            x = self._mlp_block(p, x)
        return self._head(params, x), pools

    # -- cache layouts ----------------------------------------------------------

    def cache_specs(self, batch: int, max_len: int) -> list:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        leaf = TensorSpec(shape, cfg.torch_dtype)
        return [{SEG: {"k": leaf, "v": leaf}}]

    def cache_page_specs(self, lanes: int, n_pages: int, page_size: int) -> list:
        """The ``cache_specs(lanes, page_size)`` tree with each seq leaf's
        lane dim swapped for a page-pool dim: (layers, n_pages, PS, Hkv, hd)."""
        cfg = self.cfg
        shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
        leaf = TensorSpec(shape, cfg.torch_dtype)
        return [{SEG: {"k": leaf, "v": leaf}}]
