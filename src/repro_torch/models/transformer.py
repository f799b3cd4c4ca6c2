"""Decoder-only LM, dense and ssm families: the port of
``repro/models/transformer.py``.

Parameters keep the JAX package's tree: ``embed``, ``final_norm``
[, ``lm_head``] and one stacked segment ``seg0 = {"s0_<kind>": {...}}``
whose leaves carry a leading layers dim: ``("dense",) × L`` for the dense
family, ``("ssm",) × L`` (mamba2) for the ssm family.  The port loops over
layers in Python (PyTorch runs eagerly; there is no scan to keep the graph
small).

A dense layer is pre-norm attention + residual, pre-norm gated MLP +
residual.  Attention goes through ``models.attention``: ``attend`` (the
flash kernel) for prefill and chunked prefill, ``paged_decode`` (the
paged-decode kernel) for the serving engine's paged decode step, the
plain ``decode_attention`` for the dense ``decode_step`` of the gather
path, and ``attend(impl="xla")`` (the differentiable chunked scan) for the
training ``forward``/``loss``.  An ssm layer is pre-norm Mamba-2 + residual
(``models.ssm``; its prefill runs the ``ssd_scan`` kernel, its decode step
is plain torch, and the training ``forward``/``loss`` run the
differentiable ``ssd_chunked(impl="xla")``).  Projections and the
MLP stay ``torch.matmul``, as the JAX package leaves them to XLA.

The training forward is functional (autograd runs through it) and shares
``_qkv``, ``_rope_qk`` and ``mlp_apply`` with serving; the serving methods
run under ``torch.no_grad()``, and their caches are written in place:
``extend_step`` into the caller's private prefill tree,
``decode_step_paged`` into the page pools and the per-lane state leaves
(the serving engine's decode loop is their only writer), and
``decode_step`` into the gathered views' k/v (its new recurrent state comes
back as new tensors, which ``absorb_decode`` keeps for active lanes only).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve

from . import ssm as _ssm
from .attention import attend, decode_attention, paged_decode
from .common import (
    PSpec,
    TensorSpec,
    activation,
    apply_rope,
    init_params,
    rms_norm,
    rope_tables,
)

# the ported families; each is one segment of one layer kind, (family,) x L
FAMILIES = ("dense", "ssm")


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


def layer_specs(cfg, kind: str) -> dict:
    ln_init = "zeros" if cfg.rms_plus_one else "ones"
    s: dict = {"ln1": PSpec((cfg.d_model,), torch.float32, ln_init)}
    if kind == "ssm":
        s["mix"] = _ssm.ssm_specs(cfg)
        return s
    s["attn"] = attn_specs(cfg)
    s["ln2"] = PSpec((cfg.d_model,), torch.float32, ln_init)
    s["mlp"] = mlp_specs(cfg)
    return s


def _stack(tree: dict, n: int) -> dict:
    return {k: _stack(v, n) if isinstance(v, dict)
            else PSpec((n,) + v.shape, v.dtype, v.init, v.scale)
            for k, v in tree.items()}


def _layer(tree: dict, r: int) -> dict:
    """Layer r's view of a stacked tree (no copies)."""
    return {k: _layer(v, r) if isinstance(v, dict) else v[r] for k, v in tree.items()}


def _unstack(tree: dict, n: int) -> list[dict]:
    """The n layers' views of a stacked tree through one ``unbind`` per leaf,
    whose backward stacks the n layer gradients once (indexing each layer
    would add a full-size zero-padded gradient per layer)."""
    views = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[r] for k, v in views.items()} for r in range(n)]


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
    """Decoder-only LM over the JAX package's parameter layout: the dense
    family and the ssm family (mamba2)."""

    supports_chunked_prefill = True

    def __init__(self, cfg):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (dense and ssm only)")
        if cfg.sliding_window is not None or cfg.learned_positions:
            raise NotImplementedError(
                "sliding-window and learned-position attention are not ported")
        if cfg.family == "ssm" and not cfg.ssm.factorized:
            raise NotImplementedError("only the factorized SSD decay is ported")
        self.cfg = cfg
        self.kind = cfg.family
        self.seg = f"s0_{self.kind}"

    # -- parameters ---------------------------------------------------------

    def param_specs(self) -> dict:
        cfg = self.cfg
        dt = cfg.torch_dtype
        specs: dict = {
            "embed": PSpec((cfg.padded_vocab, cfg.d_model), dt, scale=1.0),
            "final_norm": PSpec((cfg.d_model,), torch.float32,
                                "zeros" if cfg.rms_plus_one else "ones"),
            "seg0": {self.seg: _stack(layer_specs(cfg, self.kind), cfg.n_layers)},
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

    def _attn_out(self, p, out, x):
        """x + the attention output (B, S, H, hd) projected, then the MLP block."""
        b, s = out.shape[:2]
        x = x + out.reshape(b, s, self.cfg.n_heads * self.cfg.hd) @ p["attn"]["wo"]
        return self._mlp_block(p, x)

    def _layers(self, params):
        seg = params["seg0"][self.seg]
        return (_layer(seg, r) for r in range(self.cfg.n_layers))

    # -- training API -------------------------------------------------------

    def _train_layer(self, p, x, tables, impl):
        if self.kind == "ssm":
            y, _, _ = _ssm.ssm_block(self.cfg, p["mix"], self._norm(p["ln1"], x), impl=impl)
            return x + y
        q, k, v = _qkv(self.cfg, p["attn"], self._norm(p["ln1"], x))
        q, k = _rope_qk(q, k, tables)
        out = attend(q, k, v, causal=True, impl=impl, chunk=self.cfg.attn_chunk)
        return self._attn_out(p, out, x)

    def forward(self, params, tokens, impl: str = "xla"):
        """tokens (B, S) → (logits (B, S, V) in the model's type, aux loss
        (a float32 zero: neither family has MoE)).  Differentiable;
        ``cfg.remat == "full"`` recomputes each layer in the backward
        (``torch.utils.checkpoint``, one per layer), ``"none"`` keeps every
        activation.  ``impl="xla"`` attends with the chunked scan (dense)
        or mixes with the plain-torch SSD (ssm), as JAX's train step does;
        ``"kernel"`` runs the flash or ``ssd_scan`` kernel, which has no
        backward and refuses grad-requiring inputs.  An ssm layer starts
        from a zero state and a zero conv context."""
        cfg = self.cfg
        if cfg.remat not in ("none", "full"):
            raise NotImplementedError(f"remat={cfg.remat!r} is not ported ('none' or 'full')")
        x = self._embed(params, tokens.long())
        s = x.shape[1]
        tables = (self._rope(torch.arange(s, device=x.device)[None])
                  if self.kind == "dense" else None)
        layers = _unstack(params["seg0"][self.seg], cfg.n_layers)
        for p in layers:
            if cfg.remat == "full":
                x = checkpoint(self._train_layer, p, x, tables, impl, use_reentrant=False)
            else:
                x = self._train_layer(p, x, tables, impl)
        return self._head(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params, batch, impl: str = "xla"):
        """Mean next-token cross-entropy + aux.  batch: {"tokens",
        "targets"[, "loss_mask"]}; the padded vocabulary is masked with -1e30
        and the log-softmax taken in float32, as in JAX."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch["tokens"], impl)
        targets = batch["targets"].long()
        logits = logits.float()
        if cfg.padded_vocab != cfg.vocab_size:
            col = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab_size
            logits = torch.where(col, -1e30, logits)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is not None:
            nll = nll * mask
            denom = torch.clamp(mask.sum(), min=1.0)
        else:
            denom = nll.numel()
        return nll.sum() / denom + aux

    # -- serving API ----------------------------------------------------------

    @torch.no_grad()
    def prefill(self, params, tokens):
        """tokens (B, S) → (logits (B, 1, V) at the last position, cache).
        The cache has the ``cache_specs(B, S)`` layout: one segment dict with
        k/v leaves (layers, B, S, Hkv, hd), or (ssm) the state leaves
        (layers, B, H, P, N) and (layers, B, K-1, conv_dim).  An ssm prompt
        longer than the chunk must be a multiple of it (``ssd_chunked``)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        b, s, _ = x.shape
        if self.kind == "ssm":
            states, convs = [], []
            for p in self._layers(params):
                y, st, cv = _ssm.ssm_block(cfg, p["mix"], self._norm(p["ln1"], x))
                x = x + y
                states.append(st)
                convs.append(cv)
            cache = [{self.seg: {"state": torch.stack(states), "conv": torch.stack(convs)}}]
            return self._head(params, x[:, -1:]), cache
        tables = self._rope(torch.arange(s, device=x.device)[None])
        ks, vs = [], []
        for p in self._layers(params):
            q, k, v = _qkv(cfg, p["attn"], self._norm(p["ln1"], x))
            q, k = _rope_qk(q, k, tables)
            x = self._attn_out(p, attend(q, k, v, causal=True), x)
            ks.append(k)
            vs.append(v)
        cache = [{self.seg: {"k": torch.stack(ks), "v": torch.stack(vs)}}]
        return self._head(params, x[:, -1:]), cache

    @torch.no_grad()
    def extend_step(self, params, cache, tokens, position: int):
        """Chunked prefill: tokens (B, C) at absolute positions
        [position, position + C) → (logits (B, C, V), cache).  Dense: writes
        the chunk's k/v into ``cache`` (the ``cache_specs(B, capacity)``
        layout) in place and attends against rows [0, position + C) of it.
        ssm: steps the state leaves in place through the chunk (in slices
        of at most ``chunk`` tokens, so any length runs)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        b, c, _ = x.shape
        seg = cache[0][self.seg]
        if self.kind == "ssm":
            for r, p in enumerate(self._layers(params)):
                y, st, cv = _ssm.ssm_extend(cfg, p["mix"], self._norm(p["ln1"], x),
                                            seg["state"][r], seg["conv"][r])
                seg["state"][r].copy_(st)
                seg["conv"][r].copy_(cv)
                x = x + y
            return self._head(params, x), cache
        tables = self._rope(position + torch.arange(c, device=x.device)[None])
        for r, p in enumerate(self._layers(params)):
            q, k, v = _qkv(cfg, p["attn"], self._norm(p["ln1"], x))
            q, k = _rope_qk(q, k, tables)
            kc, vc = seg["k"][r], seg["v"][r]
            kc[:, position:position + c] = k
            vc[:, position:position + c] = v
            out = attend(q, kc, vc, causal=True, q_offset=position, kv_len=position + c)
            x = self._attn_out(p, out, x)
        return self._head(params, x), cache

    def _ssm_decode_layers(self, params, x, seg, keep=None):
        """Step every ssm layer once for each lane; returns (x, states,
        convs), the new per-layer state of every lane.  With ``keep`` (B,)
        bool, lanes where it is False keep their state: the new state is
        written into ``seg``'s leaves in place for the others."""
        states, convs = [], []
        for r, p in enumerate(self._layers(params)):
            st_r, cv_r = seg["state"][r], seg["conv"][r]
            y, st, cv = _ssm.ssm_decode(self.cfg, p["mix"], self._norm(p["ln1"], x),
                                        st_r, cv_r)
            x = x + y
            if keep is not None:
                st_r.copy_(torch.where(keep[:, None, None, None], st, st_r))
                cv_r.copy_(torch.where(keep[:, None, None], cv, cv_r))
            states.append(st)
            convs.append(cv)
        return x, states, convs

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, positions):
        """Dense-cache decode (the gather path): one token per lane,
        tokens (B, 1) at per-lane ``positions`` (B,) against per-lane views
        (the ``cache_specs(B, S)`` layout) → (logits (B, 1, V), cache).
        Dense: writes each lane's k/v at its position into the views in
        place and attends over rows [0, position] with the plain
        ``decode_attention``.  ssm: the returned tree carries every lane's
        new state as new tensors; the given state leaves are not written."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        b = x.shape[0]
        seg = cache[0][self.seg]
        if self.kind == "ssm":
            x, states, convs = self._ssm_decode_layers(params, x, seg)
            new = [{self.seg: {"state": torch.stack(states), "conv": torch.stack(convs)}}]
            return self._head(params, x), new
        positions = positions.long()
        rows = torch.arange(b, device=x.device)
        tables = self._rope(positions[:, None])
        for r, p in enumerate(self._layers(params)):
            q, k, v = _qkv(cfg, p["attn"], self._norm(p["ln1"], x))
            q, k = _rope_qk(q, k, tables)
            kc, vc = seg["k"][r], seg["v"][r]
            kc[rows, positions] = k[:, 0].to(kc.dtype)
            vc[rows, positions] = v[:, 0].to(vc.dtype)
            x = self._attn_out(p, decode_attention(q, kc, vc, positions), x)
        return self._head(params, x), cache

    @torch.no_grad()
    def decode_step_paged(self, params, pools, block_tables, tokens, positions,
                          active):
        """One decode token per lane straight against the page pools:
        tokens (B, 1), block_tables (B, P) int32, positions (B,), active (B,)
        bool → (logits (B, 1, V), pools).

        Dense: each layer writes the new k/v into the lane's current page
        (idle lanes and lanes whose page is unallocated write nothing) and
        then runs the paged-decode kernel over the pages the block table
        names, reading ``positions + 1`` tokens per active lane and none for
        an idle one.  ssm: each layer steps the per-lane state leaves; idle
        lanes keep theirs.  The pools are updated in place."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        b = x.shape[0]
        seg = pools[0][self.seg]
        if self.kind == "ssm":
            x, _, _ = self._ssm_decode_layers(params, x, seg, keep=active)
            return self._head(params, x), pools
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
            x = self._attn_out(p, out.reshape(b, 1, cfg.n_heads, cfg.hd), x)
        return self._head(params, x), pools

    # -- cache layouts ----------------------------------------------------------

    def cache_specs(self, batch: int, max_len: int) -> list:
        cfg = self.cfg
        if self.kind == "ssm":
            tree = {k: TensorSpec((cfg.n_layers,) + t.shape, t.dtype)
                    for k, t in _ssm.ssm_cache_spec(cfg, batch).items()}
            return [{self.seg: tree}]
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        leaf = TensorSpec(shape, cfg.torch_dtype)
        return [{self.seg: {"k": leaf, "v": leaf}}]

    def cache_page_specs(self, lanes: int, n_pages: int, page_size: int) -> list:
        """The ``cache_specs(lanes, page_size)`` tree with each seq leaf's
        lane dim swapped for a page-pool dim: (layers, n_pages, PS, Hkv, hd).
        Recurrent-state leaves (ssm) keep the per-lane layout: they are the
        one "page" per request the scheduler never splits."""
        if self.kind == "ssm":
            return self.cache_specs(lanes, page_size)
        cfg = self.cfg
        shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
        leaf = TensorSpec(shape, cfg.torch_dtype)
        return [{self.seg: {"k": leaf, "v": leaf}}]
