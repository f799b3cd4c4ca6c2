"""Decoder-only LM, dense, vlm, moe, ssm and hybrid families: the port of
``repro/models/transformer.py``.

A model is a list of *segments*, each a repeating *pattern* of layer kinds
(``segments_for``, as in the JAX package):

    dense  : [("dense",) × L]                    (vlm: the same backbone)
    moe    : [("dense",) × first_dense] + [("moe",) × (L - first_dense)]
                                                 deepseek-v3, qwen3-moe
    ssm    : [("ssm",) × L]                      mamba2
    hybrid : [("rec", "rec", "attn") × (L // 3)] + the remainder pattern
                                                 recurrentgemma

Parameters keep the JAX package's tree: ``embed``, ``final_norm``
[, ``lm_head``] and one dict per segment ``seg{si} = {"s{i}_{kind}": {...}}``
whose leaves carry a leading repeats dim.  The port loops over segments,
repeats and the pattern in Python (PyTorch runs eagerly; there is no scan
to keep the graph small).

A dense layer is pre-norm attention + residual, pre-norm gated MLP +
residual; an ``attn`` layer (the hybrid's local attention) is the same
with ``cfg.rglru.attn_window``.  Attention goes through ``models.attention``:
``attend`` (the flash kernel, windowed for ``attn``) for prefill and chunked
prefill; for the serving engine's paged decode step, ``paged_decode`` (the
paged-decode kernel) in dense layers and ``paged_decode_windowed`` (the
``paged_gather`` kernel and the windowed plain read) in ``attn`` layers;
the plain ``decode_attention`` for ``decode_step`` of the gather path; and
``attend(impl="xla")`` (the differentiable chunked scan) for the training
``forward``/``loss``.  With ``cfg.mla`` (deepseek-v3) the dense and moe
layers attend through ``models.mla`` instead: the flash kernel in prefill,
the absorbed latent contraction in chunked prefill and both decodes (the
paged one after one ``paged_gather`` launch per layer).  A ``moe`` layer
has the routed-expert FFN of ``models.moe`` in place of the MLP: it drops
tokens past each expert's capacity in the whole-prompt prefill and drops
none (one group, ``drop=False``) in chunked prefill and decode, as the
reference does; the training ``forward``/``loss`` (whose MLA layers
attend through the chunked scan) drop as the whole-prompt prefill does and
add each layer's router aux loss to the loss.  An ssm layer is pre-norm
Mamba-2 + residual (``models.ssm``; its prefill runs the ``ssd_scan``
kernel, its decode step is plain torch, and the training
``forward``/``loss`` run the differentiable ``ssd_chunked(impl="xla")``).
A ``rec`` layer is pre-norm RG-LRU + residual, then the MLP block
(``models.rglru``, plain torch on every path, its scan the doubling scan).
Projections and the MLP stay ``torch.matmul``, as the JAX package leaves
them to XLA.

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

from repro_torch.analysis.ownership import captured_step
from repro_torch.device import resolve

from . import mla as _mla
from . import moe as _moe
from . import rglru as _rglru
from . import ssm as _ssm
from .attention import (
    attend,
    decode_attention,
    paged_decode,
    paged_decode_windowed,
    paged_write_step,
)
from .common import (
    SEQ_CACHE_KEYS,
    PSpec,
    TensorSpec,
    activation,
    apply_rope,
    init_params,
    rms_norm,
    rope_tables,
    tree_map_with_path,
)

# the decoder-only families (audio is models.encdec.EncDecLM), and the
# layer kinds that attend or carry a state
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
ATTN_KINDS = ("dense", "attn", "moe")
STATE_KINDS = ("ssm", "rec")
# moe_ffn's dispatch on each path, as the reference calls it: capacity
# drops with the default groups in the whole-prompt prefill; one group and
# no drops in chunked prefill (whose long chunks materialise only the
# filled slots) and in decode
MOE_DISPATCH = {"prefill": {}, "extend": dict(n_groups=1, drop=False, trim=True),
                "decode": dict(n_groups=1, drop=False)}


def segments_for(cfg) -> list[tuple[tuple[str, ...], int]]:
    """(pattern of layer kinds, repeats) per segment."""
    if cfg.family in ("dense", "vlm"):
        return [(("dense",), cfg.n_layers)]
    if cfg.family == "moe":
        segs = []
        if cfg.first_dense_layers:
            segs.append((("dense",), cfg.first_dense_layers))
        segs.append((("moe",), cfg.n_layers - cfg.first_dense_layers))
        return segs
    if cfg.family == "ssm":
        return [(("ssm",), cfg.n_layers)]
    if cfg.family == "hybrid":
        pat = tuple(cfg.rglru.block_pattern)
        n_full = cfg.n_layers // len(pat)
        rem = cfg.n_layers - n_full * len(pat)
        segs = [(pat, n_full)]
        if rem:
            segs.append((pat[:rem], 1))
        return segs
    raise NotImplementedError(f"family {cfg.family!r} has no segments in the port")


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
    if kind == "rec":
        s["mix"] = _rglru.rglru_specs(cfg)
    elif kind in ATTN_KINDS:
        s["attn"] = _mla.mla_specs(cfg) if cfg.mla else attn_specs(cfg)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    s["ln2"] = PSpec((cfg.d_model,), torch.float32, ln_init)
    if kind == "moe":
        s["moe"] = _moe.moe_specs(cfg)
    else:
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


def _at(leaves: dict, r: int) -> dict:
    """Repeat r's view of one layer's stacked cache leaves."""
    return {n: t[r] for n, t in leaves.items()}


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
    (and the vlm's backbone, ``api.VLM``), moe (deepseek-v3 with MLA,
    qwen3-moe), ssm (mamba2) and hybrid (recurrentgemma) families."""

    supports_chunked_prefill = True

    def __init__(self, cfg):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not a DecoderLM family ({', '.join(FAMILIES)}); "
                "build_model gives the audio family an EncDecLM")
        if cfg.sliding_window is not None or cfg.learned_positions:
            raise NotImplementedError(
                "sliding-window and learned-position attention are not ported to "
                "DecoderLM (learned positions are EncDecLM's)")
        if cfg.family == "ssm" and not cfg.ssm.factorized:
            raise NotImplementedError("only the factorized SSD decay is ported")
        self.cfg = cfg
        self.segments = segments_for(cfg)
        self._has_attn = any(k in ATTN_KINDS for pattern, _ in self.segments for k in pattern)

    # -- parameters ---------------------------------------------------------

    def param_specs(self) -> dict:
        cfg = self.cfg
        dt = cfg.torch_dtype
        specs: dict = {
            "embed": PSpec((cfg.padded_vocab, cfg.d_model), dt, scale=1.0),
            "final_norm": PSpec((cfg.d_model,), torch.float32,
                                "zeros" if cfg.rms_plus_one else "ones"),
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = PSpec((cfg.d_model, cfg.padded_vocab), dt)
        for si, (pattern, reps) in enumerate(self.segments):
            specs[f"seg{si}"] = _stack(
                {f"s{i}_{k}": layer_specs(cfg, k) for i, k in enumerate(pattern)}, reps)
        return specs

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Random weights from ``generator`` (which lives on ``device``) on
        the card, or on the CPU when ``device="cpu"``."""
        return init_params(self.param_specs(), generator, resolve(device))

    # -- pieces -------------------------------------------------------------

    def _norm(self, w, x):
        return rms_norm(x, w, self.cfg.norm_eps, plus_one=self.cfg.rms_plus_one)

    def _embed(self, params, tokens, extra_embeds=None):
        """The token embeddings, with ``extra_embeds`` (B, P, D), when given,
        put before them (the vlm's image tokens): (B, P + S, D)."""
        x = params["embed"][tokens]
        if self.cfg.embed_scale:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        if extra_embeds is None:
            return x
        return torch.cat([extra_embeds.to(x.dtype), x], dim=1)

    def _head(self, params, x):
        x = self._norm(params["final_norm"], x)
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return x @ w.to(x.dtype)

    def _rope(self, positions):
        """Rotary tables for (B or 1, S) positions, shared by every attention
        layer (None when the model has none); MLA rotates only its
        ``qk_rope_head_dim`` dims."""
        if not self._has_attn:
            return None
        if self.cfg.mla:
            return _mla.mla_rope_tables(self.cfg, positions)
        return rope_tables(positions, self.cfg.hd, self.cfg.rope_theta)

    def _window(self, kind):
        """The attention window of a layer kind: the hybrid's local
        attention layers have one, dense layers none."""
        return self.cfg.rglru.attn_window if kind == "attn" else None

    def _ffn_block(self, kind, p, x, path="prefill"):
        """(x + the layer's FFN of the normed x, its aux loss): the MLP, or
        for a moe layer the routed experts with ``path``'s dispatch
        (``MOE_DISPATCH``) and the router's float32 aux loss.  A layer
        without a router gives None in place of the reference's float32
        zero, which adds nothing to the sum (and costs the serving paths,
        which ignore the aux, no zero-fill launch per layer)."""
        h = self._norm(p["ln2"], x)
        if kind == "moe":
            y, aux = _moe.moe_ffn(self.cfg, p["moe"], h, **MOE_DISPATCH[path])
            return x + y, aux
        return x + mlp_apply(self.cfg, p["mlp"], h), None

    def _attn_out(self, kind, p, out, x, path="prefill"):
        """x + the attention output (B, S, H, hd) projected, then the FFN
        block → (x, aux) as ``_ffn_block``."""
        b, s = out.shape[:2]
        x = x + out.reshape(b, s, self.cfg.n_heads * self.cfg.hd) @ p["attn"]["wo"]
        return self._ffn_block(kind, p, x, path)

    def _qkv_rope(self, p, x, tables):
        q, k, v = _qkv(self.cfg, p["attn"], self._norm(p["ln1"], x))
        q, k = _rope_qk(q, k, tables)
        return q, k, v

    def _layers(self, params):
        """(segment, repeat, key, kind, parameter views) of every layer, in
        order (no copies)."""
        for si, (pattern, reps) in enumerate(self.segments):
            seg = params[f"seg{si}"]
            for r in range(reps):
                for i, kind in enumerate(pattern):
                    key = f"s{i}_{kind}"
                    yield si, r, key, kind, _layer(seg[key], r)

    # -- training API -------------------------------------------------------

    def _train_layer(self, kind, p, x, tables, impl):
        """One layer of the training forward → (x, its aux loss or None)."""
        cfg = self.cfg
        if kind == "ssm":
            y, _, _ = _ssm.ssm_block(cfg, p["mix"], self._norm(p["ln1"], x), impl=impl)
            return x + y, None
        if kind == "rec":
            y, _ = _rglru.rglru_block(cfg, p["mix"], self._norm(p["ln1"], x))
            return self._ffn_block(kind, p, x + y)
        if cfg.mla:
            y, _ = _mla.mla_attention(cfg, p["attn"], self._norm(p["ln1"], x), tables,
                                      impl=impl)
            return self._ffn_block(kind, p, x + y)
        q, k, v = self._qkv_rope(p, x, tables)
        out = attend(q, k, v, causal=True, window=self._window(kind), impl=impl,
                     chunk=cfg.attn_chunk)
        return self._attn_out(kind, p, out, x)

    def _train_repeat(self, pattern, p, x, aux, tables, impl):
        """One repeat of a segment's pattern → (x, aux + its layers' aux
        losses): the unit ``remat="full"`` recomputes, as the JAX package
        checkpoints its scanned body with the (x, aux) carry."""
        for i, kind in enumerate(pattern):
            x, a = self._train_layer(kind, p[f"s{i}_{kind}"], x, tables, impl)
            if a is not None:
                aux = aux + a
        return x, aux

    def forward(self, params, tokens, impl: str = "xla", extra_embeds=None):
        """tokens (B, S) → (logits (B, S, V) in the model's type, aux loss:
        the moe layers' router losses summed in float32, each already
        weighted by ``router_aux_weight``; a float32 zero for a model
        without a router).  Differentiable; a moe layer dispatches with
        capacity drops and the default groups (``MOE_DISPATCH["prefill"]``),
        as the reference trains.
        ``cfg.remat == "full"`` recomputes each repeat of a segment's pattern
        in the backward (``torch.utils.checkpoint``), ``"none"`` keeps every
        activation.  ``impl="xla"`` attends with the chunked scan (dense,
        local and MLA attention) or mixes with the plain-torch SSD (ssm), as
        JAX's train step does; ``"kernel"`` runs the flash or ``ssd_scan``
        kernel, which has no backward and refuses grad-requiring inputs.
        The RG-LRU always runs its plain doubling scan.  Recurrent layers
        start from a zero state and a zero conv context.  ``extra_embeds``
        (B, P, D) go before the tokens, positions run over all P + S, and
        the logits cover them all (B, P + S, V)."""
        cfg = self.cfg
        if cfg.remat not in ("none", "full"):
            raise NotImplementedError(f"remat={cfg.remat!r} is not ported ('none' or 'full')")
        x = self._embed(params, tokens.long(), extra_embeds)
        tables = self._rope(torch.arange(x.shape[1], device=x.device)[None])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for si, (pattern, reps) in enumerate(self.segments):
            for p in _unstack(params[f"seg{si}"], reps):
                if cfg.remat == "full":
                    # the forward draws no random numbers: no RNG state to
                    # stash and restore, nor to read inside a captured step
                    x, aux = checkpoint(self._train_repeat, pattern, p, x, aux, tables, impl,
                                        use_reentrant=False, preserve_rng_state=False)
                else:
                    x, aux = self._train_repeat(pattern, p, x, aux, tables, impl)
        return self._head(params, x), aux

    def loss(self, params, batch, impl: str = "xla"):
        """Mean next-token cross-entropy + aux.  batch: {"tokens",
        "targets"[, "loss_mask", "extra_embeds"]}; with extra embeddings
        only the text positions (the last S) are scored; the padded
        vocabulary is masked with -1e30 and the log-softmax taken in
        float32, as in JAX."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch["tokens"], impl,
                                   extra_embeds=batch.get("extra_embeds"))
        targets = batch["targets"].long()
        logits = logits[:, -targets.shape[1]:].float()
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

    def _prefill_layer(self, kind, p, x, tables):
        """One layer over a whole prompt → (x, the layer's cache leaves)."""
        cfg = self.cfg
        if kind == "ssm":
            y, st, cv = _ssm.ssm_block(cfg, p["mix"], self._norm(p["ln1"], x))
            return x + y, {"state": st, "conv": cv}
        if kind == "rec":
            y, c = _rglru.rglru_block(cfg, p["mix"], self._norm(p["ln1"], x))
            return self._ffn_block(kind, p, x + y)[0], c
        if cfg.mla:
            y, c = _mla.mla_attention(cfg, p["attn"], self._norm(p["ln1"], x), tables)
            return self._ffn_block(kind, p, x + y)[0], c
        q, k, v = self._qkv_rope(p, x, tables)
        out = attend(q, k, v, causal=True, window=self._window(kind))
        return self._attn_out(kind, p, out, x)[0], {"k": k, "v": v}

    @torch.no_grad()
    def prefill(self, params, tokens, extra_embeds=None):
        """tokens (B, S) → (logits (B, 1, V) at the last position, cache);
        ``extra_embeds`` (B, P, D) go before the tokens, and the cache then
        holds P + S positions.
        The cache has the ``cache_specs(B, S)`` layout: per segment, per
        layer of its pattern, k/v leaves (repeats, B, S, Hkv, hd), MLA's
        latent/k_rope leaves (repeats, B, S, rank or qr), or the
        recurrent state leaves (ssm: (repeats, B, H, P, N) and
        (repeats, B, K-1, conv_dim); rec: (repeats, B, W) and
        (repeats, B, K-1, W)).  An ssm prompt longer than the chunk must be
        a multiple of it (``ssd_chunked``)."""
        x = self._embed(params, tokens, extra_embeds)
        tables = self._rope(torch.arange(x.shape[1], device=x.device)[None])
        per = [{f"s{i}_{k}": [] for i, k in enumerate(pattern)} for pattern, _ in self.segments]
        for si, _, key, kind, p in self._layers(params):
            x, c = self._prefill_layer(kind, p, x, tables)
            per[si][key].append(c)
        cache = [{key: {n: torch.stack([c[n] for c in cs]) for n in cs[0]}
                  for key, cs in seg.items()} for seg in per]
        return self._head(params, x[:, -1:]), cache

    @captured_step
    @torch.no_grad()
    def extend_step(self, params, cache, tokens, position: int | torch.Tensor,
                    last_only: bool = False):
        """Chunked prefill: tokens (B, C) at absolute positions
        [position, position + C) → (logits (B, C, V), or (B, 1, V) of the
        last position with ``last_only``, cache), every leaf updated in
        place.  Attention layers write the chunk's k/v into ``cache`` (the
        ``cache_specs(B, capacity)`` layout) and attend against rows
        [0, position + C) of it (within the window for local attention);
        recurrent layers step their state through the chunk (ssm in slices
        of at most ``chunk`` tokens, so any length runs).

        The k/v writes are an ``index_copy_`` at ``position + arange(C)``
        (the reference's ``dynamic_update_slice``).  ``position`` is an int,
        or a 0-d int64 tensor on the model's device: then the rotary tables,
        those writes and the flash kernel's offsets are all computed on the
        device and nothing is read back, so the step can be captured once in
        a CUDA graph and replayed at every offset (``serve.captured.CapturedExtend``);
        the kernel then reads the cache's rows past ``position + C`` too,
        weighted by 0, so they must be finite (the engine zeroes its slots).
        Both forms give the same bits.  MLA's extend takes an int only (the
        moe family's extend dispatches with a host read, so it runs
        eagerly)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        c = x.shape[1]
        at = position + torch.arange(c, device=x.device)
        tables = self._rope(at[None])
        if isinstance(position, torch.Tensor):
            if cfg.mla:
                raise TypeError("extend_step: MLA's extend takes an int position")
            # the kernel's (q_offset, kv_len), one int32 pair for every layer
            offs = torch.stack((position, position + c)).to(torch.int32)
            q_offset, kv_len = offs[0], offs[1]
        else:
            q_offset, kv_len = position, position + c
        for si, r, key, kind, p in self._layers(params):
            leaves = cache[si][key]
            if kind == "ssm":
                y, st, cv = _ssm.ssm_extend(cfg, p["mix"], self._norm(p["ln1"], x),
                                            leaves["state"][r], leaves["conv"][r])
                leaves["state"][r].copy_(st)
                leaves["conv"][r].copy_(cv)
                x = x + y
            elif kind == "rec":
                y, new = _rglru.rglru_extend(cfg, p["mix"], self._norm(p["ln1"], x),
                                             _at(leaves, r))
                for n, t in new.items():
                    leaves[n][r].copy_(t)
                x, _ = self._ffn_block(kind, p, x + y)
            elif cfg.mla:
                y, _ = _mla.mla_extend(cfg, p["attn"], self._norm(p["ln1"], x),
                                       _at(leaves, r), position, tables)
                x, _ = self._ffn_block(kind, p, x + y, "extend")
            else:
                q, k, v = self._qkv_rope(p, x, tables)
                kc, vc = leaves["k"][r], leaves["v"][r]
                kc.index_copy_(1, at, k)
                vc.index_copy_(1, at, v)
                out = attend(q, kc, vc, causal=True, window=self._window(kind),
                             q_offset=q_offset, kv_len=kv_len)
                x, _ = self._attn_out(kind, p, out, x, "extend")
        return self._head(params, x[:, -1:] if last_only else x), cache

    def _decode_state(self, kind, p, x, state):
        """One recurrent layer's decode step → (x, its new state leaves)."""
        h = self._norm(p["ln1"], x)
        if kind == "ssm":
            y, st, cv = _ssm.ssm_decode(self.cfg, p["mix"], h, state["state"], state["conv"])
            return x + y, {"state": st, "conv": cv}
        y, new = _rglru.rglru_decode(self.cfg, p["mix"], h, state)
        return self._ffn_block(kind, p, x + y)[0], new

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, positions):
        """Dense-cache decode (the gather path): one token per lane,
        tokens (B, 1) at per-lane ``positions`` (B,) against per-lane views
        (the ``cache_specs(B, S)`` layout) → (logits (B, 1, V), cache).
        Attention layers write each lane's k/v (MLA: latent and rotary key)
        at its position into the views in place and attend over rows
        [0, position] (within the window for local attention) with the
        plain ``decode_attention`` (MLA: the absorbed ``mla_decode``).
        Recurrent layers' new states come back as new tensors in the
        returned tree; the given state leaves are not written."""
        x = self._embed(params, tokens)
        positions = positions.long()
        rows = torch.arange(x.shape[0], device=x.device)
        tables = self._rope(positions[:, None])
        states: dict = {}
        for si, r, key, kind, p in self._layers(params):
            leaves = cache[si][key]
            if kind in STATE_KINDS:
                x, new = self._decode_state(kind, p, x, _at(leaves, r))
                states.setdefault((si, key), []).append(new)
                continue
            if self.cfg.mla:
                y, _ = _mla.mla_decode(self.cfg, p["attn"], self._norm(p["ln1"], x),
                                       _at(leaves, r), positions, tables)
                x, _ = self._ffn_block(kind, p, x + y, "decode")
                continue
            q, k, v = self._qkv_rope(p, x, tables)
            kc, vc = leaves["k"][r], leaves["v"][r]
            kc[rows, positions] = k[:, 0].to(kc.dtype)
            vc[rows, positions] = v[:, 0].to(vc.dtype)
            out = decode_attention(q, kc, vc, positions, window=self._window(kind))
            x, _ = self._attn_out(kind, p, out, x, "decode")
        new_cache = [dict(seg) for seg in cache]
        for (si, key), sts in states.items():
            new_cache[si][key] = {n: torch.stack([st[n] for st in sts]) for n in sts[0]}
        return self._head(params, x), new_cache

    @torch.no_grad()
    def decode_step_paged(self, params, pools, block_tables, tokens, positions,
                          active):
        """One decode token per lane straight against the page pools:
        tokens (B, 1), block_tables (B, P) int32, positions (B,), active (B,)
        bool → (logits (B, 1, V), pools).

        Attention layers write the new k/v into the lane's current page
        through one ``paged_write`` launch (idle lanes and lanes whose page
        is unallocated write nothing; no host read, so the step can be
        captured in a CUDA graph).  A
        dense layer then runs the paged-decode kernel over the pages the
        block table names, reading ``positions + 1`` tokens per active lane
        and none for an idle one; a local-attention layer (which that kernel
        does not mask) gathers its lanes' k and v pages through one
        ``paged_gather`` launch and attends within the window
        (``paged_decode_windowed``), as the JAX package sends windowed
        layers to its XLA form; an MLA layer writes
        its latent and rotary key the same way and attends its gathered
        pages in the absorbed form (``mla.mla_decode_paged``).  Recurrent
        layers step the per-lane state leaves; idle lanes keep theirs.  The
        pools are updated in place."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        b = x.shape[0]
        positions = positions.long()
        tables = self._rope(positions[:, None])
        if self._has_attn:
            lengths = torch.where(active, positions + 1, 0).to(torch.int32)
            block_tables = block_tables.to(torch.int32).contiguous()
        for si, r, key, kind, p in self._layers(params):
            leaves = pools[si][key]
            if kind in STATE_KINDS:
                x, new = self._decode_state(kind, p, x, _at(leaves, r))
                for n, t in new.items():
                    old = leaves[n][r]
                    keep = active.view((b,) + (1,) * (old.ndim - 1))
                    old.copy_(torch.where(keep, t.to(old.dtype), old))
                continue
            if cfg.mla:
                y, _ = _mla.mla_decode_paged(cfg, p["attn"], self._norm(p["ln1"], x),
                                             _at(leaves, r), block_tables, positions, active,
                                             tables)
                x, _ = self._ffn_block(kind, p, x + y, "decode")
                continue
            q, k, v = self._qkv_rope(p, x, tables)
            kp, vp = leaves["k"][r], leaves["v"][r]
            paged_write_step([kp, vp], [k, v], block_tables, positions, active)
            if kind == "attn":
                out = paged_decode_windowed(q, kp, vp, block_tables, positions,
                                            self._window(kind))
            else:
                out = paged_decode(q.reshape(b, cfg.n_heads, cfg.hd), kp, vp,
                                   block_tables, lengths).reshape(b, 1, cfg.n_heads, cfg.hd)
            x, _ = self._attn_out(kind, p, out, x, "decode")
        return self._head(params, x), pools

    # -- cache layouts ----------------------------------------------------------

    def _layer_cache_spec(self, kind, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        if kind == "ssm":
            return _ssm.ssm_cache_spec(cfg, batch)
        if kind == "rec":
            return _rglru.rglru_cache_spec(cfg, batch)
        if cfg.mla:
            return _mla.mla_cache_spec(cfg, batch, max_len)
        # local attention keeps a full-length cache masked by the window, as
        # the JAX package does
        leaf = TensorSpec((batch, max_len, cfg.n_kv_heads, cfg.hd), cfg.torch_dtype)
        return {"k": leaf, "v": leaf}

    def cache_specs(self, batch: int, max_len: int) -> list:
        """One dict per segment, ``{"s{i}_{kind}": {leaf: spec}}``, each leaf
        stacked over the segment's repeats."""
        return [{f"s{i}_{k}": {n: TensorSpec((reps,) + t.shape, t.dtype)
                               for n, t in self._layer_cache_spec(k, batch, max_len).items()}
                 for i, k in enumerate(pattern)}
                for pattern, reps in self.segments]

    def cache_page_specs(self, lanes: int, n_pages: int, page_size: int) -> list:
        """The ``cache_specs(lanes, page_size)`` tree with each seq leaf's
        lane dim swapped for a page-pool dim: (repeats, n_pages, PS, Hkv, hd),
        or (repeats, n_pages, PS, rank or qr) for MLA's latent leaves.
        Recurrent-state leaves keep the per-lane layout: they are the one
        "page" per request the scheduler never splits."""
        def leaf(path, s):
            if path[-1] not in SEQ_CACHE_KEYS:
                return s
            return TensorSpec((s.shape[0], n_pages) + s.shape[2:], s.dtype)

        return tree_map_with_path(leaf, self.cache_specs(lanes, page_size))
