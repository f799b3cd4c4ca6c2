"""Whisper-style encoder/decoder (the audio family): the port of
``repro/models/encdec.py``.

The conv frontend is a stub, as in the JAX package: callers pass
precomputed mel-frame embeddings (B, n_ctx, d_model).  Everything after it
is real: sinusoidal encoder positions, learned decoder positions, pre-LN
blocks with biased LayerNorm, non-causal encoder self-attention, causal
decoder self-attention and cross-attention over the encoder's output, a
tanh-GeLU MLP and a head tied to ``embed``.  Attention projections carry
``bq``, ``bv`` and ``bo`` but no ``bk``.

Attention runs as ``DecoderLM``'s does: ``encode`` and ``prefill`` through
``attend`` with the caller's ``impl`` (``"kernel"``, the flash kernel, when
serving; ``"xla"``, the differentiable chunked scan, in the training
``forward``/``loss``), and ``decode_step``'s self- and cross-attention
through the plain ``decode_attention``, as the reference leaves both to
XLA.  The serving methods run under ``torch.no_grad()``; ``decode_step``
writes the new k/v row into the cache in place.  There is no paged decode:
the serving engine refuses the model on its paged path, as the
reference's does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve

from .attention import attend, decode_attention
from .common import PSpec, TensorSpec, init_params, layer_norm, sinusoidal_positions
from .transformer import _layer, _proj, _stack


def _ln(d: int) -> dict:
    return {"w": PSpec((d,), torch.float32, "ones"), "b": PSpec((d,), torch.float32, "zeros")}


def _attn_specs(cfg) -> dict:
    d, hhd, dt = cfg.d_model, cfg.n_heads * cfg.hd, cfg.torch_dtype
    return {
        "wq": PSpec((d, hhd), dt),
        "bq": PSpec((hhd,), dt, "zeros"),
        "wk": PSpec((d, hhd), dt),
        "wv": PSpec((d, hhd), dt),
        "bv": PSpec((hhd,), dt, "zeros"),
        "wo": PSpec((hhd, d), dt),
        "bo": PSpec((d,), dt, "zeros"),
    }


def _mlp_specs(cfg) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
    return {
        "fc1": PSpec((d, f), dt),
        "b1": PSpec((f,), dt, "zeros"),
        "fc2": PSpec((f, d), dt),
        "b2": PSpec((d,), dt, "zeros"),
    }


def _heads(cfg, x):
    return x.view(x.shape[0], x.shape[1], cfg.n_heads, cfg.hd)


def _proj_qkv(cfg, p, xq, xkv):
    """q, k, v (B, S, H, hd) of the queries' and the keys' inputs."""
    return (_heads(cfg, _proj(xq, p["wq"], p["bq"])), _heads(cfg, _proj(xkv, p["wk"])),
            _heads(cfg, _proj(xkv, p["wv"], p["bv"])))


def _out(p, a):
    """The attention output (B, S, H, hd) through ``wo`` + ``bo``."""
    return _proj(a.reshape(a.shape[0], a.shape[1], -1), p["wo"], p["bo"])


def _attn(cfg, p, xq, xkv, causal: bool, impl: str):
    """Attention of xq over xkv → (projected output, (k, v))."""
    q, k, v = _proj_qkv(cfg, p, xq, xkv)
    a = attend(q, k, v, causal=causal, impl=impl, chunk=cfg.attn_chunk)
    return _out(p, a), (k, v)


def _mlp(p, x):
    return _proj(F.gelu(_proj(x, p["fc1"], p["b1"]), approximate="tanh"), p["fc2"], p["b2"])


class EncDecLM:
    """Whisper-family model with ``DecoderLM``'s serving surface but a
    shared decode position (no paged decode)."""

    def __init__(self, cfg):
        if cfg.family != "audio":
            raise ValueError(f"EncDecLM serves the audio family, not {cfg.family!r}")
        if cfg.remat not in ("none", "full"):
            raise NotImplementedError(f"remat={cfg.remat!r} is not ported ('none' or 'full')")
        self.cfg = cfg
        self._positions: dict = {}      # (n_ctx, device, dtype) -> sinusoidal table

    # -- parameters ---------------------------------------------------------

    def param_specs(self) -> dict:
        cfg = self.cfg
        d, dt = cfg.d_model, cfg.torch_dtype
        enc = {"ln1": _ln(d), "attn": _attn_specs(cfg), "ln2": _ln(d), "mlp": _mlp_specs(cfg)}
        dec = {"ln1": _ln(d), "attn": _attn_specs(cfg), "lnx": _ln(d),
               "cross": _attn_specs(cfg), "ln2": _ln(d), "mlp": _mlp_specs(cfg)}
        return {
            "embed": PSpec((cfg.padded_vocab, d), dt, scale=1.0),
            "pos_dec": PSpec((cfg.max_position, d), dt, scale=0.02),
            "enc_ln_post": _ln(d),
            "dec_ln_post": _ln(d),
            "enc": _stack(enc, cfg.encoder.n_layers),
            "dec": _stack(dec, cfg.n_layers),
        }

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Random weights from ``generator`` (which lives on ``device``) on
        the card, or on the CPU when ``device="cpu"``."""
        return init_params(self.param_specs(), generator, resolve(device))

    # -- pieces -------------------------------------------------------------

    def _ln(self, p, x):
        return layer_norm(x, p["w"], p["b"], self.cfg.norm_eps)

    def _run(self, fn, *args):
        """One layer, recomputed in the backward under ``remat="full"``."""
        if self.cfg.remat == "full" and torch.is_grad_enabled():
            # no random numbers drawn: no RNG state to stash (see DecoderLM.forward)
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def _enc_layer(self, p, x, impl):
        h = self._ln(p["ln1"], x)
        x = x + _attn(self.cfg, p["attn"], h, h, False, impl)[0]
        return x + _mlp(p["mlp"], self._ln(p["ln2"], x))

    def _dec_layer(self, p, x, enc, impl):
        """One decoder layer over whole sequences → (x, its cache leaves)."""
        cfg = self.cfg
        h = self._ln(p["ln1"], x)
        a, (k, v) = _attn(cfg, p["attn"], h, h, True, impl)
        x = x + a
        c, (ck, cv) = _attn(cfg, p["cross"], self._ln(p["lnx"], x), enc, False, impl)
        x = x + c
        x = x + _mlp(p["mlp"], self._ln(p["ln2"], x))
        return x, {"k": k, "v": v, "ck": ck, "cv": cv}

    def _head(self, params, x):
        x = self._ln(params["dec_ln_post"], x)
        return x @ params["embed"].T.to(x.dtype)

    def _dec_embed(self, params, tokens, pos0: int):
        """Token embeddings plus the learned positions [pos0, pos0 + S), the
        start clamped to [0, max_position - S] as ``lax.dynamic_slice_in_dim``
        clamps it."""
        s = tokens.shape[1]
        pos = params["pos_dec"]
        start = min(max(pos0, 0), pos.shape[0] - s)
        return params["embed"][tokens] + pos[start:start + s][None]

    # -- encoder ------------------------------------------------------------

    def encode(self, params, frames, impl: str = "kernel"):
        """frames (B, n_ctx, D) → the encoder's output (B, n_ctx, D):
        sinusoidal positions, the pre-LN blocks, the final LayerNorm."""
        cfg = self.cfg
        x = frames.to(cfg.torch_dtype)
        key = (x.shape[1], x.device, x.dtype)
        if key not in self._positions:
            self._positions[key] = sinusoidal_positions(x.shape[1], cfg.d_model).to(
                x.device, x.dtype)
        x = x + self._positions[key][None]
        for r in range(cfg.encoder.n_layers):
            x = self._run(self._enc_layer, _layer(params["enc"], r), x, impl)
        return self._ln(params["enc_ln_post"], x)

    # -- training API -------------------------------------------------------

    def forward(self, params, tokens, impl: str = "xla", frames=None, extra_embeds=None):
        """tokens (B, S) and frames (B, n_ctx, D) (or ``extra_embeds``) →
        (logits (B, S, V) in the model's type, a float32 zero aux loss).
        Differentiable; ``impl="xla"`` attends with the chunked scan, as
        JAX's train step does."""
        frames = frames if frames is not None else extra_embeds
        enc = self.encode(params, frames, impl)
        x = self._dec_embed(params, tokens.long(), 0)
        for r in range(self.cfg.n_layers):
            x = self._run(lambda p, h: self._dec_layer(p, h, enc, impl)[0],
                          _layer(params["dec"], r), x)
        return self._head(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params, batch, impl: str = "xla"):
        """Mean next-token cross-entropy of batch {"tokens", "targets",
        "frames"}; the padded vocabulary is masked with -1e30 and the
        log-softmax taken in float32, as in JAX."""
        cfg = self.cfg
        logits, _ = self.forward(params, batch["tokens"], impl, frames=batch["frames"])
        logits = logits.float()
        if cfg.padded_vocab != cfg.vocab_size:
            col = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab_size
            logits = torch.where(col, -1e30, logits)
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, batch["targets"].long()[..., None]).mean()

    # -- serving API --------------------------------------------------------

    @torch.no_grad()
    def prefill(self, params, tokens, frames=None, extra_embeds=None, max_len=None):
        """tokens (B, S) and frames (B, n_ctx, D) → (logits (B, 1, V) at the
        last position, ``[{"k", "v", "ck", "cv"}]``): each leaf (L, B, rows,
        H, hd), k/v over the prompt's S rows, ck/cv over the encoder's
        n_ctx.  ``max_len`` is taken and ignored, as the reference does: a
        caller that decodes copies the cache into ``cache_specs`` zeros.
        Every attention runs the flash kernel."""
        frames = frames if frames is not None else extra_embeds
        enc = self.encode(params, frames, "kernel")
        x = self._dec_embed(params, tokens, 0)
        layers = []
        for r in range(self.cfg.n_layers):
            x, c = self._dec_layer(_layer(params["dec"], r), x, enc, "kernel")
            layers.append(c)
        cache = {n: torch.stack([c[n] for c in layers]) for n in ("k", "v", "ck", "cv")}
        return self._head(params, x[:, -1:]), [cache]

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, position: int):
        """One token per lane, tokens (B, 1), at one ``position`` shared by
        the batch → (logits (B, 1, V), cache).
        Self-attention writes each lane's k/v at ``position`` into the
        cache in place (the row clamped to the cache, as
        ``dynamic_update_slice`` clamps it) and reads rows [0, position];
        cross-attention reads all n_ctx encoder rows."""
        cfg = self.cfg
        x = self._dec_embed(params, tokens, position)
        cs = cache[0]
        b, dev = x.shape[0], x.device
        smax, nctx = cs["k"].shape[2], cs["ck"].shape[2]
        # filled on the device: no host-to-device copy, no sync
        row = torch.full((1,), min(max(position, 0), smax - 1), dtype=torch.long, device=dev)
        self_pos = torch.full((b,), position, dtype=torch.long, device=dev)
        cross_pos = torch.full((b,), nctx - 1, dtype=torch.long, device=dev)
        for r in range(cfg.n_layers):
            p = _layer(params["dec"], r)
            kc, vc = cs["k"][r], cs["v"][r]
            hq = self._ln(p["ln1"], x)
            q, k, v = _proj_qkv(cfg, p["attn"], hq, hq)
            kc.index_copy_(1, row, k.to(kc.dtype))
            vc.index_copy_(1, row, v.to(vc.dtype))
            x = x + _out(p["attn"], decode_attention(q, kc, vc, self_pos))
            qx = _heads(cfg, _proj(self._ln(p["lnx"], x), p["cross"]["wq"], p["cross"]["bq"]))
            x = x + _out(p["cross"], decode_attention(qx, cs["ck"][r], cs["cv"][r], cross_pos))
            x = x + _mlp(p["mlp"], self._ln(p["ln2"], x))
        return self._head(params, x), cache

    # -- cache layout -------------------------------------------------------

    def cache_specs(self, batch: int, max_len: int) -> list:
        """``[{"k", "v": (L, B, max_len, H, hd), "ck", "cv": (L, B, n_ctx,
        H, hd)}]`` in the model's type."""
        cfg = self.cfg
        tail = (cfg.n_heads, cfg.hd)
        seq = TensorSpec((cfg.n_layers, batch, max_len) + tail, cfg.torch_dtype)
        ctx = TensorSpec((cfg.n_layers, batch, cfg.encoder.n_ctx) + tail, cfg.torch_dtype)
        return [{"k": seq, "v": seq, "ck": ctx, "cv": ctx}]
