"""Mamba-2 SSD block, chunked form: the port of ``repro/models/ssm.py``.

``ssd_chunked`` has two implementations of its sequence mix.
``impl="kernel"`` (serving's prefill; the default) runs
``kernels.ops.ssd_scan``: the hand-written CUDA kernel on the card, its
plain PyTorch version on the CPU; it has no backward and refuses inputs
that require grad.  ``impl="xla"`` (training) runs the JAX package's
factorized XLA form in plain torch on any device, which is that plain
version itself (``kernels.ref.ssd_scan``: chunked cumulative decays
clamped to ±60 around each chunk's midpoint, the masked intra-chunk
product, the chunk states and a Python loop over chunks in place of
``lax.scan``), with autograd through it; the ``d_skip`` term follows
either.  The chunk is
``cfg.ssm.chunk`` (the port has no tuning registry; the JAX ``@tunable``
lookup finds no tuned entry for these shapes and falls back to the same
value).  The depthwise causal conv and the O(1) decode step
(``ssm_decode``: h ← exp(dt·a)·h + dt·B⊗x, y = C·h) stay plain torch, as
the JAX package leaves them to XLA.

Only the factorized intra-chunk decay (``SSMConfig.factorized``, the
default) is ported.  The recurrent state is float32 (tiny, sensitive); the
conv state keeps the model's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

from .common import PSpec, TensorSpec, causal_conv, rms_norm


def ssm_specs(cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di, nh, n = s.d_inner(d), s.n_heads(d), s.d_state
    dt = cfg.torch_dtype
    conv_dim = di + 2 * n
    return {
        "in_proj": PSpec((d, 2 * di + 2 * n + nh), dt),
        "conv_w": PSpec((s.d_conv, conv_dim), dt),
        "conv_b": PSpec((conv_dim,), dt, "zeros"),
        "a_log": PSpec((nh,), torch.float32, "zeros"),
        "d_skip": PSpec((nh,), torch.float32, "ones"),
        "dt_bias": PSpec((nh,), torch.float32, "zeros"),
        "norm": PSpec((di,), torch.float32, "ones"),
        "out_proj": PSpec((di, d), dt),
    }


def _split_proj(cfg, zxbcdt):
    """(z, the conv input [x, B, C], dt) as views of the in_proj output."""
    s = cfg.ssm
    di, n = s.d_inner(cfg.d_model), s.d_state
    return (zxbcdt[..., :di], zxbcdt[..., di: 2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _causal_conv(x, w, b, state=None):
    """silu of the depthwise causal conv (``common.causal_conv``) and the new
    conv state."""
    y, new_state = causal_conv(x, w, b, state)
    return F.silu(y), new_state


def _conv_split(cfg, conv_out):
    s = cfg.ssm
    di, n = s.d_inner(cfg.d_model), s.d_state
    return conv_out[..., :di], conv_out[..., di: di + n], conv_out[..., di + n:]


def ssd_chunked(cfg, xh, bb, cc, dt, a_log, d_skip, init_state=None, impl: str = "kernel"):
    """SSD forward.  xh (B, S, H, P); bb/cc (B, S, N); dt (B, S, H) before
    the softplus → (y (B, S, H, P) in xh's dtype, final state (B, H, P, N)
    float32).  ``impl`` is ``"kernel"`` (``ssd_scan``, no backward) or
    ``"xla"`` (differentiable plain torch).  S must be a multiple of
    ``min(chunk, S)``: the JAX reference asserts it and the port raises
    ``ValueError`` (it does not pad)."""
    if impl not in ("kernel", "xla"):
        raise ValueError(f"ssd_chunked: impl must be 'kernel' or 'xla', got {impl!r}")
    sl = xh.shape[1]
    q = min(cfg.ssm.chunk, sl)
    if sl % q:
        raise ValueError(f"ssd_chunked: a {sl}-token sequence is not a multiple of "
                         f"the {q}-token chunk")
    a = -torch.exp(a_log)
    dt = F.softplus(dt.float())
    scan = kref.ssd_scan if impl == "xla" else kops.ssd_scan
    y, final = scan(xh, bb, cc, dt, a, q, init_state)
    y = y + d_skip[None, None, :, None] * xh.float()
    return y.to(xh.dtype), final


def ssm_block(cfg, p, x, init_state=None, conv_state=None, impl: str = "kernel"):
    """Full Mamba-2 block: x (B, S, D) → (out (B, S, D), new state
    (B, H, P, N) float32, new conv state (B, K-1, C)); ``impl`` picks
    ``ssd_chunked``'s sequence mix."""
    s = cfg.ssm
    b, sl, d = x.shape
    di = s.d_inner(d)
    z, conv_in, dt = _split_proj(cfg, x @ p["in_proj"])
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"], conv_state)
    xi, bb, cc = _conv_split(cfg, conv_out)
    xh = xi.reshape(b, sl, s.n_heads(d), s.head_dim)
    y, final = ssd_chunked(cfg, xh, bb, cc, dt, p["a_log"], p["d_skip"], init_state, impl)
    y = y.reshape(b, sl, di)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], final, new_conv


def ssm_extend(cfg, p, x, state, conv):
    """Multi-token extend (chunked prefill): the chunked SSD forward seeded
    with the carried (state, conv), the sequence split into slices of at
    most ``chunk`` tokens (each slice is one chunk, so ragged lengths run)."""
    q = cfg.ssm.chunk
    ys = []
    for i0 in range(0, x.shape[1], q):
        y, state, conv = ssm_block(cfg, p, x[:, i0: i0 + q], init_state=state,
                                   conv_state=conv)
        ys.append(y)
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), state, conv


def ssm_decode(cfg, p, x, state, conv):
    """O(1) decode: x (B, 1, D) with the per-lane state (B, H, P, N) and
    conv state (B, K-1, C) → (out (B, 1, D), new state, new conv state)."""
    s = cfg.ssm
    b, _, d = x.shape
    di, nh, n = s.d_inner(d), s.n_heads(d), s.d_state
    z, conv_in, dt = _split_proj(cfg, x @ p["in_proj"])
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"], conv)
    xi, bb, cc = _conv_split(cfg, conv_out)
    xh = xi.reshape(b, nh, s.head_dim).float()                      # (B, H, P)
    dtv = F.softplus(dt.float()).reshape(b, nh)
    da = torch.exp(dtv * -torch.exp(p["a_log"]))                    # (B, H)
    bf = bb.reshape(b, n).float()
    cf = cc.reshape(b, n).float()
    h_new = state.float() * da[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dtv, bf, xh)
    y = torch.einsum("bn,bhpn->bhp", cf, h_new)
    y = (y + p["d_skip"][None, :, None] * xh).reshape(b, 1, di)
    y = rms_norm(y.to(x.dtype) * F.silu(z.float()).to(x.dtype), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], h_new, new_conv


def ssm_cache_spec(cfg, batch: int) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    nh, n = s.n_heads(d), s.d_state
    return {
        "state": TensorSpec((batch, nh, s.head_dim, n), torch.float32),
        "conv": TensorSpec((batch, s.d_conv - 1, s.d_inner(d) + 2 * n), cfg.torch_dtype),
    }
