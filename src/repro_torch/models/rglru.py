"""RecurrentGemma (Griffin) RG-LRU recurrent block: the port of
``repro/models/rglru.py``.

    r_t = σ(block_diag(W_r) x_t);  i_t = σ(block_diag(W_i) x_t)
    a_t = exp(-c · softplus(Λ) · r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The JAX package scans (a, b) pairs with ``jax.lax.associative_scan``; PyTorch
has none, so prefill, chunked prefill and training run ``linear_scan``, a
log-depth doubling scan (Hillis–Steele) in plain, differentiable torch:
⌈log₂ S⌉ passes over (B, S, W) float32 instead of S one-step launches.  It
equals the reference within float32 sum order.  Decode carries h directly.
The conv1d(4) and the two-branch gating follow the Griffin recurrent block;
projections stay ``torch.matmul``.  The recurrent state h is float32 (tiny,
sensitive); the conv state keeps the model's type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import PSpec, TensorSpec, causal_conv

_C = 8.0          # Griffin's fixed scaling constant
_NB = 16          # block-diagonal gate blocks


def rglru_specs(cfg) -> dict:
    d = cfg.d_model
    w = cfg.rglru.lru_width
    k = cfg.rglru.d_conv
    dt = cfg.torch_dtype
    bw = w // _NB
    return {
        "w_x": PSpec((d, w), dt),
        "w_gate": PSpec((d, w), dt),
        "conv_w": PSpec((k, w), dt),
        "conv_b": PSpec((w,), dt, "zeros"),
        "gate_r": PSpec((_NB, bw, bw), dt),
        "gate_i": PSpec((_NB, bw, bw), dt),
        "lambda_p": PSpec((w,), torch.float32, "ones"),
        "w_out": PSpec((w, d), dt),
    }


def _block_diag_gate(x, w):
    """x (B, S, W) → σ(x · blockdiag(w)) in float32, w (NB, W/NB, W/NB); the
    product in the model's type."""
    b, s, width = x.shape
    y = torch.einsum("bsnw,nwv->bsnv", x.reshape(b, s, _NB, width // _NB), w)
    return torch.sigmoid(y.reshape(b, s, width).float())


def _gates(p, xc):
    """(a, b·x): the decay a and the scaled input of each step, float32."""
    r = _block_diag_gate(xc, p["gate_r"])
    i = _block_diag_gate(xc, p["gate_i"])
    log_a = -_C * F.softplus(p["lambda_p"]) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably in log space
    b_scale = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, b_scale * i * xc.float()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + b_t from h_{-1} = 0 along dim 1: the doubling
    scan.  Pass d combines each step with the one d before it,
    (a, b)_t ← (a_t · a_{t-d}, a_t · b_{t-d} + b_t), steps before d taking
    the identity (1, 0); out of place, so autograd runs through it."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.addcmul(b, a, F.pad(b[:, :-d], (0, 0, d, 0)))
        if 2 * d < s:
            a = a * F.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
        d *= 2
    return b


def _in_branches(p, x, conv_state):
    xb = x @ p["w_x"]
    gate_branch = F.gelu(x @ p["w_gate"], approximate="tanh")
    xc, new_conv = causal_conv(xb, p["conv_w"], p["conv_b"], conv_state)
    return gate_branch, xc, new_conv


def rglru_block(cfg, p, x, state=None, conv_state=None):
    """x (B, S, D) → (y (B, S, D), cache {"h": (B, W) float32, "conv":
    (B, K-1, W)}).  A carried ``state`` (B, W) folds into the first step."""
    gate_branch, xc, new_conv = _in_branches(p, x, conv_state)
    a, bx = _gates(p, xc)
    if state is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * state.float()[:, None], bx[:, 1:]], dim=1)
    h = linear_scan(a, bx)
    y = (h.to(x.dtype) * gate_branch) @ p["w_out"]
    return y, {"h": h[:, -1], "conv": new_conv}


def rglru_extend(cfg, p, x, cache):
    """Multi-token extend (chunked prefill): the scanned block seeded with
    the carried (h, conv); any chunk length runs."""
    return rglru_block(cfg, p, x, state=cache["h"], conv_state=cache["conv"])


def rglru_decode(cfg, p, x, cache):
    """x (B, 1, D): the O(1) state update → (y (B, 1, D), new cache)."""
    gate_branch, xc, new_conv = _in_branches(p, x, cache["conv"])
    a, bx = _gates(p, xc)
    h = a[:, 0] * cache["h"].float() + bx[:, 0]
    y = (h[:, None].to(x.dtype) * gate_branch) @ p["w_out"]
    return y, {"h": h, "conv": new_conv}


def rglru_cache_spec(cfg, batch: int) -> dict:
    w = cfg.rglru.lru_width
    k = cfg.rglru.d_conv
    return {
        "h": TensorSpec((batch, w), torch.float32),
        "conv": TensorSpec((batch, k - 1, w), cfg.torch_dtype),
    }
