"""Mixture-of-Experts FFN with grouped capacity-factor dispatch: the port of
``repro/models/moe.py``.

Token-choice top-k routing (DeepSeek-V3 / Qwen3-MoE style) as the grouped
dense dispatch of the JAX package: tokens are split into G groups, each
group dispatches into per-expert capacity slots through (G, T, E, C)
dispatch and combine masks, the experts run over the (G, E, C, D) slab, and
the combine mask carries the router weights back.  The router runs in
float32; the masks are cast to the activation type before the two dispatch
contractions, as in the reference (so bf16 serving rounds the router
weights before the combine).  Every contraction is a plain torch matmul:
the reference runs them outside any Pallas kernel.

``drop=True`` (whole-prompt prefill, training) sizes each expert's queue
by ``capacity_factor`` and drops the (token, rank) pairs past it;
``drop=False`` (chunked prefill and decode, with one group) gives every
expert ``T`` slots, so nothing drops.  ``trim=True`` materialises only the
slots some token fills: the same function (an empty slot's row is zero,
and these gated FFNs map a zero row to zero), at the cost of one host read
for the fill count.  The tuning registry that picks ``expert_block`` in
the reference is not ported: ``expert_ffn`` keeps its default, 0.
"""
from __future__ import annotations

import torch

from .common import PSpec, activation


def moe_specs(cfg) -> dict:
    e, d = cfg.n_experts, cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    specs = {
        "router": PSpec((d, e), torch.float32),
        "w_gate": PSpec((e, d, f), dt),
        "w_up": PSpec((e, d, f), dt),
        "w_down": PSpec((e, f, d), dt),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        specs["shared"] = {
            "w_gate": PSpec((d, fs), dt),
            "w_up": PSpec((d, fs), dt),
            "w_down": PSpec((fs, d), dt),
        }
    return specs


def _dispatch_masks(gates: torch.Tensor, k: int, capacity: int, trim: bool = False):
    """Top-k token-choice dispatch and combine masks, per group.

    gates: (G, T, E) router probabilities.  Returns dispatch (G, T, E, C)
    (0/1) and combine (G, T, E, C) (the renormalised router weight of each
    kept pair), both float32.  A (token, rank) pair takes the next slot of
    its expert's queue, counted over the flattened (T, k) order: token-major,
    then by rank (``torch.topk`` sorts descending, as ``lax.top_k``); pairs
    at or past ``capacity`` are dropped.  C is ``capacity``, or with
    ``trim`` the most slots any expert fills (one host read)."""
    g, t, e = gates.shape
    topw, topi = torch.topk(gates, k, dim=-1)                       # (G, T, k)
    # renormalise the kept weights (deepseek-v3 / switch convention)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    onehot = torch.nn.functional.one_hot(topi, e).float()           # (G, T, k, E)
    flat = onehot.reshape(g, t * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, t, k, e)
    slot = pos.gather(-1, topi[..., None])[..., 0]                  # (G, T, k)
    keep = slot < capacity                                          # capacity drop
    width = capacity
    if trim:
        width = max(1, min(capacity, int(flat.sum(1).max())))
    slot_oh = (slot[..., None] == torch.arange(width, device=gates.device)).float()
    kept = onehot * keep[..., None]
    disp = torch.einsum("gtke,gtkc->gtec", kept, slot_oh)
    # per-slot router weights ride the combine tensor
    comb = torch.einsum("gtke,gtkc->gtec", kept * topw[..., None], slot_oh)
    return disp, comb


def aux_load_balance_loss(gates_mean: torch.Tensor, counts_mean: torch.Tensor,
                          e: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * <p_e> . <f_e>."""
    return e * torch.sum(gates_mean * counts_mean)


def _expert_ffn_slab(xe, w_gate, w_up, w_down, act):
    g, e, c, d = xe.shape
    xs = xe.transpose(0, 1).reshape(e, g * c, d)                    # experts lead
    h = torch.bmm(xs, w_gate)
    h = act(h) * torch.bmm(xs, w_up) if w_up is not None else act(h)
    return torch.bmm(h, w_down).view(e, g, c, d).transpose(0, 1)


def expert_ffn(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor | None,
               w_down: torch.Tensor, *, act=activation("gelu"),
               expert_block: int | None = None) -> torch.Tensor:
    """Per-expert FFN over the dispatched capacity slabs: xe (G, E, C, D)
    with w_gate/w_up (E, D, F) (``w_up`` None: a gate-only FFN) and w_down
    (E, F, D) → (G, E, C, D).  ``expert_block`` > 0 runs the experts in
    slabs of that many (E is a batch dim of every contraction, so the
    result is the same); 0 or None, the default, runs them all at once."""
    e = xe.shape[1]
    if expert_block and 0 < expert_block < e:
        return torch.cat([
            _expert_ffn_slab(xe[:, i:i + expert_block], w_gate[i:i + expert_block],
                             None if w_up is None else w_up[i:i + expert_block],
                             w_down[i:i + expert_block], act)
            for i in range(0, e, expert_block)], dim=1)
    return _expert_ffn_slab(xe, w_gate, w_up, w_down, act)


def n_groups_for(b: int, s: int) -> int:
    """The reference's default group count: ~4k-token groups, but never
    fewer than 32 when the tokens divide into 32 (its batch shards), else
    the first of 16, 8, the batch and 1 that divides them."""
    total = b * s
    return next(c for c in (max(32, total // 4096), total // 4096, 32, 16, 8, b, 1)
                if c > 0 and total % c == 0)


def _dispatch(cfg, p: dict, xt: torch.Tensor, capacity: int, trim: bool):
    """Route xt (G, T, D) and fill the experts' slots: → (xe (G, E, C, D),
    the combine mask (G, T, E, C) in float32, the aux loss)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    gates = torch.softmax(xt.float() @ p["router"], dim=-1)            # (G, T, E)
    disp, comb = _dispatch_masks(gates, k, capacity, trim)

    # aux load-balance loss (mean gate prob vs mean dispatch fraction)
    gates_mean = gates.mean(dim=(0, 1))
    counts_mean = disp.sum(-1).mean(dim=(0, 1)) * (e / k)
    aux = aux_load_balance_loss(gates_mean, counts_mean, e) * cfg.router_aux_weight
    return torch.einsum("gtec,gtd->gecd", disp.to(xt.dtype), xt), comb, aux


def _combine(comb: torch.Tensor, ye: torch.Tensor) -> torch.Tensor:
    """Carry the experts' rows ye (G, E, C, D) back to their tokens, weighted
    by the combine mask rounded to the activation type: → (G, T, D)."""
    return torch.einsum("gtec,gecd->gtd", comb.to(ye.dtype), ye)


def moe_ffn(cfg, p: dict, x: torch.Tensor, n_groups: int | None = None,
            drop: bool = True, trim: bool = False):
    """x (B, S, D) → (output (B, S, D), aux loss (a float32 scalar)).
    ``n_groups`` None takes the reference's heuristic (``n_groups_for``);
    ``drop=False`` gives every expert as many slots as a group has tokens;
    ``trim`` materialises only the filled slots (the same function)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    act = activation(cfg.act)
    g = n_groups_for(b, s) if n_groups is None else n_groups
    if (b * s) % g:
        raise ValueError(f"moe_ffn: {b * s} tokens do not split into {g} groups")
    t = b * s // g
    capacity = max(int(t * k * cfg.capacity_factor / e), 4) if drop else t
    xe, comb, aux = _dispatch(cfg, p, x.reshape(g, t, d), capacity, trim)
    ye = expert_ffn(xe, p["w_gate"], p["w_up"], p["w_down"], act=act)
    y = _combine(comb, ye).reshape(b, s, d)

    if cfg.n_shared_experts:
        sp = p["shared"]
        y = y + (act(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]
    return y, aux
