"""Positive fixture: captured steps in the port's idiom — branches on
device checks, shapes, config flags, identity and ``isinstance`` tests;
``torch.where`` with three arguments; offsets kept on the device; tree
walks; a tunable wrapper's table lookup in ``models/``; a kernel's plain
version reached through ``kernels/ref.py``, which is never followed."""
import torch

from repro_torch.analysis.ownership import captured_step
from repro_torch.kernels import ops

from .common import tree_items


def resolve_tuned(name, *args):
    return {"chunk": 128}


def attend(q, k, v, q_offset=0, kv_len=None, chunk=None):
    if chunk is None:
        chunk = resolve_tuned("attend", q)["chunk"]     # the @tunable wrapper's read
    return ops.flash_attention(q, k, v, q_offset=q_offset, kv_len=kv_len)


class LM:
    @captured_step
    def extend_step(self, params, cache, tokens, position: int | torch.Tensor,
                    last_only: bool = False):
        cfg = self.cfg
        x = self._embed(params, tokens)
        c = x.shape[1]
        at = position + torch.arange(c, device=x.device)
        if isinstance(position, torch.Tensor):
            offs = torch.stack((position, position + c)).to(torch.int32)
            q_offset, kv_len = offs[0], offs[1]
        else:
            q_offset, kv_len = position, position + c
        for si, r, key, kind, p in self._layers(params):
            leaves = cache[si][key]
            if kind == "ssm" or cfg.mla:
                continue
            kc, vc = leaves["k"][r], leaves["v"][r]
            kc.index_copy_(1, at, x)
            vc.index_copy_(1, at, x)
            x = x + attend(x, kc, vc, q_offset=q_offset, kv_len=kv_len)
        return self._head(params, x[:, -1:] if last_only else x), cache

    @captured_step
    def decode_step_paged(self, params, pools, block_tables, tokens, positions, active):
        x = self._embed(params, tokens)
        b = x.shape[0]
        lengths = torch.where(active, positions + 1, 0).to(torch.int32)
        if x.is_cuda and b > 1 and x.device.type == "cuda":
            block_tables = block_tables.to(torch.int32).contiguous()
        for lane in range(x.shape[0]):                  # a shape: static
            x[lane] = x[lane] * 1
        for _path, leaf in tree_items(pools):
            keep = active.view((b,) + (1,) * (leaf.ndim - 1))
            leaf.copy_(torch.where(keep, leaf * 0, leaf))
        states = {}
        for n, t in states.items():
            pools[n].copy_(t)
        out = ops.paged_write([p for _, p in tree_items(pools)], [x], block_tables,
                              positions, active)
        if self._extra is None or out is not None:
            x = x + 1
        return self._head(params, x), lengths

    def _layers(self, params):
        for si, (pattern, reps) in enumerate(self.segments):
            for r in range(reps):
                for i, kind in enumerate(pattern):
                    key = f"s{i}_{kind}"
                    yield si, r, key, kind, params[f"seg{si}"][key]

    def _embed(self, params, tokens):
        return params["embed"][tokens]

    def _head(self, params, x):
        return x @ params["head"]
