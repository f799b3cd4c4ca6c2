"""The fixed-slot serving engine over a dense cache, kept as the paged
engine's reference (the port of ``repro/serve/dense_engine.py``).

A fixed-size slot array over a dense ``batch_slots x max_len`` decode cache
(the model's ``cache_specs`` layout); finished slots are refilled from the
queue (continuous batching); prefill runs per request and its cache is
packed into the slot's row.  Every slot pays ``max_len`` of cache whatever
the request's length, and every slot steps at the shared maximum position:
the two costs the paged ``ServeEngine`` removes.  With prompts of one length
the two engines give the same greedy tokens.

The JAX package rebuilds a model built with per-layer decode caches
(``decode_unroll_layers``) on the stacked layout first
(``stacked_decode_model``); the port's ``cache_specs`` is always stacked,
so there is nothing to rebuild.  Sampling draws under a ``torch.Generator``
where the reference splits a JAX key.  Runs on the card unless
``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models.common import tree_map

from .engine import EngineConfig, Request, sample_tokens


class DenseSlotEngine:
    """Greedy and temperature sampling over a dense per-slot decode cache."""

    def __init__(self, model, params, ecfg: EngineConfig, device=None):
        self.device = resolve(device)
        self.model = model
        self.params = params
        self.ecfg = ecfg
        self.cfg = model.cfg
        b, m = ecfg.batch_slots, ecfg.max_len
        self.cache = tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=self.device),
            model.cache_specs(b, m))
        self.slot_req: list[Request | None] = [None] * b
        self.slot_pos = np.zeros(b, np.int32)      # next write position
        self.queue: list[Request] = []

    # -- request handling ------------------------------------------------------

    def submit(self, req: Request):
        self.queue.append(req)

    def _finished(self, req: Request, tok: int, pos: int) -> bool:
        return (len(req.out_tokens) >= req.max_new_tokens or tok == self.ecfg.eos_id
                or pos >= self.ecfg.max_len - 1)

    def _fill_slot(self, slot: int, req: Request) -> bool:
        """Prefill one request and pack its cache into the slot's row.  False
        when the request finished on its prefill token: the slot stays free
        for the next request in the queue."""
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                                 device=self.device)[None]
        logits, cache = self.model.prefill(self.params, prompt)
        s = prompt.shape[1]
        tok = int(logits[0, -1].float().argmax())
        req.out_tokens.append(tok)
        if self._finished(req, tok, s):
            req.done = True
            return False

        def pack(big, small):
            # big (reps, B, ...), small (reps, 1, ...) whose seq dim is s
            if big.ndim >= 3 and small.ndim == big.ndim and small.shape[2] != big.shape[2]:
                small = torch.nn.functional.pad(
                    small, (0, 0) * (small.ndim - 3) + (0, big.shape[2] - small.shape[2]))
            big[:, slot:slot + 1] = small.to(big.dtype)
            return big

        self.cache = tree_map(pack, self.cache, cache)
        self.slot_req[slot] = req
        self.slot_pos[slot] = s
        return True

    def _refill(self):
        for i in range(self.ecfg.batch_slots):
            while self.slot_req[i] is None and self.queue:
                if self._fill_slot(i, self.queue.pop(0)):
                    break

    def step(self, generator: torch.Generator | None = None) -> bool:
        """One decode step for every active slot, all at the shared maximum
        position (the reference's dense engine)."""
        self._refill()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        b = self.ecfg.batch_slots
        last = np.zeros((b, 1), np.int64)
        for i in active:
            last[i, 0] = self.slot_req[i].out_tokens[-1]
        pos = int(max(self.slot_pos[i] for i in active))
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, torch.as_tensor(last, device=self.device),
            torch.full((b,), pos, dtype=torch.long, device=self.device))
        rows = logits[:, 0].float()
        toks = rows.argmax(-1)
        sampled = ([i for i in active if self.slot_req[i].temperature > 0]
                   if generator is not None else [])
        if sampled:
            idx = torch.tensor(sampled, device=self.device)
            temps = torch.tensor([self.slot_req[i].temperature for i in sampled],
                                 dtype=torch.float32, device=self.device)
            toks[idx] = sample_tokens(rows[idx], temps, generator)
        toks = toks.cpu().numpy()
        for i in active:
            req = self.slot_req[i]
            tok = int(toks[i])
            req.out_tokens.append(tok)
            self.slot_pos[i] = pos + 1
            if self._finished(req, tok, self.slot_pos[i]):
                req.done = True
                self.slot_req[i] = None
        return True

    def run(self, generator: torch.Generator | None = None) -> list[Request]:
        done: list[Request] = []
        seen: set[int] = set()
        all_reqs = list(self.queue)
        while self.queue or any(r is not None for r in self.slot_req):
            self.step(generator)
            for r in all_reqs:
                if r.done and r.uid not in seen:
                    seen.add(r.uid)
                    done.append(r)
        return done
