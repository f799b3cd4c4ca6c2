"""Deterministic synthetic data with a checkpointable cursor: the port of
``repro/data/pipeline.py``.

Token streams are counter-mode Philox (numpy), exactly as in the JAX
package, so batch ``i`` of a seed is the same array bit for bit on either
side.  ``SyntheticLMData`` hands each batch to an explicit device (the card
unless ``device="cpu"``) as int32 tensors; a background thread can build
batches ahead of the step (``start_prefetch`` / ``next_prefetched``).  The
cursor (seed, step) goes into the checkpoint, so restarts resume exactly.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve


def _hash_tokens(seed: int, step: int, shape: tuple[int, ...], vocab: int) -> np.ndarray:
    """Counter-mode Philox: reproducible batch at any step without history."""
    rng = np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, 0, step]))
    return rng.integers(0, vocab, size=shape, dtype=np.int32)


def _hash_normal(seed: int, step: int, shape: tuple[int, ...]) -> np.ndarray:
    rng = np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, 1, step]))
    return rng.standard_normal(size=shape, dtype=np.float32)


@dataclass
class PipelineState:
    seed: int
    step: int


class SyntheticLMData:
    """Next-token-prediction batches: targets are tokens shifted by one."""

    def __init__(self, cfg, batch: int, seq: int, seed: int = 0, device=None,
                 prefetch: int = 2):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.device = resolve(device)
        self.state = PipelineState(seed=seed, step=0)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- batch construction --------------------------------------------------

    def _make(self, step: int) -> dict:
        cfg = self.cfg
        toks = _hash_tokens(self.state.seed, step, (self.batch, self.seq + 1),
                            cfg.vocab_size)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if cfg.family == "vlm":
            batch["patches"] = _hash_normal(
                self.state.seed, step, (self.batch, cfg.vision.n_image_tokens, 1024))
        if cfg.family == "audio":
            batch["frames"] = _hash_normal(
                self.state.seed, step, (self.batch, cfg.encoder.n_ctx, cfg.d_model))
        return batch

    def _put(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    # -- iteration -------------------------------------------------------------

    def next(self) -> dict:
        b = self._put(self._make(self.state.step))
        self.state.step += 1
        return b

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    # -- background prefetch ---------------------------------------------------

    def start_prefetch(self):
        def work():
            step = self.state.step
            while not self._stop.is_set():
                try:
                    self._q.put(self._make(step), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def next_prefetched(self) -> dict:
        b = self._put(self._q.get())
        self.state.step += 1
        return b

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- checkpoint integration ----------------------------------------------

    def state_dict(self) -> dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: dict):
        self.state = PipelineState(**d)


class SyntheticImageData:
    """NHWC image batches + labels for the ConvNet examples (numpy, as in
    the JAX package)."""

    def __init__(self, px: int, channels: int, classes: int, batch: int, seed: int = 0):
        self.px, self.ch, self.classes, self.batch = px, channels, classes, batch
        self.state = PipelineState(seed=seed, step=0)
        # fixed per-class spatial templates (the learnable signal)
        trng = np.random.Generator(np.random.Philox(key=seed + 77))
        self.templates = (
            trng.standard_normal((classes, px, px, channels))
            + trng.standard_normal((classes, 1, 1, channels))   # channel bias
        ).astype(np.float32)

    def next(self) -> tuple[np.ndarray, np.ndarray]:
        s = self.state.step
        x = _hash_normal(self.state.seed, s, (self.batch, self.px, self.px, self.ch))
        y = _hash_tokens(self.state.seed, s, (self.batch,), self.classes)
        x = x + 1.2 * self.templates[y]
        self.state.step += 1
        return x.astype(np.float32), y.astype(np.int32)

    def state_dict(self):
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d):
        self.state = PipelineState(**d)
