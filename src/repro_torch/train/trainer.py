"""Trainer: the fault-tolerant training loop, the port of
``repro/train/trainer.py``.

Composes the data pipeline (checkpointable cursor), the train step
(microbatched; its ``sgd``/``momentum`` updates run the ``stream_gd``
kernel), async checkpointing (atomic, step-versioned, the JAX package's
layout), straggler detection, and crash→restore→resume.  Parameters come
from ``model.init`` with a generator seeded from ``seed`` on every
(re)start, as JAX re-inits from the same key, or from an initial tree the
caller gives (``init_params``, e.g. JAX's weights through
``repro_torch.convert``), which is copied so the in-place updates never
touch it.  With ``ckpt_dir=None`` nothing is saved or restored (the
default: a full-width run would write ~18 GB per checkpoint).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.device import resolve
from repro_torch.dist.fault import FaultInjector, StragglerDetector
from repro_torch.models.common import tree_map
from repro_torch.optim.optimizer import Optimizer, get_optimizer
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.train_step import make_train_step


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 25
    keep: int = 3
    log_every: int = 10
    optimizer: str = "adamw"
    lr: float = 3e-4
    n_microbatches: int = 1
    max_restarts: int = 3


@dataclass
class TrainState:
    params: object
    opt_state: object
    step: int = 0
    losses: list = field(default_factory=list)
    step_s: list = field(default_factory=list)     # wall seconds of each step


class Trainer:
    def __init__(self, model, data, tcfg: TrainerConfig,
                 fault_injector: FaultInjector | None = None, device=None):
        self.model = model
        self.data = data
        self.tcfg = tcfg
        self.device = resolve(device)
        self.optimizer: Optimizer = get_optimizer(tcfg.optimizer, lr=tcfg.lr)
        self.step_fn = make_train_step(model, self.optimizer,
                                       n_microbatches=tcfg.n_microbatches)
        self.saver = (ckpt_lib.AsyncSaver(tcfg.ckpt_dir, keep=tcfg.keep)
                      if tcfg.ckpt_dir else None)
        self.fault = fault_injector
        self.detector = StragglerDetector(n_hosts=1)

    # -- state construction / restore ---------------------------------------

    def init_state(self, seed: int = 0, init_params=None) -> TrainState:
        if init_params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, self.device)
        else:
            params = tree_map(lambda t: t.detach().to(self.device, copy=True), init_params)
        opt_state = self.optimizer.init(params)
        latest = ckpt_lib.latest_step(self.tcfg.ckpt_dir) if self.tcfg.ckpt_dir else None
        if latest is not None:
            params, opt_state, extra, step = ckpt_lib.restore(
                self.tcfg.ckpt_dir, params, opt_state, device=self.device)
            if "data" in extra:
                self.data.load_state_dict(extra["data"])
            return TrainState(params, opt_state, step=step)
        return TrainState(params, opt_state, step=0)

    # -- the loop -------------------------------------------------------------

    def run(self, state: TrainState) -> TrainState:
        t = self.tcfg
        while state.step < t.total_steps:
            t0 = time.perf_counter()
            batch = self.data.next()
            if self.fault is not None:
                self.fault.maybe_fail(state.step)
            state.params, state.opt_state, metrics = self.step_fn(
                state.params, state.opt_state, batch)
            state.step += 1
            self.detector.report(0, state.step)
            loss = float(metrics["loss"])           # waits for the step
            state.losses.append(loss)
            state.step_s.append(time.perf_counter() - t0)
            if state.step % t.log_every == 0:
                print(f"step {state.step}: loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f}", flush=True)
            if self.saver is not None and (
                    state.step % t.ckpt_every == 0 or state.step == t.total_steps):
                self.saver.save(state.step, state.params, state.opt_state,
                                extra={"data": self.data.state_dict()})
        if self.saver is not None:
            self.saver.wait()
        return state

    def run_with_restarts(self, seed: int = 0, init_params=None) -> tuple[TrainState, int]:
        """Crash→restore→resume until total_steps reached."""
        restarts = 0
        while True:
            state = self.init_state(seed, init_params)
            try:
                return self.run(state), restarts
            except RuntimeError as e:
                print(f"[fault] {e}; restarting from latest checkpoint", flush=True)
                if self.saver is not None:
                    self.saver.wait()
                restarts += 1
                if restarts > self.tcfg.max_restarts:
                    raise
