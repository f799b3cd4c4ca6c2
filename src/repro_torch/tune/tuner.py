"""Cutout search: enumerate → roofline-prune → measure → cache winner, the
port of ``repro/tune/tuner.py``.

The prune is analytic and machine-independent: each config's cost model
yields (flops, bytes); its roofline bound on the card
(``core.roofline.H100``) is ``max(flops/peak_flops, bytes/hbm_bw)``; a
config whose bound exceeds ``slack ×`` the best bound in the space cannot
win even if it executes at the roofline, so it is never timed.  The
declared default config is always measured regardless (the tuned-vs-default
ratio needs both legs), and a kernel without a cost model measures its
whole (small) space.

Survivors are timed through ``launch.searchloop.search``, each config
called with its parameters bound explicitly (no table lookup on the
measurement path): the median wall time per call, the first call (which
builds the kernels) excluded, each call on the card ending in
``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import itertools
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.roofline import H100
from repro_torch.launch.searchloop import search

from .registry import REGISTRY, TunableKernel, backend_of

# prune slack: the cost models are deliberately crude (they rank, they
# don't predict), so a config keeps its measurement slot unless its bound
# is >3x the best bound in the space
DEFAULT_SLACK = 3.0


def med_time_us(fn, *args, iters: int = 20) -> float:
    """Median per-call wall time in us (the first call excluded): the
    cached winners feed ratios, so one descheduled call must not crown the
    wrong config.  On the card each call ends in a synchronize."""
    sync = torch.cuda.synchronize if backend_of(args) == "cuda" else (lambda: None)
    fn(*args)
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def enumerate_space(space: dict[str, tuple]) -> list[dict[str, Any]]:
    """Cartesian product of the config space, stable order."""
    names = sorted(space)
    return [dict(zip(names, combo))
            for combo in itertools.product(*(space[n] for n in names))]


def roofline_bound(flops: float, bytes_: float, hw=H100) -> float:
    return max(flops / hw.peak_flops, bytes_ / hw.hbm_bw)


def prune_configs(
    kern: TunableKernel,
    configs: list[dict],
    args: tuple,
    slack: float = DEFAULT_SLACK,
) -> tuple[list[dict], int]:
    """(surviving configs, number pruned).  Invalid (shape, config)
    combinations are dropped first and not counted as roofline prunes;
    the default config always survives."""
    valid = [c for c in configs
             if kern.validate is None or kern.validate(c, *args)]
    if kern.cost_model is None:
        return valid, 0
    bounds = [roofline_bound(*kern.cost_model(c, *args)) for c in valid]
    best = min(bounds)
    kept = [c for c, b in zip(valid, bounds)
            if b <= slack * best or c == kern.defaults]
    return kept, len(valid) - len(kept)


def _label(params: dict, defaults: dict) -> str:
    if params == defaults:
        return "default"
    return ",".join(f"{k}={v}" for k, v in sorted(params.items()))


def tune_kernel(
    name: str,
    args: tuple,
    *,
    iters: int = 20,
    slack: float = DEFAULT_SLACK,
    log=None,
) -> dict:
    """Tune one kernel on one concrete cutout; returns the table entry.

    ``args`` are the kernel's concrete positional inputs (from
    ``cutouts.build`` or ``registry.materialize`` of a captured cutout),
    on the device the entry is for.
    """
    kern = REGISTRY[name]
    configs = enumerate_space(kern.space)
    space_size = len(configs)
    if kern.defaults not in configs:
        configs.append(dict(kern.defaults))
    kept, pruned = prune_configs(kern, configs, args, slack=slack)

    def measure(_label_: str, params: dict) -> dict:
        with torch.no_grad():
            us = med_time_us(lambda *a: kern.fn(*a, **params), *args, iters=iters)
        return {"us": us, "params": params}

    rows = search(
        [(_label(c, kern.defaults), c) for c in kept], measure,
        render=lambda row: f"{row['us']:10.1f}us", log=log,
    )
    timed = [r for r in rows if "us" in r]
    if not timed:
        raise RuntimeError(f"{name}: every config failed to measure")
    default_row = next(
        (r for r in timed if r["params"] == kern.defaults), None)
    if default_row is None:
        raise RuntimeError(f"{name}: default config failed to measure")
    winner = min(timed, key=lambda r: r["us"])
    return {
        "params": winner["params"],
        "default_us": round(default_row["us"], 1),
        "winner_us": round(winner["us"], 1),
        "ratio": round(winner["us"] / default_row["us"], 4),
        "space_size": space_size,
        "pruned": pruned,
        "measured": len(timed),
    }
