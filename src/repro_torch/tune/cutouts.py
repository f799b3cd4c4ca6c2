"""Canonical cutouts: the concrete kernel invocations the committed
``TUNED_kernels_torch.json`` is tuned on, the port of
``repro/tune/cutouts.py`` (the same shapes and dtypes, drawn with numpy in
the same order, so each cutout's shape-class key is the reference's).

Each spec has a ``build`` (the canonical shape) and optionally a ``smoke``
(a tiny shape class tuned fresh in seconds —
``python -m repro_torch.tune --smoke``).  Importing this module imports the
model modules, which populates ``repro_torch.tune.REGISTRY`` as a side
effect of their ``@tunable`` decorators.
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import SSMConfig


class SsdBenchCfg:
    """Static cfg carrier for the SSD cutout (the reference's)."""

    ssm = SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=64)


class SsdSmokeCfg:
    ssm = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16)


@dataclass(frozen=True)
class CutoutSpec:
    kernel: str
    build: Callable[[np.random.Generator, torch.device], tuple]
    smoke: Callable[[np.random.Generator, torch.device], tuple] | None = None


def _f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device=device, dtype=torch.float32)


def _i32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device=device, dtype=torch.int32)


def _flash_build(rng: np.random.Generator, device) -> tuple:
    # prefill-shaped self-attention
    b, s, h, d = 1, 512, 8, 64
    q = _f32(rng.normal(size=(b, s, h, d)), device)
    return (q, q, q)


def _paged_build(rng: np.random.Generator, device) -> tuple:
    n_pages, ps, hkv, lanes, p, h, d = 128, 16, 2, 8, 16, 8, 64
    kpool = _f32(rng.normal(size=(n_pages, ps, hkv, d)), device)
    vpool = _f32(rng.normal(size=(n_pages, ps, hkv, d)), device)
    bt = _i32(rng.permutation(n_pages)[: lanes * p].reshape(lanes, p), device)
    pos = _i32(rng.integers(1, p * ps - 1, size=(lanes,)), device)
    qd = _f32(rng.normal(size=(lanes, 1, h, d)), device)
    return (qd, kpool, vpool, bt, pos)


def _ssd_args(rng: np.random.Generator, device, cfg, hs: int, ps_: int, ns: int,
              ss: int) -> tuple:
    xh = _f32(rng.normal(size=(1, ss, hs, ps_)), device)
    bb = _f32(rng.normal(size=(1, ss, ns)), device)
    cc = _f32(rng.normal(size=(1, ss, ns)), device)
    dt = _f32(rng.normal(size=(1, ss, hs)), device)
    a_log = _f32(rng.normal(size=(hs,)), device)
    d_skip = _f32(rng.normal(size=(hs,)), device)
    return (cfg, xh, bb, cc, dt, a_log, d_skip)


def _ssd_build(rng: np.random.Generator, device) -> tuple:
    return _ssd_args(rng, device, SsdBenchCfg, hs=8, ps_=64, ns=64, ss=256)


def _ssd_smoke(rng: np.random.Generator, device) -> tuple:
    return _ssd_args(rng, device, SsdSmokeCfg, hs=2, ps_=16, ns=16, ss=64)


def _moe_build(rng: np.random.Generator, device) -> tuple:
    # the dispatched capacity slabs of the reference's MoE bench shape
    # (g, t, e, c, d, f) = (1, 512, 8, 128, 128, 256); w_up=None: a
    # gate-only expert FFN
    g, e, c, d, f = 1, 8, 128, 128, 256
    xe = _f32(rng.normal(size=(g, e, c, d)), device)
    wg = _f32(rng.normal(size=(e, d, f)) * d ** -0.5, device)
    wd = _f32(rng.normal(size=(e, f, d)) * f ** -0.5, device)
    return (xe, wg, None, wd)


CUTOUTS: dict[str, CutoutSpec] = {
    "attn.flash_xla": CutoutSpec("attn.flash_xla", _flash_build),
    "attn.paged_decode": CutoutSpec("attn.paged_decode", _paged_build),
    "ssd.chunked": CutoutSpec("ssd.chunked", _ssd_build, smoke=_ssd_smoke),
    "moe.dispatch": CutoutSpec("moe.dispatch", _moe_build),
}


def build(name: str, seed: int = 0, smoke: bool = False, *, device) -> tuple:
    """Concrete args for a canonical cutout on ``device`` (fresh rng per
    call — builders stay deterministic in ``seed`` for cross-process key
    stability)."""
    spec = CUTOUTS[name]
    fn = spec.smoke if smoke else spec.build
    if fn is None:
        raise KeyError(f"{name} has no smoke cutout")
    return fn(np.random.default_rng(seed), torch.device(device))


# populate REGISTRY: the @tunable decorators run at import of the model
# modules (kept at the bottom — the builders above must not depend on them)
from repro_torch.models import attention as _attn  # noqa: E402,F401
from repro_torch.models import moe as _moe         # noqa: E402,F401
from repro_torch.models import ssm as _ssm         # noqa: E402,F401
