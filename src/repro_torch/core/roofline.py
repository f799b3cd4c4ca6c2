"""The card's published peaks, for roofline bounds.

Only ``HardwareSpec`` and its ``H100`` instance of the reference's
``repro/core/roofline.py`` are ported: the tuner's prune and
``chip_smoke.py``'s kernel bounds read them.  The reference's HLO parsing
is not ported (the port produces no HLO).

The numbers are NVIDIA's H100 SXM data sheet (dense rates, no sparsity, at
the full 700 W power limit), not measurements.  The module imports nothing
of the package, so ``chip_smoke.py`` can load it on its own.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    """Per-card peaks of one accelerator."""

    name: str
    peak_flops: float               # dense bf16 tensor-core FLOP/s
    peak_flops_f32: float           # float32 FLOP/s outside the tensor cores
    hbm_bw: float                   # device-memory bytes/s
    hbm_bytes: float                # device-memory capacity


# NVIDIA H100 SXM data sheet
H100 = HardwareSpec(name="h100-sxm", peak_flops=989e12, peak_flops_f32=67e12,
                    hbm_bw=3.35e12, hbm_bytes=80e9)
