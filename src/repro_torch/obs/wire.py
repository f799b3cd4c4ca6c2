"""Telemetry snapshots as ``dist.collectives``-compatible wire trees (the
port of ``repro/obs/wire.py``).

A telemetry snapshot is nested plain-Python data (ints, floats, lists,
strings).  ``wire_snapshot`` lowers its numeric leaves to a same-shape tree
of float32 tensors, which the codecs (``compress_tree``/``decompress_tree``/
``wire_bytes``/``wire_pack``) take unchanged, so the cube processes ship
per-cube telemetry in the same wire format as page payloads.
``unwire_snapshot`` recovers plain floats and lists on the receiving side.

Non-numeric leaves (strings, None) are dropped at wire time: the wire
carries measurements, not configuration.
"""
from __future__ import annotations

from typing import Any

import torch


def _is_num_list(v: Any) -> bool:
    return isinstance(v, (list, tuple)) and all(
        isinstance(x, (int, float)) and not isinstance(x, bool) for x in v)


def wire_snapshot(snap: dict[str, Any]) -> dict[str, Any]:
    """Lower a snapshot's numeric leaves to a tree of float32 tensors."""
    out: dict[str, Any] = {}
    for k, v in snap.items():
        if isinstance(v, dict):
            sub = wire_snapshot(v)
            if sub:
                out[k] = sub
        elif isinstance(v, bool):
            out[k] = torch.tensor(float(v), dtype=torch.float32)
        elif isinstance(v, (int, float)):
            out[k] = torch.tensor(v, dtype=torch.float32)
        elif _is_num_list(v):
            out[k] = torch.tensor([float(x) for x in v], dtype=torch.float32)
        # anything else (strings, Nones) stays host-side
    return out


def unwire_snapshot(wired: dict[str, Any]) -> dict[str, Any]:
    """Recover plain Python floats and lists from a wire tree."""
    out: dict[str, Any] = {}
    for k, v in wired.items():
        if isinstance(v, dict):
            out[k] = unwire_snapshot(v)
        elif v.ndim == 0:
            out[k] = float(v)
        else:
            out[k] = [float(x) for x in v.tolist()]
    return out


__all__ = ["wire_snapshot", "unwire_snapshot"]
