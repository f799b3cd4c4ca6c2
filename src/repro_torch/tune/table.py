"""Tuned-parameter table: the JSON cache of cutout-search winners, the port
of ``repro/tune/table.py``.

Ships in-repo as ``TUNED_kernels_torch.json`` (the reference's
``TUNED_kernels.json`` is its own).  Entries are keyed
``kernel|shape_class|backend`` where ``shape_class`` is the kernel's own
pure function of its arguments' shapes/dtypes (the same string the
reference builds for the same shapes) and ``backend`` the device type of
the call's tensors (``cuda`` or ``cpu``): the key a call site recomputes
must match the key ``--update`` wrote byte-for-byte.

Entry schema (``version`` 1)::

    {"params":     {<tunable param>: <winner value>, ...},
     "default_us": <median us of the declared defaults>,
     "winner_us":  <median us of the winner>,
     "ratio":      winner_us / default_us,       # <= 1.0 by construction
     "space_size": <configs enumerated>, "pruned": <killed by roofline>,
     "measured":   <configs timed>}

Reads are cached module-globally (one file read per process), and so are
the parameters each (kernel, shape class, backend, table) resolves to
(``memo``, filled by ``registry.resolve_tuned``).  ``REPRO_TORCH_TUNED_TABLE``
points lookups at an alternate table (tests use this; the reference's
``REPRO_TUNED_TABLE`` is its own); ``reload_table()`` drops both caches.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Any

TABLE_VERSION = 1
TABLE_PATH = pathlib.Path(__file__).resolve().parents[3] / "TUNED_kernels_torch.json"
ENV_VAR = "REPRO_TORCH_TUNED_TABLE"

_cache: dict[str, Any] | None = None
_cache_path: str | None = None
# (kernel, shape class, backend, table path) -> resolved params
memo: dict[tuple, dict] = {}
_DEFAULT_PATH = str(TABLE_PATH)


def active_path() -> str:
    """The table lookups read: ``$REPRO_TORCH_TUNED_TABLE`` or the committed one."""
    return os.environ.get(ENV_VAR) or _DEFAULT_PATH


def entry_key(kernel: str, shape_class: str, backend: str) -> str:
    return f"{kernel}|{shape_class}|{backend}"


def load_table(path: pathlib.Path | None = None) -> dict[str, Any]:
    """Parse a tuned table; missing file → empty table (everything falls
    back to defaults, the correct cold-start behavior)."""
    p = pathlib.Path(path or active_path())
    if not p.exists():
        return {"version": TABLE_VERSION, "env": {}, "entries": {}}
    data = json.loads(p.read_text())
    if data.get("version") != TABLE_VERSION:
        raise ValueError(
            f"tuned table {p} has version {data.get('version')!r}, "
            f"expected {TABLE_VERSION} — regenerate with "
            "`python -m repro_torch.tune --update`"
        )
    return data


def save_table(table: dict[str, Any], path: pathlib.Path | None = None) -> None:
    p = pathlib.Path(path or active_path())
    p.write_text(json.dumps(table, indent=2, sort_keys=True) + "\n")
    reload_table()


def reload_table() -> None:
    """Drop the process-level caches (tests and the tuner swap tables
    through ``REPRO_TORCH_TUNED_TABLE`` mid-process)."""
    global _cache, _cache_path
    _cache, _cache_path = None, None
    memo.clear()


def tuned_entry(kernel: str, shape_class: str, backend: str) -> dict | None:
    """The cached winner for (kernel, shape_class, backend), or ``None``
    when this shape class was never tuned (caller falls back to defaults)."""
    global _cache, _cache_path
    p = active_path()
    if _cache is None or _cache_path != p:
        _cache = load_table(pathlib.Path(p))
        _cache_path = p
    return _cache["entries"].get(entry_key(kernel, shape_class, backend))
