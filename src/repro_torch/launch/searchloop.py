"""Generic variant-search loop: the port of ``repro/launch/searchloop.py``,
which ``repro_torch.tune`` drives over kernel config spaces.

Free of import side effects; measurement policy lives in the callers.

The contract: iterate ``(name, payload)`` variants, call ``measure`` on
each, collect row dicts.  A variant that raises becomes an ``error`` row
instead of aborting the sweep (one broken config must not kill a search).
"""
from __future__ import annotations

import json
import os
from collections.abc import Callable, Iterable
from typing import Any


def search(
    variants: Iterable[tuple[str, Any]],
    measure: Callable[[str, Any], dict],
    *,
    render: Callable[[dict], str] | None = None,
    log: Callable[[str], None] | None = None,
    out_path: str | None = None,
) -> list[dict]:
    """Run ``measure(name, payload)`` per variant; return one row dict per
    variant (``measure``'s dict plus ``variant``; ``error`` on exception).

    ``render`` formats a success row for ``log``; ``out_path`` dumps the
    rows as JSON (parent directories created).
    """
    rows: list[dict] = []
    for name, payload in variants:
        try:
            row = dict(measure(name, payload))
            row["variant"] = name
            if log is not None:
                log(f"[{name:16s}] " + (render(row) if render else
                                        json.dumps(row, default=str)))
        except Exception as e:  # noqa: BLE001 — survey loop, record + continue
            if log is not None:
                log(f"[{name:16s}] FAILED: {type(e).__name__}: {str(e)[:200]}")
            row = {"variant": name, "error": str(e)[:500]}
        rows.append(row)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rows, f, indent=1)
    return rows
