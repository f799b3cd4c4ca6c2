"""tune-lookup: tuned-table reads stay in the wrappers, off hot paths.

The port's ``repro_torch.tune`` resolves kernel parameters by reading a
JSON table (``tuned_entry`` / ``load_table`` in ``tune/table.py``,
``resolve_tuned`` in ``tune/registry.py``).  The ``@tunable`` wrappers of
``models/`` make that read once per shape class and keep the winner in a
memo; it is file I/O plus dict probes, so it must never run per event or
per launch:

* ``tune-lookup-in-hot-path`` — a lookup call inside a function carrying
  the ``@hot_path`` marker (``repro_torch.obs.trace.hot_path``).  The
  tracer's hot-path contract is "a handful of scalar stores"; a table probe
  there is allocation + I/O on the decode loop.  Resolve the parameters at
  engine/config construction and pass them in.
* ``tune-lookup-in-kernel`` — a lookup call inside any function of a
  ``kernels/`` module (the launch wrappers in ``kernels/ops.py``, their
  plain versions and the build helpers), which run on every launch, inside
  a captured CUDA graph's recording too.  Look up in the ``@tunable`` model
  function around the launch and pass the winners in as arguments.  (The
  reference confines this to Pallas ``*_kernel`` bodies; the port's kernels
  are CUDA sources, so the whole host side of a launch is the domain.)
"""
from __future__ import annotations

import ast

from ..findings import (
    Finding,
    SourceFile,
    call_name,
    decorator_tags,
    iter_functions,
)

RULES = [
    "tune-lookup-in-hot-path",
    "tune-lookup-in-kernel",
]

# the repro_torch.tune read API (keep in sync with tune/table.py + registry.py)
_LOOKUP_CALLS = {"tuned_entry", "resolve_tuned", "load_table"}


def _lookup_calls(fn: ast.FunctionDef):
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and call_name(node) in _LOOKUP_CALLS:
            yield node


def check(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in files:
        for qual, _cls, fn in iter_functions(src.tree):
            hot = ("hot_path", None) in decorator_tags(fn)
            if not (hot or src.kind == "kernels"):
                continue
            for node in _lookup_calls(fn):
                if hot:
                    findings.append(src.finding(
                        "tune-lookup-in-hot-path", node, qual,
                        f"tuned-table lookup `{call_name(node)}(...)` "
                        "inside a @hot_path function — table reads are "
                        "file I/O + dict probes, forbidden on the record "
                        "hot path; resolve at construction time"))
                else:
                    findings.append(src.finding(
                        "tune-lookup-in-kernel", node, qual,
                        f"tuned-table lookup `{call_name(node)}(...)` "
                        "in a kernels/ function, which runs on every launch "
                        "— look up in the @tunable wrapper around it and "
                        "pass the winner in"))
    return findings
