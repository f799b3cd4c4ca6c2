"""cube-boundary: the wire moves bytes, the engine moves pages.

The port's copy of ``repro/analysis/rules/cube_boundary.py``.  The
inter-cube transport (``serve/cube_proc.py``) frames and ships
messages between worker processes.  Everything device-owned — page pools,
block tables, decode-loop state — belongs to the engine on the OTHER side
of the ``migrate_put``/``migrate_signal`` API; a transport function that
reaches it has smuggled engine ownership across the process boundary.

Checks, over the ``@cube_transport`` taint closure (bare-callee-name
resolution, same conservative scheme as ``sole_writer``):

* ``transport-pools-call`` — transport-reachable code calling a
  ``@pool_mutator("pools")`` method;
* ``transport-decode-only-call`` — transport-reachable code calling a
  ``@decode_loop_only`` method (the decode loop is a per-process thread;
  the wire layer must hand off through the committed-migration queue, not
  call into it).

The runtime sanitizer enforces the same boundary dynamically
(``REPRO_SANITIZE=1``: per-thread transport depth; see
``analysis/sanitizer.py``) — this rule catches the violations no test
happens to execute.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

from ..findings import (
    Finding,
    SourceFile,
    call_name,
    decorator_tags,
    iter_functions,
)

RULES = [
    "cube-boundary/transport-pools-call",
    "cube-boundary/transport-decode-only-call",
]


@dataclass
class _Fn:
    qual: str
    node: ast.FunctionDef
    src: SourceFile
    transport: bool = False
    pools_mutator: bool = False
    decode_only: bool = False
    calls: list[tuple[str, ast.Call]] = field(default_factory=list)


def _collect(files: list[SourceFile]) -> dict[str, _Fn]:
    fns: dict[str, _Fn] = {}
    for src in files:
        if src.kind != "serve":
            continue
        for qual, _cls, node in iter_functions(src.tree):
            info = _Fn(qual=qual, node=node, src=src)
            for name, arg in decorator_tags(node):
                if name == "cube_transport":
                    info.transport = True
                elif name == "pool_mutator" and (arg or "pools") == "pools":
                    info.pools_mutator = True
                elif name == "decode_loop_only":
                    info.decode_only = True
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    callee = call_name(sub)
                    if callee:
                        info.calls.append((callee, sub))
            fns[f"{src.display}:{qual}"] = info
    return fns


def _transport_taint(fns: dict[str, _Fn]) -> set[str]:
    """Closure of functions reachable from ``@cube_transport`` roots.
    Does not traverse INTO pools mutators / decode-only functions — those
    edges are the violations, reported at the call site."""
    by_name: dict[str, list[_Fn]] = {}
    for info in fns.values():
        by_name.setdefault(info.node.name, []).append(info)
    roots = [i for i in fns.values() if i.transport]
    seen = {f"{r.src.display}:{r.qual}" for r in roots}
    work = list(roots)
    while work:
        info = work.pop()
        for callee, _node in info.calls:
            for target in by_name.get(callee, ()):
                if target.pools_mutator or target.decode_only:
                    continue
                key = f"{target.src.display}:{target.qual}"
                if key not in seen:
                    seen.add(key)
                    work.append(target)
    return seen


def check(files: list[SourceFile]) -> list[Finding]:
    fns = _collect(files)
    if not fns:
        return []
    tainted = _transport_taint(fns)
    pools_names = {i.node.name for i in fns.values() if i.pools_mutator}
    decode_only_names = {i.node.name for i in fns.values() if i.decode_only}

    findings: list[Finding] = []
    for key, info in fns.items():
        if key not in tainted:
            continue
        for callee, node in info.calls:
            if callee == info.node.name:
                continue
            if callee in pools_names:
                findings.append(info.src.finding(
                    "cube-boundary/transport-pools-call", node, info.qual,
                    f"pools mutator `{callee}` reachable from the "
                    "@cube_transport wire path — the transport moves bytes "
                    "between processes, never engine-owned pages"))
            if callee in decode_only_names:
                findings.append(info.src.finding(
                    "cube-boundary/transport-decode-only-call", node,
                    info.qual,
                    f"@decode_loop_only `{callee}` reachable from the "
                    "@cube_transport wire path — hand off through the "
                    "committed-migration queue instead"))
    return findings
