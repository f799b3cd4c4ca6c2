"""sole-writer: the decode loop is the only pools/block-table writer.

The port's copy of ``repro/analysis/rules/sole_writer.py``.  Builds a
name-resolved call graph over the port's ``serve`` modules and checks the
ownership annotations (``repro_torch.analysis.ownership``):

* ``undeclared-mutation`` — direct mutation of ownership-protected state
  (``<x>.pools = ...``, ``<x>.block_tables[...] = ...``, free-list
  internals) in a function not declared ``@pool_mutator``;
* ``admission-writes-pools`` — a ``@pool_mutator("pools")`` method invoked
  from a function reachable from the admission pipeline's call graph
  (``@admission_api`` roots) — the pipeline must compute into private
  buffers only;
* ``admission-calls-decode-only`` — admission-reachable code calling a
  ``@decode_loop_only`` method;
* ``pipeline-pools-call`` — any ``AdmissionPipeline`` method naming a pools
  mutator at all (the pipeline is restricted to the staging/private-buffer
  API, whatever the call graph says);
* ``unowned-pools-call`` — a pools mutator invoked from a function that is
  neither decode-loop-owned nor itself a mutator nor reachable from a
  ``@decode_loop_only`` root.

Resolution is by bare callee name (conservative: a name shared by several
methods taints all of them), which is exactly right for a repo-local lint:
false sharing shows up as a finding to annotate, never as silence.
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
    "sole-writer/undeclared-mutation",
    "sole-writer/admission-writes-pools",
    "sole-writer/admission-calls-decode-only",
    "sole-writer/pipeline-pools-call",
    "sole-writer/unowned-pools-call",
]

_FREELIST_ATTRS = {"_free", "_free_set"}
_MUTATING_METHODS = {"append", "pop", "extend", "add", "remove", "discard",
                     "difference_update", "update", "clear", "insert"}


@dataclass
class _Fn:
    qual: str
    cls: str | None
    node: ast.FunctionDef
    src: SourceFile
    mutator_kind: str | None = None      # "pools" | "free_list" | None
    decode_only: bool = False
    admission: bool = False
    calls: list[tuple[str, ast.Call]] = field(default_factory=list)


def _collect(files: list[SourceFile]) -> dict[str, _Fn]:
    fns: dict[str, _Fn] = {}
    for src in files:
        if src.kind != "serve":
            continue
        for qual, cls, node in iter_functions(src.tree):
            info = _Fn(qual=qual, cls=cls, node=node, src=src)
            for name, arg in decorator_tags(node):
                if name == "pool_mutator":
                    info.mutator_kind = arg or "pools"
                elif name == "decode_loop_only":
                    info.decode_only = True
                elif name == "admission_api":
                    info.admission = True
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    callee = call_name(sub)
                    if callee:
                        info.calls.append((callee, sub))
            # later definitions shadow earlier ones only on exact qualname
            fns[f"{src.display}:{qual}"] = info
    return fns


def _is_protected_target(node: ast.AST) -> str | None:
    """Classify an assignment target as protected state, or None."""
    if isinstance(node, ast.Attribute) and node.attr == "pools":
        return "pools"
    if isinstance(node, ast.Attribute) and node.attr == "block_tables":
        return "block tables"
    if isinstance(node, ast.Subscript):
        v = node.value
        if isinstance(v, ast.Attribute) and v.attr == "block_tables":
            return "block tables"
        if isinstance(v, ast.Attribute) and v.attr in _FREELIST_ATTRS:
            return "free list"
    return None


def _undeclared_mutations(fns: dict[str, _Fn]) -> list[Finding]:
    out = []
    for info in fns.values():
        if info.mutator_kind is not None or info.node.name == "__init__":
            continue
        for sub in ast.walk(info.node):
            targets: list[ast.AST] = []
            if isinstance(sub, ast.Assign):
                targets = list(sub.targets)
            elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                targets = [sub.target]
            flat: list[ast.AST] = []
            for t in targets:
                flat.extend(t.elts if isinstance(t, ast.Tuple) else [t])
            for t in flat:
                what = _is_protected_target(t)
                if what:
                    out.append(info.src.finding(
                        "sole-writer/undeclared-mutation", sub, info.qual,
                        f"mutates {what} (`{ast.unparse(t)} = ...`) but is "
                        "not declared @pool_mutator"))
            if isinstance(sub, ast.Call) and isinstance(sub.func,
                                                        ast.Attribute):
                recv = sub.func.value
                if (sub.func.attr in _MUTATING_METHODS
                        and isinstance(recv, ast.Attribute)
                        and recv.attr in _FREELIST_ATTRS):
                    out.append(info.src.finding(
                        "sole-writer/undeclared-mutation", sub, info.qual,
                        f"mutates free list (`{ast.unparse(sub.func)}(...)`)"
                        " but is not declared @pool_mutator"))
    return out


def _taint(fns: dict[str, _Fn], roots: list[_Fn],
           stop_at_pools: bool) -> set[str]:
    """Closure of functions reachable from ``roots`` by callee name.
    Does not traverse into pools mutators / decode-only functions when
    ``stop_at_pools`` (those edges are the violations, reported separately).
    """
    by_name: dict[str, list[_Fn]] = {}
    for info in fns.values():
        by_name.setdefault(info.node.name, []).append(info)
    seen = {f"{r.src.display}:{r.qual}" for r in roots}
    work = list(roots)
    while work:
        info = work.pop()
        for callee, _node in info.calls:
            for target in by_name.get(callee, ()):
                if stop_at_pools and (target.mutator_kind == "pools"
                                      or target.decode_only):
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
    findings = _undeclared_mutations(fns)

    pools_names = {i.node.name for i in fns.values()
                   if i.mutator_kind == "pools"}
    decode_only_names = {i.node.name for i in fns.values() if i.decode_only}

    admission_roots = [i for i in fns.values() if i.admission]
    decode_roots = [i for i in fns.values() if i.decode_only]
    admission_tainted = _taint(fns, admission_roots, stop_at_pools=True)
    decode_tainted = _taint(fns, decode_roots, stop_at_pools=False)

    for key, info in fns.items():
        in_admission = key in admission_tainted
        for callee, node in info.calls:
            if callee in pools_names and callee != info.node.name:
                if in_admission:
                    findings.append(info.src.finding(
                        "sole-writer/admission-writes-pools", node, info.qual,
                        f"pools mutator `{callee}` reachable from the "
                        "admission pipeline (decode loop is the sole "
                        "pools/block-table writer)"))
                if info.cls == "AdmissionPipeline":
                    findings.append(info.src.finding(
                        "sole-writer/pipeline-pools-call", node, info.qual,
                        f"AdmissionPipeline calls pools mutator `{callee}` — "
                        "the pipeline is restricted to the staging/private-"
                        "buffer API"))
                if (not in_admission and key not in decode_tainted
                        and info.mutator_kind is None
                        and not info.decode_only):
                    findings.append(info.src.finding(
                        "sole-writer/unowned-pools-call", node, info.qual,
                        f"pools mutator `{callee}` called from a function "
                        "with no declared ownership (@decode_loop_only / "
                        "@pool_mutator) and unreachable from any decode-loop "
                        "root"))
            if (callee in decode_only_names and in_admission
                    and callee != info.node.name):
                findings.append(info.src.finding(
                    "sole-writer/admission-calls-decode-only", node,
                    info.qual,
                    f"@decode_loop_only `{callee}` reachable from the "
                    "admission pipeline"))
    return findings
