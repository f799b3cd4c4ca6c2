"""obs-hot-path: tracer record functions must not allocate or take locks.

The port's copy of ``repro/analysis/rules/obs_hot_path.py``.  The port's
tracer (``repro_torch.obs``) records an event from the decode loop or the
admission worker in a handful of scalar stores — no allocation (GC
pressure and allocator locks), no lock acquisition (a tracer that blocks
the decode loop perturbs the very timings it records), no torch.
Functions carrying the ``@hot_path`` marker
(``repro_torch.obs.trace.hot_path``) declare themselves part of that
contract; this rule is the static check that keeps them honest.

Flags, inside any ``@hot_path`` function in an ``obs`` module:

* ``with`` blocks (context managers are how locks are taken here);
* list/set/dict displays and comprehensions, and f-strings — each builds
  a fresh object per event;
* calls to known allocators (``dict``, ``list``, ``sorted``, ``str``,
  ``format``, ``copy``/``deepcopy``, ``append``/``extend``/``join``/
  ``split``, ...) and to lock/thread primitives (``acquire``, ``wait``,
  ``notify``, ``join``, ...).

Cold-path helpers (schema registration, export, ``instant_named``) simply
don't carry the marker.
"""
from __future__ import annotations

import ast

from ..findings import Finding, SourceFile, call_name, decorator_tags

RULES = ["obs-hot-path"]

_RULE = "obs-hot-path"

# callables that allocate a fresh container/string per call
_ALLOC_CALLS = {
    "dict", "list", "set", "tuple", "frozenset", "sorted", "reversed",
    "str", "bytes", "bytearray", "format", "repr",
    "copy", "deepcopy",
    "append", "extend", "insert", "join", "split", "splitlines", "update",
}
# lock / thread-coordination primitives
_LOCK_CALLS = {"acquire", "release", "wait", "wait_for", "notify",
               "notify_all", "join", "Lock", "RLock", "Condition"}


def _flag(src: SourceFile, fn: ast.FunctionDef, qual: str) -> list[Finding]:
    out: list[Finding] = []
    for stmt in fn.body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                out.append(src.finding(
                    _RULE, node, qual,
                    "`with` block inside a @hot_path record function — "
                    "lock acquisition (or any context manager) is "
                    "forbidden on the tracer hot path"))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                out.append(src.finding(
                    _RULE, node, qual,
                    "comprehension inside a @hot_path record function "
                    "allocates per event"))
            elif isinstance(node, (ast.List, ast.Set, ast.Dict)):
                out.append(src.finding(
                    _RULE, node, qual,
                    "container display inside a @hot_path record function "
                    "allocates per event"))
            elif isinstance(node, ast.JoinedStr):
                out.append(src.finding(
                    _RULE, node, qual,
                    "f-string inside a @hot_path record function builds a "
                    "fresh str per event"))
            elif isinstance(node, ast.Call):
                name = call_name(node)
                if name in _LOCK_CALLS:
                    out.append(src.finding(
                        _RULE, node, qual,
                        f"lock/thread call `{name}(...)` inside a "
                        "@hot_path record function"))
                elif name in _ALLOC_CALLS:
                    out.append(src.finding(
                        _RULE, node, qual,
                        f"allocating call `{name}(...)` inside a "
                        "@hot_path record function"))
    return out


def check(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in files:
        if src.kind != "obs":
            continue
        for qual, _cls, fn in iter_hot_functions(src):
            findings.extend(_flag(src, fn, qual))
    return findings


def iter_hot_functions(src: SourceFile):
    from ..findings import iter_functions

    for qual, cls, fn in iter_functions(src.tree):
        if ("hot_path", None) in decorator_tags(fn):
            yield qual, cls, fn
