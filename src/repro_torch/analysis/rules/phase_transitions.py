"""phase-transitions: every ``<st>.phase = ...`` write must be a declared
edge written by its declared owner.

The port's copy of ``repro/analysis/rules/phase_transitions.py``, held
to the port's own tables.  The request lifecycle
(``repro_torch.analysis.phases``) is
``waiting -> admitting(prefill|restore) -> ready -> running`` with
preemption back to ``waiting`` and retirement to ``done``.  The same
tables drive the runtime check in ``RequestState.__setattr__`` under
``REPRO_SANITIZE=1``; this rule is the static half:

* ``non-literal`` — ``.phase`` assigned a non-string-literal expression
  (the state machine is only checkable when phases are literal);
* ``unknown-phase`` — a literal not in the declared phase set;
* ``undeclared-writer`` — a known phase written by a function that is not
  in ``PHASE_WRITERS[phase]``.

Writer declarations make the *edge* checkable statically: each writer
only ever performs declared transitions, so a new ``.phase = "running"``
in, say, the admission worker is flagged at lint time rather than at 2am
under load.
"""
from __future__ import annotations

import ast

from ..findings import Finding, SourceFile, iter_functions
from ..phases import PHASES, PHASE_WRITERS

RULES = [
    "phase-transitions/non-literal",
    "phase-transitions/unknown-phase",
    "phase-transitions/undeclared-writer",
]


def _phase_targets(stmt: ast.AST) -> list[ast.Attribute]:
    targets: list[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    out = []
    for t in targets:
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        out.extend(e for e in elts
                   if isinstance(e, ast.Attribute) and e.attr == "phase")
    return out


def check(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in files:
        if src.kind != "serve":
            continue
        for qual, _cls, fn in iter_functions(src.tree):
            if fn.name in ("__init__", "__setattr__"):
                continue
            for stmt in ast.walk(fn):
                for target in _phase_targets(stmt):
                    value = getattr(stmt, "value", None)
                    if not (isinstance(value, ast.Constant)
                            and isinstance(value.value, str)):
                        findings.append(src.finding(
                            "phase-transitions/non-literal", stmt, qual,
                            f"`{ast.unparse(target)}` assigned a non-literal "
                            "phase — transitions must be string literals so "
                            "the state machine is statically checkable"))
                        continue
                    phase = value.value
                    if phase not in PHASES:
                        findings.append(src.finding(
                            "phase-transitions/unknown-phase", stmt, qual,
                            f"unknown phase {phase!r} (declared: "
                            f"{sorted(PHASES)})"))
                    elif qual not in PHASE_WRITERS[phase]:
                        owners = ", ".join(sorted(PHASE_WRITERS[phase]))
                        findings.append(src.finding(
                            "phase-transitions/undeclared-writer", stmt, qual,
                            f"phase {phase!r} may only be written by "
                            f"{owners} (declared in repro_torch.analysis.phases), "
                            f"not {qual}"))
    return findings
