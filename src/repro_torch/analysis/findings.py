"""Shared types for the port's repro-lint rules: findings, parsed sources,
inline suppressions, and stable fingerprints for the baseline (the port's
copy of ``repro/analysis/findings.py``: the same fingerprints, marker and
path-derived rule domains, so a baseline entry means the same thing in
both packages)."""
from __future__ import annotations

import ast
import hashlib
from dataclasses import dataclass
from pathlib import Path
from collections.abc import Iterator

# inline suppression marker: on the flagged line or the line above,
#   # repro-lint: skip[<rule-id>] <justification>
# ("skip[*]" suppresses every rule on that line; a justification is
# expected by convention — the marker is grep-able either way)
SKIP_MARK = "repro-lint: skip["


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str                       # posix, repo-relative when possible
    line: int
    func: str                       # enclosing Class.method / "<module>"
    message: str

    def fingerprint(self) -> str:
        """Stable id for the suppression baseline: line numbers excluded so
        unrelated edits above a finding don't churn the baseline."""
        key = f"{self.rule}|{self.path}|{self.func}|{self.message}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}" + (
            f" (in {self.func})" if self.func != "<module>" else ""
        )


class SourceFile:
    """One parsed source file plus the path-derived rule domain."""

    def __init__(self, path: Path, display_path: str | None = None):
        self.path = path
        self.display = display_path or path.as_posix()
        self.text = path.read_text()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(path))
        parts = path.as_posix().split("/")
        if "serve" in parts:
            self.kind = "serve"
        elif "kernels" in parts:
            self.kind = "kernels"
        elif "obs" in parts:
            self.kind = "obs"
        else:
            self.kind = "other"

    def suppressed(self, finding: Finding) -> bool:
        """True when an inline ``repro-lint: skip[rule]`` marker covers the
        finding's line (same line or the line above)."""
        for ln in (finding.line, finding.line - 1):
            if 1 <= ln <= len(self.lines):
                text = self.lines[ln - 1]
                i = text.find(SKIP_MARK)
                if i < 0:
                    continue
                listed = text[i + len(SKIP_MARK):].split("]", 1)[0]
                rules = {r.strip() for r in listed.split(",")}
                if "*" in rules or finding.rule in rules:
                    return True
        return False

    def finding(self, rule: str, node: ast.AST, func: str,
                message: str) -> Finding:
        return Finding(rule=rule, path=self.display,
                       line=getattr(node, "lineno", 0),
                       func=func, message=message)


def iter_functions(
    tree: ast.Module,
) -> Iterator[tuple[str, str | None, ast.FunctionDef]]:
    """Yield (qualname, class_name, node) for module-level functions and
    class methods.  Nested defs/lambdas are treated as part of their
    enclosing function by the rules, so they are not yielded."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, None, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{sub.name}", node.name, sub


def decorator_tags(node: ast.FunctionDef) -> set[tuple[str, str | None]]:
    """Normalize decorators to (name, first-str-arg-or-None) tags, accepting
    bare names, attribute paths, and call forms."""
    tags: set[tuple[str, str | None]] = set()
    for dec in node.decorator_list:
        target, arg = dec, None
        if isinstance(dec, ast.Call):
            target = dec.func
            if dec.args and isinstance(dec.args[0], ast.Constant) \
                    and isinstance(dec.args[0].value, str):
                arg = dec.args[0].value
        if isinstance(target, ast.Attribute):
            tags.add((target.attr, arg))
        elif isinstance(target, ast.Name):
            tags.add((target.id, arg))
    return tags


def attr_root(node: ast.AST) -> str | None:
    """Name at the root of an attribute chain (``torch.cuda.x`` -> ``torch``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def call_name(node: ast.Call) -> str | None:
    """Bare callee name: ``x.y.foo(...)`` / ``foo(...)`` -> ``foo``."""
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None
