"""The port's repro-lint command line: ``python -m repro_torch.analysis.lint [paths...]``.

Runs the port's rule families (``analysis/rules``: device work under a
lock, sole writer, phase transitions, capture safety, the tracer's hot
path, tuned-table lookups, the cube boundary) over the given
files/directories (default: the ``repro_torch`` package directory) and
reports findings not covered by an inline ``# repro-lint: skip[rule] why``
marker or the committed baseline.  Standard library only: it imports
neither torch nor the modules it reads.

Exit codes: 0 = clean, 1 = findings, 2 = usage/parse error.

The baseline (``src/repro_torch/analysis/baseline.json``) holds
fingerprints of accepted findings — line-number-free hashes, so edits
above a finding don't churn it.  It is committed (empty on a clean tree)
and refreshed with ``--update-baseline``; a test runs the linter with the
committed file, so a new violation fails while a justified legacy one
doesn't.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .findings import Finding, SourceFile
from .rules import ALL_RULE_IDS, ALL_RULE_MODULES

DEFAULT_BASELINE = Path(__file__).parent / "baseline.json"
_SKIP_DIRS = {"__pycache__", ".git", "analysis_fixtures"}


def _iter_py(paths: list[Path]):
    for p in paths:
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not _SKIP_DIRS & set(f.parts):
                    yield f
        elif p.suffix == ".py":
            yield p


def _display(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root).as_posix()
    except ValueError:
        return path.as_posix()


def load_files(paths: list[Path], root: Path | None = None
               ) -> tuple[list[SourceFile], list[str]]:
    root = (root or Path.cwd()).resolve()
    files, errors = [], []
    for f in _iter_py(paths):
        try:
            files.append(SourceFile(f, display_path=_display(f, root)))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(f"{f}: {e}")
    return files, errors


def run_rules(files: list[SourceFile]) -> list[Finding]:
    """All findings surviving inline suppression, sorted and deduplicated."""
    by_display = {src.display: src for src in files}
    seen: set[Finding] = set()
    out: list[Finding] = []
    for mod in ALL_RULE_MODULES:
        for finding in mod.check(files):
            src = by_display.get(finding.path)
            if finding in seen or (src and src.suppressed(finding)):
                continue
            seen.add(finding)
            out.append(finding)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def load_baseline(path: Path) -> set[str]:
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return {entry["fingerprint"] for entry in data.get("suppressions", [])}


def write_baseline(path: Path, findings: list[Finding]) -> None:
    data = {
        "version": 1,
        "comment": "accepted repro-lint findings of the port; refresh with "
                   "`python -m repro_torch.analysis.lint --update-baseline`",
        "suppressions": [
            {"fingerprint": f.fingerprint(), "rule": f.rule,
             "path": f.path, "func": f.func, "message": f.message}
            for f in findings
        ],
    }
    path.write_text(json.dumps(data, indent=2) + "\n")


def lint_paths(paths: list[Path], baseline: Path | None = DEFAULT_BASELINE,
               root: Path | None = None) -> tuple[list[Finding], list[str]]:
    """Library entry point (used by tests): returns (new findings, errors)."""
    files, errors = load_files(paths, root=root)
    findings = run_rules(files)
    known = load_baseline(baseline) if baseline else set()
    return [f for f in findings if f.fingerprint() not in known], errors


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's concurrency/ownership/capture-safety lint")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files or directories (default: the repro_torch package)")
    parser.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE)
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding, ignoring the baseline")
    parser.add_argument("--update-baseline", action="store_true",
                        help="accept current findings into the baseline")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rid in ALL_RULE_IDS:
            print(rid)
        return 0

    # default: the package this module lives in (…/src/repro_torch)
    paths = ([Path(p) for p in args.paths] if args.paths
             else [Path(__file__).resolve().parents[1]])

    files, errors = load_files(paths)
    for err in errors:
        print(f"error: {err}", file=sys.stderr)
    findings = run_rules(files)

    if args.update_baseline:
        write_baseline(args.baseline, findings)
        print(f"baseline: wrote {len(findings)} suppression(s) to "
              f"{args.baseline}")
        return 0

    known = set() if args.no_baseline else load_baseline(args.baseline)
    new = [f for f in findings if f.fingerprint() not in known]

    if args.format == "json":
        print(json.dumps([{
            "rule": f.rule, "path": f.path, "line": f.line,
            "func": f.func, "message": f.message,
            "fingerprint": f.fingerprint(),
        } for f in new], indent=2))
    else:
        for f in new:
            print(f.render())
        baselined = len(findings) - len(new)
        tail = f" ({baselined} baselined)" if baselined else ""
        print(f"repro-lint: {len(new)} finding(s) in {len(files)} "
              f"file(s){tail}")
    if errors:
        return 2
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
