"""no-device-work-under-lock: no device work lexically inside a lock block.

The port's counterpart of the reference's ``no-jax-under-lock``.  The
engine's bookkeeping lock serializes the decode loop against the admission
pipeline; a launch, a device-to-host read or a stream sync under it turns
a microsecond critical section into a device-length stall for the other
thread (a ``.cpu()`` or ``.item()`` waits for every kernel queued before
it).  The discipline (``serve/engine.py``: device work never runs inside
the lock) is *lexical*, as the reference's is: a helper that does device
work and is called under the lock is out of its sight.

Flags, inside any ``with <...>._lock/._cv/...*_lock:`` block in a
``serve`` module:

* calls rooted at ``torch.`` / ``F.`` (``torch.nn.functional``);
* the tensor methods that read the device back (``item``, ``tolist``,
  ``cpu``, ``numpy``, ``synchronize``) and a CUDA graph's ``replay``;
* the port's dispatch and copy entry points: the decode step
  (``_decode_impl``), the captured step objects' calls
  (``eng.decode_graph(...)``, ``eng.prefill_slots(...)``), and the page
  and state copies of ``serve/engine.py``, ``serve/paged_cache.py`` and
  ``serve/host_tier.py`` (``run_prefill``, ``stage_in``, ``write_prefill``,
  ``read_pages``, ``put_pages``, ...).
"""
from __future__ import annotations

import ast

from ..findings import Finding, SourceFile, attr_root, iter_functions

RULES = ["no-device-work-under-lock"]

_RULE = "no-device-work-under-lock"
_TORCH_ROOTS = {"torch", "F"}
# tensor methods that wait for the device (a read back or a sync)
_READBACK_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# the port's step objects and the methods that launch kernels or copy pages
_DISPATCH_ATTRS = {
    "_decode_impl", "decode_graph", "prefill_slots", "replay",
    "run_prefill", "stage_in", "swap_out_batch", "commit_many",
    "commit_swap_in", "write_prefill", "write_state", "swap_in", "swap_out",
    "gather_views", "absorb_decode", "read_pages", "put_pages",
    "import_pages", "export_pages", "fork_pages",
}
_DISPATCH_NAMES = {"gather_views", "absorb_decode", "read_pages",
                   "prefill_logits_token"}


def _is_lock_expr(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and (
        node.attr in ("_lock", "_cv") or node.attr.endswith("_lock")
    )


def _flag_calls(src: SourceFile, body, func: str) -> list[Finding]:
    out = []
    for stmt in body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute):
                root = attr_root(fn)
                if root in _TORCH_ROOTS:
                    out.append(src.finding(
                        _RULE, node, func,
                        f"torch call `{ast.unparse(fn)}(...)` lexically inside "
                        "a lock block — move device work outside the critical "
                        "section"))
                elif fn.attr in _READBACK_ATTRS:
                    out.append(src.finding(
                        _RULE, node, func,
                        f"device read-back `{ast.unparse(fn)}(...)` lexically "
                        "inside a lock block — it waits for the queued kernels "
                        "while holding the lock"))
                elif fn.attr in _DISPATCH_ATTRS:
                    out.append(src.finding(
                        _RULE, node, func,
                        f"device dispatch `{ast.unparse(fn)}(...)` lexically "
                        "inside a lock block"))
            elif isinstance(fn, ast.Name) and fn.id in _DISPATCH_NAMES:
                out.append(src.finding(
                    _RULE, node, func,
                    f"device dispatch `{fn.id}(...)` lexically inside a "
                    "lock block"))
    return out


def check(files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for src in files:
        if src.kind != "serve":
            continue
        for qual, _cls, fn in iter_functions(src.tree):
            for node in ast.walk(fn):
                if isinstance(node, ast.With) and any(
                    _is_lock_expr(item.context_expr) for item in node.items
                ):
                    findings.extend(_flag_calls(src, node.body, qual))
    return findings
