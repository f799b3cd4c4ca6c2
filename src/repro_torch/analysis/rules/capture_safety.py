"""capture-safety: a step recorded into a CUDA graph reads nothing back.

The port's counterpart of the reference's ``pallas-trace-safety``.  The card
records the decode step, the chunked-prefill step and the training step into
CUDA graphs once and replays them (``serve/captured.py``,
``train/captured.py``).  Inside the recording every tensor is a device value
the host does not have: a read of it (``.item()``, ``.cpu()``, ``nonzero``,
a Python ``if`` or ``int()`` on it) either fails the capture or, where the
read happens to work, bakes the value it saw into every replay, the way a
Python branch on a tracer bakes one branch into a compiled kernel.  The
sanctioned forms are ``torch.where``, masks and device-side offsets, and
branches on static facts: shapes, dtypes, the device, config flags and
identity tests.

The capture sites call an attribute (``self._step(...)``), so, unlike a
``pallas_call`` site, they do not name the body.  The bodies carry the
``@captured_step`` marker (``repro_torch.analysis.ownership``) instead:
``ServeEngine._decode_impl``, ``DecoderLM.extend_step`` and
``TrainStep.__call__``.  The rule takes their call closure by bare callee
name (as ``sole_writer``: a name shared by several functions takes all of
them), through the modules a step can reach: ``models/``, ``configs/`` (the
config's properties), ``kernels/ops.py``, ``serve/captured.py``,
``serve/paged_cache.py`` (the gather path's ``gather_views``/
``absorb_decode``), ``train/train_step.py``, ``train/captured.py``,
``optim/optimizer.py`` and the tuned-table lookup (``tune/registry.py``,
``tune/table.py``).  It never follows ``kernels/ref.py``: the kernels' plain
versions run only for CPU tensors, never under capture.  Besides calls, a
function named as a value (a callback), a property read as an attribute and
a reached function's decorators (``@tunable``'s wrapper runs at every call)
are in the closure, and so is a function in which a def named by an
attribute call is nested (an optimizer's ``update``, handed out in a record).

Taint works as in ``pallas_trace._analyze``: it is seeded from the roots'
tensor parameters (positional, without a default, not annotated with a
non-tensor type) and, in a callee, from the parameters that receive a
tainted argument; it flows through assignments.  Static metadata blocks it:
``.shape``, ``.dtype``, ``.ndim``, ``.device``, ``.is_cuda``, the metadata
methods (``size()``, ``dim()``, ``numel()``, ``stride()``, ``data_ptr()``,
...), ``len()``, and ``is`` / ``is not`` and ``isinstance`` tests (e.g.
``isinstance(position, torch.Tensor)`` in ``extend_step``).

* ``graph-host-read`` — ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.to("cpu")``, ``nonzero`` / ``argwhere`` / one-argument
  ``torch.where``, ``masked_select``, ``torch.equal`` or a ``synchronize``
  anywhere in the closure, tainted or not (the static twin of ``HOST_READS``
  in ``tests/test_torch_decode_graph.py``);
* ``graph-tensor-branch`` — ``if`` / ``while`` / a conditional expression
  on a tainted value;
* ``graph-tensor-cast`` — ``int()`` / ``float()`` / ``bool()`` on a tainted
  value;
* ``graph-tensor-loop`` — a Python ``for`` over a tainted value (``range``
  of a tensor reads it back; iterating one unrolls a launch per row into
  the graph).  Walking a tree of tensors (``.items()``, ``.keys()``,
  ``.values()`` or a generator of the followed modules, such as
  ``tree_items`` or ``DecoderLM._layers``) walks its static structure and
  is not flagged.

``pallas-shape-loop`` has no counterpart: a graph is recorded per static
shape (one per engine for the decode step, one per prefill slot for the
extend), so a loop whose extent comes from a shape costs nothing at replay.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

from ..findings import (
    Finding,
    SourceFile,
    attr_root,
    call_name,
    decorator_tags,
    iter_functions,
)

RULES = [
    "graph-host-read",
    "graph-tensor-branch",
    "graph-tensor-cast",
    "graph-tensor-loop",
]

_MARKER = "captured_step"
_FOLLOWED_DIRS = {"models", "configs"}
_FOLLOWED_FILES = {"kernels/ops.py", "serve/captured.py", "serve/paged_cache.py",
                   "train/train_step.py", "train/captured.py", "optim/optimizer.py",
                   "tune/registry.py", "tune/table.py"}
_NEVER = {"kernels/ref.py"}
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda"}
_STATIC_CALLS = {"size", "dim", "numel", "stride", "data_ptr", "is_contiguous",
                 "element_size", "storage_offset", "len", "isinstance"}
_CASTS = {"float", "int", "bool"}
_HOST_READ_ATTRS = {"item", "tolist", "cpu", "numpy", "nonzero", "argwhere",
                    "masked_select", "equal", "synchronize"}
_TREE_WALKS = {"items", "keys", "values"}
# builtins a loop unwraps to the sequences they walk
_SEQUENCE_WRAPPERS = {"enumerate", "zip", "reversed", "sorted"}
# calls rooted here are the libraries', never a followed function of the same name
_LIBRARY_ROOTS = {"torch", "F", "nn", "np", "math"}
_NON_TENSOR_TYPES = {"int", "float", "bool", "str", "bytes", "None"}


@dataclass(eq=False)
class _Fn:
    qual: str
    node: ast.FunctionDef
    src: SourceFile
    method: bool
    seeds: set[str] = field(default_factory=set)

    @property
    def key(self) -> tuple[str, str]:
        return self.src.display, self.qual


def _rel(src: SourceFile) -> str:
    return "/".join(src.path.as_posix().split("/")[-2:])


def _followed(src: SourceFile) -> bool:
    if _rel(src) in _NEVER:
        return False
    return (bool(_FOLLOWED_DIRS & set(src.path.parts[:-1]))
            or _rel(src) in _FOLLOWED_FILES)


def _positional(fn: ast.FunctionDef) -> list[ast.arg]:
    return fn.args.posonlyargs + fn.args.args


def _root_seeds(info: _Fn) -> set[str]:
    """A root's tensor parameters: positional, without a default, and not
    annotated with a non-tensor type only (``int | torch.Tensor`` counts)."""
    args = _positional(info.node)
    n_plain = len(args) - len(info.node.args.defaults)
    out = set()
    for i, a in enumerate(args[:n_plain]):
        if i == 0 and info.method:
            continue
        ann = a.annotation
        names = ({n.id for n in ast.walk(ann) if isinstance(n, ast.Name)}
                 | {n.attr for n in ast.walk(ann) if isinstance(n, ast.Attribute)}
                 | {str(n.value) for n in ast.walk(ann) if isinstance(n, ast.Constant)}
                 if ann is not None else set())
        if ann is None or "Tensor" in names or not names <= _NON_TENSOR_TYPES:
            out.add(a.arg)
    return out


def _assigned(stmt: ast.AST) -> tuple[list[ast.AST], ast.AST | None]:
    if isinstance(stmt, ast.Assign):
        return list(stmt.targets), stmt.value
    if isinstance(stmt, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr)):
        return [stmt.target], stmt.value
    return [], None


def _target_names(t: ast.AST):
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _target_names(e)
    elif isinstance(t, ast.Starred):
        yield from _target_names(t.value)


def _nested_defs(node: ast.FunctionDef):
    for sub in ast.walk(node):
        if sub is not node and isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield sub


def _collect(files: list[SourceFile]) -> tuple[list[_Fn], dict[str, list[_Fn]],
                                                dict[str, list[tuple[_Fn, ast.FunctionDef]]]]:
    """(roots, followed functions by bare name, functions nested in followed
    functions by bare name with the function they are nested in)."""
    roots: list[_Fn] = []
    by_name: dict[str, list[_Fn]] = {}
    nested: dict[str, list[tuple[_Fn, ast.FunctionDef]]] = {}
    for src in files:
        followed = _followed(src)
        for qual, cls, node in iter_functions(src.tree):
            tags = {name for name, _ in decorator_tags(node)}
            info = _Fn(qual=qual, node=node, src=src,
                       method=cls is not None and "staticmethod" not in tags)
            if _MARKER in tags and _rel(src) not in _NEVER:
                info.seeds = _root_seeds(info)
                roots.append(info)
            if followed:
                by_name.setdefault(node.name, []).append(info)
                for sub in _nested_defs(node):
                    nested.setdefault(sub.name, []).append((info, sub))
    return roots, by_name, nested


class _Closure:
    """The roots' closure and its taint, to a fixpoint: the functions
    reached, the seeds each receives, and the functions whose return value
    is tainted (a call's result is tainted when a function of its name
    returns a tainted value, or, for a call that names no followed
    function, when any argument or the receiver is tainted)."""

    def __init__(self, files: list[SourceFile]):
        roots, self.by_name, self.nested = _collect(files)
        self.generators = {name for name, fns in self.by_name.items()
                           if any(isinstance(n, (ast.Yield, ast.YieldFrom))
                                  for f in fns for n in ast.walk(f.node))}
        self.returns: set[tuple[str, str]] = set()
        self.reached = {r.key: r for r in roots}
        changed = True
        while changed:
            changed = False
            for info in list(self.reached.values()):
                changed |= self._visit(info)

    def _targets(self, func: ast.AST) -> list[_Fn]:
        if isinstance(func, ast.Attribute):
            if attr_root(func) in _LIBRARY_ROOTS:
                return []
            return self.by_name.get(func.attr, [])
        if isinstance(func, ast.Name):
            # a bare name is a module-level function, never a method
            return [t for t in self.by_name.get(func.id, ()) if not t.method]
        return []

    def _visit(self, info: _Fn) -> bool:
        names = self.local_taint(info)
        changed = False
        called: set[int] = set()
        # a decorator's wrapper runs at every call (``@tunable``'s lookup)
        decorators = [d.func if isinstance(d, ast.Call) else d for d in info.node.decorator_list]
        for target in (t for d in decorators for t in self._targets(d)):
            if target.key not in self.reached:
                self.reached[target.key] = target
                changed = True
        for sub in ast.walk(info.node):
            refs: list[tuple[_Fn, set[str]]] = []
            if isinstance(sub, ast.Call):
                called.add(id(sub.func))
                refs = [(t, self._bind(sub, t, names)) for t in self._targets(sub.func)]
                if isinstance(sub.func, ast.Attribute) \
                        and attr_root(sub.func) not in _LIBRARY_ROOTS:
                    # a def nested in a followed function and handed out in a
                    # record (an optimizer's ``update``): its enclosing function
                    # is reached, with the def's parameters that receive a
                    # tainted argument
                    refs += [(t, self._bind(sub, t, names, entry))
                             for t, entry in self.nested.get(sub.func.attr, ())]
            elif isinstance(sub, (ast.Name, ast.Attribute)) \
                    and isinstance(sub.ctx, ast.Load) and id(sub) not in called:
                # a callback named as a value, a property read as an attribute
                refs = [(t, set()) for t in self._targets(sub)]
            for target, seeds in refs:
                if target.key not in self.reached:
                    self.reached[target.key] = target
                    changed = True
                if not seeds <= target.seeds:
                    target.seeds |= seeds
                    changed = True
        if info.key not in self.returns and any(
                isinstance(n, (ast.Return, ast.Yield, ast.YieldFrom)) and n.value is not None
                and self.tainted(n.value, names) for n in ast.walk(info.node)):
            self.returns.add(info.key)
            changed = True
        return changed

    def _bind(self, call: ast.Call, target: _Fn, names: set[str],
              entry: ast.FunctionDef | None = None) -> set[str]:
        """The target's parameters that receive a tainted argument at ``call``
        (``entry``: the def nested in the target that the call enters)."""
        node = entry or target.node
        params = [a.arg for a in _positional(node)]
        if entry is None and target.method and isinstance(call.func, ast.Attribute):
            params = params[1:]
        named = set(params) | {a.arg for a in node.args.kwonlyargs}
        out: set[str] = set()
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                if self.tainted(arg.value, names):
                    out |= set(params[i:])
                break
            if i < len(params) and self.tainted(arg, names):
                out.add(params[i])
        for kw in call.keywords:
            if not self.tainted(kw.value, names):
                continue
            if kw.arg is None:
                out |= named
            elif kw.arg in named:
                out.add(kw.arg)
        return out

    def local_taint(self, info: _Fn) -> set[str]:
        """Names tainted anywhere in the function (flow-insensitive: an
        assignment from a tainted value taints its target names)."""
        names = set(info.seeds)
        assigns = [_assigned(n) for n in ast.walk(info.node)]
        assigns = [(ts, v) for ts, v in assigns if ts and v is not None]
        changed = True
        while changed:
            changed = False
            for targets, value in assigns:
                if self.tainted(value, names):
                    new = {n for t in targets for n in _target_names(t)} - names
                    names |= new
                    changed |= bool(new)
        return names

    def tainted(self, expr: ast.AST, names: set[str]) -> bool:
        """True if the expression's value depends on a tainted name.  Static
        metadata (``.shape``, ``.dtype``, ``len()``, ...) and identity tests
        block propagation."""
        if isinstance(expr, ast.Attribute) and expr.attr in _STATIC_ATTRS:
            return False
        if isinstance(expr, ast.Call):
            # a cast or a host read is reported where it is; its result is
            # a host value
            if call_name(expr) in _STATIC_CALLS or _host_read(expr) or (
                    isinstance(expr.func, ast.Name) and expr.func.id in _CASTS):
                return False
            targets = self._targets(expr.func)
            if targets:
                recv = expr.func.value if isinstance(expr.func, ast.Attribute) else None
                return any(t.key in self.returns for t in targets) or (
                    recv is not None and self.tainted(recv, names))
        if isinstance(expr, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return False
        if isinstance(expr, ast.IfExp):
            return (self.tainted(expr.body, names) or self.tainted(expr.orelse, names)
                    or self.value_test(expr.test, names))
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            # the elements carry the taint: a target is tainted when its
            # iterable is (``any(p.ndim < 2 for p in pools)`` is static)
            inner = set(names)
            for gen in expr.generators:
                if self.tainted(gen.iter, inner):
                    inner |= set(_target_names(gen.target))
            elts = ([expr.key, expr.value] if isinstance(expr, ast.DictComp)
                    else [expr.elt])
            return any(self.tainted(e, inner) for e in elts) or any(
                self.value_test(c, inner) for gen in expr.generators for c in gen.ifs)
        if isinstance(expr, ast.Name):
            return expr.id in names
        return any(self.tainted(c, names) for c in ast.iter_child_nodes(expr))

    def value_test(self, test: ast.AST, names: set[str]) -> bool:
        """Whether a branch's test reads a tensor's value: a tainted test
        other than the truthiness of a bare name (``if pools:``, ``not
        tensors``), which the port uses for its lists and trees of tensors
        and for None, never for a tensor (a mask is tested with ``.any()``)."""
        if isinstance(test, ast.BoolOp):
            return any(self.value_test(v, names) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self.value_test(test.operand, names)
        if isinstance(test, ast.Name):
            return False
        return self.tainted(test, names)

    def loop_reads(self, it: ast.AST, names: set[str]) -> bool:
        """Whether a ``for`` walks a tensor's values: ``range`` of a tainted
        value, or a tainted expression other than a bare name (a list or tree
        the caller passed in), a tree walk (``.items()``, ...) or a followed
        generator (``tree_items``, ``DecoderLM._layers``)."""
        if isinstance(it, ast.Call) and attr_root(it.func) not in _LIBRARY_ROOTS:
            name = call_name(it)
            if name in _SEQUENCE_WRAPPERS and isinstance(it.func, ast.Name):
                return any(self.loop_reads(a, names) for a in it.args)
            if name in _TREE_WALKS or name in self.generators:
                return False
        if isinstance(it, ast.Name):
            return False
        return self.tainted(it, names)


def closure(files: list[SourceFile]) -> set[tuple[str, str]]:
    """(display path, qualname) of every function in the roots' closure."""
    return set(_Closure(files).reached)


def _host_read(node: ast.Call) -> bool:
    fn = node.func
    if not isinstance(fn, ast.Attribute):
        return False
    if fn.attr in _HOST_READ_ATTRS:
        return True
    if fn.attr == "where":
        return len(node.args) == 1 and not node.keywords
    if fn.attr == "to":
        devs = node.args[:1] + [k.value for k in node.keywords if k.arg == "device"]
        for d in devs:
            if isinstance(d, ast.Call) and call_name(d) == "device" and d.args:
                d = d.args[0]
            if isinstance(d, ast.Constant) and d.value == "cpu":
                return True
    return False


def _analyze(graph: _Closure, info: _Fn) -> list[Finding]:
    src, qual = info.src, info.qual
    names = graph.local_taint(info)
    out: list[Finding] = []
    for node in ast.walk(info.node):
        if isinstance(node, ast.Call):
            if _host_read(node):
                out.append(src.finding(
                    "graph-host-read", node, qual,
                    f"host read `{ast.unparse(node.func)}(...)` in a captured step's "
                    "closure — it fails the capture or bakes one value into every "
                    "replay; keep the value on the device"))
            elif isinstance(node.func, ast.Name) and node.func.id in _CASTS and any(
                    graph.value_test(a, names) if node.func.id == "bool"
                    else graph.tainted(a, names) for a in node.args):
                out.append(src.finding(
                    "graph-tensor-cast", node, qual,
                    f"`{node.func.id}()` on a tensor value in a captured step's "
                    "closure reads it back — keep it a tensor"))
        elif isinstance(node, (ast.If, ast.While, ast.IfExp)) \
                and graph.value_test(node.test, names):
            kind = {ast.If: "if", ast.While: "while"}.get(type(node), "conditional expression")
            out.append(src.finding(
                "graph-tensor-branch", node, qual,
                f"Python `{kind}` on a tensor value in a captured step's closure — "
                "the graph keeps the branch its capture took; use `torch.where` "
                "or a mask"))
        elif isinstance(node, ast.For) and graph.loop_reads(node.iter, names):
            out.append(src.finding(
                "graph-tensor-loop", node, qual,
                "Python `for` over a tensor value in a captured step's closure — "
                "`range` of it reads it back, iterating it unrolls one launch per "
                "row; use a batched op"))
    return out


def check(files: list[SourceFile]) -> list[Finding]:
    graph = _Closure(files)
    findings: list[Finding] = []
    for info in graph.reached.values():
        findings.extend(_analyze(graph, info))
    return findings
