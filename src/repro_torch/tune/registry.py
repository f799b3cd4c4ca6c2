"""Kernel registry: the ``@tunable`` decorator and call-time lookup, the
port of ``repro/tune/registry.py``.

A tunable kernel declares its config space (param → choices), the default
config its callers get today, a *shape-class* function (a pure function of
the call's ``.shape``/``.dtype`` producing the table key, so resolving
reads nothing back from the card and is safe inside CUDA-graph capture),
and optionally an analytic cost model for the roofline prune plus a
validity predicate for (shape, config) combinations.

The wrapper resolves any tunable parameter the caller passed as ``None``:
the table's winner when the (kernel, shape-class, backend) entry exists,
the declared default otherwise.  The backend is the device type of the
call's first tensor argument (``"cuda"`` or ``"cpu"``).  Callers that pass
explicit values never consult the table.  ``no_tuning()`` force-disables
lookups for a block.  Eager torch resolves on every call (the reference
resolves once per trace), so the parameters each (kernel, shape class,
backend, table) resolves to are kept in ``table.memo``: after the first
call a lookup is the shape-class string and one dict read.

``capture()`` records cutouts — (kernel, shape_class, arg structs) — from
real invocations flowing through the wrappers; ``materialize`` turns one
back into random inputs on a device, for ``python -m repro_torch.tune`` or
``tuner.tune_kernel``.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import threading
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from . import table
from .table import tuned_entry

REGISTRY: dict[str, TunableKernel] = {}

_state = threading.local()

# short dtype codes for shape-class keys (the reference's, by dtype name)
_DT_CODES = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
             "float64": "f64", "int32": "i32", "int8": "i8", "bool": "b1"}


def dtype_code(dtype) -> str:
    name = str(dtype).removeprefix("torch.")
    return _DT_CODES.get(name, name)


@dataclass(frozen=True)
class TunableKernel:
    name: str
    fn: Callable
    space: dict[str, tuple]            # param -> candidate values
    defaults: dict[str, Any]           # param -> the pre-tuner behavior
    shape_class: Callable[..., str]    # (*call args) -> table key segment
    cost_model: Callable | None        # (params, *args) -> (flops, bytes)
    validate: Callable | None          # (params, *args) -> bool
    backends: tuple[str, ...]          # backends the space is meaningful on


@dataclass(frozen=True)
class TensorStruct:
    """The shape and dtype of one tensor argument, without its data."""

    shape: tuple
    dtype: torch.dtype


@dataclass(frozen=True)
class Cutout:
    """One extracted kernel invocation: real shapes/dtypes, no data."""

    kernel: str
    shape_class: str
    args: tuple = field(default=())    # TensorStruct per tensor arg,
                                       # non-tensor args carried verbatim


def _struct(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return TensorStruct(tuple(x.shape), x.dtype)
    return x


def materialize(cutout: Cutout, seed: int = 0, *, device) -> tuple:
    """Concrete random inputs for a captured cutout on ``device``, drawn
    with numpy as the reference draws them.  Float structs draw from
    N(0,1); integer structs draw small non-negative values (safe for
    index-like operands — the kernels clip/mask out-of-range indices)."""
    rng = np.random.default_rng(seed)
    out = []
    for a in cutout.args:
        if isinstance(a, TensorStruct):
            if a.dtype.is_floating_point:
                v = rng.normal(size=a.shape)
            else:
                v = rng.integers(0, 4, size=a.shape)
            out.append(torch.from_numpy(v).to(device=device, dtype=a.dtype))
        else:
            out.append(a)
    return tuple(out)


@contextlib.contextmanager
def no_tuning():
    """Disable table lookups for the block: every ``None`` tunable param
    resolves to its declared default."""
    prev = getattr(_state, "disabled", False)
    _state.disabled = True
    try:
        yield
    finally:
        _state.disabled = prev


@contextlib.contextmanager
def capture():
    """Record the cutout of every tunable-kernel invocation in the block
    that resolves a parameter (one record per call)."""
    prev = getattr(_state, "captured", None)
    _state.captured = []
    try:
        yield _state.captured
    finally:
        _state.captured = prev


def backend_of(args) -> str:
    """The device type of the first tensor among ``args`` (``"cpu"`` when
    there is none)."""
    return next(("cuda" if a.is_cuda else a.device.type for a in args
                 if isinstance(a, torch.Tensor)), "cpu")


def resolve_tuned(name: str, *args) -> dict[str, Any]:
    """Call-time parameter resolution for kernel ``name`` called with
    ``args``: table winner when present, declared defaults otherwise."""
    kern = REGISTRY[name]
    if getattr(_state, "disabled", False):
        return dict(kern.defaults)
    sc = kern.shape_class(*args)
    captured = getattr(_state, "captured", None)
    if captured is not None:
        captured.append(Cutout(name, sc, tuple(_struct(a) for a in args)))
    backend = backend_of(args)
    key = (name, sc, backend, table.active_path())
    params = table.memo.get(key)
    if params is None:
        params = dict(kern.defaults)
        if backend in kern.backends:
            entry = tuned_entry(name, sc, backend)
            if entry is not None:
                params.update(entry["params"])
        table.memo[key] = params
    return dict(params)


def tunable(
    name: str,
    *,
    space: dict[str, tuple],
    defaults: dict[str, Any],
    shape_class: Callable[..., str],
    cost_model: Callable | None = None,
    validate: Callable | None = None,
    backends: tuple[str, ...] = ("cpu", "cuda"),
):
    """Register ``fn`` as a tunable kernel.  Every key of ``space`` must be
    a keyword-only parameter of ``fn`` whose ``None`` means "resolve me"."""

    def deco(fn: Callable) -> Callable:
        kern = TunableKernel(
            name=name, fn=fn, space=dict(space), defaults=dict(defaults),
            shape_class=shape_class, cost_model=cost_model,
            validate=validate, backends=tuple(backends),
        )
        if set(kern.defaults) != set(kern.space):
            raise ValueError(f"{name}: defaults {sorted(kern.defaults)} do not name "
                             f"the space's parameters {sorted(kern.space)}")
        REGISTRY[name] = kern
        # positional parameters a caller may pass by keyword: the shape class
        # and the cutout see them in their places (the rest at their defaults)
        positional = [(q.name, None if q.default is q.empty else q.default)
                      for q in inspect.signature(fn).parameters.values()
                      if q.kind is q.POSITIONAL_OR_KEYWORD]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if any(kwargs.get(p) is None for p in kern.space):
                later = positional[len(args):]
                if any(n in kwargs for n, _ in later):
                    resolved = resolve_tuned(name, *args, *(kwargs.get(n, d) for n, d in later))
                else:
                    resolved = resolve_tuned(name, *args)
                for p in kern.space:
                    if kwargs.get(p) is None:
                        kwargs[p] = resolved[p]
            return fn(*args, **kwargs)

        wrapper.__tunable__ = kern
        return wrapper

    return deco
