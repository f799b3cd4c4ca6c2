"""Ownership markers for the two-loop serving engine (the port's copy).

The same decorator names as ``repro/analysis/ownership.py``, so the JAX
package's ``sole-writer`` lint rule, which matches them by name, checks the
port's ``serve`` modules too:

* ``@pool_mutator(kind)`` — mutates engine-shared state: ``"pools"`` (page
  pools and block tables, owned by the decode loop) or ``"free_list"`` (the
  page allocator, shared under the engine lock);
* ``@decode_loop_only`` — runs on the decode-loop thread only;
* ``@admission_api`` — in the admission pipeline's call graph: may reserve
  and free pages under the lock and compute into private buffers, never
  write the pools.

The port has no runtime sanitizer yet: the markers only tag the function.
"""
from __future__ import annotations

__all__ = ["pool_mutator", "decode_loop_only", "admission_api", "MUTATOR_KINDS"]

MUTATOR_KINDS = ("pools", "free_list")


def pool_mutator(kind: str):
    if kind not in MUTATOR_KINDS:
        raise ValueError(f"unknown pool_mutator kind: {kind!r}")

    def deco(fn):
        fn._repro_pool_mutator = kind
        return fn

    return deco


def decode_loop_only(fn):
    fn._repro_decode_loop_only = True
    return fn


def admission_api(fn):
    fn._repro_admission_api = True
    return fn
