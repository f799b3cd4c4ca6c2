"""Ownership markers, the declared request state machine and the runtime
sanitizer of the port's serving engine (``REPRO_SANITIZE=1`` turns the
sanitizer on), and the port's repro-lint, their static half
(``python -m repro_torch.analysis.lint``; ``findings``, ``rules``)."""
from . import sanitizer
from .ownership import admission_api, captured_step, decode_loop_only, pool_mutator
from .phases import PHASE_EDGES, PHASE_WRITERS

__all__ = [
    "admission_api",
    "captured_step",
    "decode_loop_only",
    "pool_mutator",
    "sanitizer",
    "PHASE_EDGES",
    "PHASE_WRITERS",
]
