"""repro_torch.tune — cutout autotuner for the port's tunable functions, the
port of ``repro.tune``.

A *cutout* is one invocation extracted with its real shapes/dtypes
(``registry.TensorStruct``s, no data).  The tuner enumerates a per-kernel
config space, prunes configs whose analytic roofline bound
(``core.roofline.H100``) cannot approach the best bound in the space,
measures the survivors (``launch.searchloop``), and caches the winner in
``TUNED_kernels_torch.json`` keyed by ``kernel|shape_class|backend``, the
backend being the device type of the call's tensors (``cuda`` or ``cpu``).

Functions participate through the ``@tunable`` registry decorator: a
tunable parameter passed as ``None`` is resolved at call time from the
committed table, falling back to the declared default when no entry
matches — so untuned shapes behave exactly as before.  Four are
registered: ``attn.flash_xla``, ``attn.paged_decode``, ``ssd.chunked`` and
``moe.dispatch``.

Regenerate the table on the card with ``python -m repro_torch.tune --update``.
"""
from .registry import (               # noqa: F401
    REGISTRY,
    Cutout,
    TensorStruct,
    capture,
    materialize,
    no_tuning,
    resolve_tuned,
    tunable,
)
from .table import TABLE_PATH, load_table, save_table, tuned_entry  # noqa: F401
from .tuner import enumerate_space, prune_configs, tune_kernel      # noqa: F401
