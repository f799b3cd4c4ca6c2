"""repro_torch.obs — tracing and metrics for the serve engine (the port's
copy of ``repro/obs``).

Three layers, strictly ordered by cost:

* :mod:`repro_torch.obs.clock` — one injectable monotonic time source;
* :mod:`repro_torch.obs.trace` — lock-free ring-buffer tracer (hot path:
  numpy scalar stores only) with Perfetto export in
  :mod:`repro_torch.obs.export`;
* :mod:`repro_torch.obs.metrics` — typed counters, gauges and histograms
  behind a single (shareable) lock, snapshot-consistent.

None of them imports torch, so the tracer and metrics stay cheap
everywhere, including under the engine lock.  :mod:`repro_torch.obs.wire`
lowers a telemetry snapshot to float32 tensors for the cube processes'
wire format.
"""
from .clock import ManualClock, monotonic, reset_source, set_source
from .metrics import (
    BYTES_EDGES,
    LATENCY_EDGES_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from .trace import NOARG, NULL_TRACER, ServeTracer, Tracer, hot_path

__all__ = [
    "ManualClock",
    "monotonic",
    "reset_source",
    "set_source",
    "BYTES_EDGES",
    "LATENCY_EDGES_S",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NOARG",
    "NULL_TRACER",
    "ServeTracer",
    "Tracer",
    "hot_path",
]
