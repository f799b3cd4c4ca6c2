"""repro_torch.obs — the serve engine's metrics (typed counters, gauges and
histograms behind one shareable lock).  Tracing is not ported yet."""
from .metrics import (
    BYTES_EDGES,
    LATENCY_EDGES_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)

__all__ = [
    "BYTES_EDGES",
    "LATENCY_EDGES_S",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]
