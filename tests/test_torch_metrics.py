"""The port's metrics registry against the JAX package's.

``repro_torch.obs.metrics`` is a copy of ``repro.obs.metrics`` (pure Python
in both packages): the same sequence of calls on a registry of each must
leave the same counters, gauges, histogram buckets, snapshots and totals,
and ``reset`` must zero both alike.
"""
import threading

import numpy as np
import pytest

from repro.obs import metrics as jm
from repro_torch.obs import metrics as tm

# (method, args): counters, a gauge that rises and falls, latency and byte
# histograms with values on, between, below and above the edges
CALLS = [
    ("inc", ("steps",)),
    ("inc", ("steps", 4)),
    ("inc", ("host.swap_outs", 2)),
    ("inc", ("host.pages_out", 17)),
    ("inc", ("prefix.hits",)),
    ("inc", ("pipeline.chunks_run", 3)),
    ("gauge_set", ("occupancy", 0.25)),
    ("gauge_set", ("occupancy", 0.75)),
    ("gauge_set", ("occupancy", 0.5)),
    ("observe", ("step_latency_s", 0.0001)),     # on the first edge
    ("observe", ("step_latency_s", 0.003)),
    ("observe", ("step_latency_s", 0.0)),        # below every edge
    ("observe", ("step_latency_s", 42.0)),       # the overflow bucket
    ("observe", ("host.swap_bytes", 4096.0, tm.BYTES_EDGES)),
    ("observe", ("host.swap_bytes", 5000.0, tm.BYTES_EDGES)),
    ("observe", ("host.swap_bytes", float(1 << 31), tm.BYTES_EDGES)),
]


def _drive(mod):
    reg = mod.MetricsRegistry()
    for name, args in CALLS:
        getattr(reg, name)(*args)
    reg.histogram("occupancy", tuple(i / 10 for i in range(1, 11))).observe(0.3)
    reg.counter("decode_tokens").inc(9)
    return reg


def test_edges_equal():
    assert tm.LATENCY_EDGES_S == jm.LATENCY_EDGES_S
    assert tm.BYTES_EDGES == jm.BYTES_EDGES


def test_snapshot_counters_and_totals_match_jax():
    t, j = _drive(tm), _drive(jm)
    assert t.snapshot() == j.snapshot()
    for prefix in ("", "host.", "prefix.", "pipeline.", "none."):
        assert t.counters(prefix) == j.counters(prefix)
        assert t.total(prefix) == j.total(prefix)
    snap = t.snapshot()
    assert snap["gauges"]["occupancy"] == {"value": 0.5, "max": 0.75}
    lat = snap["histograms"]["step_latency_s"]
    assert lat["count"] == 4 and lat["counts"][0] == 2 and lat["counts"][-1] == 1
    assert len(lat["counts"]) == len(tm.LATENCY_EDGES_S) + 1


def test_snapshot_is_a_deep_copy():
    reg = _drive(tm)
    snap = reg.snapshot()
    snap["counters"]["steps"] = -1
    snap["histograms"]["step_latency_s"]["counts"][0] = -1
    again = reg.snapshot()
    assert again["counters"]["steps"] == 5
    assert again["histograms"]["step_latency_s"]["counts"][0] == 2


def test_reset_matches_jax():
    t, j = _drive(tm), _drive(jm)
    t.reset()
    j.reset()
    assert t.snapshot() == j.snapshot()
    snap = t.snapshot()
    assert set(snap["counters"].values()) == {0}
    assert all(h["count"] == 0 and h["sum"] == 0.0 and not any(h["counts"])
               for h in snap["histograms"].values())
    # metrics survive a reset: the same objects count on
    t.inc("steps")
    assert t.counters()["steps"] == 1


@pytest.mark.parametrize("edges", [(), (1.0, 0.5)])
def test_histogram_rejects_bad_edges_like_jax(edges):
    with pytest.raises(ValueError):
        tm.Histogram(edges)
    with pytest.raises(ValueError):
        jm.Histogram(edges)


def test_shared_lock_and_concurrent_increments():
    """A registry on an engine's RLock takes it re-entrantly, and counts
    every increment of several threads."""
    lock = threading.RLock()
    reg = tm.MetricsRegistry(lock=lock)
    assert reg.lock is lock
    with lock:
        reg.inc("a")                     # re-entrant under the shared lock
    n, threads = 2000, 8

    def bump():
        c = reg.counter("b")
        for _ in range(n):
            with reg.lock:
                c.inc()
            reg.observe("lat", 0.001)

    ts = [threading.Thread(target=bump) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert reg.counters()["b"] == n * threads
    assert reg.snapshot()["histograms"]["lat"]["count"] == n * threads


def test_random_sequences_match_jax():
    rng = np.random.default_rng(0)
    t, j = tm.MetricsRegistry(), jm.MetricsRegistry()
    for _ in range(500):
        k = int(rng.integers(3))
        name = f"m{int(rng.integers(4))}"
        if k == 0:
            n = int(rng.integers(1, 5))
            t.inc(name, n)
            j.inc(name, n)
        elif k == 1:
            v = float(rng.random())
            t.gauge_set(name, v)
            j.gauge_set(name, v)
        else:
            v = float(rng.exponential(0.05))
            t.observe(name, v)
            j.observe(name, v)
    assert t.snapshot() == j.snapshot()
