"""Negative fixture: tuned-table lookups inside ``@hot_path`` record
functions (file I/O + dict probes on the tracer hot path)."""


def hot_path(fn):
    return fn


def resolve_tuned(name, *args):
    return {}


def load_table():
    return {}


class TunedTracer:
    def __init__(self, a0):
        self._a0 = a0

    @hot_path
    def record_resolved(self, ev, q):
        params = resolve_tuned("attn.paged_decode", q)   # BAD: table lookup
        self._a0[ev] = params["lane_block"]

    @hot_path
    def record_reload(self, ev):
        tab = load_table()                               # BAD: file read
        self._a0[ev] = tab["version"]
