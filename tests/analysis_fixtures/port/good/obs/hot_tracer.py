"""Positive fixture: the real tracer idiom — hot record functions are
scalar stores into preallocated arrays; everything that allocates or
locks lives on undecorated cold paths."""
import itertools
import threading


def hot_path(fn):
    return fn


class GoodTracer:
    def __init__(self, capacity, ts, ev, a0, sn):
        self.capacity = capacity
        self._seq = itertools.count()
        self._ts = ts                       # preallocated parallel arrays
        self._ev = ev
        self._a0 = a0
        self._sn = sn
        self._on = True
        self._reg_lock = threading.Lock()
        self._names = []

    @hot_path
    def record(self, ev, a0, now):
        if not self._on:
            return
        sn = next(self._seq)                # GIL-atomic slot claim
        i = sn % self.capacity
        self._ts[i] = now
        self._ev[i] = ev
        self._a0[i] = a0
        self._sn[i] = sn

    @hot_path
    def instant(self, ev, a0, now):
        self.record(ev, a0, now)

    # cold path: registration may allocate and lock freely (no marker)
    def register(self, name):
        with self._reg_lock:
            self._names.append(str(name))
            return len(self._names) - 1
