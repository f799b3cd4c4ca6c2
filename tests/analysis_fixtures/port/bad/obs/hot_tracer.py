"""Negative fixture: every obs-hot-path violation class — allocation and
lock-taking inside ``@hot_path`` tracer record functions."""


def hot_path(fn):
    return fn


class BadTracer:
    def __init__(self, lock):
        self._lock = lock
        self._events = []
        self._names = {}

    @hot_path
    def record_locked(self, ev, a0):
        with self._lock:                    # BAD: lock on the hot path
            self._events.append((ev, a0))   # BAD: append allocates/mutates

    @hot_path
    def record_alloc(self, ev, args):
        row = {"ev": ev, "args": list(args)}   # BAD: dict + list displays
        self._events.append(row)               # BAD: allocating call

    @hot_path
    def record_format(self, ev, uid):
        name = f"ev-{ev}-{uid}"             # BAD: f-string per event
        self._names[ev] = name

    @hot_path
    def record_comprehension(self, pages):
        self._events.extend([int(p) for p in pages])   # BAD: comprehension

    @hot_path
    def record_wait(self, cv):
        cv.wait(timeout=0.1)                # BAD: thread coordination
