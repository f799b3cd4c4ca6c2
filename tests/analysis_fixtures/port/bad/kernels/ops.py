"""Negative fixture: a launch wrapper that reads the device back inside a
captured step's closure and a tuned-table lookup on every launch."""


def resolve_tuned(name, *args):
    return {"lanes": 4}


def paged_decode(q, pools, lengths):
    lens = lengths.cpu()                                # BAD: graph-host-read
    plan = resolve_tuned("paged.decode", q)             # BAD: tune-lookup-in-kernel
    return _launch(q, pools, lens, plan["lanes"])


def _launch(q, pools, lens, lanes):
    return q
