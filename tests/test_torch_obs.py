"""The port's tracer, Perfetto export and traced engine against the JAX
package's (the cases of ``tests/test_obs.py`` but the wire and router ones;
its three metrics cases are ``tests/test_torch_metrics.py``'s).

* the same calls on a JAX tracer and on the port's give the same events,
  and the same events export to the same Chrome-trace JSON;
* ``validate_lifecycles`` accepts and rejects what JAX's does;
* in inline admission, under the forced-preemption cell of
  ``test_traced_engine_lifecycles_and_token_identity`` (reduced qwen2.5-3b
  in float32, the JAX weights through ``repro_torch.convert``), every
  request's phase history and every event name's count in the port's trace
  equal the JAX engine's, and so do the tokens;
* a traced engine gives the untraced engine's tokens, in async admission
  too, and with an injected clock the engine's histograms equal JAX's
  bucket for bucket.
"""
import collections
import copy
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import serve as jserve  # noqa: E402
from repro.analysis import phases as jphases  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.obs import clock as jclock  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.analysis import phases as tphases  # noqa: E402
from repro_torch.analysis import sanitizer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import clock as tclock  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

SIDES = {"jax": (jclock, jtrace, jexport), "torch": (tclock, ttrace, texport)}

# the forced-preemption cell of test_obs.py's lifecycle test: the pool
# admits all three lanes' long prompts exactly, then dries as decode grows
CELL = dict(batch_slots=3, max_len=32, page_size=4, n_pages=13, swap_token_cost=0.0,
            prefill_chunk=6)
CELL_REQS = dict(plen=14, max_new=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these engines run tiny ops, which more threads
    only slow down while the suite's other workers hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clocks():
    """A ManualClock installed in both packages (each has its own source)."""
    clk = tclock.ManualClock()
    for mod in (jclock, tclock):
        mod.set_source(clk)
    try:
        yield clk
    finally:
        for mod in (jclock, tclock):
            mod.reset_source()


def _both(fn):
    """``fn(trace_module)`` on each package's tracer module."""
    return {side: fn(mods[1]) for side, mods in SIDES.items()}


# -- tracer ------------------------------------------------------------------


def test_tracer_deterministic_timestamps_match_jax(clocks):
    def drive(mod):
        clocks.now = 0.0
        tr = mod.Tracer(capacity=16)
        ev = tr.register("work", ("n",))
        tr.begin(ev, 3)
        clocks.advance(0.5)
        tr.end(ev, 3)
        return tr

    trs = _both(drive)
    a, b = trs["torch"].events()
    assert (a["ts"], b["ts"]) == (0.0, 0.5)
    assert a["name"] == b["name"] == "work" and a["args"] == {"n": 3}
    assert trs["torch"].total == 2 and trs["torch"].dropped == 0
    assert trs["jax"].events() == [a, b]


def test_ring_wraparound_keeps_newest_like_jax():
    def drive(mod):
        tr = mod.Tracer(capacity=8)
        ev = tr.register("tick", ("i",))
        for i in range(20):
            tr.instant(ev, i)
        return tr

    trs = _both(drive)
    tr = trs["torch"]
    assert tr.total == 20 and tr.dropped == 12
    events = tr.events()
    assert [e["args"]["i"] for e in events] == list(range(12, 20))
    assert [e["seq"] for e in events] == list(range(12, 20))
    strip = [[(e["seq"], e["name"], e["ph"], e["args"]) for e in t.events()]
             for t in trs.values()]
    assert strip[0] == strip[1]


def test_disabled_tracer_records_nothing():
    tr = ttrace.Tracer(capacity=8, enabled=False)
    ev = tr.register("tick", ())
    tr.begin(ev)
    tr.instant_named("nope")
    tr.ensure_thread_name("ghost")
    assert tr.total == 0 and tr.events() == [] and tr.thread_names() == {}
    tr.enable()
    tr.instant(ev)
    assert tr.total == 1
    # the shared disabled singleton stayed empty through every serve-layer
    # default call site of the tests that ran before
    assert ttrace.NULL_TRACER.total == 0 and not ttrace.NULL_TRACER.enabled


def test_phase_vocabulary_matches_state_machine_and_jax():
    machine_phases = {p for edge in tphases.PHASE_EDGES for p in edge}
    assert machine_phases == set(ttrace.ServeTracer.PHASES)
    assert ttrace.ServeTracer.PHASES == jtrace.ServeTracer.PHASES
    assert tphases.PHASE_EDGES == jphases.PHASE_EDGES
    assert tphases.PHASE_WRITERS == jphases.PHASE_WRITERS
    for old in sorted(tphases.PHASES) + [None]:
        for new in sorted(tphases.PHASES) + ["zombie"]:
            assert tphases.check_phase_edge(old, new) == jphases.check_phase_edge(old, new)
    tr = ttrace.ServeTracer(capacity=8)
    tr.phase(5, "prefill")
    tr.phase(5, "not-a-phase")          # unknown names are ignored, not stored
    (e,) = tr.events()
    assert e["name"] == "phase.prefill" and e["args"] == {"uid": 5}


def test_serve_schema_and_counter_events_match_jax():
    trs = _both(lambda mod: mod.ServeTracer(capacity=8))
    assert trs["torch"]._names == trs["jax"]._names
    assert trs["torch"]._argnames == trs["jax"]._argnames
    for tr in trs.values():
        tr.counter(tr.EV_PAGES_FREE, 11)
    (e,) = trs["torch"].events()
    assert e["ph"] == ttrace.PH_COUNTER and e["args"]["value"] == 11
    assert e["args"] == trs["jax"].events()[0]["args"]


# -- export ------------------------------------------------------------------


def test_chrome_trace_structure_matches_jax(clocks, tmp_path):
    def drive(mod):
        clocks.now = 0.0
        tr = mod.Tracer(capacity=32)
        tr.name_thread("decode-loop")
        ev = tr.register("engine.step", ("step",))
        tr.begin(ev, 0)
        clocks.advance(0.002)
        tr.end(ev, 0)
        tr.instant_named("sanitizer: boom")
        return tr

    trs = _both(drive)
    path = str(tmp_path / "t.json")
    texport.write_chrome_trace(path, {"engine": trs["torch"]})
    trace = texport.load_chrome_trace(path)
    evs = trace["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "engine"}} in meta
    assert any(e["name"] == "thread_name" and e["args"]["name"] == "decode-loop"
               for e in meta)
    spans = [e for e in evs if e["ph"] in ("B", "E")]
    assert [e["ts"] for e in spans] == [0.0, 2000.0]     # microseconds
    inst = [e for e in evs if e["ph"] == "i"]
    assert inst and all(e["s"] == "t" for e in inst)
    assert any(e["name"] == "sanitizer: boom" for e in inst)
    # the same events export to the same JSON on both sides
    assert trace == json.loads(json.dumps(jexport.chrome_trace({"engine": trs["jax"]})))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nope": []}))
    for mod in (texport, jexport):
        with pytest.raises(ValueError):
            mod.load_chrome_trace(str(bad))


def _fake(phases_by_uid):
    return {"traceEvents": [
        {"name": "phase." + p, "ph": "i", "ts": 0.0, "pid": 0, "tid": 0,
         "args": {"uid": uid}, "s": "t"}
        for uid, phases in phases_by_uid.items() for p in phases]}


@pytest.mark.parametrize("phases,require_done,match", [
    ({1: ["waiting", "prefill", "ready", "running", "done"]}, True, None),
    ({1: ["waiting", "running", "done"]}, True, "illegal phase edge"),
    ({1: ["ready", "running", "done"]}, True, "not 'waiting'"),
    ({1: ["waiting", "prefill", "ready"]}, True, "not 'done'"),
    # an in-flight trace (a snapshot mid-serve) can opt out of the done bar
    ({1: ["waiting", "prefill", "ready", "running"]}, False, None),
    ({2: ["waiting", "restore", "ready", "running", "waiting", "match", "done"]}, True, None),
    ({}, True, "no phase"),
], ids=["legal", "skips-admission", "starts-late", "unfinished", "in-flight",
        "preempted-and-matched", "empty"])
def test_validate_lifecycles_like_jax(phases, require_done, match):
    trace = _fake(phases)
    assert texport.request_phases(trace) == jexport.request_phases(trace)
    if match is None:
        got = texport.validate_lifecycles(trace, require_done=require_done)
        assert got == jexport.validate_lifecycles(trace, require_done=require_done) == phases
        return
    for mod in (texport, jexport):
        with pytest.raises(ValueError, match=match):
            mod.validate_lifecycles(trace, require_done=require_done)


def test_chrome_trace_merges_multiple_tracers():
    a, b = ttrace.Tracer(capacity=8), ttrace.Tracer(capacity=8)
    ea, eb = a.register("x", ()), b.register("y", ())
    a.instant(ea)
    b.instant(eb)
    trace = texport.chrome_trace({"pod0": a, "pod1": b})
    pids = {e["pid"] for e in trace["traceEvents"] if e["ph"] != "M"}
    assert pids == {0, 1}


def test_sanitizer_phase_finding_lands_in_trace():
    class _Req:
        uid = 7

    tr = ttrace.ServeTracer(capacity=32)
    st = tserve.RequestState(req=_Req(), resume_tokens=np.arange(3), tracer=tr)
    sanitizer.enable()
    try:
        with pytest.raises(sanitizer.SanitizerError, match="uid=7"):
            st.phase = "running"         # waiting -> running: illegal
    finally:
        sanitizer.disable()
    names = [e["name"] for e in tr.events()]
    assert "phase.waiting" in names      # the construction-time write recorded
    assert any(n.startswith("sanitizer: illegal phase edge") for n in names)
    assert st.phase == "waiting"         # the write did not land


# -- engine integration (reduced qwen2.5-3b, float32) --------------------------


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = dataclasses.replace(jax_arch("qwen2.5-3b").reduced(), dtype="float32")
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(dataclasses.replace(get_arch("qwen2.5-3b").reduced(), dtype="float32"))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model, params


def _ecfg(mod, batch_slots, max_len, page_size=16, n_pages=None, swap_token_cost=0.25,
          prefill_chunk=0, async_prefill=True, trace=False, trace_annotations=False):
    return mod.EngineConfig(
        batch_slots=batch_slots, max_len=max_len,
        cache=mod.CacheConfig(page_size=page_size, n_pages=n_pages,
                              swap_token_cost=swap_token_cost),
        admission=mod.AdmissionConfig(prefill_chunk=prefill_chunk, async_prefill=async_prefill),
        obs=mod.ObsConfig(trace=trace, trace_annotations=trace_annotations))


def _reqs(mod, vocab, n, plen=7, max_new=6, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(0, vocab, size=(plen + i % 3,))
                        .astype(np.int32), max_new_tokens=max_new)
            for i in range(n)]


def _run(side, n=5, plen=7, max_new=6, **knobs):
    """test_obs.py's ``_run``: submissions interleaved with steps, then
    drained.  Returns (engine, {uid: tokens})."""
    jmodel, jparams, model, params = _models()
    if side == "jax":
        eng = jserve.ServeEngine(jmodel, jparams, _ecfg(jserve, **knobs))
        mod = jserve
    else:
        eng = tserve.ServeEngine(model, params, _ecfg(tserve, **knobs), device="cpu")
        mod = tserve
    reqs = _reqs(mod, model.cfg.vocab_size, n, plen, max_new)
    for r in reqs:
        eng.submit(r)
        eng.step()                       # interleave arrivals with decode
    eng.run()
    eng.pipeline.shutdown()
    return eng, {r.uid: list(r.out_tokens) for r in reqs}


def _ticking(side, **knobs):
    """``_run`` with the side's clock ticking 1 ms per read."""
    clock = SIDES[side][0]
    ticks = iter(range(1 << 30))
    clock.set_source(lambda: next(ticks) * 1e-3)
    try:
        return _run(side, **knobs)
    finally:
        clock.reset_source()


@functools.lru_cache(maxsize=None)
def _jax_traced_inline():
    eng, toks = _ticking("jax", trace=True, async_prefill=False, **CELL, **CELL_REQS)
    trace = json.loads(json.dumps(jexport.chrome_trace({"engine": eng.tracer})))
    return toks, trace, eng.telemetry()


def _name_counts(trace):
    return collections.Counter((e["name"], e["ph"]) for e in trace["traceEvents"])


def test_traced_engine_phases_and_event_counts_match_jax(tmp_path):
    want, jtrace_json, jtel = _jax_traced_inline()
    eng, got = _ticking("torch", trace=True, async_prefill=False, **CELL, **CELL_REQS)
    assert got == want and len(got) == 5
    path = str(tmp_path / "torch.json")
    eng.save_trace(path)
    trace = texport.load_chrome_trace(path)
    hist = texport.validate_lifecycles(trace, require_done=True)
    assert hist == texport.request_phases(jtrace_json)
    assert _name_counts(trace) == _name_counts(jtrace_json)
    tel = eng.telemetry()
    assert tel["preemptions"] == jtel["preemptions"] > 0     # the cell fired
    assert any(ph.count("waiting") > 1 for ph in hist.values())
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"engine.step", "decode.batch", "prefill.chunk", "admission.reserve",
            "pages.free", "swap_out.batch", "swap_in.stage", "preempt.swap"} <= names
    assert eng.tracer.dropped == 0
    # each engine reads time only through its package's clock, at the same
    # points: on a clock that ticks per read, every event's timestamp and
    # the step-latency and queue-wait histograms equal JAX's
    assert trace == jtrace_json
    h, jh = tel["histograms"], jtel["histograms"]
    assert h["step_latency_s"]["count"] == tel["steps"] == jtel["steps"]
    assert h["queue_wait_s"]["count"] == 5 + tel["preemptions"]   # one per admission
    for name in ("step_latency_s", "queue_wait_s"):
        assert h[name]["counts"] == jh[name]["counts"], name
        assert h[name]["sum"] == pytest.approx(jh[name]["sum"]), name


def test_traced_engine_async_lifecycles_and_token_identity(tmp_path):
    want, _, _ = _jax_traced_inline()
    traced, toks_t = _run("torch", trace=True, async_prefill=True, **CELL, **CELL_REQS)
    plain, toks_p = _run("torch", trace=False, async_prefill=True, **CELL, **CELL_REQS)
    # recording events must not change a single token
    assert toks_t == toks_p == want
    assert plain.tracer is ttrace.NULL_TRACER and plain.tracer.total == 0
    trace = traced.save_trace(str(tmp_path / "serve_trace.json"))
    hist = texport.validate_lifecycles(trace, require_done=True)
    assert set(hist) == set(toks_t)
    # (whether this cell preempts in async admission depends on the
    # worker's pace; the inline comparison above holds the preemptions)
    # both loops own a labelled thread track
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"decode-loop", "admission-pipeline"} <= tracks


def test_engine_telemetry_snapshot_isolation():
    eng, _ = _run("torch", batch_slots=3, max_len=32, page_size=4, n_pages=7,
                  swap_token_cost=0.0)
    tel = eng.telemetry()
    ref = copy.deepcopy(tel)
    tel["steps"] = -1
    tel["pipeline"]["chunks_run"] = -1
    tel["host_tier"]["pages_out"] = -1
    tel["histograms"]["step_latency_s"]["counts"][0] = -1
    assert eng.telemetry() == ref        # live stats never saw the mutation


def test_stats_property_is_copy_and_reset_stats_zeroes():
    eng, toks = _run("torch", batch_slots=2, max_len=32)
    s = eng.stats
    assert s["steps"] > 0
    # each request's first token comes from prefill, the rest from decode
    assert s["decode_tokens"] == sum(len(t) for t in toks.values()) - len(toks)
    s["steps"] = -5
    assert eng.stats["steps"] > 0        # a copy, not the live dict
    eng.reset_stats()
    z = eng.stats
    assert z["steps"] == 0 and z["decode_tokens"] == 0
    assert eng.pipeline.stats["chunks_run"] == 0     # one registry resets all


def test_step_and_queue_histograms_populate():
    eng, _ = _run("torch", batch_slots=2, max_len=32)
    tel = eng.telemetry()
    h = tel["histograms"]
    assert h["step_latency_s"]["count"] == tel["steps"]
    assert h["step_latency_s"]["sum"] > 0
    assert h["queue_wait_s"]["count"] == 5           # one wait per admission
    assert len(h["step_latency_s"]["counts"]) == len(h["step_latency_s"]["edges"]) + 1


def test_trace_annotations_smoke():
    annot, toks_a = _run("torch", n=3, batch_slots=2, max_len=32, trace_annotations=True)
    plain, toks_p = _run("torch", n=3, batch_slots=2, max_len=32)
    assert toks_a == toks_p              # profiler ranges change nothing
    # one profiler range per decode call, as many as the tracer's spans
    _, _, model, params = _models()
    eng = tserve.ServeEngine(model, params, _ecfg(tserve, 2, 32, async_prefill=False,
                                                  trace=True, trace_annotations=True),
                             device="cpu")
    for r in _reqs(tserve, model.cfg.vocab_size, 2, max_new=4):
        eng.submit(r)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.run()
    n = sum(1 for e in prof.events() if e.name == "decode.batch")
    spans = sum(1 for e in eng.tracer.events()
                if e["name"] == "decode.batch" and e["ph"] == ttrace.PH_BEGIN)
    assert n == spans == 3               # 4 tokens: one from prefill, 3 decode steps
