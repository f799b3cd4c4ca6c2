"""The port's runtime sanitizer against the JAX package's.

The sanitizer cases of ``tests/test_analysis.py`` (thread ownership, lock
discipline, double free, use-after-free, the stale-page ABA, the
invariant check after every mutation, phase edges), each run on both
packages (``repro.analysis`` with ``repro.serve``'s allocator and request
state, ``repro_torch.analysis`` with the port's): every seeded violation
raises on both sides with the same finding, and the legal path stays quiet
on both.  Then the engines themselves under the sanitizer: a sanitized
port engine under page pressure (swap and restore through async admission,
prefix sharing with host retire) raises nothing and gives the JAX engine's
tokens, and a pools write or a decode-loop entry from another thread
raises on both.
"""
import dataclasses
import functools
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.analysis.ownership as jown  # noqa: E402
import repro.analysis.sanitizer as jsan  # noqa: E402
import repro_torch.analysis.ownership as town  # noqa: E402
import repro_torch.analysis.sanitizer as tsan  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

SIDES = {"jax": (jsan, jown, jserve), "torch": (tsan, town, tserve)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: these engines run tiny ops, which more threads
    only slow down while the suite's other workers hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mini_classes(own, serve):
    class MiniCache:
        """Smallest object graph the ownership decorators operate on."""

        def __init__(self, n_pages=8):
            self.pools = 0
            self.allocator = serve.PageAllocator(n_pages)

        @own.pool_mutator("pools")
        def bump(self):
            self.pools += 1

        @own.pool_mutator("pools")
        def touch(self, pages):
            pass

    class MiniEngine:
        def __init__(self):
            self.cache = MiniCache()
            self._lock = threading.RLock()

        @own.decode_loop_only
        def decode_step(self):
            pass

    return MiniCache, MiniEngine


@pytest.fixture(params=list(SIDES))
def side(request):
    """One package's sanitizer (enabled for the test), ownership markers,
    serve module and mini object graph."""
    san, own, serve = SIDES[request.param]
    was = san.enabled()
    san.enable()
    cache_cls, engine_cls = _mini_classes(own, serve)
    yield SimpleNamespace(san=san, serve=serve, Cache=cache_cls, Engine=engine_cls)
    if not was:
        san.disable()


def _on_thread(fn):
    """Run ``fn`` on a fresh thread, re-raising anything it raises."""
    box = []

    def runner():
        try:
            fn()
        except BaseException as e:           # noqa: B036 - relay to caller
            box.append(e)

    t = threading.Thread(target=runner)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    if box:
        raise box[0]


def test_sanitizer_catches_pool_write_from_admission_thread(side):
    eng = side.Engine()
    side.san.register_engine(eng)
    eng.cache.bump()                         # the main thread binds as the writer

    def admission():
        side.san.register_admission_thread(eng)
        try:
            eng.cache.bump()
        finally:
            side.san.unregister_admission_thread(eng)

    with pytest.raises(side.san.SanitizerError, match="admission"):
        _on_thread(admission)


def test_sanitizer_catches_second_pool_writer_thread(side):
    eng = side.Engine()
    side.san.register_engine(eng)
    eng.cache.bump()
    with pytest.raises(side.san.SanitizerError, match="two threads"):
        _on_thread(eng.cache.bump)


def test_sanitizer_catches_decode_only_on_admission_thread(side):
    eng = side.Engine()
    side.san.register_engine(eng)

    def admission():
        side.san.register_admission_thread(eng)
        try:
            eng.decode_step()
        finally:
            side.san.unregister_admission_thread(eng)

    with pytest.raises(side.san.SanitizerError, match="decode_loop_only"):
        _on_thread(admission)


def test_sanitizer_enforces_free_list_lock(side):
    eng = side.Engine()
    side.san.register_engine(eng)
    with pytest.raises(side.san.SanitizerError, match="lock"):
        eng.cache.allocator.acquire(1)
    with eng._lock:
        pages = eng.cache.allocator.acquire(1)
        assert pages is not None
        eng.cache.allocator.release(pages)


def test_sanitizer_catches_double_free(side):
    alloc = side.serve.PageAllocator(4)      # standalone: no lock registered
    pages = alloc.acquire(2)
    alloc.release(pages)
    with pytest.raises(side.san.SanitizerError, match="double free"):
        alloc.release([pages[0]])


def test_sanitizer_catches_use_after_free(side):
    cache = side.Cache()
    pages = cache.allocator.acquire(2)
    cache.allocator.release(pages)
    with pytest.raises(side.san.SanitizerError, match="use-after-free"):
        cache.touch(pages)


def test_sanitizer_catches_stale_page_aba(side):
    alloc = side.serve.PageAllocator(2)
    st = SimpleNamespace(pages=alloc.acquire(1))
    side.san.note_grant(st, st.pages, alloc)
    side.san.verify_grant(st, alloc)         # a fresh grant: fine
    alloc.release(st.pages)                  # preemption frees the page...
    other = alloc.acquire(1)                 # ...and it is issued again (LIFO)
    assert other == st.pages                 # same id, new generation
    with pytest.raises(side.san.SanitizerError, match="stale page"):
        side.san.verify_grant(st, alloc)     # the stale list still names it


def test_sanitizer_catches_refcount_mirror_divergence(side):
    alloc = side.serve.PageAllocator(4)
    pages = alloc.acquire(2)
    alloc.share(pages[:1])
    alloc.refs[pages[0]] = 5                 # the allocator's count goes wrong
    with pytest.raises(side.san.SanitizerError, match="refcount mirror diverged"):
        alloc.share(pages[:1])


def test_sanitizer_runs_check_invariant_after_mutation(side):
    class Broken(side.serve.PageAllocator):
        def check_invariant(self):
            super().check_invariant()
            raise AssertionError("seeded invariant failure")

    alloc = Broken(2)
    with pytest.raises(AssertionError, match="seeded"):
        alloc.acquire(1)


def test_sanitizer_validates_phase_edges(side):
    req = SimpleNamespace(uid=7)
    st = side.serve.RequestState(req=req, resume_tokens=np.asarray([1, 2], np.int32))
    st.phase = "prefill"                     # waiting -> prefill: legal
    st.phase = "ready"
    st.phase = "running"
    with pytest.raises(side.san.SanitizerError, match="illegal phase edge"):
        st.phase = "ready"                   # running -> ready: not an edge
    st.phase = "waiting"                     # preemption: legal
    with pytest.raises(side.san.SanitizerError, match="unknown phase"):
        st.phase = "zombie"


@pytest.mark.parametrize("name", list(SIDES))
def test_sanitizer_disabled_is_silent(name):
    san, _own, serve = SIDES[name]
    if san.enabled():
        pytest.skip("suite running under REPRO_SANITIZE=1")
    alloc = serve.PageAllocator(2)
    pages = alloc.acquire(1)
    alloc.release(pages)
    with pytest.raises(AssertionError):      # the allocator's own assert
        alloc.release(pages)


def test_markers_keep_the_lint_tags_and_wrap():
    cache = tserve.PagedKVCache
    assert cache.assign_lane._repro_pool_mutator == "pools"
    assert cache.assign_lane.__name__ == "assign_lane"
    assert cache.assign_lane.__wrapped__.__name__ == "assign_lane"
    assert tserve.PageAllocator.acquire._repro_pool_mutator == "free_list"
    eng = tserve.ServeEngine
    assert eng._decode_lanes._repro_decode_loop_only
    assert eng._decode_lanes._repro_pool_mutator == "pools"
    assert eng.run_prefill._repro_admission_api
    assert not hasattr(eng.run_prefill, "__wrapped__")      # a marker only


# -- the engines under the sanitizer ------------------------------------------


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = dataclasses.replace(jax_arch("qwen2.5-3b").reduced(), dtype="float32")
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(dataclasses.replace(get_arch("qwen2.5-3b").reduced(), dtype="float32"))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model, params


def _engine(name, async_prefill=True, **cache):
    jmodel, jparams, model, params = _models()
    mod = SIDES[name][2]
    ecfg = mod.EngineConfig(
        batch_slots=3, max_len=32,
        cache=mod.CacheConfig(page_size=4, swap_token_cost=0.0, **cache),
        admission=mod.AdmissionConfig(prefill_chunk=3, async_prefill=async_prefill))
    if name == "jax":
        return jserve.ServeEngine(jmodel, jparams, ecfg)
    return tserve.ServeEngine(model, params, ecfg, device="cpu")


def _stress(eng, mod, vocab, n=8):
    """Staggered submissions while stepping (tests/test_async_serve.py's
    stress): admissions, chunks, swap preemptions and restores in flight
    at once."""
    rng = np.random.default_rng(3)
    reqs = [mod.Request(uid=i, prompt=rng.integers(0, vocab, size=(7 + i % 3,))
                        .astype(np.int32), max_new_tokens=9)
            for i in range(n)]
    i = step = 0
    while i < len(reqs) or eng.load:
        if i < len(reqs) and step % 2 == 0:
            eng.submit(reqs[i])
            i += 1
        eng.step()
        step += 1
    eng.pipeline.shutdown()
    return {r.uid: list(r.out_tokens) for r in reqs}


@functools.lru_cache(maxsize=None)
def _jax_stress_inline():
    eng = _engine("jax", async_prefill=False, n_pages=7)
    return _stress(eng, jserve, _models()[2].cfg.vocab_size), eng.telemetry()


@pytest.mark.parametrize("async_prefill", [False, True], ids=["inline", "async"])
def test_sanitized_engine_under_pressure_matches_jax(async_prefill):
    """Inline admission is deterministic: swaps and restores fire, and the
    counters equal JAX's.  In async admission the worker thread (registered
    with the sanitizer) admits, prefills and stages; how often the pool
    runs dry there depends on its pace, and the tokens may not change."""
    want, jtel = _jax_stress_inline()
    tsan.enable()
    try:
        eng = _engine("torch", async_prefill=async_prefill, n_pages=7)
        got = _stress(eng, tserve, _models()[2].cfg.vocab_size)
    finally:
        tsan.disable()
    assert got == want
    tel = eng.telemetry()
    if async_prefill:
        # every admission (and re-admission after a preemption) on the worker
        assert tel["pipeline"]["admitted"] >= len(want)
    else:
        assert tel["swap_preemptions"] > 0 and tel["host_tier"]["swap_ins"] > 0
        for key in ("steps", "preemptions", "swap_preemptions", "pipeline", "host_tier"):
            assert tel[key] == jtel[key], key
    assert eng.cache.allocator.n_free == eng.cache.n_pages
    eng.cache.check_invariant()


def test_sanitized_prefix_rounds_with_host_retire():
    """Prefix matches whose host-retired pages the admission thread stages
    back, forks and retires, under the sanitizer: quiet, and the replayed
    rounds give the first round's tokens."""
    _, _, model, _ = _models()
    tsan.enable()
    try:
        eng = _engine("torch", prefix_sharing=True)
        rng = np.random.default_rng(5)
        base = rng.integers(0, model.cfg.vocab_size, size=(12,)).astype(np.int32)
        prompts = [np.concatenate([base, rng.integers(0, model.cfg.vocab_size, size=(k,))
                                   .astype(np.int32)]) for k in (0, 3, 5)]
        rounds = []
        for rnd in range(3):
            reqs = [tserve.Request(uid=10 * rnd + i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            rounds.append([r.out_tokens for r in reqs])
            with eng._lock:                  # every index page to the host tier
                eng.cache.prefix_retire(eng.cache.n_pages)
    finally:
        tsan.disable()
    assert rounds[0] == rounds[1] == rounds[2]
    pr = eng.telemetry()["prefix"]
    assert pr["hits"] > 0 and pr["retired_pages"] > 0 and pr["restored_pages"] > 0


@pytest.mark.parametrize("name", list(SIDES))
def test_sanitizer_catches_engine_stepped_from_a_second_thread(name):
    """The engine's first pools write binds the decode-loop thread: a step
    from another thread that writes the pools raises, on both engines."""
    san, _own, mod = SIDES[name]
    vocab = _models()[2].cfg.vocab_size
    san.enable()
    try:
        eng = _engine(name, n_pages=7)
        eng.submit(mod.Request(uid=0, prompt=np.arange(5, dtype=np.int32) % vocab,
                               max_new_tokens=8))
        while not eng.sched.running:
            eng.step()
        eng.step()                           # this thread writes the pools
        with pytest.raises(san.SanitizerError, match="two threads"):
            _on_thread(eng.step)
    finally:
        san.disable()
        eng.pipeline.shutdown()


@pytest.mark.parametrize("name", list(SIDES))
def test_sanitizer_catches_decode_loop_entry_from_admission_thread(name):
    san, _own, _mod = SIDES[name]
    san.enable()
    try:
        eng = _engine(name)

        def admission():
            san.register_admission_thread(eng)
            try:
                eng._fill_lanes()
            finally:
                san.unregister_admission_thread(eng)

        with pytest.raises(san.SanitizerError, match="decode_loop_only"):
            _on_thread(admission)
    finally:
        san.disable()
        eng.pipeline.shutdown()
