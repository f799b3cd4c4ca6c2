"""The port's prefix sharing (radix index, copy-on-write, host retire)
against the JAX package's.

The cases of ``tests/test_prefix_cache.py``, each on both engines with the
same weights (the JAX ``model.init(jax.random.key(0))`` tree through
``repro_torch.convert``), the same seeded prompts and every family in
float32:

* the refcounted allocator's ownership API gives JAX's refcounts and free
  lists, and every misuse trips an assert;
* serving from indexed resident pages gives the tokens of re-prefilling
  (prefix off) and of the JAX engine, on qwen2.5-3b, deepseek-v3-671b
  (MLA), mamba2-130m (state-snapshot sharing) and recurrentgemma-9b (full
  terminal matches only); in inline (sync) admission the ``prefix``
  counters (hits, misses, hit and lookup tokens, forks, retired, restored
  and dropped pages) equal the JAX engine's;
* a replay's decode writes fork the shared tail page (copy-on-write);
* cold prefix pages retired to the host tier restore bit-exactly;
* a partial hit seeds a chunked prefill from shared pages;
* shared pages survive preemption pressure under the async pipeline;
* per-uid hit tallies do not outlive their request.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import serve as jserve  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

PAGED_FAMILIES = ["qwen2.5-3b", "deepseek-v3-671b", "mamba2-130m", "recurrentgemma-9b"]
PREFIX_KEYS = ("hits", "misses", "hit_tokens", "lookup_tokens", "forks", "retired_pages",
               "restored_pages", "dropped_pages")


@functools.lru_cache(maxsize=None)
def _family(arch):
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype="float32",
                               decode_unroll_layers=False)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return cfg, jmodel, jparams, build_model(cfg), params


def _engine(mod, arch, prefix, host_pages=None, n_pages=24, lanes=2, page_size=4,
            max_len=64, chunk=0, async_prefill=False, swap_token_cost=0.25):
    _, jmodel, jparams, model, params = _family(arch)
    ecfg = mod.EngineConfig(
        batch_slots=lanes, max_len=max_len,
        cache=mod.CacheConfig(page_size=page_size, n_pages=n_pages, host_pages=host_pages,
                              prefix_sharing=prefix, swap_token_cost=swap_token_cost),
        admission=mod.AdmissionConfig(prefill_chunk=chunk, async_prefill=async_prefill))
    if mod is jserve:
        return jserve.ServeEngine(jmodel, jparams, ecfg)
    return tserve.ServeEngine(model, params, ecfg, device="cpu")


def _prompts(cfg, n=2, plen=10, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(plen + i,)).astype(np.int32)
            for i in range(n)]


def _serve_rounds(eng, mod, rounds, max_new=5, retire_between=False):
    """Serve each round to completion before the next (insertion into the
    index is deterministic, so later rounds' repeats are resident matches);
    with ``retire_between`` every index page goes to the host tier before
    each later round."""
    out = {}
    uid = 0
    for i, prompts in enumerate(rounds):
        if i and retire_between:
            with eng._lock:
                before = len(eng.cache.prefix.by_page)
                freed = eng.cache.prefix_retire(eng.cache.n_pages)
            if eng.cache.prefix.has_seq:
                assert before > 0 and freed == before
                assert not eng.cache.prefix.by_page     # all device refs gone
        for p in prompts:
            eng.submit(mod.Request(uid=uid, prompt=p, max_new_tokens=max_new))
            uid += 1
        done = eng.run()
        out.update({r.uid: list(r.out_tokens) for r in done})
    return out


def _pair(arch, rounds, **kw):
    """(port tokens, port engine, JAX tokens, JAX telemetry) of one run."""
    retire = kw.pop("retire_between", False)
    max_new = kw.pop("max_new", 5)
    jeng = _engine(jserve, arch, True, **kw)
    want = _serve_rounds(jeng, jserve, rounds, max_new, retire)
    teng = _engine(tserve, arch, True, **kw)
    got = _serve_rounds(teng, tserve, rounds, max_new, retire)
    return got, teng, want, jeng.telemetry()


def _prefix_counters_equal(teng, jtel):
    tel = teng.telemetry()
    for k in PREFIX_KEYS:
        assert tel["prefix"][k] == jtel["prefix"][k], k
    assert tel["prefix"]["hit_rate"] == pytest.approx(jtel["prefix"]["hit_rate"])
    for k in ("prefill_tokens", "decode_tokens", "steps", "max_request_prefix_hit_tokens"):
        assert tel[k] == jtel[k], k
    if "host_tier" in jtel:
        assert tel["host_tier"] == jtel["host_tier"]


# ---------------------------------------------------------------------------
# Allocator ownership API (host-side units)
# ---------------------------------------------------------------------------


def _both(n):
    return tserve.PageAllocator(n), jserve.PageAllocator(n)


def _same(a, b):
    assert a.refs == b.refs and a._free == b._free
    a.check_invariant()
    b.check_invariant()


def test_release_frees_only_at_zero():
    t, j = _both(6)
    for alloc in (t, j):
        pages = alloc.acquire(3)
        alloc.share(pages)                       # refcount 2 each
        assert alloc.release(pages) == []        # co-owner survives
        assert alloc.n_free == 3
        assert sorted(alloc.release(pages)) == sorted(pages)
        assert alloc.n_free == 6
    _same(t, j)


def test_double_release_trips():
    alloc = tserve.PageAllocator(4)
    pages = alloc.acquire(2)
    alloc.release(pages)
    with pytest.raises(AssertionError, match="double release"):
        alloc.release([pages[0]])
    alloc.check_invariant()


def test_share_after_free_trips():
    alloc = tserve.PageAllocator(4)
    (p,) = alloc.acquire(1)
    alloc.release([p])
    with pytest.raises(AssertionError, match="shared while free"):
        alloc.share([p])
    alloc.check_invariant()


def test_fork_then_release_ordering():
    t, j = _both(4)
    for alloc in (t, j):
        (p,) = alloc.acquire(1)
        alloc.share([p])                         # two owners
        q = alloc.fork_for_write(p)              # owner A goes private
        assert q != p and alloc.refcount(p) == 1 and alloc.refcount(q) == 1
        assert alloc.fork_for_write(q) == q      # sole owner forks in place
    _same(t, j)
    for alloc in (t, j):
        assert alloc.release([0]) == [0]         # the other owner frees the original
        assert alloc.release([1]) == [1]
        assert alloc.n_free == 4
    _same(t, j)


def test_fork_exhaustion_leaves_ownership_intact():
    t, j = _both(2)
    for alloc in (t, j):
        pages = alloc.acquire(2)
        alloc.share([pages[0]])
        assert alloc.fork_for_write(pages[0]) is None     # pool can't cover it
        assert alloc.refcount(pages[0]) == 2              # nothing leaked
    _same(t, j)
    for alloc in (t, j):
        alloc.release([0, 1])
        alloc.release([0])
        assert alloc.n_free == 2
    _same(t, j)


def test_random_ownership_sequence_matches_jax():
    rng = np.random.default_rng(1)
    t, j = _both(16)
    for _ in range(400):
        live = sorted(t.refs)
        op = int(rng.integers(4))
        if op == 0:
            n = int(rng.integers(1, 4))
            assert t.acquire(n) == j.acquire(n)
        elif live and op == 1:
            p = [int(rng.choice(live))]
            t.share(p)
            j.share(p)
        elif live and op == 2:
            p = [int(rng.choice(live))]
            assert t.release(p) == j.release(p)
        elif live:
            p = int(rng.choice(live))
            assert t.fork_for_write(p) == j.fork_for_write(p)
        _same(t, j)


# ---------------------------------------------------------------------------
# Token identity: cached-prefix serving == re-prefill serving == JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PAGED_FAMILIES)
def test_prefix_on_off_token_identical(arch):
    cfg = _family(arch)[0]
    a, b = _prompts(cfg, 2)
    rounds = [[a, b], [a, a, b], [a]]        # seeding round, then replays
    off = _serve_rounds(_engine(tserve, arch, False), tserve, rounds)
    got, eng, want, jtel = _pair(arch, rounds)
    assert got == off == want
    tel = eng.telemetry()
    # the replays hit the index (full-terminal matches work on every
    # family; the ssm shares the state snapshot, not pages)
    assert tel["prefix"]["hits"] >= 4
    assert tel["prefix"]["hit_rate"] > 0.0
    _prefix_counters_equal(eng, jtel)
    eng.cache.check_invariant()
    # every page released by retired requests; index references remain
    held_by_index = len(eng.cache.prefix.by_page)
    assert eng.cache.allocator.n_free == eng.cache.n_pages - held_by_index
    assert eng.prefix_match_tokens(a) == len(a)


def test_cow_fork_preserves_cached_content():
    """A replayed prompt's decode writes land in a forked tail page, never in
    the shared one: a third replay still matches bit for bit."""
    arch = "qwen2.5-3b"
    (a,) = _prompts(_family(arch)[0], 1)     # plen 10 on ps 4: a sub-page tail
    off = _serve_rounds(_engine(tserve, arch, False), tserve, [[a], [a], [a]])
    got, eng, want, jtel = _pair(arch, [[a], [a], [a]])
    assert got == off == want
    tel = eng.telemetry()
    assert tel["prefix"]["forks"] >= 2       # each replay forked its tail
    assert tel["prefix"]["hits"] >= 2
    _prefix_counters_equal(eng, jtel)
    eng.cache.check_invariant()


# ---------------------------------------------------------------------------
# Host-tier retire / restore round trip (bit-exact per family)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PAGED_FAMILIES)
def test_prefix_retire_restore_bit_exact(arch):
    a, b = _prompts(_family(arch)[0], 2)
    rounds = [[a, b], [a, b]]
    off = _serve_rounds(_engine(tserve, arch, False), tserve, rounds)
    got, eng, want, jtel = _pair(arch, rounds, host_pages=32, retire_between=True)
    assert got == off == want
    tel = eng.telemetry()
    assert tel["prefix"]["hits"] >= 2
    if eng.cache.prefix.has_seq:
        assert tel["prefix"]["retired_pages"] > 0
        assert tel["prefix"]["restored_pages"] > 0
        assert tel["host_tier"]["device_gets"] > 0 and tel["host_tier"]["pages_in"] > 0
    _prefix_counters_equal(eng, jtel)
    eng.cache.check_invariant()


# ---------------------------------------------------------------------------
# Partial hits: a chunked prefill seeded from shared pages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v3-671b"])
def test_partial_prefix_hit_seeds_chunked_prefill(arch):
    """Prompts sharing a 12-token system prefix with their own tails: the
    later ones claim 8 matched tokens (page- and chunk-aligned, short of the
    last token) and extend from there."""
    cfg = _family(arch)[0]
    rng = np.random.default_rng(9)
    system = rng.integers(0, cfg.vocab_size, size=(12,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, size=(n,))])
               .astype(np.int32) for n in (3, 6, 1, 9)]
    rounds = [prompts[:1], prompts[1:]]
    kw = dict(chunk=4, n_pages=40, lanes=3)
    off_eng = _engine(tserve, arch, False, **kw)
    off = _serve_rounds(off_eng, tserve, rounds)
    got, eng, want, jtel = _pair(arch, rounds, **kw)
    assert got == off == want
    tel = eng.telemetry()
    assert tel["prefix"]["hits"] == 3 and tel["prefix"]["hit_tokens"] == 3 * 12
    assert (off_eng.stats["prefill_tokens"] - eng.stats["prefill_tokens"]) == 3 * 12
    _prefix_counters_equal(eng, jtel)
    eng.cache.check_invariant()


# ---------------------------------------------------------------------------
# Preemption pressure with shared pages (cross-thread stress)
# ---------------------------------------------------------------------------


def _pressure_stress(mod, prefix, n=8, seed=3):
    """Duplicate-heavy arrivals on a pool sized to run dry mid-decode:
    preemption, restore, copy-on-write forks and index reclaim all fire
    while the admission pipeline races the decode loop."""
    cfg = _family("qwen2.5-3b")[0]
    eng = _engine(mod, "qwen2.5-3b", prefix, n_pages=9, lanes=3, max_len=32, chunk=3,
                  async_prefill=True, swap_token_cost=0.0)
    rng = np.random.default_rng(seed)
    bases = [rng.integers(0, cfg.vocab_size, size=(7 + k,)).astype(np.int32) for k in range(2)]
    reqs = [mod.Request(uid=i, prompt=bases[i % 2], max_new_tokens=9) for i in range(n)]
    i, step = 0, 0
    while i < len(reqs) or eng.load:
        if i < len(reqs) and step % 2 == 0:
            eng.submit(reqs[i])
            i += 1
        eng.step()
        if prefix and mod is tserve:
            _partition_ok(eng)
        step += 1
    eng.pipeline.shutdown()
    return {r.uid: list(r.out_tokens) for r in reqs}, eng


def _partition_ok(eng):
    with eng._lock:
        s = eng.sched
        alloc = eng.cache.allocator
        held = []
        for st in list(s.waiting) + list(s.admitting) + list(s.ready) + list(s.running.values()):
            held.extend(st.pages)
        counts: dict[int, int] = {}
        for p in held + list(eng.cache.prefix.by_page):
            counts[p] = counts.get(p, 0) + 1
        for p, c in counts.items():
            assert c <= alloc.refcount(p), (
                f"page {p} held by {c} owners with refcount {alloc.refcount(p)}")
        eng.cache.check_invariant()


def _index_host_pages(prefix) -> int:
    """Host pages the prefix index holds (its nodes' and terminals' retired
    copies, resident on the device again or not)."""
    held, stack = 0, [prefix.root]
    while stack:
        node = stack.pop()
        held += sum(t.host_page is not None for t in node.terminals.values())
        for child in node.children.values():
            held += child.host_page is not None
            stack.append(child)
    return held


def test_shared_pages_survive_preemption_pressure():
    want, _ = _pressure_stress(jserve, prefix=True)
    off, _ = _pressure_stress(tserve, prefix=False)
    got, eng = _pressure_stress(tserve, prefix=True)
    assert got == off == want
    assert eng.sched.n_preemptions > 0       # the pressure fired
    # drained: only the index still owns pages, and the partition closes
    held_by_index = len(eng.cache.prefix.by_page)
    assert eng.cache.allocator.n_free == eng.cache.n_pages - held_by_index
    # and the host tier holds only the index's retired copies
    assert eng.cache.host.allocator.n_free == eng.cache.host.n_pages - _index_host_pages(
        eng.cache.prefix)
    eng.cache.check_invariant()


# ---------------------------------------------------------------------------
# Telemetry + the retire contract
# ---------------------------------------------------------------------------


def test_prefix_telemetry_and_uid_counter_retire():
    (a,) = _prompts(_family("qwen2.5-3b")[0], 1)
    got, eng, want, jtel = _pair("qwen2.5-3b", [[a], [a, a]])
    assert got == want
    tel = eng.telemetry()
    assert tel["prefix"]["hit_rate"] > 0.5       # replays dominate lookups
    assert tel["prefix"]["hit_tokens"] == 2 * len(a)
    # the high-water mark survives request retirement...
    assert tel["max_request_prefix_hit_tokens"] == len(a)
    # ...the per-uid tallies do not
    assert eng.sched.prefix_hit_tokens_by_uid == {}
    assert not eng.sched.running and not eng.sched.admitting
    _prefix_counters_equal(eng, jtel)
    # off: no index, no signal
    assert _engine(tserve, "qwen2.5-3b", False).prefix_match_tokens(a) == 0
