"""The port's host tier and swap preemption against the JAX package's.

The cases of ``tests/test_tiered_cache.py`` (but the two mesh-sharding
ones: the port has no mesh), each on both engines with the same weights
(the JAX ``model.init(jax.random.key(0))`` tree through
``repro_torch.convert``) and the same seeded requests, every family in
float32 (the JAX package's bf16 MLA does not run on this container's CPU):

* swap == recompute == the gather path, token for token, on qwen2.5-3b,
  deepseek-v3-671b (MLA), mamba2-130m (ssm state only) and
  recurrentgemma-9b (RG-LRU state + local attention pages), and equal to
  the JAX engine's tokens;
* in inline (sync) admission the preemption counts, every ``host.*``
  counter and the ``host.swap_bytes`` histogram equal the JAX engine's
  telemetry, step for step;
* a swap captures and restores a lane's recurrent state bit for bit
  (``torch.equal``);
* a second preemption copies only the dirty pages, host-tier exhaustion
  and an adverse cost model fall back to recompute, and both tiers' free
  lists come back full.
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
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.serve.paged_cache import _is_seq  # noqa: E402

# the forced-preemption cell of tests/test_tiered_cache.py: 3 lanes on a
# 7-page pool of page_size 4 — every request reserves 2 pages and grows past
# them, so the pool runs dry mid-decode
PRESSURE = dict(batch_slots=3, max_len=32, page_size=4, n_pages=7)
PAGED_FAMILIES = ["qwen2.5-3b", "deepseek-v3-671b", "mamba2-130m", "recurrentgemma-9b"]


@functools.lru_cache(maxsize=None)
def _family(arch):
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype="float32",
                               decode_unroll_layers=False)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return cfg, jmodel, jparams, build_model(cfg), params


def _prompts(cfg, n=3, plen=7, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(plen,)).astype(np.int32) for _ in range(n)]


def _cfg(mod, batch_slots, max_len, async_prefill=False, **cache):
    return mod.EngineConfig(batch_slots=batch_slots, max_len=max_len,
                            cache=mod.CacheConfig(**cache),
                            admission=mod.AdmissionConfig(async_prefill=async_prefill))


def _serve(eng, mod, prompts, max_new=12):
    reqs = [mod.Request(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return {r.uid: list(r.out_tokens) for r in reqs}


@functools.lru_cache(maxsize=None)
def _jax_run(arch, knobs):
    """The JAX engine's tokens and telemetry for one config (inline
    admission: deterministic counters), cached across tests."""
    cfg, jmodel, jparams, _, _ = _family(arch)
    eng = jserve.ServeEngine(jmodel, jparams, _cfg(jserve, **dict(knobs)))
    toks = _serve(eng, jserve, _prompts(cfg))
    return toks, eng.telemetry(), eng.stats


def _port_run(arch, async_prefill=False, **knobs):
    cfg, _, _, model, params = _family(arch)
    eng = tserve.ServeEngine(model, params, _cfg(tserve, async_prefill=async_prefill, **knobs),
                             device="cpu")
    return _serve(eng, tserve, _prompts(cfg)), eng


def _k(**kw):
    return tuple(sorted(kw.items()))


def _assert_counters_equal(teng, jtel):
    tel = teng.telemetry()
    for key in ("preemptions", "swap_preemptions", "recompute_preemptions",
                "max_request_preemptions", "prefill_tokens", "decode_tokens", "steps"):
        assert tel[key] == jtel[key], key
    assert ("host_tier" in tel) == ("host_tier" in jtel)
    if "host_tier" in tel:
        assert tel["host_tier"] == jtel["host_tier"]
        hb, jb = tel["histograms"].get("host.swap_bytes"), jtel["histograms"].get("host.swap_bytes")
        assert (hb is None) == (jb is None)
        if hb is not None:
            assert hb["counts"] == jb["counts"] and hb["sum"] == jb["sum"]


def _drained(eng):
    assert eng.cache.allocator.n_free == eng.cache.n_pages
    if eng.cache.host is not None:
        assert eng.cache.host.allocator.n_free == eng.cache.host.n_pages
    eng.cache.check_invariant()


# ---------------------------------------------------------------------------
# The acceptance bar: swap == recompute == gather == JAX, per family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PAGED_FAMILIES)
def test_swap_matches_recompute_and_gather_under_pressure(arch):
    rec_k = _k(**PRESSURE, preempt_policy="recompute")
    swp_k = _k(**PRESSURE, preempt_policy="swap", swap_token_cost=0.0)
    want, jtel_rec, _ = _jax_run(arch, rec_k)
    jswap, jtel_swp, _ = _jax_run(arch, swp_k)
    assert jswap == want
    got_rec, e_rec = _port_run(arch, **dict(rec_k))
    got_swp, e_swp = _port_run(arch, **dict(swp_k))
    got_gat, e_gat = _port_run(arch, **dict(swp_k), decode_path="gather")
    assert got_rec == got_swp == got_gat == want
    assert e_rec.sched.n_recompute_preemptions > 0
    assert e_swp.sched.n_swap_preemptions > 0 and e_swp.sched.n_recompute_preemptions == 0
    assert e_gat.sched.n_swap_preemptions > 0
    assert e_rec.cache.host is None
    for eng in (e_rec, e_swp, e_gat):
        _drained(eng)
    # swap preemption never re-runs prefill: exactly the 3 submitted 7-token
    # prompts are prefilled once each, while recompute re-prefills victims
    assert e_swp.stats["prefill_tokens"] == 3 * 7
    assert e_rec.stats["prefill_tokens"] > e_swp.stats["prefill_tokens"]
    # inline admission: the same steps, preemptions and host-tier traffic as JAX
    _assert_counters_equal(e_rec, jtel_rec)
    _assert_counters_equal(e_swp, jtel_swp)
    _assert_counters_equal(e_gat, jtel_swp)
    host = e_swp.telemetry()["host_tier"]
    assert host["swap_ins"] == host["swap_outs"] == e_swp.sched.n_swap_preemptions
    if e_swp.cache._has_seq_leaves():
        assert host["bytes_out"] > 0 and host["bytes_in"] > host["bytes_out"] // 2
    else:                       # mamba2: no pages to move, only the lane state
        assert host["bytes_out"] == host["bytes_in"] == 0


def test_swap_async_admission_matches_jax():
    """The worker thread stages the restores: the same tokens."""
    swp_k = _k(**PRESSURE, preempt_policy="swap", swap_token_cost=0.0)
    want, _, _ = _jax_run("qwen2.5-3b", swp_k)
    got, eng = _port_run("qwen2.5-3b", async_prefill=True, **dict(swp_k))
    assert got == want
    assert eng.sched.n_swap_preemptions > 0
    assert eng.telemetry()["pipeline"]["restores_staged"] > 0
    _drained(eng)


def test_unpressured_baseline_matches_swap():
    base, e0 = _port_run("qwen2.5-3b", batch_slots=1, max_len=32, page_size=4, n_pages=16)
    assert e0.sched.n_preemptions == 0
    jbase, _, _ = _jax_run("qwen2.5-3b", _k(batch_slots=1, max_len=32, page_size=4,
                                            n_pages=16))
    got, _ = _port_run("qwen2.5-3b", **PRESSURE, preempt_policy="swap", swap_token_cost=0.0)
    assert base == got == jbase


# ---------------------------------------------------------------------------
# Recurrent lane state (ssm / RG-LRU) rides the swap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_swap_roundtrips_recurrent_lane_state_bitexact(arch):
    cfg, _, _, model, params = _family(arch)
    cache = tserve.PagedKVCache(model, lanes=2, n_pages=8, page_size=4, max_len=32,
                                device="cpu", host_pages=8)
    assert cache.has_state_leaves()
    prompt = np.asarray([5, 9, 2, 7, 11], np.int32)
    _, pc = model.prefill(params, torch.as_tensor(prompt, dtype=torch.long)[None])
    pages = cache.acquire(len(prompt) + 1)
    cache.write_prefill(pages, pc, lane=0)
    cache.assign_lane(0, pages)
    before = {path: x.clone() for path, x in tree_items(cache.pools)}

    handle = cache.swap_out(pages, lane=0, length=len(prompt))
    assert handle is not None and handle.state is not None
    # scramble the freed pages and the lane row (as a new tenant would)
    for _, x in tree_items(cache.pools):
        if x.is_floating_point():
            x.add_(1.0)
    cache.allocator.release(pages)
    cache.clear_lane(0)

    new_pages = cache.allocator.acquire(len(handle.host_pages))
    state = cache.swap_in(handle, new_pages)
    assert state is not None
    cache.assign_lane(1, new_pages)
    cache.write_state(1, state)
    for path, a in tree_items(cache.pools):
        b = before[path]
        if _is_seq(path):
            for lp, pp in zip(pages, new_pages):
                assert torch.equal(b[:, lp], a[:, pp]), path
        else:
            assert torch.equal(b[:, 0], a[:, 1]), path   # lane 0 -> lane 1
    counters = cache.host.stats
    assert counters["swap_outs"] == counters["swap_ins"] == 1
    cache.host_free(handle)
    assert cache.host.allocator.n_free == cache.host.n_pages


# ---------------------------------------------------------------------------
# Dirty-page bookkeeping: double preemption of the same request
# ---------------------------------------------------------------------------


def test_double_preemption_reuses_clean_host_pages():
    swp_k = _k(**PRESSURE, preempt_policy="swap", swap_token_cost=0.0)
    want, jtel, _ = _jax_run("qwen2.5-3b", swp_k)
    got, eng = _port_run("qwen2.5-3b", **dict(swp_k))
    assert want == got
    # per-uid counters are cleared on retire; the high-water mark survives
    assert eng.sched.preemptions_by_uid == {}
    assert eng.sched.max_preemptions_per_request >= 2
    assert eng.telemetry()["max_request_preemptions"] == jtel["max_request_preemptions"]
    # the second swap-out skipped the still-clean full pages...
    assert eng.cache.host.stats["dirty_pages_skipped"] > 0
    # ...so fewer pages went out than came back in
    assert eng.cache.host.stats["pages_out"] < eng.cache.host.stats["pages_in"]
    assert eng.cache.host.stats == jtel["host_tier"]


# ---------------------------------------------------------------------------
# Fallbacks: host-tier exhaustion and the cost model
# ---------------------------------------------------------------------------


def test_host_tier_exhaustion_falls_back_to_recompute():
    want, _, _ = _jax_run("qwen2.5-3b", _k(**PRESSURE, preempt_policy="recompute"))
    knobs = _k(**PRESSURE, preempt_policy="swap", swap_token_cost=0.0, host_pages=1)
    jgot, jtel, _ = _jax_run("qwen2.5-3b", knobs)
    got, eng = _port_run("qwen2.5-3b", **dict(knobs))
    assert want == got == jgot
    assert eng.sched.n_swap_preemptions == 0
    assert eng.sched.n_recompute_preemptions > 0
    assert eng.cache.host.stats["exhausted_fallbacks"] > 0
    _assert_counters_equal(eng, jtel)
    # a failed swap holds no host pages
    assert eng.cache.host.allocator.n_free == eng.cache.host.n_pages


def test_adverse_cost_model_prefers_recompute():
    want, _, _ = _jax_run("qwen2.5-3b", _k(**PRESSURE, preempt_policy="recompute"))
    knobs = _k(**PRESSURE, preempt_policy="swap", swap_token_cost=1e9)
    jgot, jtel, _ = _jax_run("qwen2.5-3b", knobs)
    got, eng = _port_run("qwen2.5-3b", **dict(knobs))
    assert want == got == jgot
    assert eng.sched.n_swap_preemptions == 0
    assert eng.sched.n_recompute_preemptions > 0
    _assert_counters_equal(eng, jtel)


def test_recompute_policy_allocates_no_host_tier():
    _, _, _, model, params = _family("qwen2.5-3b")
    eng = tserve.ServeEngine(model, params, _cfg(tserve, 1, 32, preempt_policy="recompute"),
                             device="cpu")
    assert eng.cache.host is None
    assert eng.telemetry()["host_page_occupancy"] == 0.0
    assert "host_tier" not in eng.telemetry()
    # the swap default takes a host tier of twice the device pool, pinning
    # nothing until a page is first copied out
    eng = tserve.ServeEngine(model, params, _cfg(tserve, 1, 32), device="cpu")
    assert eng.cache.host.n_pages == 2 * eng.cache.n_pages
    assert eng.cache.host._buffers is None


def test_telemetry_layout_matches_jax():
    swp_k = _k(**PRESSURE, preempt_policy="swap", swap_token_cost=0.0)
    _, jtel, jstats = _jax_run("qwen2.5-3b", swp_k)
    _, eng = _port_run("qwen2.5-3b", **dict(swp_k))
    tel = eng.telemetry()
    assert set(tel) == set(jtel) | {"device"}
    assert tel["migrations"] == jtel["migrations"]
    assert set(tel["pipeline"]) == set(jtel["pipeline"])
    assert tel["pipeline"] == jtel["pipeline"]
    assert set(tel["histograms"]) == set(jtel["histograms"])
    assert tel["decode_idle_fraction"] == pytest.approx(jtel["decode_idle_fraction"])
    assert eng.stats.keys() == jstats.keys()
    assert eng.stats["occupancy_sum"] == pytest.approx(jstats["occupancy_sum"])
    eng.reset_stats()
    zero = eng.telemetry()
    assert zero["steps"] == 0 and not any(zero["host_tier"].values())


# ---------------------------------------------------------------------------
# Cost model and policy checks (no model)
# ---------------------------------------------------------------------------


class _StubCache:
    page_size = 4


def _running_state(mod, plen, out_tokens, n_pages, clean=0):
    req = mod.Request(uid=0, prompt=np.zeros(plen, np.int32))
    req.out_tokens = list(range(out_tokens))
    st = mod.RequestState(req=req, resume_tokens=np.zeros(plen, np.int32),
                          pages=list(range(n_pages)), lane=0)
    if clean:
        st.swap_handle = mod.SwapHandle(host_pages=list(range(n_pages)), clean_pages=clean)
    return st


@pytest.mark.parametrize("cost", [0.0, 0.25, 1.0])
def test_cost_model_pages_vs_tokens(cost):
    s = tserve.Scheduler(tserve.SchedulerConfig(swap_token_cost=cost))
    js = jserve.Scheduler(jserve.SchedulerConfig(swap_token_cost=cost))
    cache = _StubCache()
    for plen, out, pages, clean in ((16, 15, 4, 0), (2, 2, 2, 0), (16, 15, 4, 3), (8, 1, 3, 2),
                                    (4, 12, 4, 1)):
        got = s.swap_beats_recompute(_running_state(tserve, plen, out, pages, clean), cache)
        want = js.swap_beats_recompute(_running_state(jserve, plen, out, pages, clean), cache)
        assert got == want, (plen, out, pages, clean)
    if cost == 0.25:
        assert s.swap_beats_recompute(_running_state(tserve, 16, 15, 4), cache)
        assert not s.swap_beats_recompute(_running_state(tserve, 2, 2, 2), cache)


def test_pick_victim_matches_jax():
    picks = []
    for mod in (tserve, jserve):
        s = mod.Scheduler(mod.SchedulerConfig())
        for lane, out in enumerate((3, 9, 9, 1)):
            st = _running_state(mod, 4, out, 2)
            st.lane = lane
            st.req.uid = lane
            s.running[lane] = st
        picks.append([getattr(s.pick_victim(exclude_lane=x), "lane", None) for x in (1, 2, -1)])
    assert picks[0] == picks[1]


def test_scheduler_rejects_unknown_preempt_policy():
    with pytest.raises(ValueError):
        tserve.Scheduler(tserve.SchedulerConfig(preempt_policy="discard"))
    with pytest.raises(ValueError):
        jserve.Scheduler(jserve.SchedulerConfig(preempt_policy="discard"))


def test_engine_rejects_unknown_preempt_policy():
    _, _, _, model, params = _family("qwen2.5-3b")
    with pytest.raises(ValueError):
        tserve.ServeEngine(model, params, _cfg(tserve, 1, 32, preempt_policy="discard"),
                           device="cpu")
