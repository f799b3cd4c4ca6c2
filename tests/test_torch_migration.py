"""Inter-cube migration in the port's engine against the JAX package's: the
cases of ``tests/test_cube_proc.py``'s in-process half, on both engines with
the same weights (the JAX ``model.init(jax.random.key(0))`` tree through
``repro_torch.convert``) and the same seeded requests, in inline admission:

* a request exported mid-decode, put through the wire format and a pickle,
  and landed on another engine by put-then-signal finishes with the
  uninterrupted run's tokens and JAX's migration run's, for the four paged
  families (attention, MLA in float32, SSD, RG-LRU), with the receiver's
  ``migrate.*`` counters and both engines' ``host.*`` counters equal to
  JAX's;
* a JAX ``export_request`` payload, converted by
  ``convert.payload_from_numpy`` and landed on a port engine, finishes with
  JAX's tokens;
* without a host tier the put degrades to the fresh path, tokens unchanged;
  an uncommitted put is never adopted; an absent request exports nothing and
  a waiting one a fresh payload;
* shadow checkpoints leave the primary running and can be adopted once
  committed; ``drop_shadow`` gives the host pages back; ``inflight_uids``
  follows the queues;
* the pools keep their storage (``data_ptr``) through a landed migration and
  an adoption, as the captured decode step needs;
* under the sanitizer, the wire functions (``@cube_transport``) move
  payloads freely and may not drive the decode loop.

Reduced configs, torch on one intra-op thread.
"""
import dataclasses
import functools
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import serve as jserve  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import cube_proc as jproc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.analysis import sanitizer  # noqa: E402
from repro_torch.analysis.ownership import cube_transport  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.serve.cube_proc import pack_payload, unpack_payload  # noqa: E402

PAGED_FAMILIES = ["qwen2.5-3b", "deepseek-v3-671b", "mamba2-130m", "recurrentgemma-9b"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _family(arch):
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype="float32",
                               decode_unroll_layers=False)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return cfg, jmodel, jparams, build_model(cfg), params


def _ecfg(mod, **cache):
    kw = dict(page_size=4, n_pages=16, preempt_policy="swap", swap_token_cost=0.0)
    kw.update(cache)
    return mod.EngineConfig(batch_slots=2, max_len=32, cache=mod.CacheConfig(**kw),
                            admission=mod.AdmissionConfig(async_prefill=False))


def _reqs(mod, cfg, n=3, plen=7, max_new=10, seed=7):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=(plen,)).astype(np.int32),
                        max_new_tokens=max_new) for i in range(n)]


def _engine(arch, **cache):
    cfg, _, _, model, params = _family(arch)
    return tserve.ServeEngine(model, params, _ecfg(tserve, **cache), device="cpu")


def _jengine(arch, **cache):
    _, jmodel, jparams, _, _ = _family(arch)
    return jserve.ServeEngine(jmodel, jparams, _ecfg(jserve, **cache))


def _drain(eng):
    while eng.load or eng.pending_migrations():
        eng.step()
    return {r.uid: list(r.out_tokens) for r in eng.completed}


def _running_uid(eng) -> int:
    return next(u for u in eng.inflight_uids()
                if any(s.req.uid == u for s in eng.sched.running.values()))


def _started(eng, mod, arch, steps=6):
    for r in _reqs(mod, _family(arch)[0]):
        eng.submit(r)
    for _ in range(steps):                    # mid-decode: progress, nobody done
        eng.step()
    return eng


@functools.lru_cache(maxsize=None)
def _baseline(arch):
    eng = _engine(arch)
    for r in _reqs(tserve, _family(arch)[0]):
        eng.submit(r)
    eng.run()
    return {r.uid: list(r.out_tokens) for r in eng.completed}


def _ptrs(eng) -> dict:
    return {path: t.data_ptr() for path, t in tree_items(eng.cache.pools)}


# ---------------------------------------------------------------------------
# export → wire → put-then-signal → resume, held to JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", PAGED_FAMILIES)
def test_migrate_resume_matches_jax_all_families(arch):
    # JAX's migration run; its payload also lands on a third, port engine
    ja, jb = _started(_jengine(arch), jserve, arch), _jengine(arch)
    juid = _running_uid(ja)
    jpayload = ja.export_request(juid)
    assert jpayload["kind"] == "pages"
    jb.migrate_put("m0", jproc.unpack_payload(jproc.pack_payload(jpayload)))
    jb.migrate_signal("m0")
    jgot = {**_drain(ja), **_drain(jb)}

    a, b = _started(_engine(arch), tserve, arch), _engine(arch)
    uid = _running_uid(a)
    assert uid == juid
    payload = a.export_request(uid)
    assert payload is not None and payload["kind"] == "pages"   # swap_token_cost=0
    assert uid not in a.inflight_uids()
    assert payload["length"] == jpayload["length"] and payload["n_pages"] == jpayload["n_pages"]
    assert payload["out_tokens"] == jpayload["out_tokens"]
    # the payload crosses the process boundary through the wire format
    payload = unpack_payload(pickle.loads(pickle.dumps(pack_payload(payload))))
    before = _ptrs(b)
    assert b.migrate_put("m0", payload) == "pages"
    b.migrate_signal("m0")
    assert b.pending_migrations() == 1
    got = {**_drain(a), **_drain(b)}
    assert got == _baseline(arch) == jgot
    assert _ptrs(b) == before                 # restored in place

    tb, jtb = b.telemetry(), jb.telemetry()
    assert tb["migrations"] == jtb["migrations"]
    assert tb["migrations"]["resumed"] == 1
    for eng, jeng in ((a, ja), (b, jb)):
        assert eng.telemetry()["host_tier"] == jeng.telemetry()["host_tier"]
        assert eng.cache.allocator.n_free == eng.cache.n_pages
        assert eng.cache.host.allocator.n_free == eng.cache.host.n_pages

    # a JAX payload converted to the port's layout lands and finishes as JAX's
    c = _engine(arch)
    assert c.migrate_put("j0", convert.payload_from_numpy(jpayload)) == "pages"
    c.migrate_signal("j0")
    assert _drain(c) == {juid: jgot[juid]}


def test_payload_layouts_carry_over():
    """The converted JAX payload has the port's keys, paths, shapes and
    dtypes, seq and state, on the hybrid (both kinds of leaf)."""
    arch = "recurrentgemma-9b"
    ja, a = _started(_jengine(arch), jserve, arch), _started(_engine(arch), tserve, arch)
    uid = _running_uid(a)
    want, got = a.checkpoint_request(uid), convert.payload_from_numpy(ja.checkpoint_request(uid))
    assert set(want) == set(got)
    for key in ("seq", "state"):
        assert want[key].keys() == got[key].keys()
        for path, t in want[key].items():
            assert (t.shape, t.dtype) == (got[key][path].shape, got[key][path].dtype)


def test_migrate_fresh_fallback_without_host_tier():
    arch = "qwen2.5-3b"
    a = _started(_engine(arch), tserve, arch)
    # no host tier on the receiver: the pages payload degrades to the
    # recompute restart, token-identical under greedy decoding
    b = _engine(arch, preempt_policy="recompute")
    assert b.cache.host is None
    payload = unpack_payload(pack_payload(a.export_request(_running_uid(a))))
    assert payload["kind"] == "pages"
    assert b.migrate_put("m0", payload) == "fresh"
    b.migrate_signal("m0")
    assert {**_drain(a), **_drain(b)} == _baseline(arch)
    assert b.telemetry()["migrations"]["fresh_fallbacks"] == 1


def test_migrate_uncommitted_put_is_never_adopted():
    arch = "qwen2.5-3b"
    a, b = _started(_engine(arch), tserve, arch), _engine(arch)
    b.migrate_put("m0", a.export_request(_running_uid(a)))
    # the sender "died" before the signal: the landed bytes stay invisible
    assert b.pending_migrations() == 0
    assert b.poll_migrations() == 0
    assert b.load == 0
    assert b.telemetry()["migrations"]["pending"] == 1
    with pytest.raises(KeyError):
        b.migrate_signal("missing-token")
    # a second put under the same token frees the first's host pages
    held = b.cache.host.n_pages - b.cache.host.allocator.n_free
    b.migrate_put("m0", a.checkpoint_request(_running_uid(a)))
    assert b.cache.host.n_pages - b.cache.host.allocator.n_free <= held + 1


def test_export_request_absent_and_waiting():
    arch = "qwen2.5-3b"
    eng = _engine(arch)
    assert eng.export_request(99) is None
    req = _reqs(tserve, _family(arch)[0], n=1)[0]
    eng.submit(req)                       # still waiting: a fresh payload
    payload = eng.export_request(req.uid)
    assert payload["kind"] == "fresh"
    assert eng.load == 0
    assert np.array_equal(payload["prompt"], req.prompt)


# ---------------------------------------------------------------------------
# shadow checkpoints: non-destructive primary, adoptable backup
# ---------------------------------------------------------------------------


def test_shadow_checkpoint_nondestructive_and_adoptable():
    arch = "qwen2.5-3b"
    want = _baseline(arch)
    a, b = _started(_engine(arch), tserve, arch), _engine(arch)
    uid = _running_uid(a)
    payload = a.checkpoint_request(uid)
    assert payload is not None and payload["kind"] == "pages"
    assert uid in a.inflight_uids()       # a checkpoint never withdraws
    before = _ptrs(b)
    b.shadow_put(uid, unpack_payload(pack_payload(payload)))
    assert not b.adopt_shadow(uid)        # the put landed, not yet committed
    b.shadow_signal(uid)
    assert b.adopt_shadow(uid)
    assert not b.adopt_shadow(uid)        # consumed
    # the primary finishes the whole stream; the backup reproduces its part
    assert _drain(a) == want
    assert _drain(b)[uid] == want[uid]
    assert _ptrs(b) == before             # the adoption restored in place


def test_drop_shadow_returns_host_pages():
    arch = "qwen2.5-3b"
    a, b = _started(_engine(arch), tserve, arch), _engine(arch)
    uid = _running_uid(a)
    free0 = b.cache.host.allocator.n_free
    b.shadow_put(uid, a.checkpoint_request(uid))
    b.shadow_signal(uid)
    assert b.cache.host.allocator.n_free < free0
    assert b.telemetry()["migrations"]["shadows"] == 1
    b.drop_shadow(uid)
    assert b.cache.host.allocator.n_free == free0
    b.drop_shadow(uid)                    # idempotent


def test_inflight_uids_tracks_queues():
    arch = "qwen2.5-3b"
    eng = _engine(arch)
    assert eng.inflight_uids() == []
    reqs = _reqs(tserve, _family(arch)[0])
    for r in reqs:
        eng.submit(r)
    assert eng.inflight_uids() == [r.uid for r in reqs]
    eng.run()
    assert eng.inflight_uids() == []


# ---------------------------------------------------------------------------
# the wire layer under the sanitizer
# ---------------------------------------------------------------------------


def test_cube_transport_moves_bytes_and_never_drives_the_decode_loop():
    arch = "qwen2.5-3b"
    was = sanitizer.enabled()
    sanitizer.enable()
    try:
        a, b = _started(_engine(arch), tserve, arch), _engine(arch)
        wired = pack_payload(a.export_request(_running_uid(a)))
        b.migrate_put("m0", unpack_payload(wired))    # landing is engine work
        b.migrate_signal("m0")

        @cube_transport
        def rogue():
            b.poll_migrations()

        with pytest.raises(sanitizer.SanitizerError, match="cube-transport"):
            rogue()
        assert not sanitizer.in_transport()
        assert {**_drain(a), **_drain(b)} == _baseline(arch)
    finally:
        if not was:
            sanitizer.disable()
