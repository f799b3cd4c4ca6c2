"""The port's serving engine against the JAX package's, request for request.

Both engines serve the same seeded requests with the same weights (the
JAX ``model.init(jax.random.key(0))`` tree converted by
``repro_torch.convert``), reduced qwen2.5-3b in float32, and must produce
identical greedy tokens in every setting: default paged path, ragged
prompts, chunked prefill, shortest-prompt-first, sync and async admission,
the per-step token budget, recompute preemption on a small pool, and the JAX Pallas paged-decode
kernel (interpret mode) as a second reference.  Both engines run with
``preempt_policy="recompute"`` (swap preemption, the default on both sides,
is held to JAX in ``tests/test_torch_tiered_cache.py``).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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

REPO = Path(__file__).resolve().parents[1]

# name: (engine knobs, request knobs, JAX-only cache knobs)
SETTINGS = {
    "default": (dict(batch_slots=2, max_len=64), dict(), {}),
    "ragged": (dict(batch_slots=3, max_len=64), dict(ragged=True), {}),
    "chunk4": (dict(batch_slots=2, max_len=64, prefill_chunk=4), dict(ragged=True), {}),
    "spf": (dict(batch_slots=2, max_len=64, policy="spf"), dict(ragged=True), {}),
    "sync": (dict(batch_slots=2, max_len=64, async_prefill=False), dict(ragged=True), {}),
    # the token budget: running lanes take their share first, chunks are
    # cut to what is left, a whole prompt waits for a step with budget
    "budget_chunk": (dict(batch_slots=2, max_len=64, prefill_chunk=4, async_prefill=False,
                          max_step_tokens=5), dict(ragged=True), {}),
    "budget_whole": (dict(batch_slots=3, max_len=64, async_prefill=False,
                          max_step_tokens=3), dict(ragged=True), {}),
    # 3 lanes on a 7-page pool of 4-token pages: each request reserves 2
    # pages and grows to 5, so the pool runs dry mid-decode
    "recompute": (dict(batch_slots=3, max_len=32, page_size=4, n_pages=7),
                  dict(n=3, plen=7, max_new=10, seed=7), {}),
    "pallas_ref": (dict(batch_slots=2, max_len=32), dict(n=2, max_new=3),
                   dict(attn_impl="pallas")),
}


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_arch("qwen2.5-3b").reduced(), dtype="float32")
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(dataclasses.replace(get_arch("qwen2.5-3b").reduced(),
                                            dtype="float32"))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model, params


def _reqs(cls, vocab, n=5, plen=6, max_new=4, ragged=False, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, size=(plen + (3 * i if ragged else 0),))
                .astype(np.int32), max_new_tokens=max_new)
            for i in range(n)]


def _split(knobs):
    cache = {k: knobs[k] for k in ("page_size", "n_pages") if k in knobs}
    adm = {k: knobs[k] for k in ("policy", "prefill_chunk", "async_prefill",
                                 "max_step_tokens") if k in knobs}
    top = {k: knobs[k] for k in ("batch_slots", "max_len")}
    return top, cache, adm


@pytest.mark.parametrize("name", list(SETTINGS))
def test_port_engine_matches_jax_engine(models, name):
    jmodel, jparams, model, params = models
    knobs, req_kw, jax_only = SETTINGS[name]
    top, cache, adm = _split(knobs)
    vocab = model.cfg.vocab_size

    jreqs = _reqs(jserve.Request, vocab, **req_kw)
    jeng = jserve.ServeEngine(jmodel, jparams, jserve.EngineConfig(
        **top, cache=jserve.CacheConfig(preempt_policy="recompute", **cache, **jax_only),
        admission=jserve.AdmissionConfig(**adm)))
    for r in jreqs:
        jeng.submit(r)
    jeng.run()

    treqs = _reqs(tserve.Request, vocab, **req_kw)
    teng = tserve.ServeEngine(model, params, tserve.EngineConfig(
        **top, cache=tserve.CacheConfig(preempt_policy="recompute", **cache),
        admission=tserve.AdmissionConfig(**adm)), device="cpu")
    for r in treqs:
        teng.submit(r)
    done = teng.run()

    assert {r.uid: r.out_tokens for r in treqs} == {r.uid: r.out_tokens for r in jreqs}
    assert len(done) == len(treqs) and all(r.done for r in treqs)
    assert teng.cache.allocator.n_free == teng.cache.n_pages     # every page back
    teng.cache.check_invariant()
    if name == "recompute":
        assert teng.sched.n_preemptions > 0 and jeng.sched.n_preemptions > 0
    assert teng.stats["decode_tokens"] + len(treqs) == sum(len(r.out_tokens) for r in treqs)
    if not adm.get("async_prefill", True):
        # inline admission is deterministic: the budget paces both engines
        # through the same steps
        assert teng.stats["steps"] == jeng.stats["steps"]


def test_page_allocator_acquire_release_share_roundtrip():
    alloc = tserve.PageAllocator(16)
    a = alloc.acquire(5)
    b = alloc.acquire(11)
    assert alloc.n_free == 0 and sorted(a + b) == list(range(16))
    assert alloc.acquire(1) is None and alloc.n_free == 0     # dry pool: no side effect
    alloc.share(a[:2])
    assert [alloc.refcount(p) for p in a[:3]] == [2, 2, 1]
    assert sorted(alloc.release(a)) == sorted(a[2:])          # shared pages survive
    assert alloc.n_free == 3 and alloc.refcount(a[0]) == 1
    assert sorted(alloc.release(b + a[:2])) == sorted(b + a[:2])
    assert alloc.n_free == 16
    alloc.check_invariant()
    with pytest.raises(AssertionError, match="double release"):
        alloc.release([3])


def test_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen2.5-3b",
         "--device", "cpu", "--requests", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 requests, 32 tokens" in proc.stdout
