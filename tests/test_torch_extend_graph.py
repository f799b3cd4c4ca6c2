"""The chunked-prefill step the card captures (``serve.captured.CapturedExtend``)
against the JAX package, on the CPU, where the engine runs the captured step
on the same static buffers, without the capture.

* ``flash_attention``'s plain version (and the wrapper's CPU path) with
  ``q_offset`` and ``kv_len`` as 0-d tensors (the kernel's device-offset
  form) gives the int form's bits at several offsets, with and without a
  window, with finite garbage in the rows past ``kv_len``;
* ``DecoderLM.extend_step`` with a 0-d tensor ``position`` gives the int
  form's logits and cache bits, and JAX's ``extend_step`` within the
  extend tests' atol = rtol = 1e-4, for the dense (qwen2.5-3b), ssm
  (mamba2-130m) and hybrid (recurrentgemma-9b) families;
* the slot engine with ``prefill_chunk`` (prompts with full chunks and a
  tail) gives the JAX engine's tokens for those families, in inline and in
  async admission;
* slot bookkeeping: no more slots in use than ``admission_inflight``; every
  slot back after the run, after swap and recompute preemptions taken
  while prefills were in flight, and after partial prefix hits seeded into
  slots; a request served after a longer one on the one slot gives the
  tokens it gives alone (the slot was zeroed);
* the static-buffer extend reads nothing back (``_HostReads`` of
  ``tests/test_torch_decode_graph.py`` around every static step);
* ``EngineConfig``'s flat keywords warn, route and fail as the reference's.

Reduced configs in float32, torch on one intra-op thread.
"""
import dataclasses
import functools
import inspect
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_torch_decode_graph import _HostReads, _paused  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_items, tree_map  # noqa: E402
from repro_torch.serve import captured  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

FAMILIES = ["qwen2.5-3b", "mamba2-130m", "recurrentgemma-9b"]
TOL = dict(atol=1e-4, rtol=1e-4)
CHUNK = 8
# two full chunks and a tail, a tail only, two full chunks, one and a tail
LENGTHS = (21, 5, 16, 13)


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


def _prompts(cfg, lengths=LENGTHS, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32) for n in lengths]


def _ecfg(mod, async_prefill=False, inflight=2, **cache):
    return mod.EngineConfig(batch_slots=2, max_len=48,
                            cache=mod.CacheConfig(page_size=4, **cache),
                            admission=mod.AdmissionConfig(prefill_chunk=CHUNK,
                                                          async_prefill=async_prefill,
                                                          admission_inflight=inflight))


def _serve(eng, mod, prompts, max_new=6):
    reqs = [mod.Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs]


# ---------------------------------------------------------------------------
# flash_attention's device-offset form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_offset,window", [(0, None), (8, None), (12, None), (20, None),
                                             (12, 6), (20, 16)])
def test_plain_flash_tensor_offsets_bit_equal_to_ints(q_offset, window):
    """A chunk of 8 queries at ``q_offset`` against a 48-row cache whose rows
    past ``kv_len`` hold finite garbage, as a slot's rows do after the
    warm-up: the tensor form (an int32 pair's halves, the wrapper's CPU
    path too) gives the int form's bits."""
    g = torch.Generator().manual_seed(q_offset)
    q = torch.randn(1, 4, 8, 32, generator=g)
    k, v = (torch.randn(1, 2, 48, 32, generator=g) for _ in range(2))
    kv_len = q_offset + 8
    want = ref.flash_attention(q, k, v, window=window, q_offset=q_offset, kv_len=kv_len)
    pair = torch.tensor([q_offset, kv_len], dtype=torch.int32)
    for qo, kl in ((pair[0], pair[1]), (torch.tensor(q_offset), torch.tensor(kv_len))):
        assert torch.equal(ref.flash_attention(q, k, v, window=window, q_offset=qo, kv_len=kl),
                           want)
        assert torch.equal(ops.flash_attention(q, k, v, window=window, q_offset=qo,
                                               kv_len=kl), want)


def test_flash_offset_forms_refused_and_paired():
    """A 1-d, float or misplaced offset tensor is refused on the CPU as on
    the card; the halves of one int32 pair go to the kernel as that pair's
    storage, anything else as a pair built from them."""
    q = torch.zeros(1, 2, 4, 32)
    k = torch.zeros(1, 2, 16, 32)
    for bad in (torch.tensor([4]), torch.tensor(4.0), torch.tensor(True)):
        with pytest.raises(ValueError, match="0-d integer"):
            ops.flash_attention(q, k, k, q_offset=bad, kv_len=8)
    pair = torch.tensor([4, 8], dtype=torch.int32)
    assert ops._offset_pair(pair[0], pair[1], 16, pair.device).data_ptr() == pair.data_ptr()
    built = ops._offset_pair(torch.tensor(4), None, 16, pair.device)
    assert built.dtype == torch.int32 and built.tolist() == [4, 16]


# ---------------------------------------------------------------------------
# extend_step with the position on the device
# ---------------------------------------------------------------------------


def _zeros(model, cap):
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype), model.cache_specs(1, cap))


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): leaf
            for path, leaf in flat}


@pytest.mark.parametrize("arch", FAMILIES)
def test_extend_step_tensor_position_bit_equal_and_held_to_jax(arch):
    cfg, jmodel, jparams, model, params = _family(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(1, 21)).astype(np.int32)
    cap = 32
    by_int, by_tensor = _zeros(model, cap), _zeros(model, cap)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jmodel.cache_specs(1, cap))
    for start, stop in ((0, 8), (8, 16), (16, 21)):
        chunk = torch.from_numpy(toks[:, start:stop]).long()
        want, by_int = model.extend_step(params, by_int, chunk, start)
        got, by_tensor = model.extend_step(params, by_tensor, chunk,
                                           torch.tensor(start, dtype=torch.int64))
        assert torch.equal(got, want)
        jlogits, jcache = jmodel.extend_step(jparams, jcache, jnp.asarray(toks[:, start:stop]),
                                             jnp.asarray(start, jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), **TOL)
    jc = _jax_paths(jcache)
    for (path, a), (_, b) in zip(tree_items(by_tensor), tree_items(by_int)):
        assert torch.equal(a, b), path
        np.testing.assert_allclose(a.float().numpy(), np.asarray(jc[path], np.float32), **TOL)
    # last_only: the last position's row, the head over that one row (a
    # product of another shape, so summed in another order: within TOL)
    chunk = torch.from_numpy(toks[:, :8]).long()
    full, _ = model.extend_step(params, _zeros(model, cap), chunk, torch.tensor(0))
    last, _ = model.extend_step(params, _zeros(model, cap), chunk, torch.tensor(0),
                                last_only=True)
    assert last.shape == (1, 1, full.shape[-1])
    torch.testing.assert_close(last[:, 0], full[:, -1], **TOL)


# ---------------------------------------------------------------------------
# the slot engine against the JAX engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch):
    cfg, jmodel, jparams, _, _ = _family(arch)
    return _serve(jserve.ServeEngine(jmodel, jparams, _ecfg(jserve)), jserve, _prompts(cfg))


@pytest.mark.parametrize("async_prefill", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_slot_engine_tokens_match_jax(arch, async_prefill):
    cfg, _, _, model, params = _family(arch)
    eng = tserve.ServeEngine(model, params, _ecfg(tserve, async_prefill), device="cpu")
    assert _serve(eng, tserve, _prompts(cfg)) == _jax_tokens(arch)
    slots = eng.prefill_slots
    assert slots.graphs == [None, None] and slots.in_use == 0
    # 21 + 16 + 13 tokens: 2 + 2 + 1 full chunks, and three 5-token tails
    assert slots.runs == 5 and slots.eager_runs == 3


# ---------------------------------------------------------------------------
# slot bookkeeping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("async_prefill", [False, True])
def test_slots_in_use_never_exceed_admission_inflight(async_prefill):
    """Eight prompts through 3 slots.  The decode loop writes a finished
    prefill into the pages slowly here, after the request has left the
    ready queue (which the admission bound counts): in async admission the
    pipeline admits meanwhile and waits for that slot to come back."""
    cfg, _, _, model, params = _family("qwen2.5-3b")
    eng = tserve.ServeEngine(model, params, _ecfg(tserve, async_prefill, inflight=3),
                             device="cpu")
    slots = eng.prefill_slots
    assert len(slots.trees) == 3
    held, take = [], slots.take

    def counted_take():
        slot = take()
        held.append(slots.in_use)
        return slot

    slots.take = counted_take
    write = eng.cache.write_prefill

    def slow_write(*a, **k):
        time.sleep(0.05)
        return write(*a, **k)

    eng.cache.write_prefill = slow_write
    _serve(eng, tserve, _prompts(cfg, (21, 13, 17, 9, 30, 11, 25, 12)))
    assert len(held) == 8 and 2 <= max(held) <= 3 and slots.in_use == 0


@pytest.mark.parametrize("policy", ["swap", "recompute"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-9b"])
def test_slots_come_back_through_preemption(arch, policy):
    """The forced-preemption cell (3 lanes on 7 pages of 4 tokens) with
    4-token chunks: lanes are evicted while other requests hold slots in
    mid-prefill, recompute victims prefill again into a slot, and every
    slot comes back; the tokens are the unpressured engine's."""
    cfg, _, _, model, params = _family(arch)
    prompts = _prompts(cfg, (7, 7, 7, 9, 6))

    def engine(**cache):
        return tserve.ServeEngine(model, params, tserve.EngineConfig(
            batch_slots=3, max_len=32, cache=tserve.CacheConfig(page_size=4, **cache),
            admission=tserve.AdmissionConfig(prefill_chunk=4, async_prefill=False)),
            device="cpu")

    eng = engine(n_pages=7, preempt_policy=policy, swap_token_cost=0.0)
    held, batch = [], eng.sched.preempt_batch

    def preempt_batch(victims, cache):
        held.append(eng.prefill_slots.in_use)
        return batch(victims, cache)

    eng.sched.preempt_batch = preempt_batch
    toks = _serve(eng, tserve, prompts, max_new=12)
    n = eng.sched.n_swap_preemptions if policy == "swap" else eng.sched.n_recompute_preemptions
    assert n > 0 and max(held) > 0
    assert eng.prefill_slots.in_use == 0
    assert toks == _serve(engine(), tserve, prompts, max_new=12)


def test_partial_prefix_hit_seeds_a_slot():
    cfg, _, _, model, params = _family("qwen2.5-3b")
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, size=(12,)).astype(np.int32)
    prompts = [shared] + [np.concatenate([shared, rng.integers(0, cfg.vocab_size, size=(
        n,)).astype(np.int32)]) for n in (3, 9)]
    got = {}
    for sharing in (True, False):
        eng = tserve.ServeEngine(model, params, _ecfg(tserve, prefix_sharing=sharing),
                                 device="cpu")
        seeded, seed = [], eng.cache.seed_prefix

        def seed_prefix(tree, pages, seed=seed, seeded=seeded, eng=eng):
            seeded.append(any(tree is t for t in eng.prefill_slots.trees))
            return seed(tree, pages)

        eng.cache.seed_prefix = seed_prefix
        got[sharing] = [_serve(eng, tserve, [p]) for p in prompts]
        assert eng.prefill_slots.in_use == 0
        if sharing:
            assert seeded and all(seeded)
            assert eng.telemetry()["prefix"]["hit_tokens"] > 0
    assert got[True] == got[False]


@pytest.mark.parametrize("arch", FAMILIES)
def test_slot_is_zeroed_between_requests(arch):
    """One slot: a 5-token request served after a 30-token one gives the
    prefill logits and tokens it gives alone (recurrent states and cache
    rows start from zero)."""
    cfg, _, _, model, params = _family(arch)
    long, short = _prompts(cfg, (30, 5), seed=11)

    def engine():
        eng = tserve.ServeEngine(model, params, _ecfg(tserve, inflight=1), device="cpu")
        rows, sample = [], eng.sample_prefill_token

        def sample_prefill_token(st):
            rows.append(st.last_logits.clone())
            return sample(st)

        eng.sample_prefill_token = sample_prefill_token
        return eng, rows

    eng, rows = engine()
    assert len(eng.prefill_slots.trees) == 1
    _serve(eng, tserve, [long])
    assert any(bool(t.any()) for _, t in tree_items(eng.prefill_slots.trees[0]))
    toks = _serve(eng, tserve, [short])
    alone, alone_rows = engine()
    assert toks == _serve(alone, tserve, [short])
    assert torch.equal(rows[-1], alone_rows[-1])
    assert eng.prefill_slots.in_use == 0


def test_slot_refuses_a_reallocated_tree_and_a_second_take():
    _, _, _, model, params = _family("qwen2.5-3b")
    eng = tserve.ServeEngine(model, params, _ecfg(tserve, inflight=1), device="cpu")
    slots = eng.prefill_slots
    slot = slots.take()
    with pytest.raises(RuntimeError, match="no free prefill slot"):
        slots.take()
    toks = np.zeros(CHUNK, np.int32)
    slots(slot, slots.trees[slot], params, toks, 0)
    moved = tree_map(torch.clone, slots.trees[slot])
    with pytest.raises(RuntimeError, match="reallocated"):
        slots(slot, moved, params, toks, CHUNK)
    slots.release(slot)
    with pytest.raises(RuntimeError, match="released twice"):
        slots.release(slot)


@pytest.mark.parametrize("arch", FAMILIES)
def test_static_extend_reads_nothing_back(arch):
    """Every static-buffer extend of a chunked run under ``_HostReads``,
    the plain kernel versions paused: no host read."""
    cfg, _, _, model, params = _family(arch)
    eng = tserve.ServeEngine(model, params, _ecfg(tserve), device="cpu")
    mode, slots = _HostReads(), eng.prefill_slots
    run, calls = slots._run, []

    def guarded(*a, **k):
        calls.append(1)
        with mode:
            return run(*a, **k)

    slots._run = guarded
    originals = {n: f for n, f in vars(ref).items()
                 if inspect.isfunction(f) and f.__module__ == ref.__name__}
    try:
        for n, f in originals.items():
            setattr(ref, n, _paused(mode, f))
        _serve(eng, tserve, _prompts(cfg))
    finally:
        for n, f in originals.items():
            setattr(ref, n, f)
    assert len(calls) == 5 and mode.seen == []


def test_moe_family_runs_every_chunk_eagerly_on_slots():
    """The moe family's extend reads the device back (its trimmed
    dispatch): its slots run every chunk eagerly, and nothing is captured."""
    arch = "qwen3-moe-235b-a22b"
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    eng = tserve.ServeEngine(model, params, _ecfg(tserve), device="cpu")
    _serve(eng, tserve, _prompts(cfg, (21, 5)))
    slots = eng.prefill_slots
    assert not slots.static and slots.runs == 0 and slots.eager_runs == 4
    assert slots.in_use == 0
    with pytest.raises(ValueError, match="static"):
        captured.CapturedExtend(None, params, model.cache_specs(1, 8), 1, CHUNK, 4,
                                torch.float32, torch.device("cpu"), static=False, capture=True)


# ---------------------------------------------------------------------------
# EngineConfig's flat keyword shim against the reference's
# ---------------------------------------------------------------------------


def _flat(mod, warned, **kw):
    """``mod.EngineConfig(**kw)`` with a fresh once-per-knob memory: the
    config, and the (category, text) of each warning it gave."""
    warned.clear()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        ecfg = mod.EngineConfig(**kw)
    return ecfg, [(w.category, str(w.message)) for w in seen]


FLAT = dict(page_size=4, n_pages=9, preempt_policy="recompute", prefill_chunk=8,
            async_prefill=False, admission_inflight=3, trace=True)


def test_engine_config_flat_keywords_as_the_reference(monkeypatch):
    monkeypatch.setattr(jengine, "_warned_flat", set())
    monkeypatch.setattr(tengine, "_warned_flat", set())
    jcfg, jw = _flat(jserve, jengine._warned_flat, batch_slots=3, **FLAT)
    tcfg, tw = _flat(tserve, tengine._warned_flat, batch_slots=3, **FLAT)
    assert tw == jw and len(tw) == len(FLAT)
    assert all(c is DeprecationWarning for c, _ in tw)
    for k, v in FLAT.items():
        assert getattr(tcfg, k) == getattr(jcfg, k) == v
    assert tcfg.cache.page_size == 4 and tcfg.admission.prefill_chunk == 8 and tcfg.obs.trace
    # once per knob: a second config warns about nothing already warned
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        tserve.EngineConfig(page_size=8)
    assert not seen
    # the flat names read and write their group; replace routes them
    tcfg.n_pages = 11
    assert tcfg.cache.n_pages == 11
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        t2 = dataclasses.replace(tcfg, n_pages=8)
        j2 = dataclasses.replace(jcfg, n_pages=8)
    assert t2.cache.n_pages == j2.cache.n_pages == 8 and t2.cache.page_size == 4
    assert t2.admission == tcfg.admission and t2.batch_slots == 3
    # cuda_graph stays a top-level field
    assert "cuda_graph" in {f.name for f in dataclasses.fields(tserve.EngineConfig)}
    assert tserve.EngineConfig(cuda_graph=False).cuda_graph is False
    for mod in (jserve, tserve):
        with pytest.raises(TypeError) as err:
            mod.EngineConfig(pages=4)
        assert str(err.value) == "EngineConfig got an unexpected keyword argument 'pages'"
