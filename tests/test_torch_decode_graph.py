"""The serving engine's static-buffer decode step (``serve.captured``) and
its drop-mode write (``kernels.ops.paged_write``) against the JAX package,
on the CPU, where the engine runs the step it captures on the card on the
same buffers, without the capture.

* ``paged_write``'s plain version equals the reference's
  ``pool.at[:, page, off].set(rows, mode="drop")`` (idle lanes and
  unallocated pages sent to the above-pool sentinel, as
  ``repro.serve.paged_cache.absorb_decode`` does) computed with ``jnp`` on
  the same seeded pools, bit for bit: idle lanes, ``-1`` pages, a page
  past the pool, several pools with a layers dimension, bf16 and float32;
* the static-buffer engine gives the JAX engine's tokens, request for
  request, for the dense (qwen2.5-3b), ssm (mamba2-130m), hybrid
  (recurrentgemma-9b) and moe (deepseek-v3-671b with MLA, in float32: the
  JAX package's bf16 MLA does not run on this CPU) families, on the paged
  and the gather decode paths (``tests/test_torch_moe_serve.py`` holds
  qwen3-moe-235b-a22b's engine, MoE with GQA, to JAX's);
* no decode step reads the device back: a ``TorchDispatchMode`` around
  every ``_decode_impl`` call of those runs and of qwen3-moe-235b-a22b's
  records ``aten.nonzero``,
  ``aten._local_scalar_dense`` (``item``, ``int``, ``bool`` of a tensor),
  ``aten.masked_select``, ``aten.equal`` and explicit copies to the CPU
  (on the CPU a device-to-host copy shows only as a ``_to_copy`` to it),
  and finds none.  The kernels' plain versions run outside the mode: their
  CPU host reads are not on the card's path;
* every pool leaf keeps its storage (``data_ptr``) through swap and
  recompute preemption on the 7-page cell of
  ``tests/test_torch_tiered_cache.py`` and through prefix copy-on-write
  forks, a host retire and restores, as a captured graph needs.

Reduced configs, torch on one intra-op thread (as ``tests/test_torch_obs.py``).
"""
import dataclasses
import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402

FAMILIES = ["qwen2.5-3b", "mamba2-130m", "recurrentgemma-9b", "deepseek-v3-671b",
            "qwen3-moe-235b-a22b"]
PATHS = ["paged", "gather"]
# the forced-preemption cell of tests/test_tiered_cache.py
PRESSURE = dict(batch_slots=3, max_len=32, page_size=4, n_pages=7)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) paged_write's plain version = the reference's drop-mode scatter
# ---------------------------------------------------------------------------


def _bits(a: np.ndarray, dtype: str):
    """(JAX array, torch tensor) of the same values in ``dtype``, bf16 by
    its bits (numpy has no bf16 torch takes)."""
    j = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    if dtype == "bfloat16":
        return j, torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(torch.bfloat16)
    return j, torch.from_numpy(np.asarray(j).copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_write_plain_equals_jax_drop_scatter(dtype):
    rng = np.random.default_rng(0)
    lanes, slots, ps, n_pages = 6, 4, 4, 10
    # three pools: k-like (2 layers, 2 x 8 rows), a latent (1 layer, 16),
    # a 3-layer rank-1 row; every pool shares the table
    shapes = [(2, n_pages, ps, 2, 8), (1, n_pages, ps, 16), (3, n_pages, ps, 5)]
    bt = np.full((lanes, slots), -1, np.int32)   # -1: unallocated
    bt[0, :1] = [3]
    bt[1, :2] = [5, 7]
    bt[2, :3] = [8, 9, 1]                        # an idle lane: writes nothing
    bt[3, :] = [2, 4, 6, 0]
    bt[4, :2] = [n_pages - 1, n_pages + 3]       # a page past the pool: dropped
    bt[5, :3] = [n_pages - 2, n_pages - 3, n_pages - 4]   # lane 5's slot 3 is -1
    positions = np.array([0, 5, 9, 15, 6, 13], np.int64)
    active = np.array([True, True, False, True, True, True])
    pages = bt[np.arange(lanes), positions // ps]
    assert (active & (pages >= 0) & (pages < n_pages)).sum() == 3   # lanes 0, 1, 3 write
    jpools, tpools, jrows, trows = [], [], [], []
    for shape in shapes:
        jp, tp = _bits(rng.standard_normal(shape).astype(np.float32), dtype)
        jr, tr = _bits(rng.standard_normal((shape[0], lanes) + shape[3:]).astype(np.float32),
                       dtype)
        jpools.append(jp)
        tpools.append(tp)
        jrows.append(jr)
        trows.append(tr)
    before = [t.clone() for t in tpools]
    ops.paged_write(tpools, trows, torch.from_numpy(bt), torch.from_numpy(positions),
                    torch.from_numpy(active))
    jbt, jpos, jact = jnp.asarray(bt), jnp.asarray(positions), jnp.asarray(active)
    page = jnp.take_along_axis(jbt, (jpos // ps)[:, None], axis=1)[:, 0]
    page = jnp.where(jact & (page >= 0), page, n_pages)       # the drop sentinel
    for jp, jr, tp, tb in zip(jpools, jrows, tpools, before):
        want = jp.at[:, page, jpos % ps].set(jr, mode="drop")
        got = tp.view(torch.uint16).numpy() if dtype == "bfloat16" else tp.numpy()
        exp = np.asarray(want).view(np.uint16) if dtype == "bfloat16" else np.asarray(want)
        assert np.array_equal(got, exp)
        changed = (tp != tb).reshape(tp.shape[0], n_pages, ps, -1).any(-1).any(0)
        assert int(changed.sum()) <= 3


def test_paged_write_refuses_mismatched_rows():
    pool = torch.zeros(1, 4, 2, 8)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    pos, act = torch.zeros(2, dtype=torch.long), torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError):
        ops.paged_write([pool], [torch.zeros(1, 3, 8)], bt, pos, act)       # 3 lanes of 2
    with pytest.raises(ValueError):
        ops.paged_write([pool], [torch.zeros(1, 2, 8, dtype=torch.bfloat16)], bt, pos, act)
    with pytest.raises(ValueError):
        ops.paged_write([pool], [torch.zeros(1, 2, 8)], bt, pos, act.long())


def test_paged_write_refuses_more_pools_than_one_launch_takes():
    """A list longer than one launch's pool table is refused on the CPU as on
    the card, so no caller relies on a split the kernel does not make."""
    bt = torch.zeros(2, 2, dtype=torch.int32)
    pos, act = torch.zeros(2, dtype=torch.long), torch.ones(2, dtype=torch.bool)
    n = ops.PAGED_WRITE_POOLS
    pools = [torch.zeros(1, 4, 2, 8) for _ in range(n + 1)]
    rows = [torch.ones(1, 2, 8) for _ in range(n + 1)]
    with pytest.raises(ValueError):
        ops.paged_write(pools, rows, bt, pos, act)
    assert not any(p.any() for p in pools)
    ops.paged_write(pools[:n], rows[:n], bt, pos, act)
    assert all(bool(p[0, 0, 0].eq(1).all()) for p in pools[:n])


# ---------------------------------------------------------------------------
# (b), (d) the static-buffer engine: JAX's tokens, no host read in a step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _family(arch):
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype="float32",
                               decode_unroll_layers=False)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return cfg, jmodel, jparams, build_model(cfg), params


def _prompts(cfg):
    """Three prompts of one length (the JAX engine compiles its prefill per
    length) for two lanes: the third waits for a lane."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, cfg.vocab_size, size=(7,)).astype(np.int32) for _ in range(3)]


def _ecfg(mod, path="paged", **cache):
    return mod.EngineConfig(batch_slots=2, max_len=32,
                            cache=mod.CacheConfig(page_size=4, decode_path=path, **cache),
                            admission=mod.AdmissionConfig(async_prefill=False))


def _serve(eng, mod, prompts, max_new=6):
    reqs = [mod.Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch):
    cfg, jmodel, jparams, _, _ = _family(arch)
    return _serve(jserve.ServeEngine(jmodel, jparams, _ecfg(jserve)), jserve, _prompts(cfg))


# host reads a decode step must not make (on the card each stalls the step
# and breaks a graph capture)
HOST_READS = ("aten.nonzero", "aten._local_scalar_dense", "aten.masked_select", "aten.equal")


class _HostReads(TorchDispatchMode):
    """Records the host reads of the ops dispatched while it is on and not
    paused."""

    def __init__(self):
        super().__init__()
        self.paused = 0
        self.seen: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            name = str(func.overloadpacket)
            to_host = name == "aten._to_copy" and str(kwargs.get("device")) == "cpu"
            if name in HOST_READS or to_host:
                self.seen.append(name)
        return func(*args, **kwargs)


def _paused(mode, fn):
    @functools.wraps(fn)
    def call(*a, **k):
        mode.paused += 1
        try:
            return fn(*a, **k)
        finally:
            mode.paused -= 1
    return call


@functools.lru_cache(maxsize=None)
def _port_run(arch, path):
    """The port's tokens on ``path`` and the host reads recorded inside
    every ``_decode_impl`` call of the run (the plain kernel versions
    paused)."""
    cfg, _, _, model, params = _family(arch)
    eng = tserve.ServeEngine(model, params, _ecfg(tserve, path), device="cpu")
    mode = _HostReads()
    impl, calls = eng._decode_impl, []

    def guarded(*a, **k):
        calls.append(1)
        with mode:
            return impl(*a, **k)

    eng._decode_impl = guarded
    originals = {n: f for n, f in vars(ref).items()
                 if inspect.isfunction(f) and f.__module__ == ref.__name__}
    try:
        for n, f in originals.items():
            setattr(ref, n, _paused(mode, f))
        toks = _serve(eng, tserve, _prompts(cfg))
    finally:
        for n, f in originals.items():
            setattr(ref, n, f)
    assert calls and eng.decode_graph.graph is None and eng.decode_graph.runs == len(calls)
    return toks, tuple(mode.seen)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", FAMILIES[:4])
def test_static_step_tokens_match_jax(arch, path):
    assert _port_run(arch, path)[0] == _jax_tokens(arch)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_impl_reads_nothing_back(arch, path):
    assert _port_run(arch, path)[1] == ()


def test_host_read_guard_sees_a_nonzero():
    """The guard itself: a step that picks its writing lanes with
    ``nonzero`` (the plain write, unpaused) is caught."""
    mode = _HostReads()
    pool = torch.zeros(1, 4, 2, 8)
    with mode:
        ref.paged_write([pool], [torch.ones(1, 2, 8)], torch.zeros(2, 2, dtype=torch.int32),
                        torch.zeros(2, dtype=torch.long), torch.ones(2, dtype=torch.bool))
        int(pool.sum())
    assert "aten.nonzero" in mode.seen and "aten._local_scalar_dense" in mode.seen


# ---------------------------------------------------------------------------
# (c) the pools keep their storage through preemption and prefix sharing
# ---------------------------------------------------------------------------


def _ptrs(eng) -> dict:
    return {path: t.data_ptr() for path, t in tree_items(eng.cache.pools)}


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-9b"])
@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_pools_keep_storage_under_preemption(arch, policy):
    cfg, _, _, model, params = _family(arch)
    p = dict(PRESSURE)
    ecfg = tserve.EngineConfig(
        batch_slots=p.pop("batch_slots"), max_len=p.pop("max_len"),
        cache=tserve.CacheConfig(**p, preempt_policy=policy, swap_token_cost=0.0),
        admission=tserve.AdmissionConfig(async_prefill=False))
    eng = tserve.ServeEngine(model, params, ecfg, device="cpu")
    before = _ptrs(eng)
    rng = np.random.default_rng(7)
    _serve(eng, tserve, [rng.integers(0, cfg.vocab_size, size=(7,)).astype(np.int32)
                         for _ in range(3)], max_new=12)
    n = eng.sched.n_swap_preemptions if policy == "swap" else eng.sched.n_recompute_preemptions
    assert n > 0
    assert _ptrs(eng) == before


def test_pools_keep_storage_through_prefix_forks_retire_and_restore():
    arch = "qwen2.5-3b"
    cfg, _, _, model, params = _family(arch)
    ecfg = _ecfg(tserve, prefix_sharing=True, n_pages=24, host_pages=32)
    eng = tserve.ServeEngine(model, params, ecfg, device="cpu")
    before = _ptrs(eng)
    a, b = _prompts(cfg)[:2]                      # 7 tokens on 4-token pages: a sub-page tail
    _serve(eng, tserve, [a, b], max_new=5)
    with eng._lock:
        assert eng.cache.prefix_retire(eng.cache.n_pages) > 0
    _serve(eng, tserve, [a, b, a], max_new=5)
    tel = eng.telemetry()
    assert tel["prefix"]["forks"] > 0 and tel["prefix"]["retired_pages"] > 0
    assert tel["prefix"]["restored_pages"] > 0
    assert _ptrs(eng) == before


def test_reallocated_pools_refuse_the_step():
    """The step checks the pools it was built over: new tensors in their
    place raise instead of decoding into stale buffers."""
    _, _, _, model, params = _family("qwen2.5-3b")
    eng = tserve.ServeEngine(model, params, _ecfg(tserve), device="cpu")
    eng.cache.pools = [{k: {n: t.clone() for n, t in v.items()} for k, v in seg.items()}
                       for seg in eng.cache.pools]
    with pytest.raises(RuntimeError, match="reallocated"):
        eng.decode_graph(eng.cache.pools)
