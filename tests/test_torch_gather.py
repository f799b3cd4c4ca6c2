"""The port's gather decode path against the JAX package, on the CPU.

The gather path (``CacheConfig.decode_path="gather"``) gathers the page
pools into dense per-lane views (``paged_gather``), steps the dense
``decode_step`` and folds the written column back (``absorb_decode``): the
oracle the paged path is held against.  Weights are the JAX
``model.init(jax.random.key(0))`` tree converted by ``repro_torch.convert``,
reduced qwen2.5-3b and mamba2-130m in float32.

* the plain ``paged_gather`` is bit-equal to JAX ``ops.paged_gather``
  (Pallas, interpret mode) and ``ref.paged_gather``, with -1 holes;
* ``paged_gather_many`` (plain) over pools of mixed types, row widths and
  leading dims is bit-equal to one ``paged_gather`` per pool and to JAX
  ``ops.paged_gather`` per pool and layer; ``paged_lane_views`` equals
  ``paged_lane_view`` per pool and JAX's ``paged_lane_view``;
* ``gather_views`` and ``absorb_decode`` are bit-equal to JAX's on both
  families' pools (seq leaves and per-lane state leaves);
* ``decode_step`` logits and caches match JAX at atol = rtol = 1e-4;
* with ``decode_path="gather"`` the port's engine gives the JAX gather
  engine's tokens and the port's own paged-path tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import paged_cache as jpc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.serve.paged_cache import absorb_decode, gather_views  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["qwen2.5-3b", "mamba2-130m"]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype="float32",
                               decode_unroll_layers=False)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(dataclasses.replace(get_arch(arch).reduced(), dtype="float32"))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model, params


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): leaf
            for path, leaf in flat}


def _random_tree(specs, rng):
    """{path: float32 numpy array} for a tree of shape specs."""
    return {path: rng.standard_normal(s.shape).astype(np.float32)
            for path, s in tree_items(specs)}


def _nest(flat, as_tensor):
    """{path: array} → the nested list/dict tree, leaves as torch tensors
    (own copies) or JAX arrays."""
    out: list = []
    for path, a in flat.items():
        node = out
        for k, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= k:
                    node.append({})
                node = node[k]
            else:
                node = node.setdefault(k, {})
        node[path[-1]] = torch.from_numpy(a.copy()) if as_tensor else jnp.asarray(a)
    return out


def _assert_trees_equal(tree, jtree):
    jl = _jax_paths(jtree)
    for path, t in tree_items(tree):
        assert np.array_equal(t.numpy(), np.asarray(jl[path])), path


# a table with -1 tails, a -1 hole inside lane 1 and an idle lane 2
TABLE = np.array([[3, 7, -1, -1], [0, -1, 9, 2], [-1, -1, -1, -1]], np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_paged_gather_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    pool = jnp.asarray(rng.standard_normal((12, 40)), jdt)     # (n_pages, page row)
    bt = jnp.asarray(TABLE)
    tpool = torch.from_numpy(np.array(pool, np.float32)).to(getattr(torch, dtype))
    got = tops.paged_gather(tpool, torch.from_numpy(TABLE))
    assert got.dtype == tpool.dtype and got.shape == (3, 4, 40)
    for want in (jops.paged_gather(pool, bt, interpret=True), jref.paged_gather(pool, bt)):
        assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert torch.all(got[2] == 0) and torch.all(got[1, 1] == 0)
    # a leading layers dim gathers every layer in one call
    layered = torch.stack([tpool, -tpool, 2 * tpool])
    got3 = tops.paged_gather(layered, torch.from_numpy(TABLE))
    for i in range(3):
        assert torch.equal(got3[i], tops.paged_gather(layered[i], torch.from_numpy(TABLE)))


# (leading dims, n_pages, row, dtype): an MLA layer's latent and k_rope
# rows, a 2-layer leaf, and rows that are no multiple of 16 bytes
MANY = [((), 12, 64, "bfloat16"), ((), 12, 8, "bfloat16"), ((2,), 12, 40, "float32"),
        ((), 12, 7, "int16"), ((3,), 12, 13, "int32")]


def _many_pools(rng):
    """(JAX arrays, torch tensors) of the ``MANY`` pools."""
    jpools, tpools = [], []
    for lead, n, f, dt in MANY:
        a = rng.standard_normal(lead + (n, f)) * 100
        j = jnp.asarray(a, jnp.float32).astype(getattr(jnp, dt))
        jpools.append(j)
        tpools.append(torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dt)))
    return jpools, tpools


def test_plain_paged_gather_many_bit_equal_to_jax():
    jpools, tpools = _many_pools(np.random.default_rng(4))
    table = torch.from_numpy(TABLE)
    got = tops.paged_gather_many(tpools, table)
    assert len(got) == len(tpools)
    for out, tpool, jpool in zip(got, tpools, jpools):
        assert out.dtype == tpool.dtype and out.shape == tpool.shape[:-2] + (3, 4) + (
            tpool.shape[-1],)
        assert torch.equal(out, tops.paged_gather(tpool, table))
        flat_j = jpool.reshape((-1,) + jpool.shape[-2:])
        for layer, jlayer in zip(out.reshape((-1,) + out.shape[-3:]), flat_j):
            want = jops.paged_gather(jlayer, jnp.asarray(TABLE), interpret=True)
            assert np.array_equal(layer.float().numpy(), np.asarray(want, np.float32))
        assert torch.all(out[..., 2, :, :] == 0) and torch.all(out[..., 1, 1, :] == 0)
    assert tops.paged_gather_many([], table) == []


def test_paged_lane_views_equal_paged_lane_view_and_jax():
    rng = np.random.default_rng(5)
    # one layer's k and v pools (n_pages, PS, Hkv, D), an MLA latent pool and
    # its k_rope pool (n_pages, PS, rank / qr)
    shapes = [(12, 4, 2, 8), (12, 4, 2, 8), (12, 4, 16), (12, 4, 4)]
    pools = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    table = torch.from_numpy(TABLE)
    got = tattn.paged_lane_views([torch.from_numpy(p) for p in pools], table)
    for view, pool in zip(got, pools):
        assert view.shape == (3, 16) + pool.shape[2:]
        assert torch.equal(view, tattn.paged_lane_view(torch.from_numpy(pool), table))
        want = jattn.paged_lane_view(jnp.asarray(pool), jnp.asarray(TABLE))
        assert np.array_equal(view.numpy(), np.asarray(want))


def _pools_and_table(model, rng):
    lanes, n_pages, ps = 3, 10, 4
    return _random_tree(model.cache_page_specs(lanes, n_pages, ps), rng), TABLE, ps


def test_gather_views_bit_equal_to_jax(models):
    jmodel, _, model, _ = models
    pools, bt, _ = _pools_and_table(model, np.random.default_rng(1))
    got = gather_views(_nest(pools, True), torch.from_numpy(bt))
    for impl in ("xla", "pallas"):
        _assert_trees_equal(got, jpc.gather_views(_nest(pools, False), jnp.asarray(bt),
                                                  impl=impl))


def test_absorb_decode_bit_equal_to_jax(models):
    jmodel, _, model, _ = models
    rng = np.random.default_rng(2)
    pools, bt, ps = _pools_and_table(model, rng)
    views = _random_tree(model.cache_specs(3, bt.shape[1] * ps), rng)
    # lane 0 writes inside its second page, lane 1 at the start of its third
    # (page 9, past the hole), lane 2 is idle
    positions = np.array([6, 8, 0], np.int32)
    active = np.array([True, True, False])
    want = jpc.absorb_decode(_nest(pools, False), _nest(views, False), jnp.asarray(bt),
                             jnp.asarray(positions), jnp.asarray(active), ps)
    tpools = _nest(pools, True)
    got = absorb_decode(tpools, _nest(views, True), torch.from_numpy(bt),
                        torch.from_numpy(positions).long(), torch.from_numpy(active), ps)
    assert got is tpools                                      # written in place
    _assert_trees_equal(got, want)


def test_decode_step_logits_and_caches(models):
    """Three lanes of dense per-lane caches at ragged positions."""
    jmodel, jparams, model, params = models
    rng = np.random.default_rng(3)
    cache = _random_tree(model.cache_specs(3, 16), rng)
    toks = rng.integers(0, model.cfg.vocab_size, size=(3, 1)).astype(np.int32)
    positions = np.array([6, 15, 0], np.int32)
    jlogits, jcache = jmodel.decode_step(jparams, _nest(cache, False), jnp.asarray(toks),
                                         jnp.asarray(positions))
    logits, tcache = model.decode_step(params, _nest(cache, True),
                                       torch.from_numpy(toks).long(),
                                       torch.from_numpy(positions).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert np.array_equal(logits.numpy().argmax(-1), np.asarray(jlogits).argmax(-1))
    jc = _jax_paths(jcache)
    for path, t in tree_items(tcache):
        np.testing.assert_allclose(t.numpy(), np.asarray(jc[path]), **TOL)


def _serve(eng, cls, prompts, max_new):
    reqs = [cls(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return {r.uid: r.out_tokens for r in reqs}


def test_gather_engine_matches_jax_gather_and_port_paged(models):
    """Ragged continuous batching with queueing and refill (as the JAX
    package's paged-vs-gather engine test): the three engines agree."""
    jmodel, jparams, model, params = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=(5 + 3 * i,)).astype(np.int32)
               for i in range(4)]
    jeng = jserve.ServeEngine(jmodel, jparams, jserve.EngineConfig(
        batch_slots=2, max_len=64,
        cache=jserve.CacheConfig(preempt_policy="recompute", decode_path="gather")))
    want = _serve(jeng, jserve.Request, prompts, 4)
    got = {}
    for path in ("gather", "paged"):
        eng = tserve.ServeEngine(model, params, tserve.EngineConfig(
            batch_slots=2, max_len=64, cache=tserve.CacheConfig(decode_path=path)),
            device="cpu")
        got[path] = _serve(eng, tserve.Request, prompts, 4)
        assert eng.cache.allocator.n_free == eng.cache.n_pages
    assert got["gather"] == want
    assert got["paged"] == want


def test_engine_refuses_an_unknown_decode_path(models):
    _, _, model, params = models
    with pytest.raises(ValueError, match="unknown decode_path"):
        tserve.ServeEngine(model, params, tserve.EngineConfig(
            cache=tserve.CacheConfig(decode_path="dense")), device="cpu")
