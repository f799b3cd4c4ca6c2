"""The port's dense decoder against the JAX package's, on converted weights.

``model.init(jax.random.key(0))`` goes through ``repro_torch.convert`` into
the port; then prefill logits and caches, chunked-prefill (``extend_step``)
logits and caches, and paged decode logits and pools are compared on the
reduced configs of the four dense archs in float32:

* qwen2.5-3b (QKV bias, GQA), gemma-7b (embed_scale, rms_plus_one, GeGLU),
  qwen3-32b (qk_norm), qwen1.5-4b (MHA).

Logits tolerance: atol = rtol = 1e-4.  Both sides compute in float32, but
XLA:CPU and PyTorch sum the projections and attention in different orders,
and the differences grow through the layers; greedy argmax must be equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["qwen2.5-3b", "gemma-7b", "qwen3-32b", "qwen1.5-4b"]


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): leaf
            for path, leaf in flat}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype="float32",
                               decode_unroll_layers=False)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(dataclasses.replace(get_arch(arch).reduced(), dtype="float32"))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model, params


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_convert_roundtrips_leaf_for_leaf(dtype):
    jcfg = dataclasses.replace(jax_arch("qwen2.5-3b").reduced(), dtype=dtype)
    jparams = jax_build(jcfg).init(jax.random.key(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    params = convert.params_from_numpy(np_tree)
    # the converted tree has the port's own names and shapes
    specs = build_model(dataclasses.replace(get_arch("qwen2.5-3b").reduced(), dtype=dtype))
    want = dict(tree_items(specs.param_specs()))
    got = dict(tree_items(params))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape and t.dtype == want[path].dtype, path
    back = dict(tree_items(convert.params_to_numpy(params)))
    jleaves = _jax_paths(np_tree)
    assert sorted(back) == sorted(jleaves)
    for path, a in back.items():
        ref = np.asarray(jleaves[path]).astype(np.float32)
        assert a.dtype == np.float32 and a.shape == ref.shape, path
        np.testing.assert_array_equal(a, ref)          # exact, through float32


def test_prefill_logits_and_cache(pair):
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jmodel.cfg.vocab_size, size=(2, 11)).astype(np.int32)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(toks))
    logits, cache = model.prefill(params, torch.from_numpy(toks).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert np.array_equal(logits.numpy().argmax(-1), np.asarray(jlogits).argmax(-1))
    jc = _jax_paths(jcache)
    for path, t in tree_items(cache):
        np.testing.assert_allclose(t.numpy(), np.asarray(jc[path]), **TOL)


def test_extend_step_logits_and_cache(pair):
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jmodel.cfg.vocab_size, size=(1, 13)).astype(np.int32)
    cap = 32
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jmodel.cache_specs(1, cap))
    cache = [{k: {n: torch.zeros(s.shape, dtype=s.dtype) for n, s in v.items()}
              for k, v in seg.items()} for seg in model.cache_specs(1, cap)]
    for start, stop in ((0, 5), (5, 9), (9, 13)):
        chunk = toks[:, start:stop]
        jlogits, jcache = jmodel.extend_step(jparams, jcache, jnp.asarray(chunk),
                                             jnp.asarray(start, jnp.int32))
        logits, cache = model.extend_step(params, cache, torch.from_numpy(chunk).long(),
                                          start)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        assert np.array_equal(logits.numpy().argmax(-1), np.asarray(jlogits).argmax(-1))
    jc = _jax_paths(jcache)
    for path, t in tree_items(cache):
        np.testing.assert_allclose(t.numpy(), np.asarray(jc[path]), **TOL)


def test_decode_step_paged_logits_and_pools(pair):
    """Three lanes on shared pools: two active at ragged depths (lane 1's
    next write opens a fresh page) and one idle lane, which writes nothing."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    n_pages, ps = 10, 4
    rng = np.random.default_rng(2)
    pool_shape = (cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.hd)
    kp = rng.standard_normal(pool_shape).astype(np.float32)
    vp = rng.standard_normal(pool_shape).astype(np.float32)
    bt = np.array([[3, 7, -1, -1], [0, 5, 9, -1], [-1, -1, -1, -1]], np.int32)
    positions = np.array([6, 8, 0], np.int32)
    active = np.array([True, True, False])
    toks = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
    jpools = [{"s0_dense": {"k": jnp.asarray(kp), "v": jnp.asarray(vp)}}]
    jlogits, jpools = jmodel.decode_step_paged(
        jparams, jpools, jnp.asarray(bt), jnp.asarray(toks), jnp.asarray(positions),
        jnp.asarray(active))
    pools = [{"s0_dense": {"k": torch.from_numpy(kp.copy()),
                           "v": torch.from_numpy(vp.copy())}}]
    logits, pools = model.decode_step_paged(
        params, pools, torch.from_numpy(bt), torch.from_numpy(toks).long(),
        torch.from_numpy(positions).long(), torch.from_numpy(active))
    got, want = logits.numpy()[active], np.asarray(jlogits)[active]
    np.testing.assert_allclose(got, want, **TOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    jp = _jax_paths(jpools)
    for path, t in tree_items(pools):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[path]), **TOL)
    # only the two active lanes' slots changed
    changed = np.argwhere(np.any(pools[0]["s0_dense"]["k"].numpy() != kp, axis=(3, 4)))
    assert {(int(p), int(o)) for _, p, o in changed} == {(7, 2), (9, 0)}
