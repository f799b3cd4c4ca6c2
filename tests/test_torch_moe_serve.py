"""The port's moe family served, against the JAX package, on the CPU:
reduced deepseek-v3-671b (MLA, one dense layer then one MoE layer with a
shared expert) and reduced qwen3-moe-235b-a22b (GQA with qk_norm, two MoE
layers), both in float32 (the JAX package's bf16 MLA does not run on this
CPU).  Weights are the JAX ``model.init(jax.random.key(0))`` tree converted
by ``repro_torch.convert``; tokens and caches come from numpy with a seed.

* the parameter tree equals JAX's ``model.abstract()`` leaf for leaf (paths,
  shapes, dtypes) at full width, at the depths ``chip_smoke.py`` serves on
  the card (deepseek 5 layers, qwen3-moe 10) with their parameter counts,
  and reduced, without allocating;
* ``prefill`` (capacity drops, default groups), ``extend_step`` (no drops,
  one group) over ragged chunks, ``decode_step`` and ``decode_step_paged``
  logits and caches within atol = rtol = 1e-4; the paged decode is
  bit-equal to the gather path; with capacity to spare, chunked prefill
  equals the whole prompt;
* engine tokens identical to the JAX engine's, request for request: whole
  prompt, chunked prefill sync and async, ``recompute`` preemption and
  ``decode_path="gather"``;
* training through the serving kernel is refused (``impl="kernel"`` with
  grad-requiring weights; the family trains through ``impl="xla"``,
  tests/test_torch_moe_train.py); ``launch.serve`` runs both archs on the
  CPU.
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
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import SEQ_CACHE_KEYS, tree_items, tree_map  # noqa: E402
from repro_torch.serve.paged_cache import absorb_decode, gather_views  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["deepseek-v3-671b", "qwen3-moe-235b-a22b"]
TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB = 512
PS = 8
# the depths chip_smoke.py serves at full width on one card, and the
# parameter counts there (JAX's abstract(): 26.62 B and 26.12 B)
CARD_DEPTH = {"deepseek-v3-671b": (5, 26.62e9), "qwen3-moe-235b-a22b": (10, 26.12e9)}


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype="float32",
                               decode_unroll_layers=False, **kw)
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw)
    return jcfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg, cfg = _cfgs(request.param)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build_model(cfg), params


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): leaf
            for path, leaf in flat}


def _random_tree(specs, rng, scale=1.0):
    return {path: (rng.standard_normal(s.shape) * scale).astype(np.float32)
            for path, s in tree_items(specs)}


def _nest(flat, as_tensor):
    out: list = []
    for path, a in flat.items():
        node = out
        for k in path[:-1]:
            if isinstance(node, list):
                while len(node) <= k:
                    node.append({})
                node = node[k]
            else:
                node = node.setdefault(k, {})
        node[path[-1]] = torch.from_numpy(a.copy()) if as_tensor else jnp.asarray(a)
    return out


def _close_trees(tree, jtree):
    jl = _jax_paths(jtree)
    assert sorted(p for p, _ in tree_items(tree)) == sorted(jl)
    for path, t in tree_items(tree):
        np.testing.assert_allclose(t.numpy(), np.asarray(jl[path]), **TOL, err_msg=str(path))


def _close_logits(logits, jlogits):
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert np.array_equal(logits.numpy().argmax(-1), np.asarray(jlogits).argmax(-1))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", ["full", "card", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_abstract(arch, width):
    """Paths, shapes and dtypes leaf for leaf; nothing is allocated."""
    depth, count = CARD_DEPTH[arch]
    jcfg, cfg = {"full": (jax_arch(arch), get_arch(arch)),
                 "card": (dataclasses.replace(jax_arch(arch), n_layers=depth),
                          dataclasses.replace(get_arch(arch), n_layers=depth)),
                 "reduced": _cfgs(arch)}[width]
    model = build_model(cfg)
    want = _jax_paths(jax_build(jcfg).abstract())
    got = dict(tree_items(model.param_specs()))
    assert sorted(got) == sorted(want)
    for path, s in got.items():
        assert tuple(s.shape) == tuple(want[path].shape), path
        assert str(s.dtype).removeprefix("torch.") == np.dtype(want[path].dtype).name, path
    moe_seg = f"seg{len(model.segments) - 1}"
    assert got[(moe_seg, "s0_moe", "moe", "router")].dtype == torch.float32
    if arch == "deepseek-v3-671b":
        assert got[("seg0", "s0_dense", "attn", "q_norm")].dtype == torch.float32
        assert got[("seg0", "s0_dense", "attn", "kv_norm")].dtype == torch.float32
    n = sum(int(np.prod(s.shape)) for s in got.values())
    if width == "full":
        e, f = cfg.n_experts, cfg.moe_d_ff
        assert got[(moe_seg, "s0_moe", "moe", "w_gate")].shape[1:] == (e, cfg.d_model, f)
        assert n > (600e9 if arch == "deepseek-v3-671b" else 230e9)
    elif width == "card":
        assert model.segments[-1][1] == depth - cfg.first_dense_layers
        assert abs(n - count) < 0.005e9, n


# ---------------------------------------------------------------------------
# prefill, chunked prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,seq", [(1, 11), (2, 40)])
def test_prefill_logits_and_cache(models, b, seq):
    jmodel, jparams, model, params = models
    toks = _tokens((b, seq), seq)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(toks))
    logits, cache = model.prefill(params, torch.from_numpy(toks).long())
    _close_logits(logits, jlogits)
    _close_trees(cache, jcache)


def _zero_cache(model, b, t):
    return [{k: {n: torch.zeros(s.shape, dtype=s.dtype) for n, s in v.items()}
             for k, v in seg.items()} for seg in model.cache_specs(b, t)]


def test_chunked_prefill_matches_jax_extend(models):
    """Ragged chunks (17, 1, 22 tokens) into a 48-row cache: each chunk's
    logits against JAX's ``extend_step``, then the caches."""
    jmodel, jparams, model, params = models
    toks = _tokens((1, 40), 7)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jmodel.cache_specs(1, 48))
    cache = _zero_cache(model, 1, 48)
    for start, stop in ((0, 17), (17, 18), (18, 40)):
        chunk = toks[:, start:stop]
        jlogits, jcache = jmodel.extend_step(jparams, jcache, jnp.asarray(chunk),
                                             jnp.asarray(start, jnp.int32))
        logits, cache = model.extend_step(params, cache, torch.from_numpy(chunk).long(),
                                          start)
        _close_logits(logits, jlogits)
    _close_trees(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_equals_whole_prompt_when_nothing_drops(arch):
    """With capacity to spare the whole-prompt prefill drops nothing, and
    16-token chunks give its last logits and its cache.  (With the default
    capacity the whole prompt's routing drops tokens that the chunks keep,
    in the port as in the reference: tests/test_torch_moe.py.)"""
    toks = torch.from_numpy(_tokens((1, 40), 8)).long()
    _, cfg = _cfgs(arch, capacity_factor=64.0)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    whole, wcache = model.prefill(params, toks)
    cache = _zero_cache(model, 1, 40)
    for start in range(0, 40, 16):
        logits, cache = model.extend_step(params, cache, toks[:, start:start + 16], start)
    torch.testing.assert_close(logits[:, -1:], whole, **TOL)
    for (path, t), (_, w) in zip(tree_items(cache), tree_items(wcache)):
        torch.testing.assert_close(t, w, **TOL)


def _decode_inputs(model, rng):
    """Three lanes at ragged positions, random caches."""
    cache = _random_tree(model.cache_specs(3, 48), rng, 0.5)
    toks = rng.integers(0, VOCAB, size=(3, 1)).astype(np.int32)
    return cache, toks, np.array([40, 17, 3], np.int32)


def test_decode_step_logits_and_caches(models):
    jmodel, jparams, model, params = models
    cache, toks, positions = _decode_inputs(model, np.random.default_rng(3))
    jlogits, jcache = jmodel.decode_step(jparams, _nest(cache, False), jnp.asarray(toks),
                                         jnp.asarray(positions))
    tcache = _nest(cache, True)
    logits, new = model.decode_step(params, tcache, torch.from_numpy(toks).long(),
                                    torch.from_numpy(positions).long())
    _close_logits(logits, jlogits)
    _close_trees(new, jcache)


def _pools(model, rng):
    """Pools of 20 pages of 8 tokens; 3 lanes x 6 slots, lane 2 idle."""
    pools = _random_tree(model.cache_page_specs(3, 20, PS), rng, 0.5)
    bt = rng.permutation(20)[:18].reshape(3, 6).astype(np.int32)
    bt[2] = -1
    return pools, bt


def test_decode_step_paged_matches_jax(models):
    jmodel, jparams, model, params = models
    rng = np.random.default_rng(4)
    pools, bt = _pools(model, rng)
    toks = rng.integers(0, VOCAB, size=(3, 1)).astype(np.int32)
    positions = np.array([40, 17, 0], np.int32)
    active = np.array([True, True, False])
    jlogits, jpools = jmodel.decode_step_paged(
        jparams, _nest(pools, False), jnp.asarray(bt), jnp.asarray(toks),
        jnp.asarray(positions), jnp.asarray(active))
    tpools = _nest(pools, True)
    logits, got = model.decode_step_paged(
        params, tpools, torch.from_numpy(bt), torch.from_numpy(toks).long(),
        torch.from_numpy(positions).long(), torch.from_numpy(active))
    assert got is tpools
    assert all(path[-1] in SEQ_CACHE_KEYS for path, _ in tree_items(got))
    _close_logits(logits[:2], np.asarray(jlogits)[:2])
    _close_trees(got, jpools)


def test_paged_decode_bit_equal_to_gather_path(models):
    """decode_step_paged against gather_views → decode_step → absorb_decode:
    the same logits of the active lanes and the same pools, bit for bit."""
    _, _, model, params = models
    rng = np.random.default_rng(5)
    pools, bt = _pools(model, rng)
    toks = torch.from_numpy(rng.integers(0, VOCAB, size=(3, 1))).long()
    positions = torch.tensor([40, 17, 0])
    active = torch.tensor([True, True, False])
    btt = torch.from_numpy(bt)
    paged = _nest(pools, True)
    lp, paged = model.decode_step_paged(params, paged, btt, toks, positions, active)
    gathered = _nest(pools, True)
    lg, views = model.decode_step(params, gather_views(gathered, btt), toks, positions)
    gathered = absorb_decode(gathered, views, btt, positions, active, PS)
    assert torch.equal(lp[:2], lg[:2])
    for (path, a), (_, b) in zip(tree_items(paged), tree_items(gathered)):
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# name: (engine knobs, prompt lengths, new tokens)
SETTINGS = {
    "whole": (dict(batch_slots=3, max_len=64), (21, 5, 40, 13), 6),
    "chunked_sync": (dict(batch_slots=3, max_len=64, prefill_chunk=16, max_step_tokens=24,
                          async_prefill=False), (21, 5, 40, 30), 6),
    "chunked_async": (dict(batch_slots=3, max_len=64, prefill_chunk=16, max_step_tokens=24),
                      (21, 5, 40, 30), 6),
    # 3 lanes of 30-token prompts on a 13-page pool of 8-token pages: the
    # pool runs dry once the lanes cross into their fifth page
    "recompute": (dict(batch_slots=3, max_len=48, page_size=8, n_pages=13,
                       async_prefill=False), (30, 30, 30), 8),
    "gather": (dict(batch_slots=3, max_len=64, decode_path="gather"), (21, 5, 40, 13), 6),
}


def _engine_cfgs(knobs):
    cache = {k: knobs[k] for k in ("page_size", "n_pages", "decode_path") if k in knobs}
    adm = {k: knobs[k] for k in ("prefill_chunk", "async_prefill", "max_step_tokens")
           if k in knobs}
    return dict(batch_slots=knobs["batch_slots"], max_len=knobs["max_len"]), cache, adm


@pytest.mark.parametrize("name", list(SETTINGS))
def test_engine_tokens_match_jax_engine(models, name):
    jmodel, jparams, model, params = models
    knobs, lengths, max_new = SETTINGS[name]
    top, cache, adm = _engine_cfgs(knobs)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, size=(n,)).astype(np.int32) for n in lengths]
    jeng = jserve.ServeEngine(jmodel, jparams, jserve.EngineConfig(
        **top, cache=jserve.CacheConfig(preempt_policy="recompute", **cache),
        admission=jserve.AdmissionConfig(**adm)))
    teng = tserve.ServeEngine(model, params, tserve.EngineConfig(
        **top, cache=tserve.CacheConfig(preempt_policy="recompute", **cache),
        admission=tserve.AdmissionConfig(**adm)),
        device="cpu")
    out = []
    for eng, cls in ((jeng, jserve.Request), (teng, tserve.Request)):
        reqs = [cls(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done for r in reqs)
        out.append({r.uid: r.out_tokens for r in reqs})
    assert out[1] == out[0]
    assert not teng.cache.has_state_leaves()
    assert teng.cache.allocator.n_free == teng.cache.n_pages
    teng.cache.check_invariant()
    if name == "recompute":
        assert teng.sched.n_preemptions > 0 and jeng.sched.n_preemptions > 0
    if not knobs.get("async_prefill", True):
        assert teng.stats["steps"] == jeng.stats["steps"]


# ---------------------------------------------------------------------------
# training through the serving kernel refused; the launcher
# ---------------------------------------------------------------------------


def test_training_is_refused(models):
    """The family trains (tests/test_torch_moe_train.py), but not through
    the flash kernel the serving paths run: it has no backward."""
    _, _, model, params = models
    toks = torch.zeros(1, 8, dtype=torch.int32)
    tree = tree_map(lambda t: t.detach().requires_grad_(), params)
    with pytest.raises(RuntimeError, match="has no backward"):
        model.forward(tree, toks, impl="kernel")
    with pytest.raises(RuntimeError, match="has no backward"):
        model.loss(tree, {"tokens": toks, "targets": toks.long()}, impl="kernel")


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--device", "cpu",
         "--requests", "2"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"{arch}-smoke: 2 requests, 32 tokens" in proc.stdout
