"""The port's hybrid family (recurrentgemma-9b) against the JAX package, on
the CPU.

Both sides run ``dataclasses.replace(get_arch("recurrentgemma-9b").reduced(),
dtype="float32", n_layers=5)``: segments ``("rec", "rec", "attn") × 1`` and
the remainder ``("rec", "rec") × 1``, local attention with a 64-token
window.  Weights are the JAX ``model.init(jax.random.key(0))`` tree
converted by ``repro_torch.convert``; tokens and caches come from numpy with
a seed.  Prompts and decode positions run past the window.

* the parameter tree equals JAX's ``model.abstract()`` leaf for leaf (paths,
  shapes, dtypes) at full width and reduced, without allocating;
* ``prefill``, ``extend_step`` (chunked = whole prompt), ``decode_step`` and
  ``decode_step_paged`` logits and caches within atol = rtol = 1e-4 (the
  same algorithm summed in another order: the RG-LRU doubling scan against
  ``associative_scan``, the flash plain version against the chunked scan);
  the paged windowed decode is bit-equal to the gather path's;
* ``gather_views`` and ``absorb_decode`` bit-equal to JAX's on pools with
  seq and state leaves in two segments;
* the flash plain version at head_dim 256, one KV head and a window, against
  the Pallas kernel in interpret mode (``q_offset=0``, which is what
  ``attend(impl="pallas")`` passes for a traced offset) and the oracle;
* engine tokens identical to the JAX engine's: whole prompt, chunked prefill
  sync and async, ``recompute`` preemption (inline admission) and
  ``decode_path="gather"``;
* forward, loss and gradients (gradients within 1e-4 of each leaf's largest
  entry), ``remat="full"`` = ``"none"``, and 4 momentum steps step for step
  (losses and grad norms rel 1e-4, parameters 1e-4);
* ``launch.serve`` and ``launch.train`` on the CPU, and ``launch.train
  --full`` refusing what one card cannot hold.
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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.common import DEFAULT_RULES, AxisRules  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.serve import paged_cache as jpc  # noqa: E402
from repro.train.train_step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.serve.paged_cache import absorb_decode, gather_views  # noqa: E402
from repro_torch.train.train_step import make_train_step, value_and_grad  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-9b"
TOL = dict(atol=1e-4, rtol=1e-4)
RULES = AxisRules(DEFAULT_RULES)
VOCAB = 512


def _cfgs(**kw):
    jcfg = dataclasses.replace(jax_arch(ARCH).reduced(), dtype="float32", n_layers=5,
                               decode_unroll_layers=False, **kw)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32", n_layers=5, **kw)
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _cfgs()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build_model(cfg), params


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): leaf
            for path, leaf in flat}


def _random_tree(specs, rng, scale=1.0):
    """{path: float32 numpy array} for a tree of shape specs."""
    return {path: (rng.standard_normal(s.shape) * scale).astype(np.float32)
            for path, s in tree_items(specs)}


def _nest(flat, as_tensor):
    """{path: array} → the nested list/dict tree, leaves as torch tensors
    (own copies) or JAX arrays."""
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


def _close_trees(tree, jtree, tol=TOL):
    jl = _jax_paths(jtree)
    paths = [p for p, _ in tree_items(tree)]
    assert sorted(paths) == sorted(jl), (paths, sorted(jl))
    for path, t in tree_items(tree):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(jl[path], np.float32), **tol,
                                   err_msg=str(path))


def _assert_trees_equal(tree, jtree):
    jl = _jax_paths(jtree)
    for path, t in tree_items(tree):
        assert np.array_equal(t.numpy(), np.asarray(jl[path])), path


def _close_logits(logits, jlogits):
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert np.array_equal(logits.numpy().argmax(-1), np.asarray(jlogits).argmax(-1))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", ["full", "reduced"])
def test_param_specs_equal_jax_abstract(width):
    """Paths, shapes and dtypes leaf for leaf; nothing is allocated."""
    if width == "full":
        jcfg, cfg = jax_arch(ARCH), get_arch(ARCH)
    else:
        jcfg, cfg = _cfgs()
    model = build_model(cfg)
    want = _jax_paths(jax_build(jcfg).abstract())
    got = dict(tree_items(model.param_specs()))
    assert sorted(got) == sorted(want)
    for path, s in got.items():
        assert tuple(s.shape) == tuple(want[path].shape), path
        assert str(s.dtype).removeprefix("torch.") == np.dtype(want[path].dtype).name, path
    assert got[("seg0", "s0_rec", "mix", "lambda_p")].dtype == torch.float32
    assert got[("seg0", "s2_attn", "ln1")].dtype == torch.float32
    if width == "full":
        assert model.segments == [(("rec", "rec", "attn"), 12), (("rec", "rec"), 1)]
        n = sum(int(np.prod(s.shape)) for s in got.values())
        assert 9.0e9 < n < 10.0e9
    else:
        assert model.segments == [(("rec", "rec", "attn"), 1), (("rec", "rec"), 1)]


def test_unported_families_name_mla_and_moe():
    """The moe family (MLA and MoE) serves now; the message names what is
    still refused."""
    build_model(get_arch("qwen3-moe-235b-a22b").reduced())
    with pytest.raises(NotImplementedError, match="vlm and audio come next"):
        build_model(get_arch("llava-next-mistral-7b").reduced())


# ---------------------------------------------------------------------------
# prefill, chunked prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq", [11, 100])
def test_prefill_logits_and_cache(models, seq):
    jmodel, jparams, model, params = models
    toks = _tokens((2, seq), seq)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(toks))
    logits, cache = model.prefill(params, torch.from_numpy(toks).long())
    _close_logits(logits, jlogits)
    _close_trees(cache, jcache)


def test_chunked_prefill_equals_whole_prompt_and_jax(models):
    """Ragged chunks (37, 1, 40, 22 tokens) against a 128-row cache, past the
    window: each chunk's logits against JAX's ``extend_step``, the last
    against the port's own whole-prompt prefill."""
    jmodel, jparams, model, params = models
    toks = _tokens((1, 100), 7)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jmodel.cache_specs(1, 128))
    cache = [{k: {n: torch.zeros(s.shape, dtype=s.dtype) for n, s in v.items()}
              for k, v in seg.items()} for seg in model.cache_specs(1, 128)]
    for start, stop in ((0, 37), (37, 38), (38, 78), (78, 100)):
        chunk = toks[:, start:stop]
        jlogits, jcache = jmodel.extend_step(jparams, jcache, jnp.asarray(chunk),
                                             jnp.asarray(start, jnp.int32))
        logits, cache = model.extend_step(params, cache, torch.from_numpy(chunk).long(),
                                          start)
        _close_logits(logits, jlogits)
    _close_trees(cache, jcache)
    whole, wcache = model.prefill(params, torch.from_numpy(toks).long())
    torch.testing.assert_close(logits[:, -1:], whole, **TOL)
    for (path, t), (_, w) in zip(tree_items(cache), tree_items(wcache)):
        torch.testing.assert_close(t[:, :, :100] if path[-1] in ("k", "v") else t, w, **TOL)


def _decode_inputs(model, rng):
    """Three lanes at ragged positions (two past the window), random caches
    (states scaled down as a trained model keeps them)."""
    cache = _random_tree(model.cache_specs(3, 128), rng, 0.5)
    toks = rng.integers(0, VOCAB, size=(3, 1)).astype(np.int32)
    return cache, toks, np.array([100, 70, 5], np.int32)


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
    # the state leaves given were not written; the k/v views were
    assert np.array_equal(tcache[0]["s0_rec"]["h"].numpy(), cache[(0, "s0_rec", "h")])
    assert not np.array_equal(tcache[0]["s2_attn"]["k"].numpy(), cache[(0, "s2_attn", "k")])


# a table of 8 slots of 16-token pages (128 tokens) per lane; lane 2 is idle
PS = 16


def _pools(model, rng):
    pools = _random_tree(model.cache_page_specs(3, 30, PS), rng, 0.5)
    bt = rng.permutation(30)[:24].reshape(3, 8).astype(np.int32)
    bt[2] = -1
    return pools, bt


def test_decode_step_paged_steps_active_lanes_only(models):
    """Lanes 0 and 1 decode past the window; idle lane 2 keeps its state and
    writes no page."""
    jmodel, jparams, model, params = models
    rng = np.random.default_rng(4)
    pools, bt = _pools(model, rng)
    toks = rng.integers(0, VOCAB, size=(3, 1)).astype(np.int32)
    positions = np.array([100, 70, 0], np.int32)
    active = np.array([True, True, False])
    jlogits, jpools = jmodel.decode_step_paged(
        jparams, _nest(pools, False), jnp.asarray(bt), jnp.asarray(toks),
        jnp.asarray(positions), jnp.asarray(active))
    tpools = _nest(pools, True)
    logits, got = model.decode_step_paged(
        params, tpools, torch.from_numpy(bt), torch.from_numpy(toks).long(),
        torch.from_numpy(positions).long(), torch.from_numpy(active))
    assert got is tpools
    _close_logits(logits[:2], np.asarray(jlogits)[:2])
    _close_trees(got, jpools)
    for path, t in tree_items(got):
        if path[-1] in ("h", "conv"):
            assert np.array_equal(t[:, 2].numpy(), pools[path][:, 2]), path
            assert not np.array_equal(t[:, 0].numpy(), pools[path][:, 0]), path


def test_paged_decode_bit_equal_to_gather_path(models):
    """decode_step_paged against gather_views → decode_step → absorb_decode:
    the same logits and pools, bit for bit."""
    _, _, model, params = models
    rng = np.random.default_rng(5)
    pools, bt = _pools(model, rng)
    toks = torch.from_numpy(rng.integers(0, VOCAB, size=(3, 1))).long()
    positions = torch.tensor([100, 70, 0])
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


def test_gather_views_and_absorb_decode_bit_equal_to_jax(models):
    jmodel, _, model, _ = models
    rng = np.random.default_rng(6)
    pools, bt = _pools(model, rng)
    got = gather_views(_nest(pools, True), torch.from_numpy(bt))
    for impl in ("xla", "pallas"):
        _assert_trees_equal(got, jpc.gather_views(_nest(pools, False), jnp.asarray(bt),
                                                  impl=impl))
    views = _random_tree(model.cache_specs(3, 8 * PS), rng)
    positions = np.array([100, 70, 0], np.int32)
    active = np.array([True, True, False])
    want = jpc.absorb_decode(_nest(pools, False), _nest(views, False), jnp.asarray(bt),
                             jnp.asarray(positions), jnp.asarray(active), PS)
    tpools = _nest(pools, True)
    got = absorb_decode(tpools, _nest(views, True), torch.from_numpy(bt),
                        torch.from_numpy(positions).long(), torch.from_numpy(active), PS)
    assert got is tpools
    _assert_trees_equal(got, want)


# id, sq, sk, window
FLASH_CASES = [("prompt", 96, 96, 32), ("short_window", 40, 40, 8), ("past_window", 64, 64, 16)]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_plain_at_head_dim_256_matches_pallas(case):
    """recurrentgemma's attention shape: 16:1 GQA (4 query heads over one KV
    head here), head_dim 256, a window."""
    _, sq, sk, window = case
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((1, 4, sq, 256)).astype(np.float32)
    k = rng.standard_normal((1, 1, sk, 256)).astype(np.float32)
    v = rng.standard_normal((1, 1, sk, 256)).astype(np.float32)
    got = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                               window=window).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    for want in (jops.flash_attention(jq, jk, jv, causal=True, window=window, q_offset=0,
                                      interpret=True),
                 jref.flash_attention(jq, jk, jv, causal=True, window=window)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# name: (engine knobs, prompt lengths, new tokens); every setting decodes
# across the 64-token window
SETTINGS = {
    "whole": (dict(batch_slots=3, max_len=128), (70, 5, 90, 33), 8),
    "chunked_sync": (dict(batch_slots=3, max_len=128, prefill_chunk=16, max_step_tokens=24,
                          async_prefill=False), (70, 5, 90, 60), 8),
    "chunked_async": (dict(batch_slots=3, max_len=128, prefill_chunk=16, max_step_tokens=24),
                      (70, 5, 90, 60), 8),
    # 3 lanes of 60-token prompts on a 25-page pool of 8-token pages: the
    # pool runs dry once the lanes cross into their ninth page
    "recompute": (dict(batch_slots=3, max_len=96, page_size=8, n_pages=25,
                       async_prefill=False), (60, 60, 60), 10),
    "gather": (dict(batch_slots=3, max_len=128, decode_path="gather"), (70, 5, 90, 33), 8),
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
        **top, cache=tserve.CacheConfig(**cache), admission=tserve.AdmissionConfig(**adm)),
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
    assert teng.cache.has_state_leaves()
    assert teng.cache.allocator.n_free == teng.cache.n_pages
    teng.cache.check_invariant()
    if name == "recompute":
        assert teng.sched.n_preemptions > 0 and jeng.sched.n_preemptions > 0
    if not knobs.get("async_prefill", True):
        assert teng.stats["steps"] == jeng.stats["steps"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _batch(b, s, seed=0):
    toks = _tokens((b, s + 1), seed)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _close_grads(got_tree, want_tree):
    want = tree_items(jax.tree.map(np.asarray, want_tree))
    got = tree_items(got_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()), err_msg=str(path))


def test_forward_loss_and_grads_match_jax(models):
    """96 tokens: past the window, two 64-token attention chunks."""
    jmodel, jparams, model, params = models
    batch = _batch(2, 96)
    jlogits, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(batch["tokens"]))
    with torch.no_grad():
        logits, aux = model.forward(params, torch.from_numpy(batch["tokens"]))
        kernel_loss = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 impl="kernel")
    assert logits.shape == (2, 96, model.cfg.padded_vocab) and float(aux) == 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(model.loss, params,
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(kernel_loss) == pytest.approx(float(jloss), rel=1e-5)
    _close_grads(grads, jgrads)


def test_remat_full_equals_none():
    _, cfg = _cfgs()
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, 80).items()}
    out = {}
    for remat in ("none", "full"):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        out[remat] = value_and_grad(model.loss, params, batch)
    assert torch.equal(out["none"][0], out["full"][0])
    for (_, a), (_, b) in zip(tree_items(out["none"][1]), tree_items(out["full"][1])):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_momentum_steps_match_jax(models, n_micro):
    """Four momentum steps from JAX's weights, the same batches on both sides."""
    jmodel, jparams, model, _ = models
    jo, to = jopt.get_optimizer("momentum", lr=1e-2), topt.get_optimizer("momentum", lr=1e-2)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    jp, jstate, state = jparams, jo.init(jparams), to.init(params)
    jstep = jax.jit(jax_train_step(jmodel, jo, RULES, n_microbatches=n_micro))
    step = make_train_step(model, to, n_microbatches=n_micro)
    for i in range(4):
        batch = _batch(4, 72, seed=i)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    for (path, got), (_, want) in zip(tree_items(params), tree_items(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=str(path))
    assert int(state["count"]) == 4


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_launch_serve_on_the_cpu():
    proc = _run("repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
                "--requests", "2", "--prefill-chunk", "4")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "recurrentgemma-9b-smoke: 2 requests, 32 tokens" in proc.stdout


def test_launch_train_on_the_cpu():
    proc = _run("repro_torch.launch.train", "--arch", ARCH, "--device", "cpu", "--steps", "4",
                "--batch", "2", "--seq", "32", "--optimizer", "momentum")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "done: step=4" in proc.stdout


def test_launch_train_full_refuses_what_one_card_cannot_hold():
    from repro_torch.launch.train import main

    with pytest.raises(SystemExit, match="does not fit one 80 GB card"):
        main(["--arch", ARCH, "--full", "--device", "cpu", "--optimizer", "momentum"])
