"""The port's vlm family (``VLM``: llava-next-mistral-7b) against the JAX
package's, on converted weights.

``model.init(jax.random.key(0))`` of reduced llava-next-mistral-7b (16 image
tokens) in float32 goes through ``repro_torch.convert``; the same seeded
numpy patches and tokens go through both: the projector, ``forward`` with
patches, ``loss`` (text positions scored), ``prefill`` with patches and its
cache, greedy ``decode_step`` after it, one SGD train step, text requests
through both serving engines, and one bf16 forward at the reference's own
tolerance.  Every registered architecture builds a model.

Logits tolerance: 2e-4 x max(1, |logits|) in float32 (XLA:CPU and PyTorch
sum the products in different orders); greedy tokens exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.common import DEFAULT_RULES, AxisRules  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train.train_step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import all_archs, get_arch  # noqa: E402
from repro_torch.models import DecoderLM, EncDecLM, VLM, build_model  # noqa: E402
from repro_torch.models.api import VISION_DIM  # noqa: E402
from repro_torch.models.common import tree_items, tree_map  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

ARCH = "llava-next-mistral-7b"
RULES = AxisRules(DEFAULT_RULES)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)


def assert_logits_close(got, want):
    """float32: within 2e-4 x max(1, |logits|), and the same argmax."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * scale)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): leaf
            for path, leaf in flat}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the reduced model runs tiny ops, which more
    threads only slow down while the suite's other workers hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_arch(ARCH).reduced(), dtype="float32",
                               decode_unroll_layers=False)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32"))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model, params


def _inputs(cfg, b=2, s=9, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    patches = rng.standard_normal((b, cfg.vision.n_image_tokens, VISION_DIM)).astype(np.float32)
    return toks, patches


@pytest.mark.parametrize("name", sorted(all_archs()))
def test_build_model_builds_every_registered_arch(name):
    """Every architecture builds, published and reduced; the vlm gives a
    VLM, the audio family an EncDecLM, the rest a DecoderLM."""
    want = {"vlm": VLM, "audio": EncDecLM}.get(get_arch(name).family, DecoderLM)
    for cfg in (get_arch(name), get_arch(name).reduced()):
        model = build_model(cfg)
        assert type(model) is want
        assert model.param_specs()["embed"].shape == (cfg.padded_vocab, cfg.d_model)


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_param_tree_is_jax_abstract(width):
    """Names, shapes and types of every leaf equal the JAX package's
    ``abstract()``: the projector's w1/b1/w2/b2 beside the dense backbone."""
    jcfg, cfg = jax_arch(ARCH), get_arch(ARCH)
    if width == "reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = jax_paths(jax_build(jcfg).abstract())
    got = dict(tree_items(build_model(cfg).param_specs()))
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        assert spec.shape == tuple(want[path].shape), path
        assert str(spec.dtype).removeprefix("torch.") == str(want[path].dtype), path
    assert got[("mm_proj", "w1")].shape == (VISION_DIM, cfg.d_model)


def test_project_patches(pair):
    jmodel, jparams, model, params = pair
    _, patches = _inputs(model.cfg)
    want = jmodel.project_patches(jparams, jnp.asarray(patches))
    got = model.project_patches(params, torch.from_numpy(patches))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_forward_with_patches(pair):
    jmodel, jparams, model, params = pair
    toks, patches = _inputs(model.cfg)
    jlogits, jaux = jmodel.forward(jparams, jnp.asarray(toks), RULES,
                                   extra_embeds=jnp.asarray(patches))
    logits, aux = model.forward(params, torch.from_numpy(toks).long(),
                                extra_embeds=torch.from_numpy(patches))
    assert logits.shape == (2, model.cfg.vision.n_image_tokens + toks.shape[1],
                            model.cfg.padded_vocab)
    assert_logits_close(logits.detach().numpy(), jlogits)
    assert float(aux) == float(jaux) == 0.0


def test_loss_scores_text_only(pair):
    """The loss equals JAX's and is the mean cross-entropy of the text
    positions alone (the image positions have no targets)."""
    jmodel, jparams, model, params = pair
    toks, patches = _inputs(model.cfg, seed=1)
    targets = np.roll(toks, -1, axis=1)
    jloss = jmodel.loss(jparams, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targets),
                                  "patches": jnp.asarray(patches)}, RULES)
    batch = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(targets),
             "patches": torch.from_numpy(patches)}
    loss = model.loss(params, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    logits, _ = model.forward(params, batch["tokens"].long(), extra_embeds=batch["patches"])
    text = logits[:, -toks.shape[1]:, :model.cfg.vocab_size].float()
    nll = -torch.log_softmax(text, -1).gather(-1, batch["targets"].long()[..., None])
    assert float(loss) == pytest.approx(float(nll.mean()), rel=1e-5)
    assert "patches" in batch                  # the caller's batch is left as it was


def test_prefill_with_patches_then_greedy_decode(pair):
    """Prefill over 16 image + 7 text tokens (logits and every cache leaf),
    then 8 greedy ``decode_step``s on caches grown to 40 rows: each step's
    logits and token equal JAX's."""
    jmodel, jparams, model, params = pair
    toks, patches = _inputs(model.cfg, s=7, seed=2)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(toks), RULES,
                                     extra_embeds=jnp.asarray(patches))
    logits, cache = model.prefill(params, torch.from_numpy(toks).long(),
                                  extra_embeds=torch.from_numpy(patches))
    assert_logits_close(logits.numpy(), jlogits)
    jc = jax_paths(jcache)
    n = model.cfg.vision.n_image_tokens + toks.shape[1]
    for path, t in tree_items(cache):
        assert t.shape[2] == n
        np.testing.assert_allclose(t.numpy(), np.asarray(jc[path]), atol=1e-4, rtol=1e-4,
                                   err_msg=str(path))
    # both caches grown to 40 rows: cache_specs zeros with the prompt's rows copied in
    specs = model.cache_specs(2, 40)
    jcache = tree_map(lambda sp, c: jnp.zeros(sp.shape, c.dtype).at[:, :, :n].set(c),
                      specs, jcache)

    def grown(sp, c):
        out = torch.zeros(sp.shape, dtype=sp.dtype)
        out[:, :, :n] = c
        return out

    cache = tree_map(grown, specs, cache)
    jtok = np.asarray(jlogits)[:, -1].argmax(-1)[:, None].astype(np.int32)
    tok = logits[:, -1].argmax(-1)[:, None]
    jstep = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos, RULES))
    assert np.array_equal(tok.numpy(), jtok)
    for i in range(8):
        pos = n + i
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(jtok), jnp.asarray(pos, jnp.int32))
        logits, cache = model.decode_step(params, cache, tok,
                                          torch.full((2,), pos, dtype=torch.long))
        assert_logits_close(logits.numpy(), jlogits)
        jtok = np.asarray(jlogits)[:, -1].argmax(-1)[:, None].astype(np.int32)
        tok = logits[:, -1].argmax(-1)[:, None]
        assert np.array_equal(tok.numpy(), jtok)


@pytest.mark.parametrize("chunk", [0, 4])
def test_engine_text_requests_match_jax(pair, chunk):
    """Text requests through both serving engines (the paged path, whole
    and chunked prefill): the same greedy tokens, request for request."""
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (6, 11, 3, 9)]
    jreqs = [jserve.Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    jeng = jserve.ServeEngine(jmodel, jparams, jserve.EngineConfig(
        batch_slots=2, max_len=32, cache=jserve.CacheConfig(preempt_policy="recompute"),
        admission=jserve.AdmissionConfig(prefill_chunk=chunk)))
    treqs = [tserve.Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    teng = tserve.ServeEngine(model, params, tserve.EngineConfig(
        batch_slots=2, max_len=32, cache=tserve.CacheConfig(preempt_policy="recompute"),
        admission=tserve.AdmissionConfig(prefill_chunk=chunk)), device="cpu")
    for j, t in zip(jreqs, treqs):
        jeng.submit(j)
        teng.submit(t)
    jeng.run()
    teng.run()
    assert {r.uid: r.out_tokens for r in treqs} == {r.uid: r.out_tokens for r in jreqs}
    assert all(r.done and len(r.out_tokens) == 5 for r in treqs)


def test_sgd_step_matches_jax(pair):
    """One SGD step of JAX's ``make_train_step`` and the port's on the same
    batch with patches: the loss, the grad norm and every updated leaf."""
    jmodel, jparams, model, params = pair
    toks, patches = _inputs(model.cfg, b=2, s=8, seed=4)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1), "patches": patches}
    jo, to = jopt.get_optimizer("sgd", lr=1e-2), topt.get_optimizer("sgd", lr=1e-2)
    jnew, _, jm = jax.jit(jax_train_step(jmodel, jo, RULES))(
        jparams, jo.init(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    new, _, m = make_train_step(model, to)(
        params, to.init(params), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    want = jax_paths(jnew)
    for path, t in tree_items(new):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[path]), **STEP_TOL,
                                   err_msg=str(path))


def test_bf16_forward_at_the_reference_tolerance():
    """bf16 weights and patches: logits within the reference's own tolerance
    (rtol 3e-2, atol 3e-2 + 0.02 x scale: ``tests/test_models.py``)."""
    jcfg = jax_arch(ARCH).reduced()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(1))
    model = build_model(get_arch(ARCH).reduced())
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    toks, patches = _inputs(jcfg, seed=5)
    jlogits, _ = jmodel.forward(jparams, jnp.asarray(toks), RULES,
                                extra_embeds=jnp.asarray(patches, jnp.bfloat16))
    logits, _ = model.forward(params, torch.from_numpy(toks).long(),
                              extra_embeds=torch.from_numpy(patches).to(torch.bfloat16))
    want = np.asarray(jlogits, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(logits.detach().float().numpy(), want, rtol=3e-2,
                               atol=3e-2 + 0.02 * scale)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "whisper-large-v3"])
def test_launch_train_takes_the_family(arch):
    """``launch.train`` trains the reduced vlm (batches with patches) and
    audio model (batches with frames) on the CPU."""
    from repro_torch.launch.train import main

    _, state, restarts = main(["--arch", arch, "--device", "cpu", "--steps", "2", "--batch", "2",
                               "--seq", "16", "--optimizer", "sgd"])
    assert state.step == 2 and restarts == 0 and np.all(np.isfinite(state.losses))


def test_launch_serve_takes_llava_and_refuses_whisper(capsys):
    """``launch.serve`` serves llava's text requests; whisper's engine raises
    the reference's TypeError, as ``python -m repro.launch.serve`` does."""
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--max-new", "4"])
    assert "llava-next-mistral-7b-smoke: 2 requests, 8 tokens" in capsys.readouterr().out
    with pytest.raises(TypeError, match="EncDecLM has no decode_step_paged"):
        main(["--arch", "whisper-large-v3", "--device", "cpu", "--requests", "1"])


def test_launch_train_full_refuses_llava_under_momentum():
    """Published llava (7.26 B parameters) with float32 momentum does not fit
    one 80 GB card (87.2 GB before activations); the launcher says so."""
    from repro_torch.launch.train import main

    with pytest.raises(SystemExit, match="does not fit one 80 GB card"):
        main(["--arch", ARCH, "--full", "--device", "cpu", "--optimizer", "momentum"])
