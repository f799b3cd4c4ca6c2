"""The port's audio family (``EncDecLM``: whisper-large-v3) against the JAX
package's, on converted weights.

``model.init(jax.random.key(0))`` of reduced whisper-large-v3 (2 encoder and
2 decoder layers, n_ctx 64) in float32 goes through ``repro_torch.convert``;
the same seeded numpy frames and tokens go through both: ``encode``,
``forward``, ``loss``, ``prefill`` with every cache leaf, a teacher-forced
``decode_step`` against ``forward`` (as ``tests/test_models.py`` holds the
reference), 16 greedy tokens for a batch of 2, one SGD train step, one
bf16 forward at the reference's own tolerance, and the serving engine's
refusal of the paged path on both sides.  ``sinusoidal_positions`` equals
JAX's table bit for bit; ``layer_norm`` equals it within float32 rounding
(XLA:CPU's ``rsqrt`` is an approximation, and its reductions sum in blocks
of 32: neither order is PyTorch's).

Logits tolerance: 2e-4 x max(1, |logits|) in float32; greedy tokens exactly.
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
from repro.models import common as jcommon  # noqa: E402
from repro.models.common import DEFAULT_RULES, AxisRules  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train.train_step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import DecoderLM, EncDecLM, build_model  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train.train_step import make_train_step, value_and_grad  # noqa: E402

ARCH = "whisper-large-v3"
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
    jcfg = dataclasses.replace(jax_arch(ARCH).reduced(), dtype="float32")
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32"))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model, params


def _grown(model, cache, rows):
    """``cache_specs`` zeros with a prefill's cache copied into their first
    rows (k/v; ck/cv are n_ctx rows in both): room for decode steps."""
    specs = model.cache_specs(cache[0]["k"].shape[1], rows)[0]
    out = {}
    for name, c in cache[0].items():
        if isinstance(c, torch.Tensor):
            out[name] = torch.zeros(specs[name].shape, dtype=c.dtype)
            out[name][:, :, :c.shape[2]] = c
        else:
            out[name] = jnp.zeros(specs[name].shape, c.dtype).at[:, :, :c.shape[2]].set(c)
    return [out]


def _inputs(cfg, b=2, s=9, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    frames = rng.standard_normal((b, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    return toks, frames


@pytest.mark.parametrize("n,d", [(64, 128), (1500, 1280), (7, 6)])
def test_sinusoidal_positions_bit_equal(n, d):
    got = common.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcommon.sinusoidal_positions(n, d)))


# XLA:CPU's rsqrt is within 1.21 ulp of exact, PyTorch's rounds once more
# (0.5 ulp), the product (x - mu) * rsqrt rounds once (0.5 ulp), and the two
# sum mean and variance in other orders (under 1 ulp more at these widths):
# under 4 float32 epsilons of max(1, |x_hat|) in all.
LN_EPS_BOUND = 4


@pytest.mark.parametrize("scale", [3.0, 0.01])
@pytest.mark.parametrize("d", [128, 1280])
def test_layer_norm_matches_jax(d, scale):
    """float32: the normalised x_hat (w = 1, b = 0) within LN_EPS_BOUND
    float32 epsilons of max(1, |x_hat|) of JAX's, and x_hat * w + b within
    |w| times that plus one rounding of the product and one of the sum; at
    scale 0.01 the variance is 1e-4, so a wrong eps or a sample variance
    fails.  bf16 within one bf16 rounding; the output keeps the input's type."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((3, 17, d)) * scale + 0.5 * scale).astype(np.float32)
    w, b = (rng.standard_normal(d).astype(np.float32) for _ in range(2))
    one, zero = np.ones(d, np.float32), np.zeros(d, np.float32)
    eps32 = float(np.finfo(np.float32).eps)

    def both(x, w, b):
        want = np.asarray(jcommon.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))
        got = common.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                1e-5)
        assert got.dtype == torch.float32
        return got.numpy(), want

    got, xhat = both(x, one, zero)
    bound = LN_EPS_BOUND * eps32 * np.maximum(1.0, np.abs(xhat))
    assert (np.abs(got - xhat) <= bound).all(), float(np.max(np.abs(got - xhat) / bound))
    got, want = both(x, w, b)
    bound = np.abs(w) * bound + eps32 * (np.abs(xhat * w) + np.abs(want))
    assert (np.abs(got - want) <= bound).all(), float(np.max(np.abs(got - want) / bound))
    want16 = np.asarray(jcommon.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                           jnp.asarray(b)), np.float32)
    got16 = common.layer_norm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                              torch.from_numpy(b))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want16, atol=1e-2, rtol=2.0 ** -7)


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_param_tree_is_jax_abstract(width):
    """Names, shapes and types of every leaf equal the JAX package's
    ``abstract()`` (no ``bk``; float32 LayerNorm leaves)."""
    jcfg, cfg = jax_arch(ARCH), get_arch(ARCH)
    if width == "reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = jax_paths(jax_build(jcfg).abstract())
    got = dict(tree_items(build_model(cfg).param_specs()))
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        assert spec.shape == tuple(want[path].shape), path
        assert str(spec.dtype).removeprefix("torch.") == str(want[path].dtype), path
    assert ("dec", "attn", "bk") not in got


def test_decoder_lm_refuses_the_audio_family():
    """Learned positions stay EncDecLM's: a DecoderLM refuses the family."""
    with pytest.raises(NotImplementedError, match="EncDecLM"):
        DecoderLM(get_arch(ARCH).reduced())
    with pytest.raises(ValueError, match="audio family"):
        EncDecLM(get_arch("qwen2.5-3b").reduced())


@pytest.fixture(scope="module")
def encoded(pair):
    """Seeded frames and JAX's encoder output of them, shared by both impls."""
    jmodel, jparams, model, _ = pair
    _, frames = _inputs(model.cfg)
    return frames, jmodel.encode(jparams, jnp.asarray(frames), RULES)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_encode(pair, encoded, impl):
    _, _, model, params = pair
    frames, want = encoded
    with torch.no_grad():
        got = model.encode(params, torch.from_numpy(frames), impl)
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4 * scale)


def test_forward_and_loss(pair):
    jmodel, jparams, model, params = pair
    toks, frames = _inputs(model.cfg, seed=1)
    targets = np.roll(toks, -1, axis=1)
    # one jitted call for JAX's forward and loss: cheaper here than both eagerly
    (jlogits, jaux), jloss = jax.jit(lambda p, batch: (
        jmodel.forward(p, batch["tokens"], RULES, frames=batch["frames"]),
        jmodel.loss(p, batch, RULES)))(jparams, {"tokens": jnp.asarray(toks),
                                                 "targets": jnp.asarray(targets),
                                                 "frames": jnp.asarray(frames)})
    logits, aux = model.forward(params, torch.from_numpy(toks).long(),
                                frames=torch.from_numpy(frames))
    assert logits.shape == (2, toks.shape[1], model.cfg.padded_vocab)
    assert_logits_close(logits.detach().numpy(), jlogits)
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0
    loss = model.loss(params, {"tokens": torch.from_numpy(toks),
                               "targets": torch.from_numpy(targets),
                               "frames": torch.from_numpy(frames)})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


def test_prefill_logits_and_cache(pair):
    """Prefill's last-position logits and its k, v, ck and cv leaves."""
    jmodel, jparams, model, params = pair
    toks, frames = _inputs(model.cfg, s=6, seed=2)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(toks), RULES,
                                     frames=jnp.asarray(frames))
    logits, cache = model.prefill(params, torch.from_numpy(toks).long(),
                                  frames=torch.from_numpy(frames))
    assert logits.shape == (2, 1, model.cfg.padded_vocab)
    assert_logits_close(logits.numpy(), jlogits)
    cfg = model.cfg
    specs = model.cache_specs(2, 6)[0]
    for name in ("k", "v", "ck", "cv"):
        got, want = cache[0][name], np.asarray(jcache[0][name])
        assert tuple(got.shape) == specs[name].shape == want.shape
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4 * scale, err_msg=name)
    assert cache[0]["ck"].shape[2] == cfg.encoder.n_ctx
    # max_len is taken and ignored, as the reference ignores it: the same
    # cache, over the prompt's S rows
    _, same = model.prefill(params, torch.from_numpy(toks).long(),
                            frames=torch.from_numpy(frames), max_len=10)
    for name in ("k", "v", "ck", "cv"):
        assert torch.equal(same[0][name], cache[0][name]), name


def test_teacher_forced_decode_matches_forward(pair):
    """Prefill 11 tokens, decode the 12th: the logits equal the full
    forward's last position (and JAX's decode step), as
    ``tests/test_models.py`` holds the reference."""
    jmodel, jparams, model, params = pair
    toks, frames = _inputs(model.cfg, b=1, s=12, seed=3)
    full, _ = model.forward(params, torch.from_numpy(toks).long(), frames=torch.from_numpy(frames))
    logits_p, cache = model.prefill(params, torch.from_numpy(toks[:, :-1]).long(),
                                    frames=torch.from_numpy(frames))
    cache = _grown(model, cache, 16)
    assert_logits_close(logits_p[:, -1].numpy(), full[:, -2].detach().numpy())
    logits_d, _ = model.decode_step(params, cache, torch.from_numpy(toks[:, -1:]).long(), 11)
    assert_logits_close(logits_d[:, 0].numpy(), full[:, -1].detach().numpy())
    _, jcache = jmodel.prefill(jparams, jnp.asarray(toks[:, :-1]), RULES,
                               frames=jnp.asarray(frames))
    jcache = _grown(model, jcache, 16)
    jlogits, _ = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, -1:]),
                                    jnp.asarray(11, jnp.int32), RULES)
    assert_logits_close(logits_d.numpy(), jlogits)


def test_greedy_decode_batch_of_two(pair):
    """A 4-token prompt per lane, then 16 greedy decode steps: every step's
    logits and both lanes' tokens equal JAX's."""
    jmodel, jparams, model, params = pair
    toks, frames = _inputs(model.cfg, b=2, s=4, seed=4)
    cap = 4 + 16
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(toks), RULES,
                                     frames=jnp.asarray(frames))
    jcache = _grown(model, jcache, cap)
    logits, cache = model.prefill(params, torch.from_numpy(toks).long(),
                                  frames=torch.from_numpy(frames))
    cache = _grown(model, cache, cap)
    jstep = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos, RULES))
    jtoks, ttoks = [], []
    for pos in range(4, cap):
        jtok = np.asarray(jlogits)[:, -1].argmax(-1)[:, None].astype(np.int32)
        tok = logits[:, -1].argmax(-1)[:, None]
        jtoks.append(jtok[:, 0].tolist())
        ttoks.append(tok[:, 0].tolist())
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(jtok), jnp.asarray(pos, jnp.int32))
        logits, cache = model.decode_step(params, cache, tok, pos)
        assert_logits_close(logits.numpy(), jlogits)
    assert ttoks == jtoks and len(ttoks) == 16
    np.testing.assert_allclose(cache[0]["k"].numpy(), np.asarray(jcache[0]["k"]),
                               atol=1e-4, rtol=1e-4)


def test_decoder_positions_clamp_as_dynamic_slice():
    """A start past ``max_position - S`` reads the table's last S rows, as
    ``lax.dynamic_slice_in_dim`` clamps it; a start inside reads its own."""
    model = build_model(dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32",
                                            max_position=16))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.tensor([[1, 2, 3]])
    emb = params["embed"][toks]
    x = model._dec_embed(params, toks, 15)
    torch.testing.assert_close(x, emb + params["pos_dec"][13:16][None], rtol=0, atol=0)
    x = model._dec_embed(params, toks, 4)
    torch.testing.assert_close(x, emb + params["pos_dec"][4:7][None], rtol=0, atol=0)


def test_sgd_step_matches_jax(pair):
    """One SGD step of JAX's ``make_train_step`` and the port's on the same
    batch with frames: the loss, the grad norm and every updated leaf."""
    jmodel, jparams, model, params = pair
    toks, frames = _inputs(model.cfg, b=2, s=8, seed=5)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1), "frames": frames}
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


def test_remat_full_gives_the_same_gradients(pair):
    """``remat="full"`` (per-layer ``torch.utils.checkpoint``) changes no
    gradient."""
    _, _, model, params = pair
    toks, frames = _inputs(model.cfg, b=1, s=5, seed=6)
    batch = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(np.roll(toks, -1, 1)),
             "frames": torch.from_numpy(frames)}
    remat = build_model(dataclasses.replace(model.cfg, remat="full"))
    loss, grads = value_and_grad(model.loss, params, batch)
    rloss, rgrads = value_and_grad(remat.loss, params, batch)
    assert float(rloss) == float(loss)
    for (path, g), (_, rg) in zip(tree_items(grads), tree_items(rgrads)):
        torch.testing.assert_close(rg, g, rtol=0, atol=0, msg=str(path))


def test_bf16_forward_at_the_reference_tolerance():
    """bf16 weights and frames: logits within the reference's own tolerance
    (rtol 3e-2, atol 3e-2 + 0.02 x scale: ``tests/test_models.py``)."""
    jcfg = jax_arch(ARCH).reduced()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(1))
    model = build_model(get_arch(ARCH).reduced())
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    toks, frames = _inputs(jcfg, seed=7)
    jlogits, _ = jmodel.forward(jparams, jnp.asarray(toks), RULES,
                                frames=jnp.asarray(frames, jnp.bfloat16))
    logits, _ = model.forward(params, torch.from_numpy(toks).long(),
                              frames=torch.from_numpy(frames).to(torch.bfloat16))
    want = np.asarray(jlogits, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(logits.detach().float().numpy(), want, rtol=3e-2,
                               atol=3e-2 + 0.02 * scale)


def test_engine_refuses_the_paged_path_on_both_sides(pair):
    """Neither serving engine takes an EncDecLM on its paged path; both
    raise the same TypeError."""
    jmodel, jparams, model, params = pair
    with pytest.raises(TypeError) as jerr:
        jserve.ServeEngine(jmodel, jparams, jserve.EngineConfig(batch_slots=2, max_len=32))
    with pytest.raises(TypeError) as terr:
        tserve.ServeEngine(model, params, tserve.EngineConfig(batch_slots=2, max_len=32),
                           device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "EncDecLM has no decode_step_paged" in str(terr.value)
