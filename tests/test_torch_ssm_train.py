"""The port's mamba2 training path against the JAX package's, on the CPU.

Weights are the JAX ``model.init(jax.random.key(0))`` tree of reduced
mamba2-130m in float32, converted by ``repro_torch.convert``; inputs and
tokens come from numpy with a seed.  Tolerances (float32; the same
algorithm summed in another order):

* ``ssd_chunked(impl="xla")``: y and the final state at atol = rtol = 1e-4,
  each gradient within 1e-4 of its largest entry (rtol 1e-4);
* the model: logits atol = rtol = 1e-4, loss rel 1e-5, gradients as above;
* train steps: losses and grad norms rel 1e-4 at every step, parameters
  atol = rtol = 1e-4.

``F.softplus`` returns x itself above 20, where JAX's ``softplus`` keeps
computing log1p(exp(x)); the two differ there by about 2e-9, far inside
these tolerances (the inputs here stay well below 20).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import DEFAULT_RULES, AxisRules  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train.train_step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train.train_step import make_train_step, value_and_grad  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
RULES = AxisRules(DEFAULT_RULES)
ARCH = "mamba2-130m"


def _cfgs(**kw):
    return (dataclasses.replace(jax_arch(ARCH).reduced(), dtype="float32", **kw),
            dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32", **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close_grads(got_tree, want_tree):
    want = tree_items(_np_tree(want_tree))
    got = tree_items(got_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=str(path))


def _ssd_inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    return {"xh": rng.normal(size=(b, s, h, p)).astype(np.float32),
            "bb": rng.normal(size=(b, s, n)).astype(np.float32) * 0.5,
            "cc": rng.normal(size=(b, s, n)).astype(np.float32) * 0.5,
            "dt": rng.normal(size=(b, s, h)).astype(np.float32),
            "a_log": rng.normal(size=(h,)).astype(np.float32) * 0.5,
            "d_skip": rng.normal(size=(h,)).astype(np.float32),
            "init_state": rng.normal(size=(b, h, p, n)).astype(np.float32)}


# id: (batch, seq, carried state); the reduced chunk is 32 tokens
SSD_CASES = {"three_chunks": (2, 96, False), "carried_state": (2, 64, True),
             "short_one_chunk": (1, 16, True)}


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_chunked_xla_values_and_grads_match_jax(case):
    b, s, carried = SSD_CASES[case]
    jcfg, cfg = _cfgs()
    inp = _ssd_inputs(b, s, 4, 8, cfg.ssm.d_state)
    if not carried:
        inp.pop("init_state")
    names = list(inp)
    rng = np.random.default_rng(1)
    wy = rng.normal(size=(b, s, 4, 8)).astype(np.float32)
    wf = rng.normal(size=(b, 4, 8, cfg.ssm.d_state)).astype(np.float32)

    def jf(*args):
        y, final = jssm.ssd_chunked(jcfg, *args)
        return jnp.sum(y * wy) + jnp.sum(final * wf), (y, final)

    (_, (jy, jfinal)), jgrads = jax.jit(jax.value_and_grad(
        jf, argnums=tuple(range(len(names))), has_aux=True))(
            *(jnp.asarray(inp[k]) for k in names))
    args = [torch.from_numpy(inp[k]).requires_grad_() for k in names]
    y, final = tssm.ssd_chunked(cfg, *args, impl="xla")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(jfinal), **TOL)
    obj = (y * torch.from_numpy(wy)).sum() + (final * torch.from_numpy(wf)).sum()
    grads = torch.autograd.grad(obj, args)
    for name, g, jg in zip(names, grads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jg).max()), err_msg=name)


def test_ssd_chunked_impls_agree_and_the_kernel_refuses_grad():
    _, cfg = _cfgs()
    inp = {k: torch.from_numpy(v) for k, v in _ssd_inputs(2, 64, 4, 8, 16, seed=3).items()}
    with torch.no_grad():
        got = tssm.ssd_chunked(cfg, **inp, impl="xla")
        want = tssm.ssd_chunked(cfg, **inp, impl="kernel")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)
    x = inp["xh"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        tssm.ssd_chunked(cfg, **dict(inp, xh=x))              # "kernel", the default
    with pytest.raises(ValueError, match="impl must be"):
        tssm.ssd_chunked(cfg, **inp, impl="pallas")
    with pytest.raises(ValueError, match="not a multiple"):
        tssm.ssd_chunked(cfg, **{k: v[:, :40] if v.dim() > 1 and k != "init_state" else v
                                 for k, v in inp.items()}, impl="xla")


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _cfgs()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    return jmodel, jparams, build_model(cfg), convert.params_from_numpy(_np_tree(jparams))


def _batch(vocab, b, s, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def test_forward_loss_and_grads_match_jax(models):
    """Reduced mamba2, 96 tokens (three 32-token chunks)."""
    jmodel, jparams, model, params = models
    batch = _batch(model.cfg.vocab_size, 2, 96)
    jlogits, jaux = jax.jit(jmodel.forward)(jparams, jnp.asarray(batch["tokens"]))
    with torch.no_grad():
        logits, aux = model.forward(params, torch.from_numpy(batch["tokens"]))
    assert logits.shape == (2, 96, model.cfg.padded_vocab) and float(aux) == float(jaux) == 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(model.loss, params,
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    _close_grads(grads, jgrads)
    dt_bias = grads["seg0"]["s0_ssm"]["mix"]["dt_bias"]      # unread on both sides
    assert not dt_bias.any()


def test_kernel_eval_equals_xla_and_refuses_grad(models):
    _, _, model, params = models
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg.vocab_size, 2, 64).items()}
    with torch.no_grad():
        torch.testing.assert_close(model.loss(params, batch, impl="kernel"),
                                   model.loss(params, batch, impl="xla"), **TOL)
    with pytest.raises(RuntimeError, match="has no backward"):
        value_and_grad(model.loss, params, batch, "kernel")


def test_remat_full_equals_none():
    _, cfg = _cfgs()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, 2, 64).items()}
    out = {}
    for remat in ("none", "full"):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        out[remat] = value_and_grad(model.loss, params, batch)
    assert torch.equal(out["none"][0], out["full"][0])
    for (_, a), (_, b) in zip(tree_items(out["none"][1]), tree_items(out["full"][1])):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_train_step_matches_jax(models, opt, n_micro):
    """Four steps from JAX's weights, the same batches on both sides."""
    jmodel, jparams, model, params = models
    lr = {"sgd": 1e-2, "momentum": 1e-2, "adamw": 1e-3}[opt]
    jo, to = jopt.get_optimizer(opt, lr=lr), topt.get_optimizer(opt, lr=lr)
    params = convert.params_from_numpy(_np_tree(jparams))     # the step writes in place
    jp, jstate, state = jparams, jo.init(jparams), to.init(params)
    jstep = jax.jit(jax_train_step(jmodel, jo, RULES, n_microbatches=n_micro))
    step = make_train_step(model, to, n_microbatches=n_micro)
    for i in range(4):
        batch = _batch(model.cfg.vocab_size, 4, 32, seed=i)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    for (path, got), (_, want) in zip(tree_items(params), tree_items(_np_tree(jp))):
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=str(path))
    assert int(state["count"]) == 4


def test_train_launcher_trains_mamba2_on_the_cpu():
    from repro_torch.kernels import ops as tops
    from repro_torch.launch.train import main

    tops.reset_launches()
    tr, state, restarts = main(["--arch", ARCH, "--device", "cpu", "--steps", "4",
                                "--batch", "2", "--seq", "32", "--optimizer", "momentum"])
    assert state.step == 4 and restarts == 0 and all(np.isfinite(state.losses))
    assert tr.model.cfg.family == "ssm" and tr.tcfg.n_microbatches == 1
    assert tops.LAUNCHES["stream_gd"] == 0                  # the CPU runs the plain version
