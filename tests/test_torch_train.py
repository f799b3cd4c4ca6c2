"""The port's training path against the JAX package's, on the CPU.

The same numpy inputs (from a seed) go through ``repro_torch`` (the plain
PyTorch versions of the kernels) and through the JAX package (the Pallas
``stream_gd`` in interpret mode and its oracle, the optimizers, the model's
``forward``/``loss``, the train step, the data pipeline, checkpoints and
the Trainer).  Tolerances, all float32 unless named:

* ``stream_gd``: atol = rtol = 1e-6 (the same products, summed in the same
  order for J <= 2; XLA may order the J > 2 sums otherwise);
* optimizer updates: 1 float32 ulp (rtol 1e-6, atol 1e-6 for values near
  0) and 1 bfloat16 ulp (rtol 2^-7) for bf16 leaves;
* logits atol = rtol = 1e-4 and loss rel 1e-5 (XLA:CPU and PyTorch sum the
  projections in other orders); gradients within 1e-4 of each leaf's
  largest entry;
* train steps: losses, grad norms and parameters within 1e-4.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.dist.fault import FaultInjector as JFault  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.common import DEFAULT_RULES, AxisRules  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro.train.train_step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.dist.fault import FaultInjector  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402
from repro_torch.train.train_step import make_eval_step, make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

GD_TOL = dict(atol=1e-6, rtol=1e-6)
F32_ULP = dict(atol=1e-6, rtol=1e-6)
BF16_ULP = dict(atol=1e-6, rtol=2.0 ** -7)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["qwen2.5-3b", "gemma-7b", "qwen3-32b", "qwen1.5-4b"]
RULES = AxisRules(DEFAULT_RULES)


def _leaves(tree):
    """Leaves as numpy float32/int arrays in sorted-path order (JAX or port
    trees alike)."""
    if not isinstance(tree, dict):
        tree = jax.tree.map(np.asarray, tree)
    out = []
    for path, x in tree_items(tree):
        if isinstance(x, torch.Tensor):
            x = x.detach().float().numpy() if x.is_floating_point() else x.numpy()
        else:
            x = np.asarray(x)
            x = x.astype(np.float32) if x.dtype.kind == "f" or x.dtype.name == "bfloat16" else x
        out.append((path, x))
    return out


def _jax_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jax_arch(arch).reduced(), dtype=dtype, **kw),
            dataclasses.replace(get_arch(arch).reduced(), dtype=dtype, **kw))


def _lm_batch(vocab, b, s, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


# ---------------------------------------------------------------------------
# (a) stream_gd, Eq. 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("j,shape", [(2, (7, 11)), (3, (64,)), (4, (5, 3, 2)), (2, (1030,))])
def test_stream_gd_matches_jax_kernel_and_oracle(j, shape):
    rng = np.random.default_rng(j)
    d = rng.normal(size=(j, *shape)).astype(np.float32)
    c = rng.normal(size=(j,)).astype(np.float32)
    got = tops.stream_gd(torch.from_numpy(d), torch.from_numpy(c)).numpy()
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jops.stream_gd(jnp.asarray(d), jnp.asarray(c),
                                                              interpret=True)), **GD_TOL)
    np.testing.assert_allclose(got, np.asarray(jref.stream_gd(jnp.asarray(d), jnp.asarray(c))),
                               **GD_TOL)


def test_stream_gd_is_sgd_update():
    """W' = C0·W + C1·dW with C0 = 1 - lr·wd, C1 = -lr reproduces SGD (paper §V-B)."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(32,)).astype(np.float32)
    g = rng.normal(size=(32,)).astype(np.float32)
    lr, wd = 0.1, 0.01
    got = tops.stream_gd(torch.from_numpy(np.stack([w, g])), [1 - lr * wd, -lr])
    np.testing.assert_allclose(got.numpy(), (1 - lr * wd) * w - lr * g, **GD_TOL)


def test_stream_gd_linearity():
    """stream_gd(d, 2c) == 2 · stream_gd(d, c) (hypothesis, as the JAX
    package's property test)."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=40, deadline=None)
    @hyp.given(st.integers(1, 8), st.integers(1, 200))
    def check(j, m):
        rng = np.random.default_rng(j * 1000 + m)
        d = torch.from_numpy(rng.normal(size=(j, m)).astype(np.float32))
        c = torch.from_numpy(rng.normal(size=(j,)).astype(np.float32))
        np.testing.assert_allclose(tops.stream_gd(d, 2.0 * c).numpy(),
                                   2.0 * tops.stream_gd(d, c).numpy(), **GD_TOL)

    check()


@pytest.mark.parametrize("dtypes", [("bfloat16", "bfloat16", "bfloat16"),
                                    ("float32", "bfloat16", "float32"),
                                    ("bfloat16", "float32", "bfloat16")],
                         ids=["sgd_bf16", "momentum_m", "momentum_w"])
def test_stream_gd_into_mixed_types_in_place_match_jax(dtypes):
    """The optimizer's launches: each stream in its own type, written into
    the first stream, equal to JAX's f32 arithmetic rounded to the output
    type."""
    rng = np.random.default_rng(3)
    t0, t1, out_t = dtypes
    x0 = rng.normal(size=(9, 13)).astype(np.float32)
    x1 = rng.normal(size=(9, 13)).astype(np.float32)
    c0, c1 = 0.999, -0.05
    ja = jnp.asarray(x0).astype(getattr(jnp, t0))
    jb = jnp.asarray(x1).astype(getattr(jnp, t1))
    want = (c0 * ja.astype(jnp.float32) + c1 * jb.astype(jnp.float32)).astype(ja.dtype)
    a = torch.tensor(x0, dtype=getattr(torch, t0))
    b = torch.tensor(x1, dtype=getattr(torch, t1))
    out = tops.stream_gd_into(a, (a, b), (c0, c1))
    assert out is a and a.dtype == getattr(torch, out_t)
    np.testing.assert_array_equal(a.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_stream_gd_into_refuses_bad_streams():
    w = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="1 to 8 streams"):
        tops.stream_gd_into(w, [w] * 9, [1.0] * 9)
    with pytest.raises(ValueError, match="one shape"):
        tops.stream_gd_into(w, (w, torch.zeros(4, 5)), (1.0, 1.0))
    with pytest.raises(ValueError, match="contiguous"):
        tops.stream_gd_into(w, (w, torch.zeros(4, 4).t()), (1.0, 1.0))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tops.stream_gd_into(w, (w, torch.zeros(4, 4, dtype=torch.float64)), (1.0, 1.0))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        m = torch.zeros(4, 4, device="meta")
        tops.stream_gd_into(m, (m, m), (1.0, 1.0))


# ---------------------------------------------------------------------------
# (b) the optimizers
# ---------------------------------------------------------------------------


OPTIMIZERS = {
    "sgd": (lambda: jopt.sgd(lr=0.1, weight_decay=0.01),
            lambda: topt.sgd(lr=0.1, weight_decay=0.01)),
    "momentum": (lambda: jopt.momentum(lr=0.05, beta=0.9, weight_decay=0.01),
                 lambda: topt.momentum(lr=0.05, beta=0.9, weight_decay=0.01)),
    "adamw": (lambda: jopt.adamw(lr=1e-2), lambda: topt.adamw(lr=1e-2)),
    "adamw_bf16_state": (lambda: jopt.adamw(lr=1e-2, state_dtype=jnp.bfloat16),
                         lambda: topt.adamw(lr=1e-2, state_dtype=torch.bfloat16)),
    "adamw_no_clip": (lambda: jopt.adamw(lr=1e-2, grad_clip=None),
                      lambda: topt.adamw(lr=1e-2, grad_clip=None)),
}


@pytest.mark.parametrize("types", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                   ("bfloat16", "float32")],
                         ids=["f32", "bf16_grads", "bf16_params_f32_grads"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_update_matches_jax(name, types):
    """Three updates from the same params, state and grads (clipping active:
    the grads' norm is ~13): params and state within one ulp of their type."""
    p_t, g_t = types
    make_j, make_t = OPTIMIZERS[name]
    rng = np.random.default_rng(1)
    shapes = {"a": (7, 11), "b": {"c": (64,), "d": (5, 3, 2)}}

    def tree(scale):
        return jax.tree.map(lambda s: (scale * rng.normal(size=s)).astype(np.float32), shapes,
                            is_leaf=lambda x: isinstance(x, tuple))

    params_np = tree(1.0)
    grads_np = [tree(1.0) for _ in range(3)]
    jo, to = make_j(), make_t()
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(getattr(jnp, p_t)), params_np)
    tp = convert.params_from_numpy(_jax_tree(jp))
    js = jo.init(jp)
    ts = convert.opt_state_from_numpy(_jax_tree(js))
    for g in grads_np:
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(getattr(jnp, g_t)), g)
        jp, js = jo.update(jg, js, jp)
        tp2, ts2 = to.update(convert.params_from_numpy(_jax_tree(jg)), ts, tp)
        assert tp2 is tp and ts2 is ts                     # updated in place
    for (path, got), (_, want) in zip(_leaves(tp), _leaves(jp)):
        np.testing.assert_allclose(got, want, **(BF16_ULP if p_t == "bfloat16" else F32_ULP),
                                   err_msg=str(path))
    got_state, want_state = _leaves(ts), _leaves(js)
    assert [p for p, _ in got_state] == [p for p, _ in want_state]
    bf16_state = name == "adamw_bf16_state"
    for (path, got), (_, want) in zip(got_state, want_state):
        np.testing.assert_allclose(got, want, **(BF16_ULP if bf16_state else F32_ULP),
                                   err_msg=str(path))
    assert int(ts["count"]) == 3


# ---------------------------------------------------------------------------
# (c) forward, loss and gradients; the chunked attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    """Reduced configs in float32, 80 tokens (two 64-token attention chunks,
    the second ragged)."""
    jcfg, cfg = _cfgs(arch)
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.key(0))
    params = convert.params_from_numpy(_jax_tree(jparams))
    batch = _lm_batch(jcfg.vocab_size, 2, 80)
    jlogits, jaux = jmodel.forward(jparams, jnp.asarray(batch["tokens"]))
    logits, aux = model.forward(params, torch.from_numpy(batch["tokens"]))
    assert logits.shape == (2, 80, cfg.padded_vocab) and float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4,
                               rtol=1e-4)
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [t.requires_grad_() for _, t in tree_items(params)]
    loss = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    evaluated = make_eval_step(model)(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert not evaluated.requires_grad and torch.equal(evaluated, loss.detach())
    for g, (path, want) in zip(grads, _leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=str(path))


# id, b, h, hkv, sq, sk, causal, window, q_offset, kv_len, chunk
ATTN_CASES = [
    ("causal_two_chunks", 2, 4, 2, 40, 40, True, None, 0, None, 16),
    ("window", 1, 4, 2, 33, 33, True, 8, 0, None, 16),
    ("kv_len_offset", 1, 4, 2, 8, 40, True, None, 20, 28, 16),
    ("noncausal_mha", 1, 2, 2, 12, 20, False, None, 0, None, 64),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_attend_xla_matches_jax_values_and_grads(case):
    _, b, h, hkv, sq, sk, causal, window, off, kv_len, chunk = case
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, sq, h, 32), (b, sk, hkv, 32), (b, sk, hkv, 32)))
    w = rng.normal(size=(b, sq, h, 32)).astype(np.float32)
    qpos = jnp.arange(sq, dtype=jnp.int32) + off

    def jf(q_, k_, v_):
        out = jattn.flash_attention_xla(q_, k_, v_, causal=causal, window=window,
                                        q_positions=qpos, kv_len=kv_len, chunk=chunk)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.attend(tq, tk, tv, causal=causal, window=window, q_offset=off, kv_len=kv_len,
                       impl="xla", chunk=chunk)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-4, rtol=1e-4)


def test_training_forward_refuses_what_is_not_ported():
    cfg = dataclasses.replace(get_arch("qwen2.5-3b").reduced(), dtype="float32")
    toks = torch.zeros(1, 8, dtype=torch.int32)
    model = build_model(dataclasses.replace(cfg, remat="dots"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="remat='dots'"):
        model.forward(params, toks)
    # the ssm, hybrid and moe families train (tests/test_torch_ssm_train.py,
    # tests/test_torch_hybrid.py, tests/test_torch_moe_train.py); what stays
    # refused is the non-factorized SSD decay and the families not ported yet
    ssm_cfg = get_arch("mamba2-130m").reduced()
    with pytest.raises(NotImplementedError, match="factorized"):
        build_model(dataclasses.replace(
            ssm_cfg, ssm=dataclasses.replace(ssm_cfg.ssm, factorized=False)))
    with pytest.raises(NotImplementedError, match="family 'vlm' is not ported"):
        build_model(get_arch("llava-next-mistral-7b").reduced())


# ---------------------------------------------------------------------------
# (d) the train step; (e) remat
# ---------------------------------------------------------------------------


def _opt_pair(name):
    lr = {"sgd": 1e-2, "momentum": 1e-2, "adamw": 1e-3}[name]
    return jopt.get_optimizer(name, lr=lr), topt.get_optimizer(name, lr=lr)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_train_step_matches_jax(opt, n_micro):
    """Three steps of reduced qwen2.5-3b in float32 from JAX's weights."""
    jcfg, cfg = _cfgs("qwen2.5-3b")
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jo, to = _opt_pair(opt)
    jparams = jmodel.init(jax.random.key(0))
    params = convert.params_from_numpy(_jax_tree(jparams))
    jstate, state = jo.init(jparams), to.init(params)
    jstep = jax.jit(jax_train_step(jmodel, jo, RULES, n_microbatches=n_micro))
    step = make_train_step(model, to, n_microbatches=n_micro)
    for i in range(3):
        batch = _lm_batch(jcfg.vocab_size, 4, 24, seed=i)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    for (path, got), (_, want) in zip(_leaves(params), _leaves(jparams)):
        np.testing.assert_allclose(got, want, **STEP_TOL, err_msg=str(path))
    assert int(state["count"]) == 3


def test_grad_types_follow_the_microbatch_count():
    """One microbatch: bf16 gradients for bf16 parameters (as jax.grad);
    two: a float32 accumulator.  The optimizer's launches take both."""
    _, cfg = _cfgs("qwen2.5-3b", dtype="bfloat16")
    model = build_model(cfg)
    seen = {}

    def spy(grads, state, params):
        seen["types"] = {t.dtype for _, t in tree_items(grads)}
        return opt.update(grads, state, params)

    opt = topt.momentum(lr=1e-2)
    batch = {k: torch.from_numpy(v) for k, v in _lm_batch(cfg.vocab_size, 2, 8).items()}
    for n, want in ((1, {torch.bfloat16, torch.float32}), (2, {torch.float32})):
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(model, topt.Optimizer(opt.init, spy), n_microbatches=n)
        params, _, m = step(params, opt.init(params), batch)
        assert seen["types"] == want and np.isfinite(float(m["loss"]))


def test_remat_full_equals_none():
    _, cfg = _cfgs("qwen2.5-3b")
    batch = {k: torch.from_numpy(v) for k, v in _lm_batch(cfg.vocab_size, 2, 40).items()}
    out = {}
    for remat in ("none", "full"):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        leaves = [t.requires_grad_() for _, t in tree_items(params)]
        loss = model.loss(params, batch)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# (f) data
# ---------------------------------------------------------------------------


def test_lm_data_bit_equal_to_jax_with_cursor():
    jcfg, cfg = _cfgs("qwen2.5-3b")
    jd = jpipe.SyntheticLMData(jcfg, batch=2, seq=8, seed=7)
    td = tpipe.SyntheticLMData(cfg, batch=2, seq=8, seed=7, device="cpu")
    for _ in range(6):
        jb, tb = jd.next(), td.next()
        for k in ("tokens", "targets"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert td.state_dict() == jd.state_dict() == {"seed": 7, "step": 6}
    td2 = tpipe.SyntheticLMData(cfg, batch=2, seq=8, seed=0, device="cpu")
    td2.load_state_dict({"seed": 7, "step": 3})
    jd2 = jpipe.SyntheticLMData(jcfg, batch=2, seq=8, seed=7)
    jd2.load_state_dict({"seed": 7, "step": 3})
    np.testing.assert_array_equal(td2.next()["tokens"].numpy(), jd2.next()["tokens"])
    td2.start_prefetch()
    try:
        np.testing.assert_array_equal(td2.next_prefetched()["tokens"].numpy(),
                                      jd2.next()["tokens"])
    finally:
        td2.stop()
    assert td2.state.step == 5


def test_image_data_bit_equal_to_jax():
    jd = jpipe.SyntheticImageData(px=8, channels=3, classes=4, batch=16, seed=2)
    td = tpipe.SyntheticImageData(px=8, channels=3, classes=4, batch=16, seed=2)
    for _ in range(2):
        (jx, jy), (tx, ty) = jd.next(), td.next()
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


# ---------------------------------------------------------------------------
# (g) checkpoints
# ---------------------------------------------------------------------------


def _mixed_tree():
    rng = np.random.default_rng(4)
    return {
        "a": jnp.asarray(rng.normal(size=(2, 3)), jnp.bfloat16),
        "nested": {"b": jnp.asarray(rng.normal(size=(4,)), jnp.float32)},
        "stack": [jnp.zeros((2, 2), jnp.float32), jnp.full((1,), 7, jnp.bfloat16)],
    }


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_checkpoint_written_by_jax_restores_bit_exactly(tmp_path):
    params = _mixed_tree()
    state = jopt.adamw(state_dtype=jnp.bfloat16).init(params)
    jck.save(str(tmp_path), 5, params, opt_state=state, extra={"data": {"seed": 1, "step": 5}})
    proto = convert.params_from_numpy(_jax_tree(params))
    tproto = convert.opt_state_from_numpy(_jax_tree(state))
    got, got_state, extra, step = tck.restore(str(tmp_path), proto, tproto, device="cpu")
    assert step == 5 and extra == {"data": {"seed": 1, "step": 5}}
    for want, have in ((params, got), (state, got_state)):
        wl, hl = jax.tree.leaves(want), [t for _, t in tree_items(have)]
        assert len(wl) == len(hl)
        for w, h in zip(wl, hl):
            assert str(h.dtype).split(".")[-1] == np.asarray(w).dtype.name
            np.testing.assert_array_equal(_bits(h), _bits(w))


def test_checkpoint_port_roundtrip_is_bit_exact_and_jax_reads_it(tmp_path):
    params = convert.params_from_numpy(_jax_tree(_mixed_tree()))
    state = topt.momentum().init(params)
    tck.save(str(tmp_path), 3, params, opt_state=state, extra={"cursor": {"s": 3}})
    got, got_state, extra, step = tck.restore(str(tmp_path), params, state, device="cpu")
    assert step == 3 and extra["cursor"]["s"] == 3
    for want, have in ((params, got), (state, got_state)):
        for (_, w), (_, h) in zip(tree_items(want), tree_items(have)):
            assert h.dtype == w.dtype
            np.testing.assert_array_equal(_bits(h), _bits(w))
    jparams, _, jstep = jck.restore(str(tmp_path), _jax_tree(_mixed_tree()))
    assert jstep == 3
    for (_, w), (_, h) in zip(tree_items(params), tree_items(jparams)):
        np.testing.assert_array_equal(_bits(w), _bits(h))


def test_checkpoint_ignores_incomplete(tmp_path):
    t = convert.params_from_numpy(_jax_tree(_mixed_tree()))
    tck.save(str(tmp_path), 1, t)
    bad = tmp_path / "step_00000002"              # a crash mid-save: no META
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"garbage")
    assert tck.latest_step(str(tmp_path)) == 1


def test_checkpoint_gc_and_async_snapshot(tmp_path):
    t = {"w": torch.arange(6, dtype=torch.float32)}
    for s in range(1, 6):
        tck.save(str(tmp_path), s, t, keep=2)
    assert tck.latest_step(str(tmp_path)) == 5
    assert len([p for p in os.listdir(tmp_path) if p.startswith("step_")]) == 2
    saver = tck.AsyncSaver(str(tmp_path / "async"), keep=2)
    saver.save(7, t)
    t["w"].add_(100.0)                            # the next step updates in place
    saver.wait()
    got, _, step = tck.restore(str(tmp_path / "async"), t, device="cpu")
    assert step == 7 and torch.equal(got["w"], torch.arange(6, dtype=torch.float32))


# ---------------------------------------------------------------------------
# (h) the Trainer
# ---------------------------------------------------------------------------


def _trainer(cfg, ckpt, fault=None, optimizer="sgd"):
    data = tpipe.SyntheticLMData(cfg, batch=2, seq=16, device="cpu")
    tcfg = TrainerConfig(total_steps=12, ckpt_dir=ckpt, ckpt_every=4, optimizer=optimizer,
                         lr=1e-3, log_every=100)
    return Trainer(build_model(cfg), data, tcfg, fault_injector=fault, device="cpu"), data


def test_trainer_crash_restore_resume(tmp_path):
    cfg = get_arch("qwen2.5-3b").reduced()
    fault = FaultInjector(fail_at={6})
    tr, data = _trainer(cfg, str(tmp_path / "faulty"), fault)
    state, restarts = tr.run_with_restarts(0)
    assert restarts == 1 and fault.fired == [6]
    assert state.step == 12 and data.state.step == 12
    tr2, _ = _trainer(cfg, str(tmp_path / "clean"))
    state2, restarts2 = tr2.run_with_restarts(0)
    assert restarts2 == 0 and state2.step == 12
    # exact resume: the same final loss with and without the crash
    assert state.losses[-1] == pytest.approx(state2.losses[-1], rel=1e-4)
    assert state.losses == state2.losses[-len(state.losses):]


@pytest.mark.parametrize("optimizer", ["sgd", "momentum"])
def test_trainer_matches_jax_step_for_step(tmp_path, optimizer):
    """The port's Trainer from JAX's initial weights, through a crash at step
    6, against the JAX Trainer with the same crash: the same losses."""
    jcfg, cfg = _cfgs("qwen2.5-3b")
    jdata = jpipe.SyntheticLMData(jcfg, batch=2, seq=16)
    jt = jtrainer.Trainer(jax_build(jcfg), jdata, jtrainer.TrainerConfig(
        total_steps=12, ckpt_dir=str(tmp_path / "jax"), ckpt_every=4, optimizer=optimizer,
        lr=1e-2, log_every=100), RULES, fault_injector=JFault(fail_at={6}))
    jstate, jrestarts = jt.run_with_restarts(jax.random.key(0))
    init = convert.params_from_numpy(_jax_tree(jax_build(jcfg).init(jax.random.key(0))))
    data = tpipe.SyntheticLMData(cfg, batch=2, seq=16, device="cpu")
    tr = Trainer(build_model(cfg), data, TrainerConfig(
        total_steps=12, ckpt_dir=str(tmp_path / "port"), ckpt_every=4, optimizer=optimizer,
        lr=1e-2, log_every=100), fault_injector=FaultInjector(fail_at={6}), device="cpu")
    state, restarts = tr.run_with_restarts(0, init_params=init)
    assert (restarts, state.step) == (jrestarts, jstate.step) == (1, 12)
    np.testing.assert_allclose(state.losses, jstate.losses, rtol=1e-4)
    for (path, got), (_, want) in zip(_leaves(state.params), _leaves(jstate.params)):
        np.testing.assert_allclose(got, want, **STEP_TOL, err_msg=str(path))


# ---------------------------------------------------------------------------
# (i) no kernel takes a gradient
# ---------------------------------------------------------------------------


def _grad_cases():
    z = torch.zeros
    return {
        "flash_attention": lambda t: tops.flash_attention(t(1, 2, 4, 32), z(1, 2, 4, 32),
                                                          z(1, 2, 4, 32)),
        "paged_attention": lambda t: tops.paged_attention(
            t(1, 2, 32), z(2, 4, 2, 32), z(2, 4, 2, 32), torch.zeros(1, 1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32)),
        "stream_mac_conv": lambda t: tops.stream_mac_conv(t(1, 4, 4, 2), z(3, 3, 2, 2)),
        "stream_maxpool": lambda t: tops.stream_maxpool(t(1, 4, 4, 2), (2, 2), (2, 2)),
        "tiled_matmul": lambda t: tops.tiled_matmul(t(4, 4), z(4, 4)),
        "ssd_scan": lambda t: tops.ssd_scan(t(1, 8, 2, 4), z(1, 8, 4), z(1, 8, 4),
                                            z(1, 8, 2), z(2), 4),
        "paged_gather": lambda t: tops.paged_gather(t(3, 8), torch.zeros(1, 2,
                                                                        dtype=torch.int32)),
        "stream_gd": lambda t: tops.stream_gd(t(2, 8), [1.0, -0.1]),
        "stream_gd_into": lambda t: tops.stream_gd_into(z(8), (t(8), z(8)), [1.0, -0.1]),
        "attend_kernel": lambda t: tattn.attend(t(1, 4, 2, 32), z(1, 4, 2, 32),
                                                z(1, 4, 2, 32), impl="kernel"),
    }


@pytest.mark.parametrize("name", list(_grad_cases()))
def test_kernel_wrappers_refuse_grad_inputs(name):
    call = _grad_cases()[name]

    def needs_grad(*shape):
        return torch.zeros(*shape, requires_grad=True)

    with pytest.raises(RuntimeError, match="has no backward"):
        call(needs_grad)
    with torch.no_grad():
        call(needs_grad)                         # no graph: the kernel may run
    call(torch.zeros)                            # nothing requires grad
    assert tops.LAUNCHES["stream_gd"] == 0       # the CPU runs the plain versions
