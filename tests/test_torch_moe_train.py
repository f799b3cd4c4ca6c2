"""The port's moe family trained, against the JAX package, on the CPU:
reduced deepseek-v3-671b (MLA, one dense layer then one MoE layer with a
shared expert) and reduced qwen3-moe-235b-a22b (GQA with qk_norm, two MoE
layers), both in float32 (the JAX package's bf16 MLA decode does not run
on jax 0.9.0's CPU backend; its training path never reaches it).  Weights are the JAX
``model.init(jax.random.key(0))`` tree converted by ``repro_torch.convert``;
tokens come from numpy with a seed.  Every JAX function is jitted once per
case, so the file stays short.

* ``forward`` logits within atol = rtol = 1e-4 and the aux loss (nonzero)
  within 1e-6 relative, at B 2 x 80 tokens: two 64-token attention chunks,
  the second ragged, and groups whose capacity drops tokens;
* the loss (rel 1e-5) and every parameter's gradient (rtol 1e-4, atol 1e-4
  of the leaf's largest entry) against ``jax.value_and_grad(model.loss)``:
  the router, the experts, the shared expert, MLA's projections and norms;
* ``mla_attention(impl="xla")``: values within 1e-5 and the gradients of
  the input and of every weight within 1e-4 of the reference's;
* ``remat="full"`` equal to ``"none"``: loss, aux and gradients bit for bit;
* train steps against ``jax.jit(make_train_step(...))``, 3 steps: qwen3-moe
  for sgd, momentum and adamw with 1 and 2 microbatches, deepseek for
  momentum with 2 and adamw with 1 (losses and grad norms rel 1e-4,
  parameters within 1e-4);
* ``impl="kernel"`` under ``torch.no_grad()`` gives ``impl="xla"``'s loss;
* a reduced qwen3-moe checkpoint written by the JAX package restores bit
  for bit in the port; the port's Trainer on reduced deepseek restores
  after a crash and resumes to the clean run's losses;
* ``launch.train`` on the CPU for both archs, and ``--full`` refusing them.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models.common import DEFAULT_RULES, AxisRules  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.train.train_step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.dist.fault import FaultInjector  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    make_eval_step,
    make_train_step,
    value_and_grad,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["deepseek-v3-671b", "qwen3-moe-235b-a22b"]
RULES = AxisRules(DEFAULT_RULES)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_arch(arch).reduced(), dtype="float32", **kw),
            dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_init(arch, dtype="float32"):
    """JAX's ``init(jax.random.key(0))`` of the reduced ``arch``, once per
    file (JAX arrays are immutable: the cases share it)."""
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype=dtype)
    return jax.jit(jax_build(jcfg).init)(jax.random.key(0))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg, cfg = _cfgs(request.param)
    jparams = _jax_init(request.param)
    return (jax_build(jcfg), jparams, build_model(cfg),
            convert.params_from_numpy(_np_tree(jparams)))


def _batch(b, s, seed=0):
    toks = np.random.default_rng(seed).integers(0, 512, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _dropped(model, params, tokens) -> int:
    """(token, rank) pairs the training forward's dispatch drops, counted
    by wrapping ``moe._dispatch_masks``."""
    seen = []
    plain = tmoe._dispatch_masks

    def counted(gates, k, capacity, trim=False):
        disp, comb = plain(gates, k, capacity, trim)
        seen.append(gates.shape[0] * gates.shape[1] * k - int(disp.sum()))
        return disp, comb

    tmoe._dispatch_masks = counted
    try:
        with torch.no_grad():
            model.forward(params, tokens)
    finally:
        tmoe._dispatch_masks = plain
    return sum(seen)


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


def test_forward_logits_and_aux_match_jax(models):
    jmodel, jparams, model, params = models
    batch = _batch(2, 80)
    jlogits, jaux = jax.jit(jmodel.forward)(jparams, jnp.asarray(batch["tokens"]))
    logits, aux = model.forward(params, torch.from_numpy(batch["tokens"]))
    assert logits.shape == (2, 80, model.cfg.padded_vocab) and aux.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4,
                               rtol=1e-4)
    assert float(jaux) > 0.0
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    # the capacity drop is exercised: some group overflows an expert's queue
    assert _dropped(model, params, torch.from_numpy(batch["tokens"])) > 0


def test_loss_and_every_gradient_match_jax(models):
    jmodel, jparams, model, params = models
    batch = _batch(2, 80, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, _j(batch))
    loss, grads = value_and_grad(model.loss, params, _t(batch))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = tree_items(_np_tree(jgrads))
    paths = [path for path, _ in want]
    assert [path for path, _ in tree_items(params)] == paths
    names = {n for path in paths for n in path}
    expect = {"router", "shared", "w_gate", "w_up", "w_down"}
    if model.cfg.mla:
        expect |= {"wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "q_norm", "kv_norm"}
    else:
        expect |= {"wq", "wk", "wv", "q_norm", "k_norm"}
        expect.discard("shared")
    assert expect <= names
    for (_, g), (path, w) in zip(tree_items(grads), want):
        w = np.asarray(w, dtype=np.float32)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()), err_msg=str(path))


def test_mla_attention_xla_values_and_grads_match_jax():
    jcfg, cfg = _cfgs("deepseek-v3-671b")
    jp = jax.tree.map(lambda a: a[0], _jax_init("deepseek-v3-671b")["seg0"]["s0_dense"]["attn"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 80, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 80, cfg.d_model)).astype(np.float32)
    pos = jnp.arange(80, dtype=jnp.int32)

    def jf(p_, x_):
        y, _ = jmla.mla_attention(jcfg, p_, x_, RULES, pos)
        return jnp.sum(y * w), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))
    p = convert.params_from_numpy(_np_tree(jp))
    for t in p.values():
        t.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    tables = tmla.mla_rope_tables(cfg, torch.arange(80)[None])
    y, _ = tmla.mla_attention(cfg, p, tx, tables, impl="xla")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    names = sorted(p)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), [tx] + [p[n] for n in names])
    for g, want, name in zip(grads, [jgx] + [jgp[n] for n in names], ["x"] + names):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)
    with pytest.raises(RuntimeError, match="has no backward"):
        tmla.mla_attention(cfg, p, tx, tables)            # the kernel refuses grad


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_equals_none(arch):
    _, cfg = _cfgs(arch)
    batch = _t(_batch(2, 40, seed=2))
    out = {}
    for remat in ("none", "full"):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        leaves = [t.requires_grad_() for _, t in tree_items(params)]
        logits, aux = model.forward(params, batch["tokens"])
        loss = model.loss(params, batch)
        out[remat] = (loss.detach(), aux.detach(), torch.autograd.grad(loss, leaves))
    assert torch.equal(out["none"][0], out["full"][0])
    assert torch.equal(out["none"][1], out["full"][1]) and float(out["full"][1]) > 0
    for a, b in zip(out["none"][2], out["full"][2]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _opt_pair(name):
    lr = {"sgd": 1e-2, "momentum": 1e-2, "adamw": 1e-3}[name]
    return jopt.get_optimizer(name, lr=lr), topt.get_optimizer(name, lr=lr)


STEP_CASES = ([("qwen3-moe-235b-a22b", o, n) for o in ("sgd", "momentum", "adamw")
               for n in (1, 2)]
              + [("deepseek-v3-671b", "momentum", 2), ("deepseek-v3-671b", "adamw", 1)])


@pytest.mark.parametrize("arch,opt,n_micro", STEP_CASES,
                         ids=[f"{a.split('-')[0]}-{o}-{n}" for a, o, n in STEP_CASES])
def test_train_step_matches_jax(arch, opt, n_micro):
    """Three steps from JAX's weights on the same batches (B 4 x 24)."""
    jcfg, cfg = _cfgs(arch)
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jo, to = _opt_pair(opt)
    jparams = _jax_init(arch)
    params = convert.params_from_numpy(_np_tree(jparams))
    jstate, state = jo.init(jparams), to.init(params)
    jstep = jax.jit(jax_train_step(jmodel, jo, RULES, n_microbatches=n_micro))
    step = make_train_step(model, to, n_microbatches=n_micro)
    for i in range(3):
        batch = _batch(4, 24, seed=10 + i)
        jparams, jstate, jm = jstep(jparams, jstate, _j(batch))
        params, state, m = step(params, state, _t(batch))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    for (path, got), (_, want) in zip(tree_items(params), tree_items(_np_tree(jparams))):
        np.testing.assert_allclose(got.numpy(), want, **STEP_TOL, err_msg=str(path))
    assert int(state["count"]) == 3


def test_kernel_eval_equals_xla(models):
    """``impl="kernel"`` under ``torch.no_grad()`` (the flash plain version
    here; tests/test_torch_moe_serve.py::test_training_is_refused holds its
    refusal of grad-requiring weights)."""
    _, _, model, params = models
    batch = _t(_batch(2, 40, seed=4))
    got = make_eval_step(model, "kernel")(params, batch)
    want = make_eval_step(model, "xla")(params, batch)
    assert not got.requires_grad
    assert float(got) == pytest.approx(float(want), rel=1e-5)


# ---------------------------------------------------------------------------
# checkpoints and the Trainer
# ---------------------------------------------------------------------------


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_jax_checkpoint_of_the_moe_tree_restores_bit_exactly(tmp_path):
    """Reduced qwen3-moe as published (bf16 weights, float32 norms and
    router) with adamw moments, written by the JAX package, read into the
    port's own freshly initialised trees."""
    cfg = get_arch("qwen3-moe-235b-a22b").reduced()
    jparams = _jax_init("qwen3-moe-235b-a22b", cfg.dtype)
    jo = jopt.adamw()
    jstate = jax.jit(jo.update)(jax.tree.map(lambda a: a * 0.5, jparams), jo.init(jparams),
                                jparams)[1]
    jck.save(str(tmp_path), 7, jparams, opt_state=jstate, extra={"data": {"seed": 0, "step": 7}})
    model = build_model(cfg)
    proto = model.init(torch.Generator().manual_seed(1), "cpu")
    tproto = topt.adamw().init(proto)
    got, got_state, extra, step = tck.restore(str(tmp_path), proto, tproto, device="cpu")
    assert step == 7 and extra == {"data": {"seed": 0, "step": 7}}
    for want, have in ((jparams, got), (jstate, got_state)):
        wl, hl = tree_items(_np_tree(want)), tree_items(have)
        assert [p for p, _ in wl] == [p for p, _ in hl]
        for (path, w), (_, h) in zip(wl, hl):
            assert str(h.dtype).split(".")[-1] == np.asarray(w).dtype.name, path
            np.testing.assert_array_equal(_bits(h), _bits(w), err_msg=str(path))


def test_trainer_on_deepseek_restores_after_a_crash(tmp_path):
    cfg = get_arch("deepseek-v3-671b").reduced()
    out = {}
    for label, fault in (("faulty", FaultInjector(fail_at={5})), ("clean", None)):
        data = tpipe.SyntheticLMData(cfg, batch=2, seq=16, device="cpu")
        tcfg = TrainerConfig(total_steps=8, ckpt_dir=str(tmp_path / label), ckpt_every=4,
                             optimizer="momentum", lr=1e-2, log_every=100)
        tr = Trainer(build_model(cfg), data, tcfg, fault_injector=fault, device="cpu")
        out[label] = tr.run_with_restarts(0), data
    ((state, restarts), data), ((clean, clean_restarts), _) = out["faulty"], out["clean"]
    assert (restarts, state.step, data.state.step) == (1, 8, 8)
    assert (clean_restarts, clean.step) == (0, 8)
    assert state.losses == clean.losses[-len(state.losses):]
    assert all(np.isfinite(clean.losses))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--device", "cpu",
         "--steps", "4", "--batch", "2", "--seq", "32", "--optimizer", "momentum"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "done: step=4" in proc.stdout


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_full_refuses_what_one_card_cannot_hold(arch):
    from repro_torch.launch.train import main

    with pytest.raises(SystemExit, match="does not fit one 80 GB card"):
        main(["--arch", arch, "--full", "--device", "cpu"])
