"""The training step on static buffers (``train.captured.CapturedTrainStep``),
the form the card replays as one CUDA graph, against the eager step and
against ``jax.jit(make_train_step(...))`` on the CPU.

On the CPU the captured path runs the step on its static buffers
(``capture=False``).  Tolerances, all float32:

* against the eager step (``make_train_step`` called directly): losses,
  grad norms and every parameter bit-equal;
* against JAX: loss and grad norm rel 1e-4, parameters atol = rtol = 1e-4
  (``tests/test_torch_train.py``'s train-step tolerance).

Also: every tensor of ``params`` and ``opt_state`` keeps its address
through the eager step while its value changes (the graph replays on those
addresses), the address check, one static buffer set per batch signature,
and the ``Trainer`` through a crash: its losses equal an uninterrupted run's
and JAX's ``Trainer``'s, and the restart builds a new captured step.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.dist.fault import FaultInjector as JFault  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.common import DEFAULT_RULES, AxisRules  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro.train.train_step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.dist.fault import FaultInjector  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_items, tree_map  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train.captured import CapturedTrainStep  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

RULES = AxisRules(DEFAULT_RULES)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
LR = {"sgd": 1e-2, "momentum": 1e-2, "adamw": 1e-3}
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the reduced models run tiny ops, which more
    threads only slow down while the suite's other workers hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """JAX's reduced float32 ``arch`` and its weights, the port's model and
    those weights converted (once per file: the cases step copies)."""
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    jmodel = jax_build(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.key(0))
    return jmodel, jparams, build_model(cfg), convert.params_from_numpy(_np_tree(jparams))


def _batches(cfg, n, batch=2, seq=16):
    """``n`` batches of the port's synthetic stream (patches for the vlm,
    frames for the audio family) as numpy arrays."""
    data = tpipe.SyntheticLMData(cfg, batch=batch, seq=seq, device="cpu")
    return [{k: v.numpy() for k, v in data.next().items()} for _ in range(n)]


def _lm_batches(vocab, n):
    """``tests/test_torch_train.py``'s train-step batches: B 4 x 24 tokens
    from seeds 0, 1, ..."""
    out = []
    for i in range(n):
        toks = np.random.default_rng(i).integers(0, vocab, size=(4, 25)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def _run(model, params, opt, n_micro, batches, captured):
    """The port's steps from a copy of ``params``: ([(loss, grad norm)],
    params, opt_state, the captured step or None)."""
    o = topt.get_optimizer(opt, lr=LR[opt])
    p = tree_map(lambda t: t.clone(), params)
    s = o.init(p)
    step = make_train_step(model, o, n_microbatches=n_micro)
    if captured:
        step = CapturedTrainStep(step, p, s, CPU, capture=False)
    metrics = []
    for b in batches:
        p, s, m = step(p, s, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append((m["loss"].clone(), m["grad_norm"].clone()))
    return metrics, p, s, step if captured else None


def _check(arch, opt, n_micro, batches):
    jmodel, jparams, model, params = _models(arch)
    steps = len(batches)
    eager, ep, es, _ = _run(model, params, opt, n_micro, batches, captured=False)
    got, gp, gs, step = _run(model, params, opt, n_micro, batches, captured=True)
    assert step.runs == steps and step.replays == 0 and step.graphs == 0
    # the captured path against the eager step: bit for bit
    for (gl, gn), (el, en) in zip(got, eager):
        assert torch.equal(gl, el) and torch.equal(gn, en)
    for (path, a), (_, b) in zip(tree_items([gp, gs]), tree_items([ep, es])):
        assert torch.equal(a, b), path
    assert int(gs["count"]) == steps
    # and against JAX's jitted step
    jo = jopt.get_optimizer(opt, lr=LR[opt])
    jstep = jax.jit(jax_train_step(jmodel, jo, RULES, n_microbatches=n_micro))
    jp, js = jparams, jo.init(jparams)
    for b, (loss, gnorm) in zip(batches, got):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        assert float(loss) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert float(gnorm) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    for (path, a), (_, b) in zip(tree_items(gp), tree_items(_np_tree(jp))):
        np.testing.assert_allclose(a.numpy(), b, **STEP_TOL, err_msg=str(path))


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_captured_step_equals_eager_and_jax(opt, n_micro):
    """Three steps of reduced qwen2.5-3b on ``tests/test_torch_train.py``'s
    batches."""
    _check("qwen2.5-3b", opt, n_micro, _lm_batches(_models("qwen2.5-3b")[2].cfg.vocab_size, 3))


FAMILIES = ["mamba2-130m", "qwen3-moe-235b-a22b", "llava-next-mistral-7b", "whisper-large-v3"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_captured_sgd_step_every_family(arch):
    """Two sgd steps of each other family's reduced model (the vlm's batches
    carry patches, the audio family's frames)."""
    _check(arch, "sgd", 1, _batches(_models(arch)[2].cfg, 2))


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_update_writes_every_state_tensor_in_place(opt):
    """The eager step keeps every tensor of ``params`` and ``opt_state`` at
    its address while changing its value, and advances ``count``: what a
    graph that captured the step reads and writes on every replay."""
    _, _, model, params = _models("qwen2.5-3b")
    o = topt.get_optimizer(opt, lr=LR[opt])
    p = tree_map(lambda t: t.clone(), params)
    s = o.init(p)
    step = make_train_step(model, o)
    leaves = [t for _, t in tree_items([p, s])]
    ptrs = [t.data_ptr() for t in leaves]
    for i, b in enumerate(_batches(model.cfg, 2, batch=2, seq=8)):
        before = [t.clone() for t in leaves]
        p, s, _ = step(p, s, {k: torch.from_numpy(v) for k, v in b.items()})
        assert [t.data_ptr() for _, t in tree_items([p, s])] == ptrs
        for (path, t), old in zip(tree_items([p, s]), before):
            assert not torch.equal(t, old), path
        assert int(s["count"]) == i + 1


def test_address_check_and_batch_signatures():
    """A call with other tensors raises; a new batch shape gets static
    buffers of its own, reused by later batches of that shape."""
    _, _, model, params = _models("qwen2.5-3b")
    o = topt.get_optimizer("sgd", lr=1e-2)
    p = tree_map(lambda t: t.clone(), params)
    s = o.init(p)
    step = CapturedTrainStep(make_train_step(model, o), p, s, CPU, capture=False)
    assert step.holds(p, s)
    for b in _batches(model.cfg, 2, batch=2, seq=8) + _batches(model.cfg, 1, batch=2, seq=4):
        step(p, s, {k: torch.from_numpy(v) for k, v in b.items()})
    assert len(step._graphs) == 2 and step.runs == 3 and int(s["count"]) == 3
    other = tree_map(lambda t: t.clone(), p)
    assert not step.holds(other, s)
    with pytest.raises(RuntimeError, match="not the tensors"):
        step(other, s, {k: torch.from_numpy(v) for k, v in b.items()})
    with pytest.raises(ValueError, match="only a step on the card"):
        CapturedTrainStep(make_train_step(model, o), p, s, CPU, capture=True)


def test_trainer_restart_builds_a_new_step_and_matches_jax(tmp_path):
    """The Trainer (adamw, the default: its count is restored too) through a
    crash at step 6: its losses equal JAX's Trainer's with the same crash,
    its losses and weights an uninterrupted run's bit for bit, and the
    restart (a restore: new tensors) builds a second captured step.  The
    weights are not held to JAX's: a key bias's gradient is 0 in exact
    arithmetic, and adamw turns its rounding noise into steps of up to lr."""
    arch = "qwen2.5-3b"
    jcfg = dataclasses.replace(jax_arch(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")

    def tcfg(root):
        return dict(total_steps=12, ckpt_dir=str(tmp_path / root), ckpt_every=4,
                    optimizer="adamw", lr=1e-3, log_every=100)

    jt = jtrainer.Trainer(jax_build(jcfg), jpipe.SyntheticLMData(jcfg, batch=2, seq=16),
                          jtrainer.TrainerConfig(**tcfg("jax")), RULES,
                          fault_injector=JFault(fail_at={6}))
    jstate, jrestarts = jt.run_with_restarts(jax.random.key(0))
    init = convert.params_from_numpy(_np_tree(jax_build(jcfg).init(jax.random.key(0))))
    runs = {}
    for label, fault in (("faulty", FaultInjector(fail_at={6})), ("clean", None)):
        tr = Trainer(build_model(cfg), tpipe.SyntheticLMData(cfg, batch=2, seq=16, device="cpu"),
                     TrainerConfig(**tcfg(label)), fault_injector=fault, device="cpu")
        used = []                               # the captured step of each step
        make = tr._captured_for
        tr._captured_for = lambda state, make=make, used=used: used.append(make(state)) \
            or used[-1]
        state, restarts = tr.run_with_restarts(0, init_params=init)
        runs[label] = (state, restarts, tr.builds, used)
    (fs, fr, fb, fused), (cs, cr, cb, cused) = runs["faulty"], runs["clean"]
    assert (fr, fs.step, cr, cs.step, jrestarts, jstate.step) == (1, 12, 0, 12, 1, 12)
    # the resumed run's losses (steps 5-12 from the step-4 checkpoint): JAX's,
    # and the uninterrupted run's bit for bit
    np.testing.assert_allclose(fs.losses, jstate.losses, rtol=1e-4)
    assert len(fs.losses) == 8 and fs.losses == cs.losses[4:]
    # six steps on the first state, eight on the restored one; one step for
    # the whole clean run
    assert (fb, cb) == (2, 1) and len(fused) == 14 and len({id(c) for c in cused}) == 1
    assert [c is fused[0] for c in fused] == [True] * 6 + [False] * 8
    assert all(c is fused[-1] for c in fused[6:])
    assert fused[-1].holds(fs.params, fs.opt_state)
    assert not fused[0].holds(fs.params, fs.opt_state)
    for (path, a), (_, b) in zip(tree_items([fs.params, fs.opt_state]),
                                 tree_items([cs.params, cs.opt_state])):
        assert torch.equal(a, b), path
