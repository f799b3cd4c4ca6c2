"""The port's multi-tensor ``stream_gd`` launch on the CPU.

``ops.stream_gd_foreach`` takes a list of leaves, each one or two ``(out,
streams)`` stages, in one launch on the card; on the CPU it runs the plain
version, stage by stage.  These tests hold it bit-equal to one
``stream_gd_into`` call per leaf and stage (the same float32 products and
sums in stream order, rounded once per output), hold the optimizers that
make one such call per step within one ulp of JAX's ``repro.optim`` on the
reduced qwen2.5-3b tree, and check what it refuses.  The card's kernel is
held against the same plain version in ``tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402

# the leaf sizes: one element, a ragged tail only, whole 8-element units,
# a tail past the units, and several thousand units
SIZES = (1, 7, 64, 1003, 8 * 4099)
F32_ULP = dict(atol=1e-6, rtol=1e-6)
BF16_ULP = dict(atol=1e-6, rtol=2.0 ** -7)
BF, F32 = torch.bfloat16, torch.float32


def _tree(form, state_t, grad_t, seed=0):
    """Leaves of SIZES elements, parameters alternately bf16 and float32:
    (w, g, m, extra) per leaf, ``extra`` a third stream for the J = 3 form."""
    g = torch.Generator().manual_seed(seed)

    def new(n, dt):
        return torch.randn(n, generator=g).to(dt)

    return [(new(n, BF if i % 2 else F32), new(n, grad_t), new(n, state_t), new(n, F32))
            for i, n in enumerate(SIZES)]


def _foreach_args(form, tree):
    """(leaves, stage coefficients) of ``stream_gd_foreach`` for ``form``."""
    if form == "sgd":
        return [((w, (w, g)),) for w, g, _, _ in tree], [(0.999, -0.05)]
    if form == "three streams":
        return [((m, (w, g, x)),) for w, g, m, x in tree], [(0.5, -1.0, 0.25)]
    return ([((m, (m, g)), (w, (w, ops.STAGE1))) for w, g, m, _ in tree],
            [(0.9, 1.0), (0.999, -0.05)])


def _per_leaf(form, tree):
    """The same update as one ``stream_gd_into`` call per leaf and stage."""
    for w, g, m, x in tree:
        if form == "sgd":
            ops.stream_gd_into(w, (w, g), (0.999, -0.05))
        elif form == "three streams":
            ops.stream_gd_into(m, (w, g, x), (0.5, -1.0, 0.25))
        else:
            ops.stream_gd_into(m, (m, g), (0.9, 1.0))
            ops.stream_gd_into(w, (w, m), (0.999, -0.05))


@pytest.mark.parametrize("grad_t", [F32, BF], ids=["f32_grads", "bf16_grads"])
@pytest.mark.parametrize("state_t", [F32, BF], ids=["f32_state", "bf16_state"])
@pytest.mark.parametrize("form", ["sgd", "momentum", "three streams"])
def test_foreach_bit_equal_to_per_leaf_calls(form, state_t, grad_t):
    """Both stages: the momentum's stage 2 reads stage 1's output as stored
    (rounded to the state's type), so one call equals the two per leaf."""
    got, want = _tree(form, state_t, grad_t), _tree(form, state_t, grad_t)
    ops.stream_gd_foreach(*_foreach_args(form, got))
    _per_leaf(form, want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert ops.LAUNCHES["stream_gd"] == 0          # the CPU runs the plain version


def test_foreach_takes_an_empty_list_and_empty_leaves():
    ops.stream_gd_foreach([], [(1.0, -0.1)])
    w, g = torch.zeros(0), torch.zeros(0)
    ops.stream_gd_foreach([((w, (w, g)),)], [(1.0, -0.1)])
    assert w.shape == (0,)


def _reduced_qwen_tree(rng, dtype):
    """The reduced qwen2.5-3b parameter tree's shapes (JAX's), filled from
    numpy."""
    cfg = dataclasses.replace(jax_arch("qwen2.5-3b").reduced(), dtype="float32")
    shapes = jax.eval_shape(jax_build(cfg).init, jax.random.key(0))
    return jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape).astype(np.float32)
                                              ).astype(dtype), shapes)


@pytest.mark.parametrize("types", [("float32", "float32"), ("bfloat16", "float32"),
                                   ("bfloat16", "bfloat16")],
                         ids=["f32", "bf16_params_f32_grads", "bf16"])
@pytest.mark.parametrize("name", ["sgd", "momentum"])
def test_optimizer_on_reduced_qwen_tree_matches_jax(name, types):
    """Three updates of the reduced qwen2.5-3b tree (one foreach call each):
    parameters and moment within one ulp of their type of JAX's."""
    p_t, g_t = types
    make_j = {"sgd": lambda: jopt.sgd(lr=0.1, weight_decay=0.01),
              "momentum": lambda: jopt.momentum(lr=0.05, beta=0.9, weight_decay=0.01)}[name]
    make_t = {"sgd": lambda: topt.sgd(lr=0.1, weight_decay=0.01),
              "momentum": lambda: topt.momentum(lr=0.05, beta=0.9, weight_decay=0.01)}[name]
    rng = np.random.default_rng(7)
    jp = _reduced_qwen_tree(rng, getattr(jnp, p_t))
    jo, to = make_j(), make_t()
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    js = jo.init(jp)
    ts = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js))
    for _ in range(3):
        jg = _reduced_qwen_tree(rng, getattr(jnp, g_t))
        jp, js = jo.update(jg, js, jp)
        tp, ts = to.update(convert.params_from_numpy(jax.tree.map(np.asarray, jg)), ts, tp)
    tol = BF16_ULP if p_t == "bfloat16" else F32_ULP
    got, want = list(tree_items(tp)), list(tree_items(jax.tree.map(np.asarray, jp)))
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) > 10
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), **tol,
                                   err_msg=str(path))
    if name == "momentum":
        for (path, a), (_, b) in zip(tree_items(ts["m"]),
                                     tree_items(jax.tree.map(np.asarray, js["m"]))):
            np.testing.assert_allclose(a.numpy(), b, **F32_ULP, err_msg=str(path))
    assert int(ts["count"]) == 3


@pytest.mark.parametrize("name", ["sgd", "momentum"])
def test_optimizer_makes_one_foreach_call_per_step(name, monkeypatch):
    calls = []
    real = ops.stream_gd_foreach
    monkeypatch.setattr(ops, "stream_gd_foreach",
                        lambda leaves, coeffs: calls.append(len(leaves)) or real(leaves, coeffs))
    opt = topt.get_optimizer(name, lr=0.1)
    params = {"a": torch.zeros(3, 4), "b": {"c": torch.ones(5, dtype=BF)}}
    state = opt.init(params)
    for _ in range(2):
        opt.update({"a": torch.ones(3, 4), "b": {"c": torch.ones(5, dtype=BF)}}, state, params)
    assert calls == [2, 2]


def _refusals():
    w, m, g = torch.zeros(8, dtype=BF), torch.zeros(8), torch.zeros(8)
    x = torch.zeros(9)
    meta = torch.zeros(8, device="meta")
    mom = [(0.9, 1.0), (0.999, -0.05)]
    return {
        "mixed devices": (ValueError, "one device",
                          [((w, (w, g)),), ((meta, (meta, meta)),)], [(1.0, -0.1)]),
        "three stages": (ValueError, "1 or 2 stages",
                         [((m, (m, g)), (w, (w, ops.STAGE1)), (g, (g,)))],
                         mom + [(1.0,)]),
        "stage 2 reads stage 1's output tensor": (
            ValueError, "only as ops.STAGE1", [((m, (m, g)), (w, (w, m)))], mom),
        "stage 2 reads a view of stage 1's output": (
            ValueError, "only as ops.STAGE1", [((m, (m, g)), (w, (w, m.view(2, 4).view(8))))],
            mom),
        "an output partly overlaps a stream": (
            ValueError, "partly overlaps", [((x[1:], (x[:-1], g)),)], [(1.0, -0.1)]),
        "STAGE1 in stage 1": (ValueError, "only stage 2",
                              [((m, (m, ops.STAGE1)), (w, (w, g)))], mom),
        "STAGE1 twice": (ValueError, "only stage 2",
                         [((m, (m, g)), (w, (ops.STAGE1, ops.STAGE1)))], mom),
        "STAGE1 at another place": (
            ValueError, "same place",
            [((m, (m, g)), (w, (w, ops.STAGE1))), ((g, (g, m)), (w, (ops.STAGE1, w)))], mom),
        "five streams in a two-stage launch": (
            ValueError, "1 to 4 streams", [((m, (m, g, g, g, g)), (w, (w, ops.STAGE1)))],
            [(1.0,) * 5, (0.999, -0.05)]),
        "a leaf without its second stage": (
            ValueError, "one \\(out, streams\\) pair per stage", [((m, (m, g)),)], mom),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_foreach_refuses(case):
    err, match, leaves, coeffs = _refusals()[case]
    with pytest.raises(err, match=match):
        ops.stream_gd_foreach(leaves, coeffs)


def test_foreach_refuses_grad_inputs_and_accepts_them_under_no_grad():
    w = torch.zeros(8, requires_grad=True)
    g = torch.zeros(8)
    with pytest.raises(RuntimeError, match="has no backward"):
        ops.stream_gd_foreach([((g, (w, g)),)], [(1.0, -0.1)])
    with torch.no_grad():
        ops.stream_gd_foreach([((g, (w, g)),)], [(1.0, -0.1)])
