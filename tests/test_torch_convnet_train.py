"""The port's ConvNet training path against the JAX package's, on the CPU.

Weights are the JAX ``ConvNetExecutor.init(jax.random.key(0))`` tree carried
across through ``repro_torch.convert``; images and labels come from numpy
with a seed.  Tolerances (float32 throughout; only the summation order
differs between XLA:CPU and PyTorch):

* logits atol = rtol = 1e-4, loss rel 1e-5, and each gradient leaf within
  1e-4 of its largest entry (rtol 1e-4);
* the port's two executors (``"xla"`` and the kernels' plain versions)
  against each other at atol = rtol = 1e-4;
* ``examples/torch_train_convnet.py`` against the JAX example's recipe,
  8 steps: losses rel 1e-4 at every step, parameters atol = rtol = 1e-4;
* checkpoints: bit-exact.

Max-pooling's backward sends a window's gradient to one of its largest
inputs.  In these nets every pool follows a ReLU, and a window of ReLU
zeros ties; which zero takes the gradient differs between the two sides
and does not matter, because the ReLU's derivative at 0 is 0 on both.
``test_maxpool_backward_over_relu_ties_matches_jax`` checks that on inputs
made mostly of such ties.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import convnet as jconvnet  # noqa: E402
from repro.core import tiling as jtiling  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import convnet as tconvnet  # noqa: E402
from repro_torch.core import zoo as tzoo  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
NETS = {
    "small": lambda: tconvnet.make_small_convnet(num_classes=10, width=16, input_px=16),
    # VGG16's 13 conv, 5 pool and 3 fc layers, channels / 16, 32-px input
    "vgg16_narrow": lambda: tconvnet.narrow_convnet(tzoo.vgg16(), channel_div=16,
                                                    input_px=32),
}


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_train_convnet", REPO / "examples" / "torch_train_convnet.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(name, batch=4):
    layers = NETS[name]()
    jlayers = [jtiling.ConvLayerSpec(**dataclasses.asdict(l)) for l in layers]
    jparams = jax.jit(jconvnet.ConvNetExecutor(jlayers, impl="xla").init)(jax.random.key(0))
    px = layers[0].xi
    rng = np.random.default_rng(5)
    x = rng.standard_normal((batch, px, px, 3)).astype(np.float32)
    labels = rng.integers(0, layers[-1].co, size=(batch,)).astype(np.int32)
    return layers, jlayers, jparams, x, labels


@pytest.mark.parametrize("name", list(NETS))
def test_xla_logits_loss_and_grads_match_jax(name):
    layers, jlayers, jparams, x, labels = _setup(name)
    jexe = jconvnet.ConvNetExecutor(jlayers, impl="xla")
    exe = tconvnet.ConvNetExecutor(layers, impl="xla")
    params = convert.params_from_numpy(_np_tree(jparams))
    jlogits = jax.jit(jexe.apply)(jparams, jnp.asarray(x))
    logits = exe.apply(params, torch.from_numpy(x))
    assert logits.shape == (x.shape[0], layers[-1].co)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(jexe.loss_fn))(jparams, jnp.asarray(x),
                                                              jnp.asarray(labels))
    loss, grads = value_and_grad(exe.loss_fn, params, torch.from_numpy(x),
                                 torch.from_numpy(labels))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    jleaves = tree_items(_np_tree(jgrads))
    assert [p for p, _ in tree_items(grads)] == [p for p, _ in jleaves]
    for (path, g), (_, want) in zip(tree_items(grads), jleaves):
        assert g.is_contiguous() and g.shape == want.shape
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=str(path))


@pytest.mark.parametrize("name", list(NETS))
def test_xla_matches_the_kernel_executor(name):
    """The same weights and images through ``"xla"`` and through the
    kernels' plain versions (``"kernel"``, the inference default)."""
    layers, _, jparams, x, _ = _setup(name)
    params = convert.params_from_numpy(_np_tree(jparams))
    with torch.no_grad():
        want = tconvnet.ConvNetExecutor(layers).apply(params, torch.from_numpy(x))
        got = tconvnet.ConvNetExecutor(layers, impl="xla").apply(params, torch.from_numpy(x))
    torch.testing.assert_close(got, want, **TOL)
    assert set(tops.LAUNCHES.values()) == {0}            # the CPU launches nothing


@pytest.mark.parametrize("pool", [(2, 2, 0), (3, 2, 1)], ids=["2x2s2", "3x3s2p1"])
def test_maxpool_backward_over_relu_ties_matches_jax(pool):
    """relu then max-pool, most windows all zeros (ties): the gradient with
    respect to the pre-ReLU input equals JAX's exactly (atol 1e-6)."""
    k, s, p = pool
    layer = tconvnet.ConvLayerSpec("pool", 8, 8, 4, 4, k, k, s, s, p, p, "pool", False)
    jl = jtiling.ConvLayerSpec(**dataclasses.asdict(layer))
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 8, 8, 4)) - 1.5).astype(np.float32)   # ~93 % below 0
    w = rng.standard_normal((2, layer.yo, layer.xo, 4)).astype(np.float32)

    def jf(x_):
        return jnp.sum(jconvnet._maxpool(jax.nn.relu(x_), jl) * w)

    want = jax.grad(jf)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tconvnet._maxpool_xla(torch.relu(tx), layer)
    (got,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), tx)
    assert float((out == 0).float().mean()) > 0.5              # ties are common
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# (H, W, Ci, Co, KH, KW, stride, padding): the small net's 3x3 / pad 1, a
# strided 2x2 with no padding, AlexNet's conv1 shape cut in width (11x11 / 4)
EXACT_WGRAD_CASES = [(8, 8, 16, 32, 3, 3, (1, 1), (1, 1)),
                     (9, 7, 5, 6, 2, 2, (2, 2), (0, 0)),
                     (23, 23, 3, 8, 11, 11, (4, 4), (2, 2))]


@pytest.mark.parametrize("case", EXACT_WGRAD_CASES, ids=["3x3s1p1", "2x2s2", "11x11s4p2"])
def test_conv2d_exact_wgrad_matches_jax(case):
    """``conv2d_exact_wgrad`` (the card's float32 convolution in ``impl="xla"``,
    weight gradient by im2col) against JAX's ``_conv_xla`` and its VJP: values
    and both gradients at the module's tolerance, and exact zeros where an
    input channel is all zero (as in the reference's direct convolution)."""
    h, w_, ci, co, kh, kw, stride, padding = case
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, h, w_, ci)).astype(np.float32)
    x[..., 0] = 0.0                                   # a dead input channel
    wt = rng.standard_normal((kh, kw, ci, co)).astype(np.float32)
    layer = tconvnet.ConvLayerSpec("conv", h, w_, ci, co, kh, kw, stride[0], stride[1],
                                   padding[0], padding[1], "conv", False)
    jl = jtiling.ConvLayerSpec(**dataclasses.asdict(layer))
    want, vjp = jax.vjp(lambda a, b: jconvnet._conv_xla(a, b, jl), jnp.asarray(x),
                        jnp.asarray(wt))
    gout = rng.standard_normal(want.shape).astype(np.float32)
    want_gx, want_gw = vjp(jnp.asarray(gout))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(wt).requires_grad_()
    got = tconvnet._nhwc(tconvnet.conv2d_exact_wgrad(tconvnet._nchw(tx), tw.permute(3, 2, 0, 1),
                                                     stride, padding))
    gx, gw = torch.autograd.grad(got, (tx, tw), torch.from_numpy(gout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, w in ((gx, want_gx), (gw, want_gw)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))
    assert np.all(np.asarray(want_gw)[:, :, 0] == 0) and torch.all(gw[:, :, 0] == 0)


def test_kernel_executor_still_refuses_grad():
    layers, _, jparams, x, labels = _setup("small")
    params = convert.params_from_numpy(_np_tree(jparams))
    exe = tconvnet.ConvNetExecutor(layers)
    assert exe.impl == "kernel"
    with pytest.raises(RuntimeError, match="has no backward"):
        value_and_grad(exe.loss_fn, params, torch.from_numpy(x), torch.from_numpy(labels))
    with pytest.raises(ValueError, match="impl must be one of"):
        tconvnet.ConvNetExecutor(layers, impl="pallas")


def _jax_recipe(opt_name, steps, width=16, batch=32):
    """``examples/train_convnet.py``'s loop, step for step: returns the
    losses and the final parameters."""
    layers = jconvnet.make_small_convnet(num_classes=10, width=width, input_px=16)
    exe = jconvnet.ConvNetExecutor(layers, impl="xla")
    data = jpipe.SyntheticImageData(px=16, channels=3, classes=10, batch=batch)
    opt = (jopt.momentum(lr=3e-3) if opt_name == "momentum"
           else jopt.adamw(lr=3e-3, weight_decay=0.0))
    params = exe.init(jax.random.key(0))
    init = _np_tree(params)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(exe.loss_fn)(params, x, y)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    losses = []
    for _ in range(steps):
        x, y = data.next()
        params, opt_state, loss = step(params, opt_state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return init, losses, params


@pytest.mark.parametrize("opt", ["momentum", "adamw"])
def test_train_example_matches_jax_recipe(opt, tmp_path):
    init, jlosses, jparams = _jax_recipe(opt, 8)
    ex = _example()
    losses, params, opt_state = ex.train(steps=8, opt=opt, ckpt=str(tmp_path), device="cpu",
                                         init_params=convert.params_from_numpy(init),
                                         ckpt_every=4)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    for (path, got), (_, want) in zip(tree_items(params), tree_items(_np_tree(jparams))):
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=str(path))
    assert int(opt_state["count"]) == 8
    assert tck.latest_step(str(tmp_path)) == 8


def test_train_example_checkpoint_restores_bit_exactly_in_jax(tmp_path):
    init, _, _ = _jax_recipe("momentum", 0)
    ex = _example()
    _, params, _ = ex.train(steps=8, opt="momentum", ckpt=str(tmp_path), device="cpu",
                            init_params=convert.params_from_numpy(init), ckpt_every=4)
    jgot, extra, step = jck.restore(str(tmp_path), init)
    assert step == 8 and extra == {"data": {"seed": 0, "step": 8}}
    for (path, want), (_, got) in zip(tree_items(params), tree_items(_np_tree(jgot))):
        np.testing.assert_array_equal(got, want.numpy(), err_msg=str(path))
    got, extra, step = tck.restore(str(tmp_path), params, device="cpu")
    assert step == 8 and extra["data"]["step"] == 8
    for (_, want), (_, have) in zip(tree_items(params), tree_items(got)):
        assert torch.equal(have, want)


def test_train_example_main_learns_on_the_cpu(tmp_path, capsys):
    """The example's command line with ``--device cpu``: 60 adamw steps cut
    the loss by more than the 10 % its check asks for."""
    losses = _example().main(["--device", "cpu", "--steps", "60", "--ckpt", str(tmp_path)])
    assert len(losses) == 60 and np.mean(losses[-20:]) < 0.9 * np.mean(losses[:20])
    assert "latest checkpoint: step 50" in capsys.readouterr().out


def test_quickstart_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", REPO / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    logits = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())
    assert "VGG16" in out and "T_Ci=" in out
