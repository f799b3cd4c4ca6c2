"""The port's ConvNet slice against the JAX package, on the CPU.

The same numpy inputs (float32, from a seed) go through ``repro_torch`` on
the CPU (the plain PyTorch versions of ``stream_mac_conv``,
``stream_maxpool`` and ``tiled_matmul``) and through the JAX oracles
(``repro.kernels.ref``), the Pallas kernels in interpret mode
(``repro.kernels.ops``) and the JAX ``ConvNetExecutor``.

Tolerances: float32 atol = rtol = 1e-4 for convolutions, products and
logits (both sides compute in float32; only the summation order differs);
max-pooling is exact, so it must be bit-equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import convnet as jconvnet  # noqa: E402
from repro.core import tiling as jtiling  # noqa: E402
from repro.core import zoo as jzoo  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import convnet as tconvnet  # noqa: E402
from repro_torch.core import zoo as tzoo  # noqa: E402
from repro_torch.core.tiling import ConvLayerSpec, Tile4D  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# kernels: the cases of tests/test_kernels.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [
    (8, 16, 8), (64, 96, 80), (128, 128, 128), (200, 300, 100), (1, 7, 5),
    (256, 512, 128),
])
def test_tiled_matmul_matches_jax(m, k, n):
    rng = _rng()
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    got = tops.tiled_matmul(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.tiled_matmul(x, y)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jops.tiled_matmul(jnp.asarray(x), jnp.asarray(y), interpret=True)), **TOL)


@pytest.mark.parametrize("n,hw,ci,co,k,s,p", [
    (1, 16, 8, 16, 3, 1, 1),
    (2, 12, 3, 8, 5, 2, 2),
    (1, 9, 4, 4, 1, 1, 0),
    (1, 11, 3, 96, 11, 4, 0),       # AlexNet conv1 shape family
    (1, 8, 130, 8, 3, 1, 1),        # ci > lane width: multi-pass T_Ci
    (2, 7, 5, 6, 7, 1, 3),
])
def test_stream_mac_conv_matches_jax(n, hw, ci, co, k, s, p):
    rng = _rng(1)
    x = rng.standard_normal((n, hw, hw, ci)).astype(np.float32)
    w = (rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci)).astype(np.float32)
    got = tops.stream_mac_conv(torch.from_numpy(x), torch.from_numpy(w),
                               stride=(s, s), padding=(p, p)).numpy()
    want = np.asarray(jref.stream_mac_conv(x, w, stride=(s, s), padding=(p, p)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    pallas = jops.stream_mac_conv(jnp.asarray(x), jnp.asarray(w), stride=(s, s),
                                  padding=(p, p), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
def test_stream_mac_conv_epilogue_bit_equal_to_unfused(dtype, relu):
    """conv(bias, relu) rounds as conv, then + b in x's type, then ReLU."""
    rng = _rng(3)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 16)).astype(np.float32)).to(dt)
    w = torch.from_numpy((rng.standard_normal((3, 3, 16, 24)) / 12).astype(np.float32)).to(dt)
    b = torch.from_numpy(rng.standard_normal(24).astype(np.float32)).to(dt)
    got = tops.stream_mac_conv(x, w, stride=(2, 1), padding=(1, 1), bias=b, relu=relu)
    want = tops.stream_mac_conv(x, w, stride=(2, 1), padding=(1, 1)) + b
    if relu:
        want = torch.relu(want)
    assert got.dtype == dt and torch.equal(got, want)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,hw,ci,co,k,s,p", [(1, 16, 8, 16, 3, 1, 1), (2, 12, 3, 8, 5, 2, 2)])
def test_stream_mac_conv_epilogue_matches_jax(relu, n, hw, ci, co, k, s, p):
    rng = _rng(4)
    x = rng.standard_normal((n, hw, hw, ci)).astype(np.float32)
    w = (rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci)).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    got = tops.stream_mac_conv(torch.from_numpy(x), torch.from_numpy(w), stride=(s, s),
                               padding=(p, p), bias=torch.from_numpy(b), relu=relu).numpy()
    want = jops.stream_mac_conv(jnp.asarray(x), jnp.asarray(w), stride=(s, s),
                                padding=(p, p), interpret=True) + b
    if relu:
        want = jax.nn.relu(want)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_stream_mac_conv_asymmetric_stride_matches_jax():
    rng = _rng(2)
    x = rng.standard_normal((1, 12, 10, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
    got = tops.stream_mac_conv(torch.from_numpy(x), torch.from_numpy(w),
                               stride=(2, 1), padding=(1, 1)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jref.stream_mac_conv(x, w, stride=(2, 1), padding=(1, 1))), **TOL)
    pallas = jops.stream_mac_conv(jnp.asarray(x), jnp.asarray(w), stride=(2, 1),
                                  padding=(1, 1), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("hw,c,k,s", [(8, 5, 2, 2), (13, 16, 3, 2), (7, 130, 3, 1)])
def test_stream_maxpool_bit_equal_to_jax(hw, c, k, s):
    x = _rng(3).standard_normal((2, hw, hw, c)).astype(np.float32)
    got = tops.stream_maxpool(torch.from_numpy(x), (k, k), (s, s)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.stream_maxpool(x, (k, k), (s, s))))
    pallas = jops.stream_maxpool(jnp.asarray(x), (k, k), (s, s), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_padded_maxpool_layer_matches_reduce_window():
    """The executor's -inf padding before the VALID kernel gives the JAX
    executor's padded ``reduce_window`` (GoogLeNet's and ResNet's pool1)."""
    layer = ConvLayerSpec("pool1", 9, 9, 6, 6, 3, 3, 2, 2, 1, 1, "pool", False)
    x = _rng(4).standard_normal((2, 9, 9, 6)).astype(np.float32)
    got = tconvnet._maxpool(torch.from_numpy(x), layer).numpy()
    jlayer = jtiling.ConvLayerSpec(**dataclasses.asdict(layer))
    np.testing.assert_array_equal(got, np.asarray(jconvnet._maxpool(jnp.asarray(x), jlayer)))


def test_cpu_calls_launch_nothing_and_other_devices_raise():
    tops.reset_launches()
    x = torch.randn(1, 8, 8, 4)
    w = torch.randn(3, 3, 4, 8)
    tops.stream_mac_conv(x, w, padding=(1, 1))
    tops.stream_maxpool(x, (2, 2), (2, 2))
    tops.tiled_matmul(x.reshape(8, 32), w.reshape(36, 8)[:32])
    assert set(tops.LAUNCHES.values()) == {0}
    # a tensor on neither the CPU nor a card is refused, never run plain
    meta = x.to("meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tops.stream_mac_conv(meta, w.to("meta"))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tops.stream_maxpool(meta, (2, 2), (2, 2))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tops.tiled_matmul(meta.reshape(8, 32), meta.reshape(32, 8))
    assert set(tops.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


def _jax_layers(layers):
    return [jtiling.ConvLayerSpec(**dataclasses.asdict(l)) for l in layers]


NETS = {
    "small": lambda: tconvnet.make_small_convnet(num_classes=4, width=8, input_px=16),
    # VGG16's 13 conv, 5 pool and 3 fc layers, channels / 16, 32-px input
    "vgg16_narrow": lambda: tconvnet.narrow_convnet(tzoo.vgg16(), channel_div=16,
                                                    input_px=32),
}


def _setup(name, batch=2):
    layers = NETS[name]()
    jlayers = _jax_layers(layers)
    jparams = jconvnet.ConvNetExecutor(jlayers).init(jax.random.key(0))
    nparams = jax.tree_util.tree_map(np.asarray, jparams)
    px = layers[0].xi
    x = _rng(5).standard_normal((batch, px, px, 3)).astype(np.float32)
    labels = _rng(6).integers(0, layers[-1].co, size=(batch,)).astype(np.int32)
    return layers, jlayers, jparams, nparams, x, labels


def test_narrow_vgg16_keeps_the_structure():
    layers = NETS["vgg16_narrow"]()
    kinds = [l.kind for l in layers]
    assert (kinds.count("conv"), kinds.count("pool"), kinds.count("fc")) == (13, 5, 3)
    assert [l.name for l in layers] == [l.name for l in tzoo.vgg16()]
    for a, b in zip(layers, layers[1:]):          # shapes chain
        if b.kind == "fc" and a.kind == "pool":
            assert b.ci * b.kx * b.ky == a.co * a.xo * a.yo
        else:
            assert (b.ci, b.xi) == (a.co, a.xo)
    assert layers[-1].co == 1000 and layers[-1].xo == 1


@pytest.mark.parametrize("name", sorted(NETS))
def test_executor_logits_and_loss_match_jax(name):
    layers, jlayers, jparams, nparams, x, labels = _setup(name)
    params = params_from_numpy(nparams)
    exe = tconvnet.ConvNetExecutor(layers)
    got = exe.apply(params, torch.from_numpy(x)).numpy()
    assert got.shape == (x.shape[0], layers[-1].co) and np.isfinite(got).all()
    for impl in ("xla", "pallas"):
        want = np.asarray(jconvnet.ConvNetExecutor(jlayers, impl=impl).apply(jparams, x))
        np.testing.assert_allclose(got, want, **TOL, err_msg=impl)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    loss = float(exe.loss_fn(params, torch.from_numpy(x), torch.from_numpy(labels)))
    jloss = float(jconvnet.ConvNetExecutor(jlayers).loss_fn(jparams, x, jnp.asarray(labels)))
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert exe.flops_per_example() == jconvnet.ConvNetExecutor(jlayers).flops_per_example()


@pytest.mark.parametrize("name", sorted(NETS))
def test_tiled_schedule_matches_jax(name):
    """The T_Ci-partial schedule, with test_substrates.py's tiles."""
    layers, jlayers, jparams, nparams, x, _ = _setup(name)
    tiles = {l.name: Tile4D(10, 10, max(l.ci // 2, 1), l.co)
             for l in layers if l.kind == "conv"}
    jtiles = {k: jtiling.Tile4D(**dataclasses.asdict(t)) for k, t in tiles.items()}
    got = tconvnet.ConvNetExecutor(layers, impl="tiled", tiles=tiles).apply(
        params_from_numpy(nparams), torch.from_numpy(x)).numpy()
    for impl, kw in (("xla", {}), ("tiled", {"tiles": jtiles})):
        want = np.asarray(jconvnet.ConvNetExecutor(jlayers, impl=impl, **kw).apply(jparams, x))
        np.testing.assert_allclose(got, want, **TOL, err_msg=impl)


def test_jax_params_carry_across_unchanged():
    """``convert.params_from_numpy`` maps the JAX executor's parameter tree
    onto the port's leaf for leaf: same layers, names, shapes and values,
    and the port's own init builds the same structure."""
    layers, _, _, nparams, _, _ = _setup("vgg16_narrow")
    params = params_from_numpy(nparams)
    own = tconvnet.ConvNetExecutor(layers).init(torch.Generator().manual_seed(0), "cpu")
    assert sorted(params) == sorted(nparams) == sorted(own)
    for name, leaves in nparams.items():
        assert sorted(params[name]) == sorted(leaves) == ["b", "w"]
        for leaf, a in leaves.items():
            t = params[name][leaf]
            assert t.dtype == torch.float32 and tuple(t.shape) == a.shape
            assert tuple(own[name][leaf].shape) == a.shape
            np.testing.assert_array_equal(t.numpy(), a)


def test_executor_entry_points_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour cannot be observed")
    exe = tconvnet.ConvNetExecutor(NETS["small"]())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exe.init(torch.Generator().manual_seed(0))
    params = exe.init(torch.Generator().manual_seed(0), "cpu")
    assert params["conv1"]["w"].device.type == "cpu"
    # "xla" is the differentiable executor (tests/test_torch_convnet_train.py);
    # JAX's "pallas" is "kernel" here
    assert tconvnet.ConvNetExecutor(NETS["small"](), impl="xla").impl == "xla"
    with pytest.raises(ValueError, match="impl must be one of"):
        tconvnet.ConvNetExecutor(NETS["small"](), impl="pallas")


# ---------------------------------------------------------------------------
# the zoo copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jzoo.ZOO))
def test_zoo_copy_equals_jax_zoo(name):
    mine, theirs = tzoo.ZOO[name](), jzoo.ZOO[name]()
    assert [dataclasses.asdict(l) for l in mine] == [dataclasses.asdict(l) for l in theirs]
    for a, b in zip(mine, theirs):
        assert (a.xo, a.yo, a.macs, a.flops, a.in_bytes, a.out_bytes, a.coeff_bytes) == \
               (b.xo, b.yo, b.macs, b.flops, b.in_bytes, b.out_bytes, b.coeff_bytes)
    assert tzoo.table1_row(mine) == jzoo.table1_row(theirs)
    assert tzoo.total_macs(mine) == jzoo.total_macs(theirs)


def test_zoo_tables_and_tiles_equal_jax():
    assert sorted(tzoo.ZOO) == sorted(jzoo.ZOO)
    assert tzoo.PAPER_FPS == jzoo.PAPER_FPS and tzoo.PAPER_TABLE1 == jzoo.PAPER_TABLE1
    layer = tzoo.vgg16()[0]
    t, jt = Tile4D(34, 18, 3, 64), jtiling.Tile4D(34, 18, 3, 64)
    jl = jtiling.ConvLayerSpec(**dataclasses.asdict(layer))
    assert (t.txo(layer), t.tyo(layer), t.r_tcl()) == (jt.txo(jl), jt.tyo(jl), jt.r_tcl())
