"""The port's wire codecs, telemetry wire trees and cube layout against the
JAX package's.

* ``compress_tree``/``decompress_tree`` give JAX's compressed leaves, scales
  and round-trip values bit for bit, per mode and dtype, on the tree of
  ``tests/test_dist_unit.py``'s round-trip test (float32 and bf16 leaves;
  bf16 compared by its bits);
* ``wire_pack`` mode ``none`` round-trips bf16, float32, int32 and int64
  leaves bit for bit through a pickle (bf16 rides as a tagged uint16 view:
  the card's machine has no ``ml_dtypes``), and the lossy modes give JAX's
  values;
* ``wire_bytes`` equals JAX's;
* ``wire_snapshot``/``unwire_snapshot`` equal ``repro.obs.wire``'s on a
  ``CubeRouter`` telemetry snapshot, exact and through bf16;
* ``make_cube_mesh(n)`` and ``cube_rules`` equal JAX's for n = 1, 2, 4 on
  this host's one device, and the port picks the reference's cube count on
  a (faked) 8-card machine.
"""
import dataclasses
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import smc as jsmc  # noqa: E402
from repro.dist import collectives as jcol  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.obs import wire as jwire  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import smc  # noqa: E402
from repro_torch.dist import collectives as col  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_items, tree_map  # noqa: E402
from repro_torch.obs import wire  # noqa: E402
from repro_torch.serve import AdmissionConfig, CacheConfig, CubeRouter, EngineConfig, Request  # noqa: E402,E501

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _trees(dtype: str):
    """The same values as a JAX tree and a port tree (bf16 by its bits)."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(3)
    raw = {"a": rng.normal(size=(8, 4)), "nested": {"b": rng.normal(size=(3,))},
           "stack": [rng.normal(size=(2, 2)), 100.0 * rng.normal(size=(5,))]}
    jt = jax.tree.map(lambda a: jnp.asarray(a, jd), raw)
    tt = jax.tree.map(lambda j: _from_jax(j), jt)
    return jt, tt


def _from_jax(j) -> torch.Tensor:
    a = np.asarray(j)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _same(j, t: torch.Tensor) -> bool:
    """Bit equality of a JAX leaf and a port leaf of the same dtype."""
    ref = _from_jax(j)
    return ref.dtype == t.dtype and ref.shape == t.shape and torch.equal(
        ref.view(torch.int16) if t.dtype == torch.bfloat16 else ref,
        t.view(torch.int16) if t.dtype == torch.bfloat16 else t)


def _pairs(jtree, ttree):
    return list(zip(jax.tree.leaves(jtree), [x for _, x in tree_items(ttree)]))


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_tree_equals_jax(mode, dtype):
    jt, tt = _trees(dtype)
    jc, js = jcol.compress_tree(jt, mode)
    tc, ts = col.compress_tree(tt, mode)
    assert all(_same(j, t) for j, t in _pairs(jc, tc))
    assert all(_same(j, t) for j, t in _pairs(js, ts))
    jb = jcol.decompress_tree(jc, js, mode)
    tb = col.decompress_tree(tc, ts, mode)
    assert isinstance(tb["stack"], list) and set(tb) == {"a", "nested", "stack"}
    assert all(_same(j, t) for j, t in _pairs(jb, tb))
    if mode == "int8":
        assert tc["a"].dtype == torch.int8


def test_compress_zero_tree_and_unknown_mode():
    c, s = col.compress_tree({"w": torch.zeros(4, 4)}, "int8")
    back = col.decompress_tree(c, s, "int8")
    assert torch.equal(back["w"], torch.zeros(4, 4))
    with pytest.raises(ValueError):
        col.compress_tree({"w": torch.ones(2)}, "fp4")


def test_wire_pack_none_round_trips_bit_exactly():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 1 << 16, size=(3, 5), dtype=np.uint16)
    bits[0, :4] = [0x7FC1, 0xFF80, 0x8000, 0x0001]          # a NaN payload, -inf, -0, a subnormal
    tree = {"bf16": torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16),
            "i32": torch.from_numpy(rng.integers(-2**31, 2**31, size=(4,), dtype=np.int32)),
            "i64": torch.arange(-3, 3),
            "f32": [torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))],
            (0, "s0_attn", "k"): torch.ones(2, dtype=torch.bfloat16)}
    msg = pickle.loads(pickle.dumps(col.wire_pack(tree, "none")))
    assert isinstance(msg["comp"]["bf16"], tuple)               # the tagged uint16 view
    back = col.wire_unpack(msg)
    for path in ("bf16", "i32", "i64", (0, "s0_attn", "k")):
        a, b = tree[path], back[path]
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    assert torch.equal(back["f32"][0], tree["f32"][0])


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_wire_pack_lossy_modes_give_jax_values(mode):
    jt, tt = _trees("float32")
    jb = jcol.wire_unpack(jcol.wire_pack(jt, mode))
    tb = col.wire_unpack(pickle.loads(pickle.dumps(col.wire_pack(tt, mode))))
    assert all(_same(j, t) for j, t in _pairs(jb, tb))


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wire_bytes_equals_jax(mode, dtype):
    jt, tt = _trees(dtype)
    assert col.wire_bytes(tt, mode) == jcol.wire_bytes(jt, mode)
    assert col.wire_bytes({"w": torch.ones((16, 16))}, "int8") == 16 * 16 + 4


@pytest.fixture(scope="module")
def router_snapshot():
    """A two-cube CubeRouter's telemetry after 4 requests (reduced
    qwen2.5-3b, inline admission, a swapping host tier)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = dataclasses.replace(get_arch("qwen2.5-3b").reduced(), dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        ecfg = EngineConfig(batch_slots=2, max_len=32,
                            cache=CacheConfig(page_size=4, n_pages=16, swap_token_cost=0.0),
                            admission=AdmissionConfig(async_prefill=False))
        router = CubeRouter(model, params, ecfg, n_cubes=2, device="cpu")
        rng = np.random.default_rng(7)
        for i in range(4):
            prompt = rng.integers(0, cfg.vocab_size, size=(7,)).astype(np.int32)
            router.submit(Request(uid=i, prompt=prompt, max_new_tokens=6))
        router.run()
        return router.telemetry()
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["none", "bf16"])
def test_wire_snapshot_equals_jax(router_snapshot, mode):
    snap = router_snapshot
    assert {"pod0", "pod1", "total_routed"} <= set(snap)
    assert isinstance(snap["pod0"]["device"], str)               # a string leaf stays home
    tw = wire.wire_snapshot(snap)
    jw = jwire.wire_snapshot(snap)
    assert "device" not in tw["pod0"]
    assert jax.tree.structure(jw) == jax.tree.structure(tree_map(lambda t: t.numpy(), tw))
    got = wire.unwire_snapshot(col.wire_unpack(col.wire_pack(tw, mode)))
    want = jwire.unwire_snapshot(jcol.wire_unpack(jcol.wire_pack(jw, mode)))
    assert got == want
    if mode == "none":
        for cube in ("pod0", "pod1"):
            for key in ("queue_depth", "running", "routed", "steps"):
                assert got[cube][key] == snap[cube][key]
            assert got[cube]["migrations"]["pending"] == 0
            assert got[cube]["host_tier"]["swap_outs"] == snap[cube]["host_tier"]["swap_outs"]
        assert got["total_routed"] == 4


@pytest.mark.parametrize("n", [1, 2, 4])
def test_cube_mesh_and_rules_equal_jax(n):
    jmesh = jsmc.make_cube_mesh(n)
    mesh = smc.make_cube_mesh(n, device="cpu")
    assert mesh.shape == tuple(jmesh.devices.shape)
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert mesh.n_cubes == jmesh.devices.shape[0]
    assert smc.cube_rules(mesh) == dict(jsharding.cube_rules(jmesh).rules)
    assert smc.CUBE_AXIS == jsmc.CUBE_AXIS


@pytest.mark.parametrize("n,want", [(1, (1, 8)), (2, (2, 4)), (3, (2, 4)), (4, (4, 2)),
                                    (None, (8, 1)), (16, (8, 1))])
def test_cube_mesh_counts_on_eight_cards(monkeypatch, n, want):
    """The reference's rule on 8 devices: the largest count <= n that divides
    8; each cube slot's device is the first of its row."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mesh = smc.make_cube_mesh(n)
    assert mesh.shape == want
    assert [d.index for d in mesh.devices] == [i * want[1] for i in range(want[0])]


def test_cube_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smc.make_cube_mesh(2)
