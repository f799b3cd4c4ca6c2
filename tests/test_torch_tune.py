"""The port's cutout autotuner (``repro_torch.tune``) on the CPU, and its
parity with ``repro.tune``.

Ports of tests/test_tune.py: stable enumeration, the table's round trip and
version check, the roofline prune (drops over-bound configs, keeps the
default, never measures a pruned config, validates before pruning),
fallback to the default, a table entry resolving, ``no_tuning``,
``capture``/``materialize``, an explicit value never reading the table, the
committed ``TUNED_kernels_torch.json`` against the registry, the registry
covering the cutouts, and a ``tune_kernel`` run on the SSD smoke cutout.

Parity with the JAX package: each kernel's shape-class string equals the
reference's on the canonical cutouts and on small shapes; every valid
config of each space gives the reference's result under the same knob
(float32, atol = rtol = 1e-5), and ``lane_block`` / ``expert_block`` give
the port's own default result bit for bit; one table read by both packages
sets the chunk of a reduced mamba2 prefill on both sides, whose logits then
agree at tests/test_torch_ssm.py's tolerance.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import tune as jtune  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.tune import cutouts as jcutouts  # noqa: E402
from repro.tune import table as jtable  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import SSMConfig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.common import activation  # noqa: E402
from repro_torch.tune import (  # noqa: E402
    REGISTRY,
    capture,
    enumerate_space,
    load_table,
    materialize,
    no_tuning,
    prune_configs,
    resolve_tuned,
    save_table,
    tune_kernel,
    tuned_entry,
)
from repro_torch.tune import __main__ as tune_cli  # noqa: E402
from repro_torch.tune import cutouts, table  # noqa: E402
from repro_torch.tune.registry import TensorStruct, TunableKernel  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KERNELS = ("attn.flash_xla", "attn.paged_decode", "ssd.chunked", "moe.dispatch")
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tuner times tiny CPU ops, which many
    threads only slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_table(tmp_path, monkeypatch):
    """Point the port's lookups at a fresh table file under tmp_path."""
    p = tmp_path / "tuned.json"
    monkeypatch.setenv(table.ENV_VAR, str(p))
    table.reload_table()
    yield p
    table.reload_table()


def _entry(params):
    return {"params": params, "default_us": 100.0, "winner_us": 70.0,
            "ratio": 0.7, "space_size": 5, "pruned": 0, "measured": 5}


def _q(shape=(1, 32, 2, 8)):
    return torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32))


# ---------------------------------------------------------------- table

def test_enumerate_space_stable_order():
    space = {"b": (1, 2), "a": (10, 20)}
    got = enumerate_space(space)
    assert got == [{"a": 10, "b": 1}, {"a": 10, "b": 2},
                   {"a": 20, "b": 1}, {"a": 20, "b": 2}]
    assert got == jtune.enumerate_space(space)


def test_table_roundtrip(tmp_table):
    tab = load_table()
    assert tab == {"version": table.TABLE_VERSION, "env": {}, "entries": {}}
    key = table.entry_key("ssd.chunked", "b1.s64.h2.p16.n16.f32", "cuda")
    assert key == jtable.entry_key("ssd.chunked", "b1.s64.h2.p16.n16.f32", "cuda")
    tab["entries"][key] = _entry({"chunk": 32})
    save_table(tab)
    assert load_table() == tab
    assert tuned_entry("ssd.chunked", "b1.s64.h2.p16.n16.f32",
                       "cuda")["params"] == {"chunk": 32}
    assert tuned_entry("ssd.chunked", "b9.s64.h2.p16.n16.f32", "cuda") is None
    assert tuned_entry("ssd.chunked", "b1.s64.h2.p16.n16.f32", "cpu") is None


def test_table_version_mismatch_raises(tmp_table):
    tmp_table.write_text(json.dumps({"version": 99, "entries": {}}))
    with pytest.raises(ValueError, match="version"):
        load_table()


# ---------------------------------------------------------------- prune

@pytest.fixture
def fake_kernel():
    """A registered kernel whose cost model makes k=3 provably hopeless."""
    measured = []

    def fn(x, *, k):
        measured.append(k)
        return x * k

    def cost(params, x):
        n = float(x.numel())
        if params["k"] == 3:
            return 1e18, 1e18        # bound >> slack * best: must be pruned
        return 2 * n, 4 * n

    kern = TunableKernel(
        name="test.fake", fn=fn, space={"k": (1, 2, 3)}, defaults={"k": 1},
        shape_class=lambda x: f"n{x.numel()}", cost_model=cost, validate=None,
        backends=("cpu", "cuda"),
    )
    REGISTRY["test.fake"] = kern
    yield kern, measured
    del REGISTRY["test.fake"]


def test_prune_drops_over_bound_config(fake_kernel):
    kern, _ = fake_kernel
    x = torch.ones(8)
    kept, pruned = prune_configs(kern, enumerate_space(kern.space), (x,))
    assert {c["k"] for c in kept} == {1, 2}
    assert pruned == 1


def test_prune_keeps_default_even_when_over_bound(fake_kernel):
    kern, _ = fake_kernel
    bad_default = TunableKernel(**{**kern.__dict__, "defaults": {"k": 3}})
    kept, pruned = prune_configs(bad_default, enumerate_space(kern.space), (torch.ones(8),))
    assert {c["k"] for c in kept} == {1, 2, 3}
    assert pruned == 0


def test_over_bound_config_is_never_measured(fake_kernel):
    kern, measured = fake_kernel
    entry = tune_kernel("test.fake", (torch.ones(8),), iters=1)
    assert 3 not in measured
    assert entry["pruned"] == 1
    assert entry["space_size"] == 3
    assert entry["measured"] == 2
    assert entry["winner_us"] <= entry["default_us"]
    assert entry["params"]["k"] in (1, 2)


def test_validate_filters_before_prune():
    kern = TunableKernel(
        name="test.valid", fn=lambda x, *, k: x, space={"k": (1, 2, 3)},
        defaults={"k": 1}, shape_class=lambda x: "s",
        cost_model=None, validate=lambda p, x: p["k"] != 2,
        backends=("cpu",),
    )
    kept, pruned = prune_configs(kern, enumerate_space(kern.space), (None,))
    assert {c["k"] for c in kept} == {1, 3}
    assert pruned == 0                   # invalid != pruned-by-roofline


def test_a_failing_config_is_an_error_row_and_a_failing_default_raises(fake_kernel):
    kern, _ = fake_kernel

    def fn(x, *, k):
        if k == 2:
            raise RuntimeError("no launch for k=2")
        return x

    REGISTRY["test.fake"] = dataclasses.replace(kern, fn=fn)
    entry = tune_kernel("test.fake", (torch.ones(8),), iters=1)
    assert entry["measured"] == 1 and entry["params"] == {"k": 1}
    REGISTRY["test.fake"] = dataclasses.replace(kern, fn=fn, defaults={"k": 2})
    with pytest.raises(RuntimeError, match="default config failed"):
        tune_kernel("test.fake", (torch.ones(8),), iters=1)


# ------------------------------------------------------------- resolve

def test_fallback_to_default_when_entry_missing(tmp_table):
    """No table entry → the declared defaults, and the output is bitwise
    identical to passing the default explicitly."""
    q = _q()
    assert resolve_tuned("attn.flash_xla", q, q, q) == {"chunk": 1024}
    tuned = tattn.flash_attention_xla(q, q, q, chunk=None)
    explicit = tattn.flash_attention_xla(q, q, q, chunk=1024)
    assert torch.equal(tuned, explicit)


def test_table_entry_resolves_and_no_tuning_disables(tmp_table):
    q = _q()
    sc = REGISTRY["attn.flash_xla"].shape_class(q, q, q)
    tab = load_table()
    tab["entries"][table.entry_key("attn.flash_xla", sc, "cpu")] = _entry({"chunk": 64})
    save_table(tab)
    assert resolve_tuned("attn.flash_xla", q, q, q) == {"chunk": 64}
    assert resolve_tuned("attn.flash_xla", q, q, q) == {"chunk": 64}     # memoised
    with no_tuning():
        assert resolve_tuned("attn.flash_xla", q, q, q) == {"chunk": 1024}
    # the backend is the tensors' device type: a cpu entry serves no other
    meta = q.to("meta")
    assert resolve_tuned("attn.flash_xla", meta, meta, meta) == {"chunk": 1024}
    # a cuda entry is never read for cpu tensors
    tab["entries"] = {table.entry_key("attn.flash_xla", sc, "cuda"): _entry({"chunk": 64})}
    save_table(tab)
    assert resolve_tuned("attn.flash_xla", q, q, q) == {"chunk": 1024}


def test_positional_parameters_passed_by_keyword_resolve():
    """A caller may name the positional parameters: the shape class and the
    cutout then see them in their places, the rest at their defaults."""
    cfg, *tensors = cutouts.build("ssd.chunked", smoke=True, device="cpu")
    names = ("xh", "bb", "cc", "dt", "a_log", "d_skip")
    with capture() as caps:
        y, fin = tssm.ssd_chunked(cfg, **dict(zip(names, tensors)), impl="xla")
    assert caps[0].shape_class == REGISTRY["ssd.chunked"].shape_class(cfg, *tensors)
    assert caps[0].args[-2:] == (None, "xla")
    want = tssm.ssd_chunked(cfg, *tensors, None, "xla", chunk=cfg.ssm.chunk)
    assert torch.equal(y, want[0]) and torch.equal(fin, want[1])


def test_capture_records_cutouts(tmp_table):
    q = _q()
    with capture() as caps:
        tattn.flash_attention_xla(q, q, q, chunk=None)
        tattn.flash_attention_xla(q, q, q, chunk=64)          # explicit: not recorded
    assert [c.kernel for c in caps] == ["attn.flash_xla"]
    cut = caps[0]
    assert cut.shape_class == REGISTRY["attn.flash_xla"].shape_class(q, q, q)
    assert cut.args == (TensorStruct((1, 32, 2, 8), torch.float32),) * 3
    args = materialize(cut, device="cpu")
    assert [tuple(a.shape) for a in args] == [(1, 32, 2, 8)] * 3
    assert all(a.dtype == torch.float32 and a.device.type == "cpu" for a in args)
    # the reference's draws: N(0, 1) with numpy's generator, in argument order
    rng = np.random.default_rng(0)
    for a in args:
        np.testing.assert_array_equal(a.numpy(), rng.normal(size=(1, 32, 2, 8)).astype(np.float32))


def test_explicit_value_never_consults_table(tmp_table, monkeypatch):
    """Callers passing real values must not trigger a lookup at all."""
    def boom(*a, **k):
        raise AssertionError("table consulted for an explicit value")

    monkeypatch.setattr("repro_torch.tune.registry.tuned_entry", boom)
    monkeypatch.setattr("repro_torch.tune.registry.resolve_tuned", boom)
    q = _q()
    tattn.flash_attention_xla(q, q, q, chunk=64)
    tmoe.expert_ffn(*cutouts.build("moe.dispatch", device="cpu"), expert_block=0)


# ------------------------------------------------- committed table meta

def test_committed_table_matches_registry_schema():
    """Every committed entry matches its kernel's current config space and
    its canonical cutout's key; four cuda entries, one per cutout."""
    tab = load_table(table.TABLE_PATH)
    assert tab["entries"], "TUNED_kernels_torch.json missing or empty"
    assert tab["env"]["backend"] == "cuda" and tab["env"]["device"]
    keys = set()
    for key, entry in tab["entries"].items():
        kernel, sc, backend = key.split("|")
        assert kernel in REGISTRY, f"{key}: unknown kernel"
        kern = REGISTRY[kernel]
        assert backend in kern.backends, f"{key}: backend not declared"
        assert set(entry["params"]) <= set(kern.space), key
        for p, v in entry["params"].items():
            assert v in kern.space[p] or v == kern.defaults[p], \
                f"{key}: {p}={v!r} not in space {kern.space[p]}"
        for field in ("default_us", "winner_us", "ratio",
                      "space_size", "pruned", "measured"):
            assert field in entry, f"{key}: missing {field}"
        assert entry["ratio"] <= 1.0, f"{key}: winner slower than default"
        assert entry["winner_us"] <= entry["default_us"], key
        if kernel in cutouts.CUTOUTS:
            args = cutouts.build(kernel, device="cpu")
            assert sc == kern.shape_class(*args), \
                f"{key}: shape class drifted from the canonical cutout"
        keys.add((kernel, backend))
    assert keys == {(k, "cuda") for k in KERNELS}


def test_registry_covers_all_cutouts():
    assert set(REGISTRY) == set(KERNELS) == set(cutouts.CUTOUTS)
    for name, kern in REGISTRY.items():
        assert set(kern.defaults) == set(kern.space)
        ref = jtune.REGISTRY[name]
        assert kern.space == ref.space and kern.defaults == ref.defaults, name
        assert (kern.cost_model is None) == (ref.cost_model is None), name
        assert (kern.validate is None) == (ref.validate is None), name


# ------------------------------------------------------------ end2end

def test_tune_kernel_smoke_end_to_end(tmp_table):
    """Tune the tiny SSD cutout fresh: the winner beats (<=) the default by
    construction, and the entry is schema-complete."""
    args = cutouts.build("ssd.chunked", smoke=True, device="cpu")
    entry = tune_kernel("ssd.chunked", args, iters=2)
    assert entry["winner_us"] <= entry["default_us"]
    assert entry["ratio"] <= 1.0
    assert entry["measured"] >= 1 and entry["space_size"] == 5
    assert set(entry["params"]) == {"chunk"}


def test_cli_smoke_on_the_cpu_and_no_card_raises(tmp_table, monkeypatch, capsys):
    assert tune_cli.main(["--smoke", "--device", "cpu", "--iters", "1"]) == 0
    assert "tuner smoke ok" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("--update", "--smoke"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tune_cli.main([mode])
    assert not tmp_table.exists()
    assert tune_cli.main(["--list"]) == 0
    assert "ssd.chunked: space=" in capsys.readouterr().out


# ------------------------------------------------------- parity with JAX

def _both(shape, dtype="float32", kind="normal", seed=0):
    """One numpy draw as (a JAX array, a torch tensor)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape) if kind == "normal" else kind(rng)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


def _small_args(kernel: str, case: int):
    """(JAX args, port args) of a small call of ``kernel`` (two cases each)."""
    dt = ("float32", "bfloat16")[case]
    if kernel == "attn.flash_xla":
        qs, ks = ((2, 24, 4, 8), (2, 40, 2, 8)) if case == 0 else ((1, 16, 8, 64), (1, 16, 1, 64))
        q, k = _both(qs, dt), _both(ks, dt, seed=1)
        return (q[0], k[0], k[0]), (q[1], k[1], k[1])
    if kernel == "attn.paged_decode":
        lanes, pages, ps, hkv, h, d = ((4, 3, 4, 2, 4, 8), (2, 6, 16, 1, 8, 32))[case]
        q = _both((lanes, 1, h, d), dt)
        pool = _both((12 + case, ps, hkv, d), dt, seed=1)
        bt = _both((lanes, pages), "int32", lambda r: r.integers(0, 12, size=(lanes, pages)))
        pos = _both((lanes,), "int32", lambda r: r.integers(1, 8, size=(lanes,)))
        return (q[0], pool[0], pool[0], bt[0], pos[0]), (q[1], pool[1], pool[1], bt[1], pos[1])
    if kernel == "ssd.chunked":
        b, s, h, p, n = ((2, 64, 2, 16, 16), (1, 32, 8, 32, 16))[case]
        arrs = [_both(sh, dt if i < 3 else "float32", seed=i) for i, sh in enumerate(
            ((b, s, h, p), (b, s, n), (b, s, n), (b, s, h), (h,), (h,)))]
        return (("cfg",) + tuple(a[0] for a in arrs), ("cfg",) + tuple(a[1] for a in arrs))
    g, e, c, d, f = ((2, 4, 5, 16, 24), (1, 8, 4, 32, 8))[case]
    xe, wg, wd = _both((g, e, c, d), dt), _both((e, d, f), dt, seed=1), _both((e, f, d), dt, seed=2)
    return (xe[0], wg[0], None, wd[0]), (xe[1], wg[1], None, wd[1])


@pytest.mark.parametrize("kernel", KERNELS)
def test_shape_class_equals_the_reference(kernel):
    """The key the tuner writes and a call site recomputes, byte for byte:
    the canonical cutout, the smoke cutout and two small shapes."""
    port, ref = REGISTRY[kernel].shape_class, jtune.REGISTRY[kernel].shape_class
    pairs = [(jcutouts.build(kernel), cutouts.build(kernel, device="cpu"))]
    if cutouts.CUTOUTS[kernel].smoke is not None:
        pairs.append((jcutouts.build(kernel, smoke=True),
                      cutouts.build(kernel, smoke=True, device="cpu")))
    pairs += [_small_args(kernel, case) for case in (0, 1)]
    for jargs, targs in pairs:
        assert port(*targs).encode() == ref(*jargs).encode()


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _flash_case():
    q, k, v = (_both(s, seed=i) for i, s in enumerate(
        ((1, 100, 4, 8), (1, 100, 2, 8), (1, 100, 2, 8))))
    return (q[0], k[0], v[0]), (q[1], k[1], v[1])


def _paged_case():
    lanes, pages, ps, hkv, h, d = 8, 5, 4, 2, 4, 8
    q = _both((lanes, 1, h, d))
    kp, vp = _both((40, ps, hkv, d), seed=1), _both((40, ps, hkv, d), seed=2)
    bt = _both((lanes, pages), "int32",
               lambda r: r.permutation(40)[: lanes * pages].reshape(lanes, pages))
    pos = _both((lanes,), "int32", lambda r: r.integers(1, pages * ps - 1, size=(lanes,)))
    return (q[0], kp[0], vp[0], bt[0], pos[0]), (q[1], kp[1], vp[1], bt[1], pos[1])


def _ssd_case(p=16):
    b, s, h, n = 2, 32, 2, 16
    rng = np.random.default_rng(7)
    arrs = (rng.normal(size=(b, s, h, p)) * 0.5, rng.normal(size=(b, s, n)) * 0.5,
            rng.normal(size=(b, s, n)) * 0.5, rng.normal(size=(b, s, h)),
            rng.normal(size=(h,)) * 0.3, rng.uniform(0.5, 1.5, size=(h,)),
            rng.normal(size=(b, h, p, n)))
    arrs = [a.astype(np.float32) for a in arrs]

    class JCfg:
        ssm = JSSMConfig(d_state=n, head_dim=p, chunk=32)

    class TCfg:
        ssm = SSMConfig(d_state=n, head_dim=p, chunk=32)

    return ((JCfg,) + tuple(jnp.asarray(a) for a in arrs),
            (TCfg,) + tuple(torch.from_numpy(a) for a in arrs))


def _moe_case(c=8):
    g, e, d, f = 2, 4, 16, 24
    rng = np.random.default_rng(5)
    arrs = [rng.normal(size=(g, e, c, d)), rng.normal(size=(e, d, f)) * d ** -0.5,
            rng.normal(size=(e, d, f)) * d ** -0.5, rng.normal(size=(e, f, d)) * f ** -0.5]
    arrs = [a.astype(np.float32) for a in arrs]
    return tuple(jnp.asarray(a) for a in arrs), tuple(torch.from_numpy(a) for a in arrs)


def _configs(kernel, targs):
    kern = REGISTRY[kernel]
    return [c for c in enumerate_space(kern.space) if kern.validate is None
            or kern.validate(c, *targs)]


@pytest.mark.parametrize("kernel", KERNELS)
def test_every_valid_config_matches_the_reference(kernel):
    """Each config of the space against the reference called with the same
    knob (float32 1e-5), and the block knobs bit-equal to the port's own
    default.  The reference reads a chunk above the sequence as the
    sequence (``min(chunk, S)``) and a block of every lane or expert as one
    pass, so configs that mean the same call share one jitted reference
    call (``same``: the knob as the reference's code reads it)."""
    if kernel == "attn.flash_xla":
        jargs, targs = _flash_case()
        jf = lambda c: jattn.flash_attention_xla(*jargs, chunk=c["chunk"])      # noqa: E731
        tf = lambda c: tattn.flash_attention_xla(*targs, chunk=c["chunk"])      # noqa: E731
        same = lambda c: min(c["chunk"], targs[0].shape[1])                     # noqa: E731
    elif kernel == "attn.paged_decode":
        jargs, targs = _paged_case()
        jf = lambda c: jattn.paged_decode_attention_xla(  # noqa: E731
            *jargs, window=12, lane_block=c["lane_block"])
        tf = lambda c: tattn.paged_decode_windowed(  # noqa: E731
            *targs, 12, lane_block=c["lane_block"])
        same = lambda c: c["lane_block"] % targs[0].shape[0]                   # noqa: E731
    elif kernel == "ssd.chunked":
        jargs, targs = _ssd_case()
        jf = lambda c: jssm.ssd_chunked(*jargs, chunk=c["chunk"])               # noqa: E731
        tf = lambda c: tssm.ssd_chunked(*targs, chunk=c["chunk"])               # noqa: E731
        same = lambda c: min(c["chunk"] or 32, targs[1].shape[1])               # noqa: E731
    else:
        jargs, targs = _moe_case()
        jf = lambda c: jmoe.expert_ffn(*jargs, expert_block=c["expert_block"])  # noqa: E731
        tf = lambda c: tmoe.expert_ffn(*targs, act=activation("gelu"),          # noqa: E731
                                       expert_block=c["expert_block"])
        same = lambda c: c["expert_block"] % targs[0].shape[1]                 # noqa: E731
    configs = _configs(kernel, targs)
    assert len(configs) == len(enumerate_space(REGISTRY[kernel].space))   # all valid here
    with no_tuning():
        default = tf(REGISTRY[kernel].defaults)
    reps = {same(c): c for c in reversed(configs)}
    want = jax.jit(lambda: {k: jf(c) for k, c in reps.items()})()
    for c in configs:
        got = tf(c)
        for g, w in zip(*((got, want[same(c)]) if isinstance(got, tuple)
                          else ((got,), (want[same(c)],)))):
            np.testing.assert_allclose(_np(g), _np(w), **TOL)
        if kernel in ("attn.paged_decode", "moe.dispatch"):
            assert torch.equal(got, default), c
        if kernel == "ssd.chunked":                 # the kernel form = the xla form
            for g, w in zip(got, tssm.ssd_chunked(*targs, impl="xla", chunk=c["chunk"])):
                np.testing.assert_allclose(g.numpy(), w.detach().numpy(), **TOL)


def test_expert_block_within_an_ulp_where_the_cpu_activation_has_a_tail():
    """torch's CPU activations run a vector loop and a scalar tail, whose
    last bit can differ: an expert slab of 2 x 5 x 24 = 240 elements (a
    16-element tail) may differ from the whole slab's result in its last
    bit, so there the blocks are held within one float32 ulp of the
    default (the 384-element slabs above, with no tail, bit-equal)."""
    _, targs = _moe_case(c=5)
    whole = tmoe.expert_ffn(*targs, act=activation("gelu"), expert_block=0)
    for eb in (1, 2):
        got = tmoe.expert_ffn(*targs, act=activation("gelu"), expert_block=eb)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=2.0 ** -23, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_validity_drops_what_the_kernel_refuses(dtype):
    """The reference's S % chunk predicate, and on the kernel form the
    chunks ``ops.ssd_plan`` refuses: at mamba2-130m's served widths (H 24,
    P 64, N 128, a 256-token slice) every chunk is valid; at P 128 no
    chunk is on the kernel form and every one is on the xla form."""
    cfg = get_arch("mamba2-130m")
    kern = REGISTRY["ssd.chunked"]

    def args(s, p, n=128, h=24):
        return (cfg, torch.empty((1, s, h, p), dtype=dtype), torch.empty((1, s, n), dtype=dtype),
                None, None, None, None)

    space = enumerate_space(kern.space)
    assert all(kern.validate(c, *args(256, 64)) for c in space)
    assert all(tops.ssd_plan(132, 1, 24, 64, 128, c["chunk"], dtype == torch.bfloat16)
               for c in space)
    assert not any(kern.validate(c, *args(256, 128)) for c in space)
    assert all(kern.validate(c, *args(256, 128), None, "xla") for c in space)
    # S % q: a 48-token slice takes chunks 16 and 48 (min(chunk, S)) but not 32
    assert [kern.validate(c, *args(48, 64)) for c in space] == [True, False, True, True, True]
    jargs = (jax_arch("mamba2-130m"), jnp.zeros((1, 48, 24, 64)))
    assert [jtune.REGISTRY["ssd.chunked"].validate(c, *jargs) for c in space] \
        == [True, False, True, True, True]


# ------------------------------------------------- one table, both packages

def test_one_table_sets_both_packages_chunk(tmp_path, monkeypatch):
    """``REPRO_TUNED_TABLE`` and ``REPRO_TORCH_TUNED_TABLE`` name one table
    whose cpu entry sets a reduced mamba2 prefill's chunk to 16 (the
    config's is 32): both packages resolve 16, the port's ``ssd_scan`` runs
    at 16, and the two prefills agree at tests/test_torch_ssm.py's
    tolerance.  The batch (3) and length (96) are traced by no other test,
    so no cached JAX trace keeps its old chunk."""
    jcfg = dataclasses.replace(jax_arch("mamba2-130m").reduced(), dtype="float32",
                               decode_unroll_layers=False)
    cfg = dataclasses.replace(get_arch("mamba2-130m").reduced(), dtype="float32")
    assert cfg.ssm.chunk == 32
    h, p, n = cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim, cfg.ssm.d_state
    sc = f"b3.s96.h{h}.p{p}.n{n}.f32"
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps({"version": 1, "env": {}, "entries": {
        f"ssd.chunked|{sc}|cpu": _entry({"chunk": 16})}}))
    monkeypatch.setenv("REPRO_TUNED_TABLE", str(path))
    monkeypatch.setenv(table.ENV_VAR, str(path))
    table.reload_table()
    jtable.reload_table()
    try:
        jmodel = jax_build(jcfg)
        params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
        jparams = jax.tree.map(jnp.asarray, convert.params_to_numpy(params))
        toks = np.random.default_rng(96).integers(0, cfg.vocab_size, size=(3, 96))
        resolved = []
        real_resolve = jtune.registry.resolve_tuned
        monkeypatch.setattr(jtune.registry, "resolve_tuned",
                            lambda *a: resolved.append((a[0], real_resolve(*a))) or resolved[-1][1])
        jlogits, _ = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks, jnp.int32))
        chunks = []
        real_scan = tops.ssd_scan
        monkeypatch.setattr(tops, "ssd_scan", lambda *a: chunks.append(a[5]) or real_scan(*a))
        with capture() as caps:
            logits, _ = build_model(cfg).prefill(params, torch.from_numpy(toks).long())
    finally:
        table.reload_table()
        jtable.reload_table()
    assert resolved and all(r == ("ssd.chunked", {"chunk": 16}) for r in resolved)
    assert [c.shape_class for c in caps] == [sc] * cfg.n_layers
    assert chunks == [16] * cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    assert np.array_equal(logits.numpy().argmax(-1), np.asarray(jlogits).argmax(-1))
