"""The port's in-process routing (``serve.router.CubeRouter``), its dense
reference engine (``serve.dense_engine.DenseSlotEngine``), the launcher's
``--cubes`` and the two examples that route, against the JAX package.

Reduced qwen2.5-3b in float32 with the JAX weights (``repro_torch.convert``),
inline admission, the same seeded requests on both sides:

* ``CubeRouter`` under ``hash``, ``least_loaded`` and ``prefix_affinity``
  (prefix sharing on, a shared prompt resident on one cube first): every
  request goes to the cube JAX's router picks, the tokens equal JAX's, and
  each cube's ``routed``, ``steps`` and ``queue_depth`` in ``telemetry()``
  equal JAX's; every engine keeps its own pools;
* ``save_trace`` writes one Perfetto process per cube, each holding its
  ``router.dispatch`` instants;
* ``DenseSlotEngine``'s tokens equal JAX's ``DenseSlotEngine`` and the
  port's paged engine, as ``tests/test_serve.py`` holds them;
* ``python -m repro_torch.launch.serve --cubes 2 --device cpu`` and
  ``examples/torch_serve_lm.py`` and ``examples/torch_multi_smc_inference.py``
  run with ``--device cpu``.
"""
import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import serve as jserve  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCH = "qwen2.5-3b"
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _family():
    jcfg = dataclasses.replace(jax_arch(ARCH).reduced(), dtype="float32",
                               decode_unroll_layers=False)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return cfg, jmodel, jparams, build_model(cfg), params


def _ecfg(mod, prefix=False, trace=False):
    return mod.EngineConfig(
        batch_slots=2, max_len=48,
        cache=mod.CacheConfig(page_size=4, n_pages=24, prefix_sharing=prefix),
        admission=mod.AdmissionConfig(async_prefill=False, prefill_chunk=4 if prefix else 0),
        obs=mod.ObsConfig(trace=trace))


def _waves(cfg, policy):
    """Lists of prompts submitted in turn, the router running dry after
    each.  prefix_affinity: one request makes a 12-token prompt resident on
    a cube, then four requests extending it and one unrelated arrive."""
    rng = np.random.default_rng(11)
    draw = lambda n: rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)  # noqa: E731
    if policy != "prefix_affinity":
        return [[draw(int(n)) for n in rng.integers(5, 12, size=6)]]
    shared = draw(12)
    return [[shared], [np.concatenate([shared, draw(3 + i)]) for i in range(4)] + [draw(9)]]


def _route(mod, router, waves, max_new=6):
    cubes, reqs, uid = [], [], 0
    for wave in waves:
        for p in wave:
            r = mod.Request(uid=uid, prompt=p, max_new_tokens=max_new)
            cubes.append(router.submit(r))
            reqs.append(r)
            uid += 1
        router.run()
    assert all(r.done for r in reqs)
    return cubes, {r.uid: list(r.out_tokens) for r in reqs}


@pytest.mark.parametrize("policy", ["hash", "least_loaded", "prefix_affinity"])
def test_router_matches_jax(policy, tmp_path):
    cfg, jmodel, jparams, model, params = _family()
    prefix = policy == "prefix_affinity"
    waves = _waves(cfg, policy)
    jr = jserve.CubeRouter(jmodel, jparams, _ecfg(jserve, prefix), n_cubes=2, policy=policy)
    jcubes, jtoks = _route(jserve, jr, waves)
    tr = tserve.CubeRouter(model, params, _ecfg(tserve, prefix, trace=True), n_cubes=2,
                           policy=policy, device="cpu")
    cubes, toks = _route(tserve, tr, waves)
    assert cubes == jcubes
    assert toks == jtoks
    assert len(set(cubes)) == 2 or prefix
    if prefix:                                # the shared prompt's cube takes its extensions
        assert cubes[1:5] == [cubes[0]] * 4 and cubes[5] != cubes[0]
        assert tr.telemetry()[f"pod{cubes[0]}"]["prefix"]["hits"] > 0
    tel, jtel = tr.telemetry(), jr.telemetry()
    for cube in ("pod0", "pod1"):
        for key in ("routed", "steps", "queue_depth", "decode_tokens", "prefill_tokens"):
            assert tel[cube][key] == jtel[cube][key], (cube, key)
    assert tel["total_routed"] == jtel["total_routed"] == len(cubes)
    assert tr.routed == jr.routed
    # each engine its own pools, both over the one parameter set
    e0, e1 = tr.engines
    assert e0.cache.pools[0]["s0_dense"]["k"].data_ptr() != e1.cache.pools[0]["s0_dense"]["k"].data_ptr()
    assert e0.params is e1.params is params

    trace = tr.save_trace(str(tmp_path / "router.json"))
    procs = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert sorted(procs.values()) == ["pod0", "pod1"]
    dispatch = {pid: sum(1 for e in trace["traceEvents"]
                         if e["pid"] == pid and e["name"] == "router.dispatch")
                for pid in procs}
    assert sorted(dispatch[pid] for pid in procs) == sorted(tr.routed)
    assert json.loads((tmp_path / "router.json").read_text())["traceEvents"]


def test_router_run_parks_every_admission_thread():
    """With async admission every engine's admission thread is stopped when
    ``run`` returns (a parked live thread would keep its engine, pools and
    parameters alive), and a second wave runs again."""
    import gc
    import weakref

    cfg, _, _, model, params = _family()
    ecfg = tserve.EngineConfig(batch_slots=2, max_len=32,
                               cache=tserve.CacheConfig(page_size=4, n_pages=16))
    router = tserve.CubeRouter(model, params, ecfg, n_cubes=2, device="cpu")
    rng = np.random.default_rng(3)
    for wave in range(2):
        for i in range(4):
            router.submit(tserve.Request(uid=4 * wave + i, max_new_tokens=4, prompt=rng.integers(
                0, cfg.vocab_size, size=(6,)).astype(np.int32)))
        assert len(router.run()) == 4
        assert all(e.pipeline._thread is None for e in router.engines)
    ref = weakref.ref(router.engines[0])
    del router
    gc.collect()
    assert ref() is None


def test_router_refuses_an_unknown_policy():
    _, _, _, model, params = _family()
    with pytest.raises(ValueError, match="policy"):
        tserve.CubeRouter(model, params, _ecfg(tserve), policy="random", device="cpu")


def test_dense_engine_matches_jax_and_paged():
    """Prompts of one length (the dense engine's shared-position step is
    exact only there), more requests than slots: queueing and refill."""
    cfg, jmodel, jparams, model, params = _family()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=(8,)).astype(np.int32) for _ in range(5)]

    def serve(mod, cls, *args, **kw):
        eng = cls(*args, mod.EngineConfig(batch_slots=2, max_len=64), **kw)
        reqs = [mod.Request(uid=i, prompt=p, max_new_tokens=10) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done for r in reqs)
        return {r.uid: list(r.out_tokens) for r in reqs}

    want = serve(jserve, jserve.DenseSlotEngine, jmodel, jparams)
    assert serve(tserve, tserve.DenseSlotEngine, model, params, device="cpu") == want
    assert serve(tserve, tserve.ServeEngine, model, params, device="cpu") == want


def _run_main(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_launch_serve_routes_over_cubes():
    out = _run_main(launch_serve.main, ["--arch", ARCH, "--device", "cpu", "--cubes", "2",
                                        "--route", "hash", "--requests", "4", "--max-new", "4",
                                        "--async-prefill", "off"])
    tel = json.loads(out[out.index("{"):])
    assert tel["total_routed"] == 4
    assert tel["pod0"]["routed"] == tel["pod1"]["routed"] == 2
    assert "4 requests, 16 tokens" in out


def test_examples_run_on_the_cpu():
    out = _run_main(_example("torch_serve_lm").main, ["--device", "cpu", "--cubes", "2"])
    assert "served 6 requests" in out and "pod0: routed=" in out
    out = _run_main(_example("torch_multi_smc_inference").main, ["--device", "cpu"])
    assert "executable 4-cube network: (4, 8, 10)" in out
    assert "batch -> ('pod', 'data')" in out
