"""The port's cube worker processes (``serve.cube_proc``) on the CPU: two
worker processes (``--device cpu``, one intra-op thread each) serve reduced
qwen2.5-3b, built in every process from the same seed.

* ``CubeProcRouter`` gives the single port engine's tokens, request for
  request, and its per-cube telemetry, each worker's launch counts
  included, crosses the wire;
* a worker SIGKILLed mid-drive: the survivor reproduces every stream, each
  stranded uid adopted from a shadow checkpoint or resubmitted;
* ``drain_cube`` moves a live cube's requests to the other by
  put-then-signal, tokens unchanged;
* the launcher's ``--cubes 2 --multiproc`` runs on the CPU;
* a worker asked for the card on a machine without one reports the error up
  the pipe, and the router raises instead of serving on the CPU;
* the framed transport treats a frame cut off mid-write as the end of the
  stream.

Every ``run`` has a timeout of at most 120 s.
"""
import contextlib
import io
import json
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionConfig, CacheConfig, CubeProcRouter, EngineConfig, Request)
from repro_torch.serve.cube_proc import build_cube_engine, recv_frame, send_frame  # noqa: E402

ARCH = "qwen2.5-3b"
ECFG = EngineConfig(batch_slots=2, max_len=48,
                    cache=CacheConfig(page_size=4, n_pages=24, preempt_policy="swap",
                                      swap_token_cost=0.0),
                    admission=AdmissionConfig(async_prefill=False))


def _reqs(n, max_new=8):
    cfg = get_arch(ARCH).reduced()
    rng = np.random.default_rng(7)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=(7,)).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n)]


def _single(n, max_new=8):
    """The single engine's tokens, built as every worker builds its own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng = build_cube_engine(ARCH, ECFG, "cpu")
        for r in _reqs(n, max_new):
            eng.submit(r)
        eng.run()
        return {r.uid: list(r.out_tokens) for r in eng.completed}
    finally:
        torch.set_num_threads(threads)


def test_two_workers_give_the_single_engines_tokens():
    want = _single(4)
    with CubeProcRouter(ARCH, ECFG, n_cubes=2, checkpoint_every=0, device="cpu") as router:
        for r in _reqs(4):
            router.submit(r)
        done = router.run(timeout=120.0)
        snap = router.telemetry()
    assert {r.uid: list(r.out_tokens) for r in done} == want
    assert snap["total_routed"] == 4 and router.routed == [2, 2]
    assert snap["dead_cubes"] == [] and snap["recoveries"] == 0
    assert snap["pod0"]["steps"] > 0 and snap["pod1"]["steps"] > 0
    assert snap["pod0"]["routed"] == 2
    # each worker's launch counts cross the wire (the plain kernels of a CPU
    # worker count nothing)
    assert snap["pod0"]["launches"] == snap["pod1"]["launches"] == dict.fromkeys(kops.LAUNCHES, 0)
    assert all(not p.alive() for p in router.procs)      # shut down on exit


def test_killed_worker_recovers_token_identically():
    want = _single(6)
    victim = 0
    with CubeProcRouter(ARCH, ECFG, n_cubes=2, checkpoint_every=2, device="cpu") as router:
        for r in _reqs(6):
            router.submit(r)

        def chaos():
            # SIGKILL the victim once it has decoded a few steps, so some
            # requests are mid-flight on it
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                if router.detector._count.get(victim, 0) >= 3:
                    router.kill_cube(victim)
                    return
                time.sleep(0.01)

        killer = threading.Thread(target=chaos, daemon=True)
        killer.start()
        done = router.run(timeout=120.0)
        killer.join(timeout=10.0)
        assert not killer.is_alive()
        assert not router.procs[victim].alive()
        log = list(router.recovery_log)
        survivor = router.telemetry()["pod1"]
    assert {r.uid: list(r.out_tokens) for r in done} == want
    deaths = [e for e in log if e["event"] == "cube_dead"]
    assert len(deaths) == 1 and deaths[0]["cube"] == victim
    ev = deaths[0]
    assert set(ev["adopted"]) | set(ev["resubmitted"]) == set(ev["stranded"])
    assert not set(ev["adopted"]) & set(ev["resubmitted"])
    assert ev["recovery_s"] >= 0.0
    # every adoption resumed from landed host pages on the survivor
    assert survivor["migrations"]["resumed"] >= len(ev["adopted"])


def test_drain_cube_moves_live_requests():
    """Cube 0 drained after 3 of its steps (its running requests already
    shadowed on cube 1, checkpoints every step): the moved requests finish
    on cube 1 with the single engine's tokens, and no shadow outlives its
    request (the drained ones' shadows on cube 1 are dropped)."""
    want = _single(4, max_new=32)
    with CubeProcRouter(ARCH, ECFG, n_cubes=2, policy="hash", checkpoint_every=1,
                        device="cpu") as router:
        for r in _reqs(4, max_new=32):
            router.submit(r)
        deadline = time.monotonic() + 60.0
        while router.detector._count.get(0, 0) < 3 and time.monotonic() < deadline:
            router._pump(0)
            time.sleep(0.001)
        moved = router.drain_cube(0)
        done = router.run(timeout=120.0)
        tel = router.telemetry()
    assert moved and set(moved) <= {0, 2}                # hash put uids 0 and 2 on cube 0
    assert router.recovery_log[-1] == {"event": "drain", "cube": 0, "target": 1, "moved": moved}
    assert {r.uid: list(r.out_tokens) for r in done} == want
    assert tel["pod1"]["migrations"]["landed"] >= len(moved)
    assert tel["pod0"]["migrations"]["shadows"] == tel["pod1"]["migrations"]["shadows"] == 0
    assert router.shadow_at == {}


def test_launch_serve_multiproc_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(["--arch", ARCH, "--device", "cpu", "--cubes", "2", "--multiproc",
                           "--requests", "4", "--max-new", "4", "--async-prefill", "off",
                           "--trace", "unused.json"])
    out = buf.getvalue()
    tel = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert tel["total_routed"] == 4 and tel["dead_cubes"] == []
    assert "4 requests, 16 tokens" in out
    assert "trace: not supported with --multiproc" in out


def test_worker_without_a_card_reports_up_the_pipe():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        CubeProcRouter(ARCH, ECFG, n_cubes=1, device="cuda", startup_timeout=60.0)


def test_truncated_frame_reads_as_end_of_stream():
    buf = io.BytesIO()
    send_frame(buf, {"ev": "ready", "cube": 0})
    send_frame(buf, {"ev": "done", "uid": 3, "tokens": [1, 2]})
    whole = buf.getvalue()
    cut = whole[:-5]                          # the second frame cut mid-write
    stream = io.BytesIO(cut)
    assert recv_frame(stream) == {"ev": "ready", "cube": 0}
    assert recv_frame(stream) is None
    assert recv_frame(io.BytesIO(whole[:4])) is None          # a cut header
    (n,) = struct.unpack("<Q", whole[:8])
    assert len(whole) == 8 + n + 8 + struct.unpack("<Q", whole[8 + n:16 + n])[0]
