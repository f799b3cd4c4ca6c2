"""Multi-process cube serving: one worker process per cube (paper §VI-C), the
port of ``repro/serve/cube_proc.py``.

``CubeRouter`` keeps its engines in one process; this module is the process
form, where a cube can really fail:

* :func:`worker_main` — one cube: builds its model and engine the same way
  in every process (the reduced config of ``--arch`` and the port's seeded
  init, so greedy decoding is identical across cubes) on ``--device`` (the
  card by default), then loops ``handle messages → engine.step()``,
  streaming completions, per-step progress reports and periodic shadow
  checkpoints back up;
* :class:`CubeProc` — the parent's handle: a framed-pickle pipe pair plus a
  reader thread (both sides always have a dedicated reader, so a write never
  deadlocks against a full pipe);
* :class:`CubeProcRouter` — the ``CubeRouter``-shaped front end:
  ``submit``/``run``/``telemetry`` over worker processes, with
  ``dist.fault.StragglerDetector`` as live policy: step reports feed it,
  straggling cubes get no new work (and can be drained with
  :meth:`CubeProcRouter.drain_cube`), and a dead cube's in-flight requests
  re-route and resume on a live cube.

Wire format: tensor payloads (page rows, lane states, prompts) travel
through ``dist.collectives.wire_pack``/``wire_unpack`` in mode ``none``
(page migration is bit-exact by contract); telemetry is lowered by
``obs.wire.wire_snapshot`` first.

Inter-cube page migration is one-sided put-then-signal: ``migrate_put``
lands the pages in the receiving cube's HOST tier while its decode loop
keeps stepping, ``migrate_signal`` commits them, and the decode loop
schedules committed entries at the top of each step
(``ServeEngine.poll_migrations``).  A sender killed mid-transfer leaves an
uncommitted entry that is never adopted.

Failure and recovery, per request, tracked by the router::

    routed ──done──▶ complete
      │ checkpoint (every N steps, forwarded to the backup cube)
      ▼
    shadowed ──cube dies──▶ adopt_shadow on the backup ──▶ resumes from
      │                        host-tier pages
      └──no committed shadow──▶ the prompt resubmitted on a live cube

Token identity on every path needs greedy decoding (``temperature == 0``);
sampled traffic migrates but draws another tail.

Each worker opens its own CUDA context on the card; the parent builds the
kernels first (``kernels.build.build``), so a worker finds them built.  A
worker given ``--device cuda`` on a machine without a card reports the
error up the pipe and exits: it never carries on on the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import pickle
import queue
import struct
import subprocess
import sys
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.analysis.ownership import cube_transport
from repro_torch.core.smc import CUBE_AXIS
from repro_torch.dist.collectives import wire_pack, wire_unpack
from repro_torch.dist.fault import StragglerDetector
from repro_torch.kernels import ops as kops
from repro_torch.obs import clock as obs_clock
from repro_torch.obs.wire import unwire_snapshot, wire_snapshot

from .router import POLICIES

__all__ = ["CubeProc", "CubeProcRouter", "worker_main",
           "send_frame", "recv_frame", "pack_payload", "unpack_payload"]

_SRC = pathlib.Path(__file__).resolve().parents[2]

# the router's fault policy: a cube whose step rate falls this many times
# below the median gets no new work, and one silent this long is dead
STRAGGLER_FACTOR = 4.0
DEAD_TIMEOUT_S = 60.0


# ---------------------------------------------------------------------------
# framed-pickle transport (8-byte little-endian length; truncation == EOF)
# ---------------------------------------------------------------------------


def _read_exact(stream, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


@cube_transport
def send_frame(stream, msg: dict) -> None:
    blob = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(struct.pack("<Q", len(blob)))
    stream.write(blob)
    stream.flush()


@cube_transport
def recv_frame(stream) -> dict | None:
    """One framed message, or None on EOF, including a frame cut off
    mid-write (the sender was SIGKILLed with the pipe half full), which is
    treated as the end of the stream.  Frames come only from this package's
    own processes (pickle runs code on load)."""
    hdr = _read_exact(stream, 8)
    if hdr is None:
        return None
    (n,) = struct.unpack("<Q", hdr)
    blob = _read_exact(stream, n)
    if blob is None:
        return None
    return pickle.loads(blob)


@cube_transport
def pack_payload(payload: dict) -> dict:
    """Lower a migration payload's tensor members to the wire format (mode
    ``none``: page content is bit-exact by contract)."""
    out = dict(payload)
    out["prompt"] = wire_pack(torch.as_tensor(np.asarray(payload["prompt"], np.int32)), "none")
    for k in ("seq", "state"):
        if out.get(k) is not None:
            out[k] = wire_pack(out[k], "none")
    return out


@cube_transport
def unpack_payload(wired: dict) -> dict:
    out = dict(wired)
    out["prompt"] = wire_unpack(wired["prompt"]).numpy().astype(np.int32)
    for k in ("seq", "state"):
        if out.get(k) is not None:
            out[k] = wire_unpack(wired[k])
    return out


def _ecfg_to_json(ecfg) -> str:
    return json.dumps(dataclasses.asdict(ecfg))


def _ecfg_from_json(blob: str):
    from .engine import AdmissionConfig, CacheConfig, EngineConfig, ObsConfig

    d = json.loads(blob)
    return EngineConfig(batch_slots=d["batch_slots"], max_len=d["max_len"], eos_id=d["eos_id"],
                        cuda_graph=d["cuda_graph"], cache=CacheConfig(**d["cache"]),
                        admission=AdmissionConfig(**d["admission"]), obs=ObsConfig(**d["obs"]))


def build_cube_engine(arch: str, ecfg, device):
    """A cube's model and engine as every worker builds them: the reduced
    config of ``arch`` and the port's init from seed 0 on ``device``, so
    every cube (and a parent that builds one the same way) holds the same
    weights."""
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve
    from repro_torch.models import build_model

    from .engine import ServeEngine

    device = resolve(device)
    model = build_model(get_arch(arch).reduced())
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    return ServeEngine(model, params, ecfg, device=device)


# ---------------------------------------------------------------------------
# worker process (one cube)
# ---------------------------------------------------------------------------


def worker_main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--ecfg", required=True, help="EngineConfig as JSON")
    ap.add_argument("--cube", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch kernels, one thread)")
    ap.add_argument("--checkpoint-every", type=int, default=4,
                    help="steps between shadow checkpoints of in-flight requests (0 = off)")
    args = ap.parse_args(argv)

    # claim the protocol fds FIRST: the wire owns the original stdout; any
    # stray print (a warning, a debug print) goes to stderr instead of
    # corrupting a frame
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    inp = os.fdopen(os.dup(0), "rb")

    from .engine import Request

    def report_error() -> int:
        import traceback

        with contextlib.suppress(Exception):
            send_frame(out, {"ev": "error", "cube": args.cube, "msg": traceback.format_exc()})
        return 1

    try:
        if args.device == "cpu":
            # the tiny ops of a reduced engine ran 30x slower on 8 threads
            torch.set_num_threads(1)
        engine = build_cube_engine(args.arch, _ecfg_from_json(args.ecfg), args.device)
    except Exception:                            # noqa: BLE001 — reported up the wire
        return report_error()

    inbox: queue.Queue = queue.Queue()

    def read_loop() -> None:
        while True:
            msg = recv_frame(inp)
            inbox.put(msg)
            if msg is None:
                return

    threading.Thread(target=read_loop, daemon=True, name=f"cube{args.cube}-wire-rx").start()
    # this cube's kernel launches, counted from here (the engine's build
    # and its graph capture excluded), go up with its telemetry
    kops.reset_launches()
    send_frame(out, {"ev": "ready", "cube": args.cube})

    shutting_down = False
    step_count = 0
    done_mark = 0

    def handle(msg: dict) -> None:
        nonlocal shutting_down
        op = msg["op"]
        if op == "submit":
            engine.submit(Request(uid=int(msg["uid"]),
                                  prompt=wire_unpack(msg["prompt"]).numpy().astype(np.int32),
                                  max_new_tokens=int(msg["max_new_tokens"]),
                                  temperature=float(msg["temperature"])))
        elif op == "migrate_put":
            kind = engine.migrate_put(msg["token"], unpack_payload(msg["payload"]))
            send_frame(out, {"ev": "put_ack", "token": msg["token"], "kind": kind})
        elif op == "migrate_signal":
            engine.migrate_signal(msg["token"])
        elif op == "shadow_put":
            engine.shadow_put(int(msg["uid"]), unpack_payload(msg["payload"]))
        elif op == "shadow_signal":
            engine.shadow_signal(int(msg["uid"]))
        elif op == "drop_shadow":
            engine.drop_shadow(int(msg["uid"]))
        elif op == "adopt_shadow":
            ok = engine.adopt_shadow(int(msg["uid"]))
            send_frame(out, {"ev": "adopted", "uid": int(msg["uid"]), "ok": ok})
        elif op == "export":
            payload = engine.export_request(int(msg["uid"]))
            send_frame(out, {"ev": "export_result", "uid": int(msg["uid"]),
                             "payload": pack_payload(payload) if payload else None})
        elif op == "telemetry":
            send_frame(out, {"ev": "telemetry", "cube": args.cube,
                             "data": wire_pack(wire_snapshot(engine.telemetry()), "none"),
                             "launches": dict(kops.LAUNCHES)})
        elif op == "shutdown":
            shutting_down = True
        else:                                    # pragma: no cover
            raise ValueError(f"unknown op {op!r}")

    def flush_done() -> None:
        nonlocal done_mark
        for req in engine.completed[done_mark:]:
            send_frame(out, {"ev": "done", "uid": req.uid,
                             "tokens": [int(t) for t in req.out_tokens]})
        done_mark = len(engine.completed)

    try:
        while True:
            while True:
                try:
                    msg = inbox.get_nowait()
                except queue.Empty:
                    break
                if msg is None:
                    return 0                     # the parent went away
                handle(msg)
            if engine.load or engine.pending_migrations():
                engine.step()
                step_count += 1
                flush_done()
                send_frame(out, {"ev": "step_report", "cube": args.cube,
                                 "step": step_count, "load": engine.load})
                if args.checkpoint_every and step_count % args.checkpoint_every == 0:
                    for uid in engine.inflight_uids():
                        p = engine.checkpoint_request(uid)
                        if p is not None:
                            send_frame(out, {"ev": "checkpoint", "uid": uid,
                                             "payload": pack_payload(p)})
                continue
            if shutting_down:
                send_frame(out, {"ev": "bye", "cube": args.cube})
                return 0
            try:
                msg = inbox.get(timeout=0.05)
            except queue.Empty:
                continue
            if msg is None:
                return 0
            handle(msg)
    except BrokenPipeError:                      # the parent died mid-write
        return 1
    except Exception:                            # noqa: BLE001 — reported up the wire
        return report_error()


# ---------------------------------------------------------------------------
# parent-side handle
# ---------------------------------------------------------------------------


class CubeProc:
    """One cube worker process: spawn, framed send, buffered receive."""

    def __init__(self, cube: int, arch: str, ecfg, checkpoint_every: int = 4,
                 device: str = "cuda"):
        self.cube = cube
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        # -c entry (not -m): runpy would run this module's source as
        # __main__ while the worker's own package import loads it again as a
        # submodule — two copies of every class.  -c imports it once
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             "from repro_torch.serve.cube_proc import worker_main; "
             "raise SystemExit(worker_main())",
             "--arch", arch, "--ecfg", _ecfg_to_json(ecfg), "--cube", str(cube),
             "--device", str(device), "--checkpoint-every", str(checkpoint_every)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        self.inbox: queue.Queue = queue.Queue()
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"cube{cube}-rx")
        self._reader.start()

    def _read_loop(self) -> None:
        while True:
            msg = recv_frame(self.proc.stdout)
            self.inbox.put(msg)
            if msg is None:
                return

    def send(self, msg: dict) -> bool:
        """False when the worker is gone (broken pipe): callers treat a failed
        send as a dead cube, never as an error."""
        try:
            send_frame(self.proc.stdin, msg)
            return True
        except (BrokenPipeError, OSError, ValueError):
            return False

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """SIGKILL, the chaos hook.  No flush, no goodbye: frames already in
        the OS pipe buffer survive and are drained during recovery."""
        with contextlib.suppress(ProcessLookupError):
            self.proc.kill()

    def close(self, timeout: float = 10.0) -> None:
        if self.alive():
            self.send({"op": "shutdown"})
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            self.proc.wait(timeout=5.0)
        self._reader.join(timeout=5.0)
        for stream in (self.proc.stdin, self.proc.stdout):
            with contextlib.suppress(Exception):
                stream.close()


# ---------------------------------------------------------------------------
# router over worker processes
# ---------------------------------------------------------------------------


class CubeProcRouter:
    """``CubeRouter``-shaped routing over one worker process per cube, with
    live fault policy: step reports feed a ``StragglerDetector``, straggling
    cubes get no new work, and a dead cube's in-flight requests re-route and
    resume on a live cube (committed shadow checkpoints restore from
    host-tier pages; otherwise the prompt is resubmitted — both
    token-identical under greedy decoding).

    ``prefix_affinity`` degrades to ``least_loaded`` here, as in the JAX
    package: the parent has no view of each cube's prefix index.  The
    workers run on ``device`` (the card by default; ``"cpu"``, one thread
    each), every one on the same card.
    """

    def __init__(self, arch: str, ecfg, n_cubes: int = 2, policy: str = "least_loaded",
                 checkpoint_every: int = 4, startup_timeout: float = 300.0,
                 device: str = "cuda"):
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy: {policy!r}")
        self.arch = arch
        self.policy = "least_loaded" if policy == "prefix_affinity" else policy
        self.axis = CUBE_AXIS            # telemetry keys match CubeRouter's
        self.procs = [CubeProc(i, arch, ecfg, checkpoint_every, device)
                      for i in range(n_cubes)]
        self.detector = StragglerDetector(n_cubes, factor=STRAGGLER_FACTOR,
                                          timeout=DEAD_TIMEOUT_S, clock=obs_clock.monotonic)
        self.dead: set[int] = set()
        self.routed = [0] * n_cubes
        self.pending: dict[int, int] = {}        # uid → cube
        self.requests: dict[int, Any] = {}       # uid → Request
        self.shadow_at: dict[int, int] = {}      # uid → backup cube
        self.completed: list = []
        self.recovery_log: list[dict] = []
        self._mtoken = 0
        deadline = time.monotonic() + startup_timeout
        try:
            for p in self.procs:
                ev = self._await_ev(p.cube, "ready",
                                    timeout=max(0.0, deadline - time.monotonic()))
                if ev is None:
                    raise RuntimeError(f"cube {p.cube} worker failed to come up within "
                                       f"{startup_timeout}s")
        except BaseException:
            self.shutdown()
            raise

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> CubeProcRouter:
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def shutdown(self) -> None:
        for p in self.procs:
            p.close()

    @property
    def n_cubes(self) -> int:
        return len(self.procs)

    def _alive(self) -> list[int]:
        return [i for i, p in enumerate(self.procs) if i not in self.dead and p.alive()]

    # -- routing -------------------------------------------------------------

    def _loads(self) -> dict[int, int]:
        loads = dict.fromkeys(self._alive(), 0)
        for cube in self.pending.values():
            if cube in loads:
                loads[cube] += 1
        return loads

    def _pick(self, req) -> int:
        alive = self._alive()
        if not alive:
            raise RuntimeError("no live cubes")
        # straggling cubes get no NEW work while a healthy cube remains
        # (their in-flight requests keep making progress)
        stragglers = set(self.detector.stragglers())
        cands = [c for c in alive if c not in stragglers] or alive
        if self.policy == "hash":
            return cands[req.uid % len(cands)]
        loads = self._loads()
        return min(cands, key=lambda c: (loads.get(c, 0), c))

    def submit(self, req) -> int:
        cube = self._pick(req)
        self.requests[req.uid] = req
        self.pending[req.uid] = cube
        self.routed[cube] += 1
        ok = self.procs[cube].send({
            "op": "submit", "uid": req.uid,
            "prompt": wire_pack(torch.as_tensor(np.asarray(req.prompt, np.int32)), "none"),
            "max_new_tokens": req.max_new_tokens, "temperature": req.temperature})
        if not ok:
            self._on_cube_death(cube, reason="send-failed")
            return self.pending[req.uid]         # recovery re-routed it
        return cube

    # -- event plumbing ------------------------------------------------------

    def _handle(self, cube: int, ev: dict) -> None:
        kind = ev["ev"]
        if kind == "step_report":
            self.detector.report(cube, ev["step"])
        elif kind == "done":
            uid = ev["uid"]
            req = self.requests.get(uid)
            if req is None or uid not in self.pending:
                return                           # a duplicate after recovery
            req.out_tokens = [int(t) for t in ev["tokens"]]
            req.done = True
            self.pending.pop(uid, None)
            self.completed.append(req)
            backup = self.shadow_at.pop(uid, None)
            if backup is not None and backup in self._alive():
                self.procs[backup].send({"op": "drop_shadow", "uid": uid})
        elif kind == "checkpoint":
            uid = ev["uid"]
            if uid not in self.pending:
                return                           # completed meanwhile
            backup = self._backup_for(cube)
            if backup is None:
                return
            self._drop_stale_shadow(uid, keep=backup)
            ok = (self.procs[backup].send({"op": "shadow_put", "uid": uid,
                                           "payload": ev["payload"]})
                  and self.procs[backup].send({"op": "shadow_signal", "uid": uid}))
            if ok:
                self.shadow_at[uid] = backup
        elif kind == "error":
            raise RuntimeError(f"cube {cube} worker failed:\n{ev['msg']}")
        # ready/bye/put_ack and the rpc replies are taken by their waiters

    def _drop_stale_shadow(self, uid: int, keep: int | None = None) -> None:
        """Drop ``uid``'s shadow on a cube other than ``keep``: a request
        drained to the cube that held its shadow runs there now, and its
        next checkpoint lands on another backup, so the old shadow would
        hold host pages for good."""
        old = self.shadow_at.get(uid)
        if old is not None and old != keep:
            del self.shadow_at[uid]
            if old in self._alive():
                self.procs[old].send({"op": "drop_shadow", "uid": uid})

    def _backup_for(self, cube: int) -> int | None:
        alive = [c for c in self._alive() if c != cube]
        if not alive:
            return None
        # a deterministic ring neighbour: the next live cube after this one
        return min(alive, key=lambda c: (c - cube) % len(self.procs))

    def _pump(self, cube: int) -> None:
        """Drain and handle every buffered event of one cube."""
        box = self.procs[cube].inbox
        while True:
            try:
                ev = box.get_nowait()
            except queue.Empty:
                return
            if ev is None:
                return
            self._handle(cube, ev)

    def _await_ev(self, cube: int, kind: str, timeout: float = 60.0,
                  match: dict | None = None) -> dict | None:
        """Block until ``cube`` sends an event of ``kind`` (handling every
        other event on the way).  None when the cube dies or the wait times
        out."""
        box = self.procs[cube].inbox
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                ev = box.get(timeout=0.05)
            except queue.Empty:
                if not self.procs[cube].alive():
                    # an error frame the worker sent before it exited raises
                    self.procs[cube]._reader.join(timeout=5.0)
                    self._pump(cube)
                    return None
                continue
            if ev is None:
                return None
            if ev["ev"] == kind and all(ev.get(k) == v for k, v in (match or {}).items()):
                return ev
            self._handle(cube, ev)
        return None

    # -- failure handling ----------------------------------------------------

    def kill_cube(self, cube: int) -> None:
        """Chaos hook: SIGKILL a worker mid-drive."""
        self.procs[cube].kill()

    def _check_failures(self) -> None:
        for cube, p in enumerate(self.procs):
            if cube not in self.dead and not p.alive():
                self._on_cube_death(cube, reason="process-exit")
        for cube in self.detector.dead(now=obs_clock.monotonic()):
            if cube not in self.dead:
                self._on_cube_death(cube, reason="report-timeout")

    def _on_cube_death(self, cube: int, reason: str) -> None:
        """Re-route a dead cube's in-flight requests: drain its surviving pipe
        frames first (completions and checkpoints already in the OS buffer
        count), then adopt committed shadows on the backup cube (resuming
        from host-tier pages) and resubmit the rest from their prompts."""
        t0 = obs_clock.monotonic()
        self.dead.add(cube)
        self.detector.forget(cube)
        # frames written before the SIGKILL survive in the pipe: wait for the
        # reader thread to reach EOF, then account for every one of them
        self.procs[cube]._reader.join(timeout=10.0)
        self._pump(cube)
        stranded = sorted(u for u, c in self.pending.items() if c == cube)
        adopted, resubmitted = [], []
        for uid in stranded:
            backup = self.shadow_at.pop(uid, None)
            if backup is not None and backup in self._alive():
                ok = self.procs[backup].send({"op": "adopt_shadow", "uid": uid})
                rep = self._await_ev(backup, "adopted", match={"uid": uid}) if ok else None
                if rep is not None and rep["ok"]:
                    self.pending[uid] = backup
                    adopted.append(uid)
                    continue
            # no committed shadow: greedy determinism makes resubmitting the
            # prompt token-identical, only slower
            req = self.requests[uid]
            req.out_tokens = []
            self.pending.pop(uid, None)
            self.submit(req)
            resubmitted.append(uid)
        self.recovery_log.append({
            "event": "cube_dead", "cube": cube, "reason": reason, "stranded": stranded,
            "adopted": adopted, "resubmitted": resubmitted,
            "recovery_s": obs_clock.monotonic() - t0})

    def drain_cube(self, cube: int, target: int | None = None) -> list[int]:
        """Migrate a (live, straggling) cube's exportable in-flight requests to
        ``target`` by put-then-signal; returns the migrated uids.  Requests
        mid-admission stay and finish where they are."""
        if target is None:
            target = self._backup_for(cube)
        if target is None or cube in self.dead:
            return []
        moved = []
        for uid in sorted(u for u, c in self.pending.items() if c == cube):
            ok = self.procs[cube].send({"op": "export", "uid": uid})
            rep = self._await_ev(cube, "export_result", match={"uid": uid}) if ok else None
            if rep is None:
                break                            # the cube died mid-drain
            if rep["payload"] is None:
                continue
            self._mtoken += 1
            token = f"migr-{uid}-{self._mtoken}"
            self.procs[target].send({"op": "migrate_put", "token": token,
                                     "payload": rep["payload"]})
            self._await_ev(target, "put_ack", match={"token": token})
            self.procs[target].send({"op": "migrate_signal", "token": token})
            self.pending[uid] = target
            self._drop_stale_shadow(uid)
            moved.append(uid)
        if moved:
            self.recovery_log.append({"event": "drain", "cube": cube, "target": target,
                                      "moved": moved})
        return moved

    # -- driving -------------------------------------------------------------

    def run(self, timeout: float = 600.0) -> list:
        """Pump events until every submitted request completes (the cubes
        decode on their own clocks: unlike ``CubeRouter.run`` there is no
        lockstep stepping).  Survives cube deaths mid-run."""
        mark = len(self.completed)
        deadline = time.monotonic() + timeout
        while self.pending:
            for cube in self._alive():
                self._pump(cube)
            self._check_failures()
            if not self.pending:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"cube router stalled: {sorted(self.pending)} pending after "
                                   f"{timeout}s (dead={sorted(self.dead)})")
            time.sleep(0.005)
        return sorted(self.completed[mark:], key=lambda r: r.uid)

    # -- telemetry -----------------------------------------------------------

    def telemetry(self) -> dict:
        """Per-cube engine telemetry (shipped in the wire format), with each
        live worker's kernel launches since its engine was built under
        ``launches``, plus the router's own fault and recovery view."""
        out: dict = {}
        for cube in self._alive():
            if not self.procs[cube].send({"op": "telemetry"}):
                continue
            rep = self._await_ev(cube, "telemetry")
            if rep is not None:
                snap = unwire_snapshot(wire_unpack(rep["data"]))
                snap["routed"] = self.routed[cube]
                snap["launches"] = rep["launches"]
                out[f"{self.axis}{cube}"] = snap
        out["total_routed"] = sum(self.routed)
        out["dead_cubes"] = sorted(self.dead)
        out["stragglers"] = self.detector.stragglers()
        out["recoveries"] = len(self.recovery_log)
        return out
