"""Request routing across the SMC cube mesh (paper §VI-C, serving form): the
port of ``repro/serve/router.py``.

The paper's scalable paradigm is a *network* of SMCs, each streaming its own
requests while the host only coordinates.  The router is that host: one
paged ``ServeEngine`` per cube slot along ``CUBE_AXIS``, each with its own
page pools and its own captured decode step, all reading one parameter set
per device, with requests spread by

* ``hash``            — uid-stable assignment, no coordination state;
* ``least_loaded``    — the engine with the least queue depth wins;
* ``prefix_affinity`` — the cube whose prefix index holds the longest
  resident prefix of the prompt wins (ties least-loaded; least-loaded on a
  miss everywhere).  Useful with ``CacheConfig.prefix_sharing`` on.

Cube ``i`` runs on the device of mesh slot ``i`` modulo the mesh's cube
count (``core.smc.make_cube_mesh``): on one card every cube shares it, and
the parameters, as the JAX router passes one ``params`` to every engine.
Every engine is built (and its decode step captured) before any request
enters.
"""
from __future__ import annotations

import torch

from repro_torch.core.smc import CUBE_AXIS, make_cube_mesh
from repro_torch.device import resolve
from repro_torch.models.common import tree_items, tree_map
from repro_torch.obs.export import write_chrome_trace
from repro_torch.obs.metrics import MetricsRegistry

from .engine import EngineConfig, Request, ServeEngine

POLICIES = ("hash", "least_loaded", "prefix_affinity")


class CubeRouter:
    """Hash / least-loaded / prefix-affinity routing of requests over
    per-cube engines."""

    def __init__(self, model, params, ecfg: EngineConfig, n_cubes: int = 2,
                 policy: str = "least_loaded", mesh=None, device=None):
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy: {policy!r}")
        self.mesh = mesh if mesh is not None else make_cube_mesh(n_cubes, device)
        self.policy = policy
        self.axis = CUBE_AXIS
        home = next(tree_items(params))[1].device
        copies = {home: params}
        self.engines = []
        for i in range(n_cubes):
            dev = resolve(self.mesh.devices[i % self.mesh.n_cubes])
            if dev not in copies:
                copies[dev] = tree_map(lambda t, d=dev: t.to(d), params)
            self.engines.append(ServeEngine(model, copies[dev], ecfg, device=dev))
        # routing counters get their own registry (the router has no lock of
        # its own to share); per-cube keys "routed.<axis><i>"
        self.metrics = MetricsRegistry()
        self._c_routed = [self.metrics.counter(f"routed.{self.axis}{i}")
                          for i in range(n_cubes)]

    @property
    def n_cubes(self) -> int:
        return len(self.engines)

    @property
    def routed(self) -> list[int]:
        """Per-cube dispatch counts, one coherent cut of the counters."""
        with self.metrics.lock:
            return [c.value for c in self._c_routed]

    # -- routing --------------------------------------------------------------

    def _pick(self, req: Request) -> int:
        if self.policy == "hash":
            return req.uid % self.n_cubes
        loads = [e.load for e in self.engines]
        if self.policy == "prefix_affinity":
            match = [e.prefix_match_tokens(req.prompt) for e in self.engines]
            best = max(match)
            if best > 0:
                # longest resident prefix wins; ties go least-loaded
                return int(min((i for i in range(self.n_cubes) if match[i] == best),
                               key=loads.__getitem__))
        return int(min(range(self.n_cubes), key=loads.__getitem__))

    def submit(self, req: Request) -> int:
        cube = self._pick(req)
        eng = self.engines[cube]
        # the dispatch instant lands on the TARGET engine's trace, so a
        # request's timeline starts with where the router sent it
        eng.tracer.instant(eng.tracer.EV_DISPATCH, req.uid, cube)
        eng.submit(req)
        self.metrics.inc(f"routed.{self.axis}{cube}")
        return cube

    # -- stepping -------------------------------------------------------------

    def step(self, generator: torch.Generator | None = None) -> bool:
        return any([e.step(generator) for e in self.engines])

    def run(self, generator: torch.Generator | None = None) -> list[Request]:
        """Step every cube in lockstep (the cubes run concurrently in the
        paper's network; here one host interleaves them) until drained;
        ``generator`` draws every sampled token of every cube.  Each
        engine's admission thread is parked at the end, as
        ``ServeEngine.run`` parks its own (a live thread would keep its
        engine, pools and parameters alive)."""
        marks = [len(e.completed) for e in self.engines]
        while any(e.load for e in self.engines):
            self.step(generator)
        for e in self.engines:
            e.pipeline.shutdown()
        done: list[Request] = []
        for e, m in zip(self.engines, marks):
            done.extend(e.completed[m:])
        return sorted(done, key=lambda r: r.uid)

    # -- telemetry (per-cube queue depth: the least-loaded signal) ------------

    def telemetry(self) -> dict:
        """Deep point-in-time snapshot: one lock cut per engine plus one for
        the routing counters; mutating it never touches live stats."""
        routed = self.routed
        per_cube: dict = {f"{self.axis}{i}": dict(e.telemetry(), routed=routed[i])
                          for i, e in enumerate(self.engines)}
        per_cube["total_routed"] = sum(routed)
        return per_cube

    def save_trace(self, path: str) -> dict:
        """Every cube's ring buffer in ONE Perfetto JSON, each engine a named
        process track."""
        return write_chrome_trace(path, {f"{self.axis}{i}": e.tracer
                                         for i, e in enumerate(self.engines)})
