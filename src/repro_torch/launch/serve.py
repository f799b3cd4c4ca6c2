"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Serves seeded random requests with the reduced config of ``--arch`` and
random weights from a seeded generator, on the card unless ``--device cpu``
is given.  The flags are those of ``python -m repro.launch.serve``.  Every
registered ``--arch`` builds; the audio family (``whisper-large-v3``) has
no paged decode, so its engine raises the reference's ``TypeError``, as the
JAX launcher does (serve it through ``EncDecLM.prefill``/``decode_step``).
``--cubes N`` routes the requests over N engines (``serve.router.CubeRouter``,
every engine on the one card with one parameter set), and with
``--multiproc`` over N worker processes (``serve.cube_proc.CubeProcRouter``,
each building the reduced model from the same seed, with shadow checkpoints
every ``--checkpoint-every`` steps).  ``--temperature T`` samples every decode
token from ``softmax(logits / T)`` under a generator on the device seeded
with ``--seed``; ``--trace OUT.json`` writes the run's Perfetto trace.
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve
from repro_torch.kernels import build
from repro_torch.models import build_model
from repro_torch.serve import (
    AdmissionConfig, CacheConfig, CubeProcRouter, CubeRouter, EngineConfig, ObsConfig, Request,
    ServeEngine)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch kernels)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="> 0 samples decode tokens from softmax(logits / T); 0 is greedy")
    ap.add_argument("--seed", type=int, default=1,
                    help="seed of the sampling generator (on the device)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=0,
                    help="page pool size (0 = dense-equivalent budget)")
    ap.add_argument("--policy", choices=["fcfs", "spf"], default="fcfs")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--max-step-tokens", type=int, default=0)
    ap.add_argument("--async-prefill", choices=["on", "off"], default="on",
                    help="run prefill on the admission pipeline thread (on, "
                         "default) or inline per step (off); identical tokens")
    ap.add_argument("--admission-inflight", type=int, default=2,
                    help="backpressure: admissions in flight (pages reserved, not yet "
                         "decoding) before the pipeline stops admitting")
    ap.add_argument("--preempt-policy", choices=["swap", "recompute"], default="swap",
                    help="eviction: swap pages to the host tier and restore them on "
                         "resume (default), or free them and prefill again")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host-tier page pool size (0 = 2x device pool under "
                         "--preempt-policy swap)")
    ap.add_argument("--swap-cost", type=float, default=0.25,
                    help="cost of moving one token of KV relative to recomputing it")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="index resident prompt prefixes so repeats share pages")
    ap.add_argument("--cubes", type=int, default=1, help="route over N cube engines")
    ap.add_argument("--route", choices=["hash", "least_loaded", "prefix_affinity"],
                    default="least_loaded")
    ap.add_argument("--multiproc", action="store_true",
                    help="with --cubes N: one worker PROCESS per cube (CubeProcRouter) with "
                         "live straggler and dead-cube policy, instead of in-process engines")
    ap.add_argument("--checkpoint-every", type=int, default=4,
                    help="multiproc: steps between shadow checkpoints forwarded to the "
                         "backup cube (0 = off)")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record request lifecycles and engine events in the ring-buffer "
                         "tracer and write a Perfetto/Chrome trace here after the run")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    ecfg = EngineConfig(
        batch_slots=args.slots, max_len=args.max_len,
        cache=CacheConfig(page_size=args.page_size, n_pages=args.pages or None,
                          host_pages=args.host_pages or None,
                          preempt_policy=args.preempt_policy, swap_token_cost=args.swap_cost,
                          prefix_sharing=args.prefix_sharing),
        admission=AdmissionConfig(
            policy=args.policy, prefill_chunk=args.prefill_chunk,
            max_step_tokens=args.max_step_tokens,
            async_prefill=args.async_prefill == "on",
            admission_inflight=args.admission_inflight,
        ),
        obs=ObsConfig(trace=args.trace is not None),
    )
    if device.type == "cuda":
        build.build()             # compile the kernels before any engine or worker runs
    multiproc = args.cubes > 1 and args.multiproc
    if multiproc:
        eng = CubeProcRouter(args.arch, ecfg, n_cubes=args.cubes, policy=args.route,
                             checkpoint_every=args.checkpoint_every, device=device.type)
    elif args.cubes > 1:
        eng = CubeRouter(model, params, ecfg, n_cubes=args.cubes, policy=args.route,
                         device=device)
    else:
        eng = ServeEngine(model, params, ecfg, device=device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, size=(8,)).astype(np.int32),
            max_new_tokens=args.max_new, temperature=args.temperature,
        ))
    t0 = time.time()
    if multiproc:
        done = eng.run()          # the workers decode greedily, on their own clocks
    else:
        done = eng.run(torch.Generator(device=device).manual_seed(args.seed))
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"{cfg.name}: {len(done)} requests, {toks} tokens, {toks / dt:.1f} tok/s "
          f"on {device}")
    print(json.dumps(eng.telemetry(), indent=2, default=float))
    if args.trace and not multiproc:
        eng.save_trace(args.trace)
        print(f"trace -> {args.trace}")
    elif args.trace:
        print("trace: not supported with --multiproc (workers own their ring buffers); "
              "recovery events land in telemetry instead")
    if multiproc:
        eng.shutdown()


if __name__ == "__main__":
    main()
