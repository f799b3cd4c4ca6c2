"""Serve a small LM with batched requests through the PyTorch port: chunked
prefill + paged-KV continuous-batching decode, optionally routed across SMC
cube engines (each cube ≙ one independently streaming SMC, the host only
coordinates).  The counterpart of ``examples/serve_lm.py``.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--arch qwen2.5-3b] [--device cpu]
      PYTHONPATH=src python examples/torch_serve_lm.py --cubes 2 --policy spf
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve
from repro_torch.models import build_model
from repro_torch.serve import (
    AdmissionConfig, CacheConfig, CubeRouter, EngineConfig, Request, ServeEngine)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help="any assigned arch id (the reduced config is served)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch kernels)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--policy", choices=["fcfs", "spf"], default="fcfs")
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--cubes", type=int, default=1,
                    help=">1 routes requests over cube engines")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    ecfg = EngineConfig(batch_slots=3, max_len=96, cache=CacheConfig(page_size=16),
                        admission=AdmissionConfig(policy=args.policy,
                                                  prefill_chunk=args.prefill_chunk))
    if args.cubes > 1:
        eng = CubeRouter(model, params, ecfg, n_cubes=args.cubes, device=device)
    else:
        eng = ServeEngine(model, params, ecfg, device=device)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=(4 + i % 5,)).astype(np.int32)
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=args.new_tokens))
    done = eng.run()
    dt = time.time() - t0

    total_tokens = sum(len(r.out_tokens) for r in done)
    print(f"arch={cfg.name}: served {len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s on {device}, reduced config)")
    for r in sorted(done, key=lambda r: r.uid)[:3]:
        print(f"  req {r.uid}: prompt[:4]={[int(t) for t in r.prompt[:4]]} -> out={r.out_tokens}")
    tel = eng.telemetry()
    if args.cubes > 1:
        for cube, t in tel.items():
            if isinstance(t, dict):
                print(f"  {cube}: routed={t['routed']} occupancy_max={t['occupancy_max']:.2f}")
    else:
        print(f"  page occupancy mean={tel['occupancy_mean']:.2f} "
              f"max={tel['occupancy_max']:.2f} preemptions={tel['preemptions']}")
    assert len(done) == args.requests
    return done


if __name__ == "__main__":
    main()
