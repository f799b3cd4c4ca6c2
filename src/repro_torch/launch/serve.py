"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Serves seeded random requests with the reduced config of ``--arch`` and
random weights from a seeded generator, on the card unless ``--device cpu``
is given.  The flags are those of ``python -m repro.launch.serve`` that the
port supports (no host tier, prefix sharing, tracing or cubes yet).
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
from repro_torch.serve import AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch kernels)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=0,
                    help="page pool size (0 = dense-equivalent budget)")
    ap.add_argument("--policy", choices=["fcfs", "spf"], default="fcfs")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--max-step-tokens", type=int, default=0)
    ap.add_argument("--async-prefill", choices=["on", "off"], default="on",
                    help="run prefill on the admission pipeline thread (on, "
                         "default) or inline per step (off); identical tokens")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = get_arch(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    ecfg = EngineConfig(
        batch_slots=args.slots, max_len=args.max_len,
        cache=CacheConfig(page_size=args.page_size, n_pages=args.pages or None),
        admission=AdmissionConfig(
            policy=args.policy, prefill_chunk=args.prefill_chunk,
            max_step_tokens=args.max_step_tokens,
            async_prefill=args.async_prefill == "on",
        ),
    )
    eng = ServeEngine(model, params, ecfg, device=device)
    if device.type == "cuda":
        build.build()             # compile the kernels before the clock starts
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, size=(8,)).astype(np.int32),
            max_new_tokens=args.max_new,
        ))
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"{cfg.name}: {len(done)} requests, {toks} tokens, {toks / dt:.1f} tok/s "
          f"on {device}")
    print(json.dumps(eng.telemetry(), indent=2, default=float))


if __name__ == "__main__":
    main()
