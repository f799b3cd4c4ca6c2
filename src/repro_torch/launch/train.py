"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains the reduced config of ``--arch`` (or, with ``--full``, the published
one with ``cfg.train_microbatches`` microbatches) from seeded random
weights on synthetic data, on the card unless ``--device cpu`` is given.
The flags are those of ``python -m repro.launch.train`` that one card
needs (no mesh, no overlap flags) plus ``--device``; ``--ckpt`` names a
checkpoint directory to save into and resume from (none by default).  On
the card every step after the first replays one CUDA graph
(``Trainer``'s captured step, ``TrainerConfig.cuda_graph``).
Every registered family trains (the vlm's batches carry stub patch
embeddings, the audio family's stub frames, as the JAX package's data
makes them).  ``--full`` refuses a configuration
whose weights, float32 gradient sums, one microbatch's gradients and
float32 optimizer moments alone exceed one 80 GB card (full-width
recurrentgemma-9b: about 9.5 B parameters; llava-next-mistral-7b, 7.3 B,
under momentum or adamw; the moe models: 671 B and 235 B).  There is no
depth cut, as in the JAX launcher: ``chip_smoke.py`` trains the moe models
at published widths cut in depth through ``Trainer`` directly.
"""
import argparse
import math

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.device import resolve
from repro_torch.kernels import build
from repro_torch.models import build_model
from repro_torch.models.common import tree_items
from repro_torch.train.trainer import Trainer, TrainerConfig

CARD_BYTES = 80e9                            # one H100's device memory
MOMENTS = {"sgd": 0, "momentum": 1, "adamw": 2}


def training_bytes(model, optimizer: str, n_microbatches: int) -> float:
    """Bytes a train step holds besides activations: the weights, the
    gradients (float32 sums with microbatches, plus one microbatch's in the
    weights' type) and the float32 optimizer moments."""
    total = 0.0
    for _, s in tree_items(model.param_specs()):
        n, item = math.prod(s.shape), s.dtype.itemsize
        grads = 4 + item if n_microbatches > 1 else item
        total += n * (item + grads + 4 * MOMENTS[optimizer])
    return total


def main(argv=None):
    """Returns (trainer, final state, restarts)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw", choices=["sgd", "momentum", "adamw"])
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (saved every 25 steps and at the end; "
                         "a rerun resumes from it); none by default")
    ap.add_argument("--full", action="store_true",
                    help="the published config, cfg.train_microbatches microbatches")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch kernels)")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg)
    n_micro = cfg.train_microbatches if args.full else 1
    if args.full and (need := training_bytes(model, args.optimizer, n_micro)) > CARD_BYTES:
        raise SystemExit(
            f"{cfg.name} at full width does not fit one 80 GB card: its weights, gradients "
            f"and {args.optimizer} state alone take {need / 1e9:.1f} GB")
    data = SyntheticLMData(cfg, batch=args.batch, seq=args.seq, device=device)
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=25,
        optimizer=args.optimizer, lr=args.lr,
        n_microbatches=n_micro,
    )
    if device.type == "cuda":
        build.build()             # compile the kernels before the first step
    print(f"training {cfg.name} on {device} for {args.steps} steps "
          f"({tcfg.n_microbatches} microbatches of {args.batch // tcfg.n_microbatches})",
          flush=True)
    tr = Trainer(model, data, tcfg, device=device)
    state, restarts = tr.run_with_restarts(0)
    first = sum(state.losses[:10]) / max(len(state.losses[:10]), 1)
    last = sum(state.losses[-10:]) / max(len(state.losses[-10:]), 1)
    print(f"done: step={state.step} loss {first:.3f} -> {last:.3f} "
          f"(restarts={restarts})", flush=True)
    return tr, state, restarts


if __name__ == "__main__":
    main()
