"""End-to-end example: train a ConvNet of the paper's family for a few
hundred steps on synthetic data with the PyTorch port, the counterpart of
``examples/train_convnet.py``: the same small net, data, optimizers and
checkpoints, on the card unless ``--device cpu`` is given.

The step is the loss's value and gradients through the differentiable
executor (``impl="xla"``), then the optimizer's update: ``momentum`` is the
paper's STREAM_GD form (Eq. 1), one ``stream_gd`` launch per step over every
leaf; ``adamw`` is plain torch.  Every 50 steps the parameters are saved with
the data cursor, in the JAX package's checkpoint layout.

Run:  PYTHONPATH=src python examples/torch_train_convnet.py [--steps 300] [--device cpu]
"""
import argparse
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.convnet import ConvNetExecutor, make_small_convnet
from repro_torch.data.pipeline import SyntheticImageData
from repro_torch.device import resolve
from repro_torch.models.common import tree_map
from repro_torch.optim.optimizer import adamw, momentum
from repro_torch.train import checkpoint as ck
from repro_torch.train.train_step import value_and_grad

DEFAULT_CKPT = Path(__file__).resolve().parents[1] / "build" / "torch_convnet_ckpt"


def make_optimizer(name: str):
    # adamw for fast convergence; momentum is the paper's STREAM_GD form
    # (W' = C0*W + C1*m, Eq. 1 — see kernels/ops.stream_gd_foreach)
    return momentum(lr=3e-3) if name == "momentum" else adamw(lr=3e-3, weight_decay=0.0)


def make_step(exe: ConvNetExecutor, opt):
    """step(params, opt_state, x, y) -> (params, opt_state, loss), as the JAX
    example's jitted step: value and grad of ``exe.loss_fn``, then
    ``opt.update`` (in place)."""

    def step(params, opt_state, x, y):
        with torch.profiler.record_function("train_step.forward_backward"):
            loss, grads = value_and_grad(exe.loss_fn, params, x, y)
        with torch.profiler.record_function("train_step.update"):
            params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def train(steps: int = 300, batch: int = 32, width: int = 16, opt: str = "adamw",
          ckpt: str | None = str(DEFAULT_CKPT), device=None, init_params=None,
          ckpt_every: int = 50):
    """Train the small net; returns (losses, params, opt_state).  Parameters
    come from ``init_params`` (copied; e.g. JAX's tree through
    ``repro_torch.convert``) or from a generator seeded with 0.  ``ckpt``
    (emptied first) receives the parameters and the data cursor every
    ``ckpt_every`` steps; None saves nothing."""
    device = resolve(device)
    layers = make_small_convnet(num_classes=10, width=width, input_px=16)
    exe = ConvNetExecutor(layers, impl="xla")
    data = SyntheticImageData(px=16, channels=3, classes=10, batch=batch)
    optimizer = make_optimizer(opt)
    if init_params is None:
        params = exe.init(torch.Generator(device=device).manual_seed(0), device)
    else:
        params = tree_map(lambda t: t.detach().to(device, copy=True), init_params)
    opt_state = optimizer.init(params)
    step = make_step(exe, optimizer)

    if ckpt is not None:
        shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.time()
    losses = []
    for i in range(steps):
        x, y = data.next()
        params, opt_state, loss = step(params, opt_state, torch.from_numpy(x).to(device),
                                       torch.from_numpy(y).to(device))
        losses.append(float(loss))
        if ckpt is not None and (i + 1) % ckpt_every == 0:
            ck.save(ckpt, i + 1, params, extra={"data": data.state_dict()})
            print(f"step {i+1:4d}  loss={np.mean(losses[-ckpt_every:]):.4f}  "
                f"({(i+1)/(time.time()-t0):.1f} steps/s)  [checkpointed]")
    return losses, params, opt_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--opt", default="adamw", choices=["adamw", "momentum"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch kernels)")
    args = ap.parse_args(argv)

    losses, _, _ = train(args.steps, args.batch, args.width, args.opt, args.ckpt,
                         args.device)
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if last < first * 0.8 else 'no progress'})")
    if not last < first * 0.9:
        raise SystemExit("training failed to reduce loss")
    print(f"latest checkpoint: step {ck.latest_step(args.ckpt)}")
    return losses


if __name__ == "__main__":
    main()
