"""Quickstart: the paper's pipeline end to end with the PyTorch port, the
counterpart of ``examples/quickstart.py``.

1. take a ConvNet of the paper's family (reduced),
2. execute it layer by layer through ``stream_mac_conv``, ``stream_maxpool``
   and ``tiled_matmul`` (``impl="kernel"``): the hand-written kernels on the
   card, their plain PyTorch versions with ``--device cpu``,
3. report the modeled SMC performance and energy for the FULL networks of
   the zoo, beside the paper's frame rates,
4. show one optimized 4D tile (section IV-A).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import zoo
from repro_torch.core.convnet import ConvNetExecutor, make_small_convnet
from repro_torch.core.smc import SMCModel
from repro_torch.device import resolve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch kernels)")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    # --- tiny ConvNet executed for real (the ConvNet kernels) ---------------
    layers = make_small_convnet(num_classes=10, width=8, input_px=16)
    exe = ConvNetExecutor(layers, impl="kernel")
    params = exe.init(torch.Generator(device=device).manual_seed(0), device)
    x = torch.randn((2, 16, 16, 3), generator=torch.Generator(device=device).manual_seed(1),
                    device=device)
    logits = exe.apply(params, x)
    print(f"forward OK on {device}: logits {tuple(logits.shape)}, "
          f"finite={bool(torch.isfinite(logits).all())}")

    # --- the paper's models, tiled + simulated on the SMC machine model ----
    model = SMCModel()
    print(f"{'net':12s} {'GFLOPS':>7s} {'fps':>6s} {'paper':>6s} "
          f"{'GF/W':>5s} {'roofline':>8s}")
    for net in ("AlexNet", "GoogLeNet", "ResNet50", "VGG16"):
        s = model.convnet_summary(zoo.ZOO[net]())
        print(f"{net:12s} {s['gflops']:7.1f} {s['fps']:6.1f} "
              f"{zoo.PAPER_FPS[net]:6d} {s['gflops_per_w_cube']:5.1f} "
              f"{s['roofline_fraction']:8.2f}")

    # --- one optimized tile, shown explicitly (Fig 3b) ---------------------
    l = zoo.ZOO["ResNet50"]()[5]
    tile, perf = model.optimize_layer(l)
    print(f"\nlayer {l.name}: tile (T_Xi={tile.txi}, T_Yi={tile.tyi}, "
          f"T_Ci={tile.tci}, T_Co={tile.tco})  OI={perf.oi:.1f} "
          f"SPM={perf.spm_bytes//1024}KB/128KB")
    return logits


if __name__ == "__main__":
    main()
