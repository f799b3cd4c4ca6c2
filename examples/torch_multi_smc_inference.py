"""Multi-SMC network inference (paper §VI-C, Fig 1a) with the PyTorch port:
the counterpart of ``examples/multi_smc_inference.py``.

Four "SMCs" each run the same ConvNet on independent images: batch-parallel
serving with coefficients replicated per cube, the paper's scale-out scheme.
The JAX example ``vmap``s the ConvNet over the cube axis; the port's
ConvNet kernels (``stream_mac_conv``, ``stream_maxpool``, ``tiled_matmul``,
launched through ``ctypes``) cannot be ``vmap``ped, so the cube axis folds
into the batch, which gives every image the same result.  On the card
(``--device cuda``, the default) the executor runs those kernels; with
``--device cpu`` their plain versions.  Then it prints the analytic
SMC-network projection (955 GFLOPS @ 42.8 W, 4.8x K40) from the machine
model.

Run:  PYTHONPATH=src python examples/torch_multi_smc_inference.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core import zoo
from repro_torch.core.convnet import ConvNetExecutor, make_small_convnet
from repro_torch.core.smc import SMCModel, cube_rules, make_cube_mesh, simulate_smc_network
from repro_torch.device import resolve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch kernels)")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    # --- executable data-parallel "SMC network" ------------------------------
    layers = make_small_convnet(num_classes=10, width=8, input_px=16)
    exe = ConvNetExecutor(layers, impl="kernel")
    params = exe.init(torch.Generator(device=device).manual_seed(0), device)

    n_cubes = 4                                  # logical SMCs
    frames = torch.randn((n_cubes, 8, 16, 16, 3),
                         generator=torch.Generator(device=device).manual_seed(1), device=device)
    # the cube axis rides the rules of the LM stack's batch axis (CUBE_AXIS ≙
    # the production mesh's "pod"); on one device every cube runs there
    mesh = make_cube_mesh(n_cubes, device)
    rules = cube_rules(mesh)
    print(f"cube mesh {mesh.shape} over {mesh.axis_names}, batch -> {rules['batch']}")

    def network_step(frames):
        # each cube's image batch is independent: fold the cube axis into the
        # batch and unfold the logits
        out = exe.apply(params, frames.reshape((-1,) + tuple(frames.shape[2:])))
        return out.reshape(frames.shape[:2] + out.shape[1:])

    out = network_step(frames)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(5):
        network_step(frames)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = (time.time() - t0) / 5
    fps = n_cubes * frames.shape[1] / dt
    print(f"executable 4-cube network: {tuple(out.shape)}, {fps:.0f} frames/s ({device})")

    # --- the paper's projection (machine model) ------------------------------
    model = SMCModel()
    print(f"\n{'cubes':>5s} {'GFLOPS':>8s} {'W':>6s} {'GF/W':>6s} {'vs K40':>7s}")
    for n in (1, 2, 4, 8):
        net = simulate_smc_network(model, zoo.ZOO["ResNet152"](), n_cubes=n)
        print(f"{n:5d} {net.gflops:8.0f} {net.power_w:6.1f} "
              f"{net.gflops_per_w:6.1f} {net.speedup_vs_k40_eff:6.1f}x")
    print("\npaper §VI-C reference: 4 cubes = 955 GFLOPS @ 42.8 W = 4.8x K40")
    return out


if __name__ == "__main__":
    main()
