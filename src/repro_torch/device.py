"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    the CPU.  Raises when the card is asked for and none is present; an
    entry point never carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU (its plain PyTorch kernels)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
