"""Parameter conversion between the JAX package's tree and the port.

The JAX model's parameters (``repro.models.DecoderLM.init``), turned into
numpy arrays, have the same nested-dict structure and leaf names as the
port's (``repro_torch.models.DecoderLM.param_specs``), so conversion is leaf
for leaf.  bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` numpy arrays,
which ``torch.from_numpy`` does not take; they pass through float32, which
holds every bfloat16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import tree_map


def params_from_numpy(tree, device="cpu"):
    """Nested dicts/lists of numpy arrays → the same tree of tensors."""

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)      # own, writable copy

    return tree_map(leaf, tree)


def opt_state_from_numpy(state, device="cpu"):
    """An optimizer state of the JAX package (``{"m": …[, "v": …], "count":
    …}`` with numpy leaves) → the port's state: moment trees leaf for leaf,
    in their own types (bf16 moments stay bf16), and ``count`` an int32
    scalar tensor."""
    if "count" not in state or not set(state) <= {"m", "v", "count"}:
        raise ValueError(f"not an optimizer state of sgd/momentum/adamw: keys {sorted(state)}")
    return params_from_numpy(state, device)


def params_to_numpy(params):
    """The port's tensors → numpy arrays (bfloat16 leaves as float32)."""

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, params)
