"""Parameter conversion between the JAX package's tree and the port.

The JAX model's parameters (``repro.models.DecoderLM.init``, and the vlm's
and the audio family's ``VLM`` and ``EncDecLM``), turned into numpy arrays,
have the same nested-dict structure and leaf names as the port's
(``repro_torch.models.DecoderLM.param_specs``, ``VLM``'s, ``EncDecLM``'s), so
conversion is leaf for leaf.  bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` numpy arrays,
which ``torch.from_numpy`` does not take; they pass through float32, which
holds every bfloat16 value exactly.  A serving engine's migration payload
crosses over the same way (``payload_from_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import SEQ_CACHE_KEYS, tree_items, tree_map


def _tensor(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)          # own, writable copy


def params_from_numpy(tree, device="cpu"):
    """Nested dicts/lists of numpy arrays → the same tree of tensors."""
    return tree_map(lambda a: _tensor(a, device), tree)


def payload_from_numpy(payload: dict) -> dict:
    """A migration payload of the JAX package's ``export_request`` or
    ``checkpoint_request`` (numpy leaves in the JAX host tier's buffer tree,
    0-d placeholders where a leaf does not apply) → the port's: ``seq`` as
    ``{path: CPU tensor (layers, n_pages, PS, *row)}`` of the seq leaves and
    ``state`` as ``{path: CPU tensor (layers, 1, *tail)}`` of the recurrent
    ones (None when the JAX payload has none), keyed by the port's cache
    paths; the other members as they are.  The trees have the same
    structure on both sides, so paths carry over."""
    out = dict(payload)
    if payload.get("seq") is not None:
        out["seq"] = {path: _tensor(a) for path, a in tree_items(payload["seq"])
                      if path[-1] in SEQ_CACHE_KEYS and np.ndim(a)}
    if payload.get("state") is not None:
        out["state"] = {path: _tensor(a) for path, a in tree_items(payload["state"])
                        if path[-1] not in SEQ_CACHE_KEYS and np.ndim(a)} or None
    return out


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
