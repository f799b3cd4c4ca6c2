"""Checkpointing: step-versioned, atomic, async — the port of
``repro/train/checkpoint.py`` with the same on-disk layout.

Layout: ``<dir>/step_<n>/arrays.npz`` + ``tree.json`` + ``META`` (fsync'd
last — a checkpoint without META is incomplete and ignored on restore).
Writes go to ``step_<n>.tmp`` and are atomically renamed, so a crash
mid-save never corrupts the latest checkpoint.  Keys are the JAX package's
(``params/…``, ``opt_state/…``, sorted dict keys, ``#i`` for list items);
bfloat16 leaves are stored as their ``uint16`` bits with the dtype named
in ``tree.json``.  So a checkpoint written by either package restores into
the other.  ``restore(..., device=...)`` puts the arrays on one device (the
port runs on one card; there is no mesh to re-shard onto).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models.common import tree_map

META = "META"
_NATIVE = ("float64", "float32", "float16", "int64", "int32", "int16", "int8", "uint8",
           "uint16", "uint32", "uint64", "bool")


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _to_numpy(x) -> tuple[np.ndarray, str | None]:
    """A leaf as a numpy array that ``np.savez`` stores, and the dtype name
    to record when that array holds another type's bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), None
    a = np.asarray(x)
    if a.dtype.name not in _NATIVE:          # e.g. an ml_dtypes bfloat16 array
        return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8), a.dtype.name
    return a, None


def _from_numpy(a: np.ndarray, dtype: str | None, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif dtype is not None:
        raise TypeError(f"checkpoint leaf of dtype {dtype} has no torch counterpart")
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def save(
    ckpt_dir: str,
    step: int,
    params,
    opt_state=None,
    extra: dict | None = None,
    keep: int = 3,
) -> str:
    """Synchronous atomic save; returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    tree = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        arrays[k], name = _to_numpy(v)
        if name is not None:
            dtypes[k] = name
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(arrays.keys()),
                   "dtypes": dtypes, "extra": extra or {}}, f)
    with open(os.path.join(tmp, META), "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _host_copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


class AsyncSaver:
    """Background-thread checkpointing (training continues while writing).
    The trees are copied to host memory before the thread starts: the
    optimizer updates the parameters in place on the next step."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save(self, step: int, params, opt_state=None, extra=None):
        params = tree_map(_host_copy, params)
        opt_state = tree_map(_host_copy, opt_state) if opt_state is not None else None
        self.wait()
        self._thread = threading.Thread(
            target=save,
            args=(self.ckpt_dir, step, params, opt_state, extra, self.keep),
            daemon=True,
        )
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if (name.startswith("step_") and not name.endswith(".tmp")
                and os.path.exists(os.path.join(ckpt_dir, name, META))):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, params_proto, opt_proto=None, step: int | None = None,
            device=None):
    """(params[, opt_state], extra, step) of ``step`` (default: the latest
    complete checkpoint), as tensors on ``device`` (the card unless
    ``"cpu"``) in the protos' tree structure."""
    device = resolve(device)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes", {})

    with np.load(os.path.join(path, "arrays.npz")) as z:
        def rebuild(p, pre):
            if isinstance(p, dict):
                return {k: rebuild(v, f"{pre}{k}/") for k, v in sorted(p.items())}
            if isinstance(p, (list, tuple)):
                return type(p)(rebuild(v, f"{pre}#{i}/") for i, v in enumerate(p))
            key = pre[:-1]
            return _from_numpy(z[key], dtypes.get(key), device)

        out = [rebuild(params_proto, "params/")]
        if opt_proto is not None:
            out.append(rebuild(opt_proto, "opt_state/"))
    out.append(meta.get("extra", {}))
    out.append(step)
    return tuple(out)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(
        n for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp")
    )
    for n in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, n), ignore_errors=True)
