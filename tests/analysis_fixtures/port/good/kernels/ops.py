"""Positive fixture: launch wrappers in the port's idiom — the plain
version for CPU tensors, metadata checks, offsets passed to the kernel on
the device, a dtype code from a validation helper."""
import torch

from . import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_cuda(name, *tensors):
    t0 = tensors[0]
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype or not t.is_contiguous():
            raise ValueError(name)
    return _DTYPES[t0.dtype]


def _on_device(q_offset, kv_len):
    tensors = [x for x in (q_offset, kv_len) if isinstance(x, torch.Tensor)]
    for x in tensors:
        if x.dim() != 0:
            raise ValueError("0-d offsets only")
    return bool(tensors)


def flash_attention(q, k, v, q_offset=0, kv_len=None):
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, q_offset=q_offset, kv_len=kv_len)
    code = _check_cuda("flash_attention", q, k, v)
    if code == 1 and q.shape[-1] not in (64, 128):
        raise ValueError("head dim")
    pair = None
    if _on_device(q_offset, kv_len):
        pair = torch.stack([q_offset, kv_len]).to(torch.int32)
    return _launch(code, q, k, v, pair)


def paged_write(pools, rows, block_table, positions, active):
    if not pools or pools[0].device.type != "cuda":
        if any(p.device.type != "cpu" for p in pools):
            raise ValueError("one device")
        return ref.paged_write(pools, rows, block_table, positions, active)
    for pool, row in zip(pools, rows):
        if pool.ndim < 3 or row.dtype != pool.dtype:
            raise ValueError("shapes")
    return _launch(0, *pools, *rows, block_table, positions, active)


def _launch(code, *tensors):
    err = 0
    if err != 0:
        raise RuntimeError("launch failed")
    return tensors[0]
