"""Positive fixture: the kernels' plain versions run for CPU tensors only
and are never followed from a captured step, host reads and all."""


def flash_attention(q, k, v, q_offset=0, kv_len=None):
    n = int(kv_len) if kv_len is not None else k.shape[2]
    return q[..., :n]


def paged_write(pools, rows, block_table, positions, active):
    for lane in active.nonzero()[:, 0].tolist():
        pools[0][lane] = rows[0][lane]
