"""Public kernel wrappers with the JAX package's layouts.

``flash_attention`` takes q (B, H, Sq, D) and k/v (B, Hkv, Sk, D);
``paged_attention`` takes q (B, H, D) and page pools (n_pages, PS, Hkv, D);
``stream_mac_conv`` takes NHWC x and HWIO w, ``stream_maxpool`` NHWC x and
``tiled_matmul`` (M, K) and (K, N) matrices, ``ssd_scan`` xh (B, S, H, P)
with B/C (B, S, N), ``paged_gather`` a (..., n_pages, F) pool with a
(B, P) table, and ``stream_gd`` (J, *shape) streams with J coefficients, as
``repro.kernels.ops`` does (``ssd_scan`` also takes an initial state and
returns the final one, ``paged_gather`` keeps the leading layers dim
instead of moving it, ``paged_gather_many`` gathers a list of pools
through one table in one launch, and ``stream_gd_foreach`` is the optimizer's form
of ``stream_gd``: a list of leaves in one launch, each with separate
streams of their own types written in place, and an optional second stage
that reads the first's output; ``stream_gd_into`` is its one-leaf,
one-stage call).  ``paged_write`` is the decode step's drop-mode scatter of
new cache rows into page pools, which the JAX package leaves to XLA.
A CPU tensor runs the plain version in ``kernels.ref``.  A CUDA tensor
launches the hand-written kernel from ``csrc/`` (built on first use by
``kernels.build``) or raises: there is no fallback from the card to the
plain version.  No kernel has a backward, so every wrapper refuses an
input that requires grad while grad mode is on (on the CPU too, so the
CPU tests see what the card would do): its output would carry no
gradient and training would go silently wrong.

Each wrapper counts the kernels it launches in ``LAUNCHES`` (on the card
only), so a run can show that its main path went through the kernels.  A
launch into a CUDA graph being captured runs nothing: inside
``captured_launches`` the thread's counts go to a dict of their own, which
``add_launches`` adds once per replay of the graph.  Every launch goes out
on the current stream (``_raw_stream``), which capture replaces with its
own.
``stream_mac_conv`` and ``tiled_matmul`` choose between two designs by
shape, ``flash_attention`` among four by dtype, head dim and query rows
per KV head (``flash_path``, with ``flash_split_plan``'s cluster size for
the few-query design), and ``paged_attention`` and ``ssd_scan`` by dtype and
their cluster size (``paged_plan``, ``ssd_plan``); ``PATHS`` names the one
their last card call took.  A
``stream_gd_foreach`` or ``paged_gather_many`` call whose list outgrows
one launch's table launches one grid per table.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from array import array
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build, ref

LAUNCHES = {"paged_decode_attention": 0, "flash_attention": 0, "stream_mac_conv": 0,
            "stream_maxpool": 0, "tiled_matmul": 0, "ssd_scan": 0, "paged_gather": 0,
            "stream_gd": 0, "paged_write": 0}
_count_lock = threading.Lock()
_recorders = threading.local()     # .counts: the open ``captured_launches`` dict, if any
# the design the last card call of a kernel that has several took, by name
PATHS: dict[str, str] = {}
CONV_PATHS = ("mma.sync 128x64", "wgmma+TMA 128x64", "wgmma+TMA 128x128", "wgmma+TMA 128x256")
MATMUL_PATHS = ("tiles 64x128", "TMA weight stream 16x128")
# flash attention's designs (rows x keys per tile) and the code the launch takes
FLASH_PATHS = {"CUDA cores": 0, "mma.sync 64x64": 1, "wgmma+TMA 128x128": 2,
               "wgmma+TMA 128x64": 2, "wgmma+TMA 192x128": 2, "mma.sync split-K 16x16": 3}
FLASH_SPLIT_ROWS = 16              # Sq * rep that one mma.sync tile of the split design holds
FLASH_SPLIT_MAX_CLUSTER = 8        # blocks a split cluster may hold (the portable size)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "paged_decode_attention_launch": (
        "paged_attn",
        [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _L, _F, _P],
    ),
    "paged_decode_attention_max_cluster": ("paged_attn", [_I, _I, _I, _I]),
    "flash_attention_launch": (
        "flash_attention",
        [_I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
         _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I, _F, _P, _P],
    ),
    "stream_mac_conv_launch": (
        "stream_mac_conv", [_I, _P, _P, _P, _P] + [_I] * 14 + [ctypes.POINTER(_I), _P]),
    "stream_maxpool_launch": ("stream_maxpool", [_I, _I, _P, _P] + [_I] * 8 + [_P]),
    "tiled_matmul_launch": ("tiled_matmul", [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "tiled_matmul_plan": ("tiled_matmul", [_I] * 6 + [ctypes.POINTER(_I)]),
    "tiled_matmul_path": ("tiled_matmul", [_I] * 3),
    "ssd_scan_launch": ("ssd_scan", [_I] + [_P] * 8 + [_I] * 8 + [_L] * 6 + [_P]),
    "paged_gather_launch": ("paged_gather", [_I, _P]),
    "paged_gather_capacity": ("paged_gather", []),
    "paged_gather_smem": ("paged_gather", [_L]),
    "paged_gather_table_cache": ("paged_gather", []),
    "stream_gd_launch": ("stream_gd", [_I, _I, _I, ctypes.POINTER(_F), _I, _P, _P, _P, _P,
                                       ctypes.POINTER(_I)]),
    "stream_gd_capacity": ("stream_gd", [_I, _I]),
    "paged_write_launch": ("paged_write", [_I, _P]),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)     # the head sizes the paged-decode kernel is built for
# flash attention's, with MLA's query-key heads (reduced 48, published 192)
FLASH_HEAD_DIMS = (32, 48, 64, 128, 192, 256)
# the pools one paged_write launch takes (csrc/paged_write.cu's kCap): 2 per
# layer on the paged path, the cache tree's seq leaves (at most 4) on the
# gather path
PAGED_WRITE_POOLS = 8
MAX_REP = 16                       # query heads per KV head in paged decode
MAX_CLUSTER = 16                   # blocks a paged-decode cluster may hold (8 is portable)
SSD_MAX_CHUNK = 512                # ssd_scan: 8 blocks of at most 64 chunk rows
SSD_MAX_P = 64                     # ssd_scan's head dims: P padded to 16, 32 or 64


_sm_counts: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)   # CUDA builds


def _raw_stream(device: torch.device) -> int:
    """The current stream's handle on ``device``, without building a
    Python ``Stream`` object where torch offers that."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(device).cuda_stream
    return _RAW_STREAM(torch.cuda.current_device() if device.index is None else device.index)


def paged_plan(sm_count: int, lanes: int, hkv: int, slots: int,
               max_cluster: int = MAX_CLUSTER) -> int:
    """Blocks per (lane, KV head) pair in paged decode, which split the
    pair's tokens and merge in one thread-block cluster: the largest power
    of two that keeps every pair's blocks within one block per SM, at most
    ``max_cluster`` and at most the table's slots (at least 1).  A pure
    function of the shape: the lengths stay on the card."""
    pairs, c = lanes * hkv, 1
    while 2 * c <= min(max_cluster, slots) and pairs * 2 * c <= sm_count:
        c *= 2
    return c


_paged_plans: dict[tuple, tuple[int, str]] = {}


def _paged_plan(device: torch.device, code: int, lanes: int, hkv: int, slots: int,
                page_size: int, d: int) -> tuple[int, str]:
    """(cluster size, design name) of a paged-decode launch, cached per shape;
    the cluster is capped by what the card fits (asked once per shape)."""
    key = (device.index, code, lanes, hkv, slots, page_size, d)
    got = _paged_plans.get(key)
    if got is None:
        fits = _entry("paged_decode_attention_max_cluster")[1](code, d, slots, page_size)
        c = paged_plan(_sm_count(device), lanes, hkv, slots, max(1, fits))
        got = _paged_plans[key] = (c, f"{'mma.sync' if code else 'CUDA cores'}, cluster of {c}")
    return got


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str, n: int) -> None:
    rec = getattr(_recorders, "counts", None)
    if rec is not None:
        rec[name] = rec.get(name, 0) + n
        return
    with _count_lock:
        LAUNCHES[name] += n


@contextlib.contextmanager
def captured_launches():
    """Inside the block, the launches this thread's wrappers make (into a
    CUDA graph being captured, where they run nothing) go into the yielded
    dict instead of ``LAUNCHES``; ``add_launches`` adds them once per
    replay.  Other threads count as before."""
    prev = getattr(_recorders, "counts", None)
    _recorders.counts = counts = {}
    try:
        yield counts
    finally:
        _recorders.counts = prev


def add_launches(counts: dict) -> None:
    """Add ``counts`` (a ``captured_launches`` dict) to ``LAUNCHES``: one
    replay of the graph they were captured into."""
    with _count_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


_entries: dict[str, tuple] = {}


def _entry(fn_name: str):
    """(library, bound C entry point), building the library at first use."""
    got = _entries.get(fn_name)
    if got is None:
        lib_name, argtypes = _SIGNATURES[fn_name]
        lib = build.library(lib_name)
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        got = _entries[fn_name] = (lib, fn)
    return got


def _check_cuda(name: str, *tensors: torch.Tensor, dense: bool = False,
                aligned: bool = True) -> int:
    """Validate the float operands of a kernel launch; returns the dtype
    code.  The operands must be contiguous (``dense``), or else have a
    contiguous last dim and (``aligned``) 16-byte aligned rows."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, "
                         f"got {t0.device}")
    if t0.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {t0.dtype} not supported "
                        "(float32 or bfloat16)")
    vec = 16 // t0.element_size()            # elements in a 16-byte load
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{name}: operands differ in device or dtype")
        if dense:
            if not t.is_contiguous():
                raise ValueError(f"{name}: operands must be contiguous")
        elif t.stride(-1) != 1 or aligned and (
                any(s % vec for s in t.stride()[:-1]) or t.data_ptr() % 16):
            raise ValueError(f"{name}: operands need a contiguous last dim, "
                             f"16-byte aligned rows (strides {t.stride()})")
    return _DTYPES[t0.dtype]


def _no_grad(name: str, *tensors) -> None:
    """Refuse inputs that would need a gradient through a kernel that has
    no backward."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it under "
                           "torch.no_grad() or on tensors that do not require grad "
                           "(training attends with impl='xla')")


def _aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_index(name: str, t: torch.Tensor, device, shape) -> None:
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: index tensor must be contiguous int32 of "
                         f"shape {tuple(shape)} on {device}")


def _launched(lib, name: str, err: int, kernels: int = 1) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {build.error_string(lib, err)}")
    _count(name, kernels)


def flash_path(dtype: torch.dtype, head_dim: int, sq: int, rep: int) -> str:
    """The design ``flash_attention`` launches on the card for ``dtype``,
    ``head_dim``, ``sq`` queries and ``rep`` query heads per KV head:
    float32 on the CUDA cores (the card-against-CPU check type), bf16 at
    head dims 32 and 48 on mma.sync, bf16 at 64 with at most
    ``FLASH_SPLIT_ROWS`` rows per KV head (Sq * rep: whisper's
    cross-attention and its decoder's prompt) on mma.sync with the keys split
    over a cluster (``flash_split_plan``), and bf16 at 64 above that and at
    128, 192 and 256 on wgmma + TMA: 192 query rows by 128 keys per tile at
    64 (three consumer warpgroups), 128 by 128 at 128, and 128 by 64 at 192
    and 256 (where O's registers leave room for no more)."""
    if head_dim not in FLASH_HEAD_DIMS or dtype not in _DTYPES:
        raise ValueError(f"flash_attention: no design for head_dim {head_dim} in {dtype} "
                         f"(head dims {FLASH_HEAD_DIMS}, float32 or bfloat16)")
    if dtype == torch.float32:
        return "CUDA cores"
    if head_dim < 64:
        return "mma.sync 64x64"
    if head_dim == 64:
        return ("mma.sync split-K 16x16" if sq * rep <= FLASH_SPLIT_ROWS
                else "wgmma+TMA 192x128")
    return "wgmma+TMA 128x128" if head_dim == 128 else "wgmma+TMA 128x64"


def flash_split_plan(sm_count: int, batch: int, hkv: int, sk: int) -> int:
    """Blocks per (batch, KV head) pair of the few-query flash design, which
    split the pair's keys and merge in one thread-block cluster: the
    smallest power of two that puts at least two blocks on every SM, at most
    ``FLASH_SPLIT_MAX_CLUSTER`` (the portable size, which every card fits)
    and at most one per 64 keys (each of a block's four warps then has a
    16-key tile); at least 1.  A pure function of the shape: with the
    device-offset form the split still covers the Sk rows the kernel finds
    visible, and a block that sees no key merges with weight 0."""
    pairs, tiles, c = batch * hkv, -(-sk // 16), 1
    while (2 * c <= FLASH_SPLIT_MAX_CLUSTER and pairs * c < 2 * sm_count
           and 2 * c * 4 <= tiles):
        c *= 2
    return c


def _on_device(q_offset, kv_len, device) -> bool:
    """Whether flash attention's ``q_offset`` / ``kv_len`` take the device
    form (either is a tensor); each tensor must be a 0-d integer tensor on
    ``device``."""
    tensors = [x for x in (q_offset, kv_len) if isinstance(x, torch.Tensor)]
    for x in tensors:
        if x.dim() != 0 or x.device != device or x.dtype.is_floating_point \
                or x.dtype.is_complex or x.dtype == torch.bool:
            raise ValueError(f"flash_attention: q_offset and kv_len must be ints or 0-d integer "
                             f"tensors on {device}, got {x.dtype} of shape {tuple(x.shape)} on "
                             f"{x.device}")
    return bool(tensors)


def _offset_pair(q_offset, kv_len, sk: int, device) -> torch.Tensor:
    """(q_offset, kv_len) as the int32 pair on the device that the kernel
    reads: the storage itself where the two are consecutive int32 elements
    of one tensor (``DecoderLM.extend_step`` passes the halves of one pair,
    so no launch builds it), else a pair built from them."""
    if isinstance(q_offset, torch.Tensor) and isinstance(kv_len, torch.Tensor) \
            and q_offset.dtype == kv_len.dtype == torch.int32 \
            and kv_len.data_ptr() == q_offset.data_ptr() + 4:
        return q_offset
    return torch.stack([torch.as_tensor(x, device=device).reshape(()).long()
                        for x in (q_offset, sk if kv_len is None else kv_len)]).to(torch.int32)


def flash_attention(
    q: torch.Tensor,              # (B, H, Sq, D)
    k: torch.Tensor,              # (B, Hkv, Sk, D)
    v: torch.Tensor,              # (B, Hkv, Sk, D)
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int | torch.Tensor = 0,
    kv_len: int | torch.Tensor | None = None,
) -> torch.Tensor:
    """Blocked GQA attention; masks keys at or past ``kv_len``, and (as
    asked) keys after each query (causal, query positions shifted by
    ``q_offset``) or ``window`` or more positions behind it.

    ``q_offset`` and ``kv_len`` are ints, or 0-d integer tensors on the
    operands' device: the card then reads them there at the kernel's entry
    (nothing is read back, so a CUDA graph replays the call at any offset),
    and k and v are read over all Sk rows, so their rows past ``kv_len`` must
    hold finite values (they are weighted by exactly 0).  Both forms give
    the same bits."""
    _no_grad("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if h % hkv:
        raise ValueError(f"flash_attention: {h} heads over {hkv} KV heads")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    scale = float(scale) if scale is not None else float(d) ** -0.5
    on_device = _on_device(q_offset, kv_len, q.device)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset, kv_len=kv_len)
    code = _check_cuda("flash_attention", q, k, v)
    if d not in FLASH_HEAD_DIMS or v.shape != k.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    path = flash_path(q.dtype, d, sq, h // hkv)
    cluster = flash_split_plan(_sm_count(q.device), b, hkv, sk) \
        if FLASH_PATHS[path] == 3 else 1
    pair = None
    if on_device:
        pair = _offset_pair(q_offset, kv_len, sk, q.device)
        q_offset, kv_len = 0, sk
    # repro-lint: skip[graph-tensor-cast] ints here: a tensor pair was swapped for (0, sk) above
    q_off, kv = int(q_offset), sk if kv_len is None else max(0, int(kv_len))
    # (B, Sq, H, D) storage: the model's next step merges heads for free
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib, fn = _entry("flash_attention_launch")
    err = fn(code, FLASH_PATHS[path], cluster, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), b, h, h // hkv, sq, sk, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], *out.stride()[:3], int(causal),
             0 if window is None else int(window), q_off, kv, scale,
             None if pair is None else pair.data_ptr(), _raw_stream(q.device))
    _launched(lib, "flash_attention", err)
    PATHS["flash_attention"] = (f"{path}, cluster of {cluster}" if FLASH_PATHS[path] == 3
                                else path)
    return out


def paged_attention(
    q: torch.Tensor,              # (B, H, D) one decode token per lane
    k_pool: torch.Tensor,         # (n_pages, PS, Hkv, D): the serving cache's
    v_pool: torch.Tensor,         #   pool layout, read where it lies
    block_table: torch.Tensor,    # (B, P) int32, -1 = unallocated
    lengths: torch.Tensor,        # (B,) int32 valid tokens per lane
    scale: float | None = None,
) -> torch.Tensor:
    """Fused paged decode-attention read (GQA grouped, online softmax).
    Table entries other than -1 must name pages of the pools; the card path
    does not check them (that would read the table back to the host)."""
    _no_grad("paged_attention", q, k_pool, v_pool)
    b, h, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    if h % hkv:
        raise ValueError(f"paged_attention: {h} heads over {hkv} KV heads")
    rep = h // hkv
    scale = float(scale) if scale is not None else float(d) ** -0.5
    if q.device.type == "cpu":
        out = ref.paged_decode_attention(
            q.reshape(b, hkv, rep, d), k_pool.permute(2, 0, 1, 3),
            v_pool.permute(2, 0, 1, 3), block_table, lengths, scale)
        return out.reshape(b, h, d)
    code = _check_cuda("paged_attention", q, k_pool, v_pool)
    if not q.is_contiguous() or d not in HEAD_DIMS or rep > MAX_REP \
            or v_pool.shape != k_pool.shape or v_pool.stride() != k_pool.stride() \
            or k_pool.shape[3] != d:
        raise ValueError(f"paged_attention: unsupported shapes q {tuple(q.shape)}"
                         f" pools {tuple(k_pool.shape)}")
    p = block_table.shape[1]
    if p < 1:
        raise ValueError("paged_attention: the block table has no page slots")
    _check_index("paged_attention", block_table, q.device, (b, p))
    _check_index("paged_attention", lengths, q.device, (b,))
    cluster, path = _paged_plan(q.device, code, b, hkv, p, ps, d)
    out = torch.empty_like(q)
    lib, fn = _entry("paged_decode_attention_launch")
    err = fn(code, d, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, hkv, rep, ps, p,
             cluster, *k_pool.stride()[:3], scale, _raw_stream(q.device))
    _launched(lib, "paged_decode_attention", err)
    PATHS["paged_decode_attention"] = path
    return out


def stream_mac_conv(
    x: torch.Tensor,              # (N, H, W, Ci)
    w: torch.Tensor,              # (KH, KW, Ci, Co)
    stride: tuple[int, int] = (1, 1),
    padding: tuple[int, int] = (0, 0),
    bias: torch.Tensor | None = None,   # (Co,) in x's type
    relu: bool = False,
) -> torch.Tensor:
    """NHWC x HWIO strided convolution with symmetric zero padding (the
    paper's CONV layer); float accumulation, output in x's type.  With
    ``bias`` and ``relu`` the epilogue adds the bias and applies ReLU, each
    rounded as ``conv(...).add_(bias).relu_()`` rounds them, so the fused
    call is bit-equal to the unfused sequence.  The card path loads 16 bytes
    at a time, so a Ci that is not a multiple of 8 is zero-padded to one on
    x and w (VGG16's conv1 has Ci = 3), and w's Co to a multiple of 8; the
    output keeps Co."""
    _no_grad("stream_mac_conv", x, w, bias)
    n, h, wd, ci = x.shape
    kh, kw, wci, co = w.shape
    sy, sx = stride
    py, px = padding
    if wci != ci or min(sy, sx) < 1 or min(py, px) < 0 or h + 2 * py < kh \
            or wd + 2 * px < kw:
        raise ValueError(f"stream_mac_conv: bad shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} stride {stride} padding {padding}")
    if bias is not None and tuple(bias.shape) != (co,):
        raise ValueError(f"stream_mac_conv: bias of shape {tuple(bias.shape)} for Co={co}")
    if x.device.type == "cpu":
        return ref.stream_mac_conv(x, w, stride=stride, padding=padding, bias=bias,
                                   relu=relu)
    code = _check_cuda("stream_mac_conv", x, w, *(() if bias is None else (bias,)),
                       dense=True)
    pad_ci, pad_co = -ci % 8, -co % 8
    if pad_ci:
        x = F.pad(x, (0, pad_ci))
        w = F.pad(w, (0, 0, 0, pad_ci))
    if pad_co:
        w = F.pad(w, (0, pad_co))
    if not _aligned16(x, w):
        raise ValueError("stream_mac_conv: operands must be 16-byte aligned")
    yo = (h + 2 * py - kh) // sy + 1
    wo = (wd + 2 * px - kw) // sx + 1
    out = torch.empty((n, yo, wo, co), dtype=x.dtype, device=x.device)
    lib, fn = _entry("stream_mac_conv_launch")
    path = ctypes.c_int(-1)
    err = fn(code, x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
             out.data_ptr(), n, h, wd, ci + pad_ci, kh, kw, co, co + pad_co, sy, sx, py, px,
             int(relu), _sm_count(x.device), ctypes.byref(path), _raw_stream(x.device))
    _launched(lib, "stream_mac_conv", err)
    PATHS["stream_mac_conv"] = CONV_PATHS[path.value]
    return out


def stream_maxpool(
    x: torch.Tensor,              # (N, H, W, C)
    window: tuple[int, int],
    stride: tuple[int, int],
) -> torch.Tensor:
    """VALID NHWC max-pooling, exact (the result is bit-equal to the plain
    version's)."""
    _no_grad("stream_maxpool", x)
    n, h, wd, c = x.shape
    kh, kw = window
    sy, sx = stride
    if min(kh, kw, sy, sx) < 1 or h < kh or wd < kw:
        raise ValueError(f"stream_maxpool: bad window {window} stride {stride} for "
                         f"x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.stream_maxpool(x, window, stride)
    code = _check_cuda("stream_maxpool", x, dense=True)
    vec = c % (16 // x.element_size()) == 0 and _aligned16(x)
    out = torch.empty((n, (h - kh) // sy + 1, (wd - kw) // sx + 1, c), dtype=x.dtype,
                      device=x.device)
    lib, fn = _entry("stream_maxpool_launch")
    err = fn(code, int(vec), x.data_ptr(), out.data_ptr(), n, h, wd, c, kh, kw, sy, sx,
             _raw_stream(x.device))
    _launched(lib, "stream_maxpool", err)
    return out


_counters: dict[tuple, torch.Tensor] = {}
_plans: dict[tuple, tuple[int, int, str]] = {}  # (splits, tiles, design) of a matmul shape


def _split_counters(device: torch.device, stream: int, tiles: int) -> torch.Tensor:
    """One zeroed int per output tile for split-K calls on ``stream`` (a
    raw handle).  The kernel's last block of each tile sets its counter back
    to zero, so the buffer is zeroed once, when it is made or grown, and not
    per call."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (idx, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < tiles:
        buf = _counters[key] = torch.zeros(max(tiles, 256), dtype=torch.int32,
                                           device=device)
    return buf


def tiled_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with float accumulation, output in x's type.  On the
    card a bf16 product with M <= 16 streams the weight by TMA, others run
    64 x 128 tiles; K may be split over blocks (one launch all the same: the
    last block of each output tile sums the partials in a fixed order, so
    two calls give the same bits)."""
    _no_grad("tiled_matmul", x, y)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"tiled_matmul: shapes {tuple(x.shape)} @ {tuple(y.shape)}")
    m, k = x.shape
    n = y.shape[1]
    if x.device.type == "cpu":
        return ref.tiled_matmul(x, y)
    code = _check_cuda("tiled_matmul", x, y, dense=True)
    vec = 16 // x.element_size()
    aligned = int(k % vec == 0 and n % vec == 0 and _aligned16(x, y))
    key = (code, aligned, m, n, k, _sm_count(x.device))
    if key not in _plans:
        tiles = ctypes.c_int()
        splits = _entry("tiled_matmul_plan")[1](*key, ctypes.byref(tiles))
        design = MATMUL_PATHS[_entry("tiled_matmul_path")[1](code, aligned, m)]
        _plans[key] = splits, tiles.value, design
    splits, tiles, PATHS["tiled_matmul"] = _plans[key]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = _raw_stream(x.device)
    ws = counters = None
    if splits > 1:
        ws = torch.empty(splits * m * n, dtype=torch.float32, device=x.device)
        counters = _split_counters(x.device, stream, tiles)
    lib, fn = _entry("tiled_matmul_launch")
    err = fn(code, aligned, x.data_ptr(), y.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(),
             None if counters is None else counters.data_ptr(), m, n, k, splits, stream)
    _launched(lib, "tiled_matmul", err)
    return out


def _check_f32(name: str, device, **tensors) -> None:
    for arg, t in tensors.items():
        if t is not None and (t.device != device or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be contiguous float32 on {device}")


class SsdPlan(NamedTuple):
    cluster: int    # blocks per (batch row, head), one thread-block cluster
    rows: int       # rows of a chunk per block, in rows / 16 tiles of 16 (at most 4)
    blocks: int     # blocks of the launch: batch x heads x cluster
    strips: int     # strips of the P x N state, at most one per warp of a cluster
    warps: int      # warps per block


def ssd_plan(sm_count: int, batch: int, heads: int, p: int, n: int, q: int,
             bf16: bool = True) -> SsdPlan:
    """The launch plan of ``ssd_scan`` for a chunk of ``q`` tokens, a pure
    function of the shape and type.  A cluster of ``cluster`` blocks serves
    one (batch row, head): block r takes the 16-row tiles r, r + cluster,
    r + 2 cluster, ... of every chunk, ``rows / 16`` of them (their C.B^T
    and y), and each of its warps (8 in bf16, 4 in float32) one strip of
    the state (16 rows of P by 16 columns of N in bf16, 32 in float32), so
    the cluster needs ``cluster * rows >= q`` and ``warps * cluster >=
    strips``.  The smallest power of two that holds both is doubled while
    the grid stays within one block per SM, the cluster at 4 and every
    block with at least 16 rows."""
    if p > SSD_MAX_P or q > SSD_MAX_CHUNK or p < 1 or n < 1 or q < 1:
        raise ValueError(f"ssd_scan: no design for P={p} (at most {SSD_MAX_P}) and a "
                         f"{q}-token chunk (at most {SSD_MAX_CHUNK})")
    warps, strip_tiles = (8, 2) if bf16 else (4, 4)
    strips = -(-p // 16) * -(-(-(-n // 16) * 2) // strip_tiles)
    need, c = max(-(-q // 64), -(-strips // warps)), 1
    while c < need:
        c *= 2
    if c > 8:
        raise ValueError(f"ssd_scan: no design for P={p}, N={n} ({strips} state strips "
                         f"over at most 8 blocks of {warps} warps)")
    while 2 * c <= 4 and batch * heads * 2 * c <= sm_count and q >= 32 * c:
        c *= 2
    rows = -(-(-(-q // c)) // 16) * 16
    return SsdPlan(c, rows, batch * heads * c, strips, warps)


_ssd_plans: dict[tuple, tuple[SsdPlan, str]] = {}


def _ssd_plan(device: torch.device, code: int, b: int, s: int, h: int, p: int, n: int,
              q: int) -> tuple[SsdPlan, str]:
    """(plan, design name) of an ``ssd_scan`` launch, cached per shape."""
    key = (device.index, code, b, s, h, p, n, q)
    got = _ssd_plans.get(key)
    if got is None:
        plan = ssd_plan(_sm_count(device), b, h, p, n, q, bf16=code == 1)
        design = "mma.sync bf16 split x3" if code else "CUDA cores"
        got = _ssd_plans[key] = (plan, f"{design}, cluster of {plan.cluster}, "
                                       f"{q}-token chunks")
    return got


def ssd_scan(
    xh: torch.Tensor,             # (B, S, H, P)
    b: torch.Tensor,              # (B, S, N)
    c: torch.Tensor,              # (B, S, N)
    dt: torch.Tensor,             # (B, S, H) float32, post-softplus
    a: torch.Tensor,              # (H,) float32, negative
    chunk: int,
    init_state: torch.Tensor | None = None,   # (B, H, P, N) float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD sequence mix over chunks of ``min(chunk, S)`` tokens →
    (y (B, S, H, P) float32, final state (B, H, P, N) float32); no D-skip.
    S must be a multiple of the chunk, as in ``ssd_chunked``.  The card
    path takes xh, b and c as strided views (contiguous last dims, as the
    model slices them out of one projection) in float32 or bfloat16, N a
    multiple of 4, P at most 64 and a chunk of at most 512 tokens; it is
    one launch (``ssd_plan``)."""
    _no_grad("ssd_scan", xh, b, c, dt, a, init_state)
    bsz, sl, h, p = xh.shape
    n = b.shape[-1]
    q = min(int(chunk), sl)
    if b.shape != (bsz, sl, n) or c.shape != b.shape or dt.shape != (bsz, sl, h) \
            or a.shape != (h,) or (init_state is not None
                                   and init_state.shape != (bsz, h, p, n)):
        raise ValueError(f"ssd_scan: shapes xh {tuple(xh.shape)} b {tuple(b.shape)} "
                         f"c {tuple(c.shape)} dt {tuple(dt.shape)} a {tuple(a.shape)}")
    if q < 1 or sl % q:
        raise ValueError(f"ssd_scan: sequence length {sl} is not a multiple of "
                         f"the chunk {q}")
    if xh.device.type == "cpu":
        return ref.ssd_scan(xh, b, c, dt, a, q, init_state)
    code = _check_cuda("ssd_scan", xh, b, c, aligned=False)
    _check_f32("ssd_scan", xh.device, dt=dt, a=a, init_state=init_state)
    if xh.stride(2) != p or n % 4:
        raise ValueError(f"ssd_scan: xh needs contiguous (H, P) rows (strides "
                         f"{xh.stride()}) and N a multiple of 4 (N={n})")
    plan, path = _ssd_plan(xh.device, code, bsz, sl, h, p, n, q)
    y = torch.empty((bsz, sl, h, p), dtype=torch.float32, device=xh.device)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=xh.device)
    lib, fn = _entry("ssd_scan_launch")
    err = fn(code, xh.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(), a.data_ptr(),
             None if init_state is None else init_state.data_ptr(), y.data_ptr(),
             final.data_ptr(), bsz, sl, h, p, n, q, plan.cluster, plan.rows,
             *xh.stride()[:2], *b.stride()[:2], *c.stride()[:2], _raw_stream(xh.device))
    _launched(lib, "ssd_scan", err)
    PATHS["ssd_scan"] = path
    return y, final


def paged_gather(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Block-table gather of a page pool: pool (..., n_pages, F) of any type
    and table (B, P) int32 → (..., B, P, F), with ``-1`` entries read as
    zeros; a bit-exact copy.  The leading dims (the layers) stay in front,
    so one launch gathers every layer of a cache leaf.  The one-pool case
    of ``paged_gather_many``."""
    return paged_gather_many([pool], block_table)[0]


def paged_gather_many(pools, block_table: torch.Tensor) -> list[torch.Tensor]:
    """``paged_gather`` of every pool in ``pools`` through one table, in
    one launch on the card (more only when the list outgrows one launch's
    pool table, ``paged_gather_capacity``).  Each pool is (..., n_pages, F)
    of its own type, row width and leading dims.  On the card the pools
    must be contiguous and the table's entries other than -1 must name
    pages of every pool (not checked: that would read the table back to
    the host).  The card path checks the table once and packs the launch's
    arguments into one array, so its host work per call stays small."""
    _no_grad("paged_gather", *pools)
    if not pools or pools[0].device.type != "cuda":
        if block_table.ndim != 2 or any(p.ndim < 2 or p.shape[-2] < 1 for p in pools):
            raise ValueError(f"paged_gather: pools {[tuple(p.shape) for p in pools]} and "
                             f"table {tuple(block_table.shape)}")
        if any(p.device.type != "cpu" for p in pools):
            raise ValueError(f"paged_gather: tensors must be on the CPU or a CUDA device, "
                             f"all on one, got {sorted({str(p.device) for p in pools})}")
        return ref.paged_gather_many(pools, block_table)
    device = pools[0].device
    if block_table.ndim != 2:
        raise ValueError(f"paged_gather: the table must be (lanes, slots), got "
                         f"{tuple(block_table.shape)}")
    _check_index("paged_gather", block_table, device, block_table.shape)
    lanes, slots = block_table.shape
    # bt, lanes, slots, SMs, stream, the launch count (written back), then
    # per pool: pool, out, layers, n_pages, row bytes
    args = array("q", (block_table.data_ptr(), lanes, slots, _sm_count(device),
                       _raw_stream(device), 0))
    outs = []
    for pool in pools:
        shape = pool.shape
        if len(shape) < 2 or shape[-2] < 1 or pool.device != device \
                or not pool.is_contiguous():
            raise ValueError(f"paged_gather: every pool must be a contiguous (..., n_pages, "
                             f"F) tensor on {device}, got {tuple(shape)} on {pool.device}")
        out = torch.empty(shape[:-2] + (lanes, slots, shape[-1]), dtype=pool.dtype,
                          device=device)
        args.extend((pool.data_ptr(), out.data_ptr(), math.prod(shape[:-2]), shape[-2],
                     shape[-1] * pool.element_size()))
        outs.append(out)
    lib, fn = _entry("paged_gather_launch")
    err = fn(len(outs), args.buffer_info()[0])
    _launched(lib, "paged_gather", err, args[5])
    return outs


def paged_gather_capacity() -> int:
    """Pools one ``paged_gather_many`` launch takes (builds the kernel)."""
    return _entry("paged_gather_capacity")[1]()


def paged_gather_table_cache() -> int:
    """Table entries a ``paged_gather`` block keeps in shared memory: a
    longer table is read from device memory (builds the kernel)."""
    return _entry("paged_gather_table_cache")[1]()


def paged_gather_smem(table_entries: int) -> int:
    """Dynamic shared memory in bytes of a ``paged_gather`` block that
    copies rows in bulk, for a table of ``table_entries`` entries (builds
    the kernel)."""
    return _entry("paged_gather_smem")[1](table_entries)


def paged_write(pools, rows, block_table: torch.Tensor, positions: torch.Tensor,
                active: torch.Tensor) -> None:
    """Drop-mode scatter of one decode step's new cache rows into page
    pools, in place, every pool in one launch on the card (at most
    ``PAGED_WRITE_POOLS``: a longer list is refused on either device).
    Each pool is (L, n_pages, PS, *t) with its rows (L, B, *t) of its type
    (PS shared); the table is (B, P) int32, ``positions`` (B,) int64 and
    ``active`` (B,) bool.  Lane b writes ``pool[:, page, positions[b] %
    PS] = row[:, b]`` where ``active[b]`` and ``page = table[b, positions[b]
    // PS]`` names a page of the pool; nothing else is written (the JAX
    package's ``.at[page, off].set(..., mode="drop")``).  The card path
    reads nothing back, so a CUDA graph can hold it."""
    _no_grad("paged_write", *pools, *rows)
    if len(pools) != len(rows) or len(pools) > PAGED_WRITE_POOLS or block_table.ndim != 2:
        raise ValueError(f"paged_write: {len(pools)} pools (at most {PAGED_WRITE_POOLS}), "
                         f"{len(rows)} row sets, table {tuple(block_table.shape)}")
    lanes, slots = block_table.shape
    ps = pools[0].shape[2] if pools else 1
    for pool, row in zip(pools, rows):
        if pool.ndim < 3 or pool.shape[2] != ps or row.dtype != pool.dtype or \
                tuple(row.shape) != (pool.shape[0], lanes) + tuple(pool.shape[3:]):
            raise ValueError(f"paged_write: pool {tuple(pool.shape)} {pool.dtype} and rows "
                             f"{tuple(row.shape)} {row.dtype} for {lanes} lanes")
    if tuple(positions.shape) != (lanes,) or tuple(active.shape) != (lanes,) \
            or active.dtype != torch.bool:
        raise ValueError(f"paged_write: positions {tuple(positions.shape)} and active "
                         f"{tuple(active.shape)} {active.dtype} for {lanes} lanes")
    if not pools:
        return
    device = pools[0].device
    if device.type != "cuda":
        tensors = (*pools, *rows, block_table, positions, active)
        if any(t.device.type != "cpu" for t in tensors):
            raise ValueError(f"paged_write: tensors must be on the CPU or a CUDA device, all "
                             f"on one, got {sorted({str(t.device) for t in tensors})}")
        ref.paged_write(pools, rows, block_table, positions, active)
        return
    _check_index("paged_write", block_table, device, (lanes, slots))
    if positions.device != device or positions.dtype != torch.int64 \
            or not positions.is_contiguous() or active.device != device \
            or not active.is_contiguous():
        raise ValueError(f"paged_write: positions must be contiguous int64 and active "
                         f"contiguous bool on {device}")
    # table, positions, active, lanes, slots, PS, stream, then per pool:
    # pool, rows, layers, n_pages, row bytes
    args = array("q", (block_table.data_ptr(), positions.data_ptr(), active.data_ptr(),
                       lanes, slots, ps, _raw_stream(device)))
    for pool, row in zip(pools, rows):
        if pool.device != device or row.device != device or not pool.is_contiguous() \
                or not row.is_contiguous():
            raise ValueError(f"paged_write: pools and rows must be contiguous on {device}")
        args.extend((pool.data_ptr(), row.data_ptr(), pool.shape[0], pool.shape[1],
                     math.prod(pool.shape[3:]) * pool.element_size()))
    lib, fn = _entry("paged_write_launch")
    _launched(lib, "paged_write", fn(len(pools), args.buffer_info()[0]))


MAX_STREAMS = 8                    # streams of a one-stage stream_gd launch
MAX_STAGE_STREAMS = 4              # streams of each stage of a two-stage launch
STAGE1 = ref.STAGE1                # a stage-2 stream: stage 1's output of its leaf


def coeffs_f32(coeffs) -> list[float]:
    """The coefficients (numbers) as Python floats rounded to float32 (what
    the kernel gets, and what JAX makes of weak-typed scalars)."""
    return [ctypes.c_float(float(c)).value for c in coeffs]


class _GdLeaf(NamedTuple):
    """One checked leaf of ``stream_gd_foreach``, packed for the kernel."""
    stages: list          # (out, [streams]) per stage
    device: torch.device
    marks: list           # where stage 2's streams name STAGE1
    spans: dict           # id -> (pointer, bytes, type code) of each distinct tensor
    row: list             # stream pointers (0 at STAGE1), then the two outputs'
    types: int            # bit k: stream k is bf16; bits 16, 17: the outputs
    numel: int


def _gd_leaf(leaf, coeffs, limit: int, grad: bool) -> _GdLeaf:
    """Checks one leaf of ``stream_gd_foreach`` and packs it."""
    stages = [(out, list(streams)) for out, streams in leaf]
    if len(stages) != len(coeffs):
        raise ValueError(f"stream_gd: every leaf has one (out, streams) pair per stage "
                         f"({len(coeffs)}), got {len(stages)}")
    for (_, streams), c in zip(stages, coeffs):
        if not 1 <= len(streams) <= limit or len(c) != len(streams):
            raise ValueError(f"stream_gd: 1 to {limit} streams with one coefficient each, "
                             f"got {len(streams)} streams and {len(c)} coefficients")
    ins = [t for _, streams in stages for t in streams]
    outs = [out for out, _ in stages]
    marks = [t is STAGE1 for t in stages[1][1]] if len(stages) == 2 else []
    n_marks = marks.count(True)
    if n_marks > 1 or [t is STAGE1 for t in ins + outs].count(True) != n_marks:
        raise ValueError("stream_gd: only stage 2 may read stage 1's output (STAGE1), "
                         "and once")
    spans = {}
    shape = device = None
    for t in outs + ins:
        if t is STAGE1 or id(t) in spans:
            continue
        if shape is None and isinstance(t, torch.Tensor):
            shape, device = t.shape, t.device
        if not isinstance(t, torch.Tensor) or t.shape != shape or t.device != device \
                or t.dtype not in _DTYPES or not t.is_contiguous():
            got = [(tuple(u.shape), u.dtype, str(u.device), u.is_contiguous())
                   if isinstance(u, torch.Tensor) else type(u).__name__
                   for u in outs + ins if u is not STAGE1]
            raise ValueError("stream_gd: streams and output must be contiguous float32 or "
                             f"bfloat16 tensors of one shape on one device, got {got}")
        if grad and t.requires_grad:
            _no_grad("stream_gd", t)
        spans[id(t)] = (t.data_ptr(), t.nbytes, _DTYPES[t.dtype])
    row = [0 if t is STAGE1 else spans[id(t)][0] for t in ins]
    row += [spans[id(out)][0] for out in outs] + [0] * (2 - len(outs))
    bits = 0
    for i, t in enumerate(ins):
        if t is not STAGE1:
            bits |= spans[id(t)][2] << i
    for k, out in enumerate(outs):
        bits |= spans[id(out)][2] << (16 + k)
    return _GdLeaf(stages, device, marks, spans, row, bits, outs[0].numel())


def _check_gd_aliases(stages, spans) -> None:
    """An output may be one of its own stage's streams, or stage 2's one of
    stage 1's, and overlaps nothing else.  Stage 2 reads stage 1's output
    only as ``STAGE1``: one pass reads every input before it writes, so it
    would see the old values."""
    for out, _ in stages:
        p, n, dt = spans[id(out)]
        for q, m, du in spans.values():
            if p < q + m and q < p + n and (p != q or dt != du):
                raise ValueError("stream_gd: an output partly overlaps another tensor of "
                                 "its leaf")
    if len(stages) == 2:
        p, n, _ = spans[id(stages[0][0])]
        for t in stages[1][1]:
            if t is not STAGE1:
                q, m, _ = spans[id(t)]
                if p < q + m and q < p + n:
                    raise ValueError("stream_gd: stage 2 reads stage 1's output only as "
                                     "ops.STAGE1 (one pass would read the old values)")


def stream_gd_foreach(leaves, stage_coeffs) -> None:
    """Eq. 1 over a list of leaves in one launch (more when the list
    outgrows one launch's leaf table, ``stream_gd_capacity``).  Each leaf is
    one or two ``(out, streams)`` stages; ``stage_coeffs`` holds one
    coefficient list per stage, shared by every leaf.  A stage computes
    ``out = sum_j coeffs[j] * streams[j]`` over equally shaped contiguous
    tensors, each float32 or bfloat16 on its own, summed in float32 in
    stream order and rounded once to ``out``'s type (1 to 8 streams with
    one stage, 1 to 4 per stage with two).  Stage 2 may name stage 1's
    output as a stream through ``STAGE1`` (at the same place in every
    leaf), and reads it as stored.  Outputs may be streams of their own
    stage (the optimizers update in place), stage 2's one of stage 1's.
    All leaves lie on one device; different leaves must not share memory
    (not checked).  Two stages give the bits of two one-stage calls per
    leaf, stage 1's first."""
    coeffs = [coeffs_f32(c) for c in stage_coeffs]
    if not 1 <= len(coeffs) <= 2:
        raise ValueError(f"stream_gd: 1 or 2 stages, got {len(coeffs)}")
    limit = MAX_STREAMS if len(coeffs) == 1 else MAX_STAGE_STREAMS
    grad = torch.is_grad_enabled()
    checked = [_gd_leaf(leaf, coeffs, limit, grad) for leaf in leaves]
    if not checked:
        return
    device, marks = checked[0].device, checked[0].marks
    for c in checked:
        if c.device != device:
            raise ValueError(f"stream_gd: every leaf must lie on one device, got "
                             f"{device} and {c.device}")
        if c.marks != marks:
            raise ValueError("stream_gd: STAGE1 must stand at the same place in every leaf")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"stream_gd: tensors must be on the CPU or a CUDA device, "
                         f"got {device}")
    for c in checked:
        _check_gd_aliases(c.stages, c.spans)
    if device.type == "cpu":
        ref.stream_gd_foreach([c.stages for c in checked], coeffs)
        return
    marker = marks.index(True) if True in marks else -1
    _count("stream_gd", _gd_launch(checked, coeffs, marker, _raw_stream(device)))


def _gd_launch(checked: list[_GdLeaf], coeffs, marker: int, stream: int) -> int:
    """Launches the kernel over packed leaves; returns the number of grids
    launched."""
    j1 = len(coeffs[0])
    j2 = len(coeffs[1]) if len(coeffs) == 2 else 0
    ptrs = array("Q", [p for c in checked for p in c.row])
    types = array("I", [c.types for c in checked])
    numel = array("q", [c.numel for c in checked])
    launches = ctypes.c_int()
    lib, fn = _entry("stream_gd_launch")
    err = fn(j1, j2, marker,
             (_F * (j1 + j2))(*coeffs[0], *coeffs[-1][:j2]), len(checked),
             ptrs.buffer_info()[0], types.buffer_info()[0], numel.buffer_info()[0], stream,
             ctypes.byref(launches))
    if err != 0:
        raise RuntimeError(f"stream_gd launch failed: {build.error_string(lib, err)}")
    return launches.value


def stream_gd_capacity(stage_streams) -> int:
    """Leaves one ``stream_gd_foreach`` launch takes, for stages of the
    given numbers of streams (builds the kernel)."""
    j1, j2 = (list(stage_streams) + [0])[:2]
    return _entry("stream_gd_capacity")[1](j1, j2)


def stream_gd_into(out: torch.Tensor, streams, coeffs) -> torch.Tensor:
    """Eq. 1 into ``out``: ``out = sum_j coeffs[j] * streams[j]`` over
    equally shaped contiguous tensors, each float32 or bfloat16 on its own,
    summed in float32 in stream order and rounded once to ``out``'s type.
    ``out`` may be one of the streams.  A one-leaf, one-stage
    ``stream_gd_foreach``; returns ``out``.  ``coeffs`` may be a tensor (the
    JAX wrapper's form), read back here: the optimizers, whose updates a
    CUDA graph captures, pass numbers to ``stream_gd_foreach``."""
    if isinstance(coeffs, torch.Tensor):
        coeffs = coeffs.detach().float().cpu().tolist()
    stream_gd_foreach([((out, streams),)], [coeffs])
    return out


def stream_gd(derivs: torch.Tensor, coeffs) -> torch.Tensor:
    """Eq. 1 over arbitrary-shaped weights: derivs (J, *shape) of one type
    and J coefficients → (*shape) in derivs' type (the JAX wrapper's
    layout)."""
    if derivs.ndim < 1:
        raise ValueError("stream_gd: derivs must have a leading streams dim")
    derivs = derivs.contiguous()
    out = torch.empty(derivs.shape[1:], dtype=derivs.dtype, device=derivs.device)
    return stream_gd_into(out, derivs.unbind(0), coeffs)
