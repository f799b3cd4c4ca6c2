"""Card-only tests of the port: each CUDA kernel against its plain version,
the served tokens (dense, mamba2, the recurrentgemma hybrid and the moe
family, paged and gather decode paths), the host tier (the swap-out read in
one ``paged_gather`` launch, a swap round trip, a restore staged on another
thread), the ConvNet logits and the reduced qwen2.5-3b train step on the
card against the CPU; a traced engine's tokens against an untraced one's,
the sampler's draws on its generator's device, and a sanitized reduced run;
``flash_attention`` at whisper-large-v3's non-causal encoder and
cross-attention shapes and at llava-next-mistral-7b's image prefill, each
bf16 head-dim-64 design's masks, offsets and strides, and
the reduced ``VLM`` and ``EncDecLM`` (prefill and greedy decode) on the
card against the CPU.

Marked ``cuda``; they skip (from a fixture, so every pytest worker collects
the same tests) when no card is present.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX.
"""
import ctypes
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda

# float32 on both sides; the kernel sums in another order than the plain version
F32 = dict(atol=1e-4, rtol=1e-4)
# bfloat16: both round the output to bf16 (one ulp near 1 is 2^-8)
BF16 = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(scope="session")
def _kernels_built():
    """Every kernel library built, and the profiler's tracer started once,
    before the first test: no profiled call waits on nvcc or on the
    tracer's start."""
    from repro_torch.kernels import build

    build.build()
    _profile(lambda: torch.ones(1, device="cuda").add_(1))


@pytest.fixture
def card(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    request.getfixturevalue("_kernels_built")
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain versions in float32
    return torch.device("cuda")


def _flash_design(dtype: str, d: int, sq: int, rep: int) -> tuple[str, str]:
    """(compiled kernel, ``ops.PATHS`` entry up to its cluster size) that a
    flash call of ``sq`` queries and ``rep`` query heads per KV head must
    take: float32 on the CUDA cores; bf16 on mma.sync at D 32 and 48; at
    D 64 with at most 16 rows per KV head on mma.sync with the keys split
    over a cluster, else on wgmma + TMA (192 rows by 128 keys a tile); at
    the served head dims on wgmma + TMA (128 keys a tile at D 128, 64
    above)."""
    if dtype == "float32":
        return f"flash_attn_fwd<float, {d}>", "CUDA cores"
    if d < 64:
        return f"flash_attn_mma<{d}>", "mma.sync 64x64"
    if d == 64 and sq * rep <= ops.FLASH_SPLIT_ROWS:
        return "flash_split_mma<64>", "mma.sync split-K 16x16"
    if d == 64:
        return "flash_attn_wgmma<64>", "wgmma+TMA 192x128"
    return f"flash_attn_wgmma<{d}>", f"wgmma+TMA 128x{128 if d == 128 else 64}"


def _design_of_last_call() -> str:
    """``ops.PATHS["flash_attention"]`` without the split design's cluster size."""
    return ops.PATHS["flash_attention"].split(",")[0]


def _profile(fn, counted=None):
    """``fn()`` under the profiler: its result, the (name, launches) of each
    device kernel it ran, and the launches ``ops.LAUNCHES[counted]`` counted
    in that call.  A profile that holds no device kernel at all (the tracer
    now and then drops a profile's kernel records) is taken again, with
    ``fn`` called again, up to three times."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        before = ops.LAUNCHES[counted] if counted else 0
        with torch.profiler.profile(activities=acts) as prof:
            out = fn()
            torch.cuda.synchronize()
        got = [(e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0],
                e.count) for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if got:
            break
    return out, got, (ops.LAUNCHES[counted] - before if counted else None)


def _profiled(fn, counted=None):
    """``fn()``, the names of the device kernels it launched and the
    launches ``ops.LAUNCHES[counted]`` counted in it (``_profile``)."""
    out, got, launched = _profile(fn, counted)
    return out, {name for name, _ in got}, launched


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h,hkv,sq,sk,q_offset,kv_len,window", [
    (128, 16, 2, 77, 77, 0, None, None),
    (32, 4, 2, 16, 64, 20, 36, None),
    (64, 8, 8, 100, 100, 0, None, 16),
    # recurrentgemma: 16 query heads over 1 KV head, head_dim 256, a window
    (256, 16, 1, 200, 200, 0, None, 64),
    (256, 16, 1, 64, 256, 128, 192, 64),
    # MLA's prefill: H = Hkv, head_dim 48 (reduced deepseek) and 192 (published)
    (48, 4, 4, 40, 40, 0, None, None),
    (192, 8, 8, 100, 100, 0, None, None),
    (192, 8, 8, 64, 256, 128, 192, None),
    # the wgmma design's served shapes at small length: D 128 at rep 16
    # (qwen3-moe), D 192 with H = Hkv, D 256 at rep 16 with a window
    (128, 16, 1, 150, 150, 0, None, None),
    (128, 64, 4, 200, 200, 0, None, None),
    (192, 16, 16, 300, 300, 0, None, None),
    (256, 16, 1, 333, 333, 0, None, 100),
    # chunks at a nonzero q_offset against a longer kv_len
    (128, 16, 2, 70, 300, 200, 270, None),
    (256, 16, 1, 100, 400, 250, 350, 64),
    # Sq and Sk multiples of no tile
    (192, 16, 16, 131, 197, 0, None, None),
    (128, 8, 2, 131, 197, 50, None, None),
    # kv_len 0: every row reads zeros
    (192, 4, 4, 40, 64, 0, 0, None),
    (128, 16, 2, 40, 64, 10, 0, None),
    # fully masked rows: the whole chunk past the window's reach, and a
    # chunk whose first rows see nothing (window 16 behind a short kv_len)
    (256, 16, 1, 4, 64, 80, 40, 8),
    (128, 16, 2, 96, 160, 20, 30, 16),
])
def test_flash_kernel_matches_plain(card, dtype, d, h, hkv, sq, sk, q_offset, kv_len, window):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(1, sq, h, d, generator=g, device=card).to(dt).transpose(1, 2)
    k = torch.randn(1, sk, hkv, d, generator=g, device=card).to(dt).transpose(1, 2)
    v = torch.randn(1, sk, hkv, d, generator=g, device=card).to(dt).transpose(1, 2)
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len, window=window)
    got, names, launched = _profiled(lambda: ops.flash_attention(q, k, v, **kw),
                                     "flash_attention")
    assert launched == 1
    kernel, design = _flash_design(dtype, d, sq, h // hkv)
    assert names == {kernel} and _design_of_last_call() == design
    want = ref.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **(F32 if dtype == "float32" else BF16))
    # rows that see no key are zeros, exactly
    qpos = torch.arange(sq, device=card)[:, None] + q_offset
    kpos = torch.arange(sk, device=card)[None, :]
    seen = (kpos < (sk if kv_len is None else kv_len)) & (qpos >= kpos)
    if window is not None:
        seen &= qpos - kpos < window
    assert torch.all(got[:, :, ~seen.any(1)] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,d,sq,sk,causal", [
    # whisper-large-v3: 20 heads = KV heads of 64, non-causal over the 1,500
    # encoder frames (a multiple of no tile): the encoder and the
    # cross-attention of a 4-token prompt, 2 requests
    (2, 20, 20, 64, 1500, 1500, False),
    (2, 20, 20, 64, 4, 1500, False),
    # llava-next-mistral-7b's image + text prefill: 2,944 causal tokens,
    # 32 query heads over 8 KV heads of 128
    (1, 32, 8, 128, 2944, 2944, True),
], ids=["whisper_encoder", "whisper_cross", "llava_prefill"])
def test_flash_kernel_at_the_served_multimodal_shapes(card, dtype, b, h, hkv, d, sq, sk, causal):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(1)
    q = torch.randn(b, sq, h, d, generator=g, device=card).to(dt).transpose(1, 2)
    k = torch.randn(b, sk, hkv, d, generator=g, device=card).to(dt).transpose(1, 2)
    v = torch.randn(b, sk, hkv, d, generator=g, device=card).to(dt).transpose(1, 2)
    got, names, launched = _profiled(lambda: ops.flash_attention(q, k, v, causal=causal),
                                     "flash_attention")
    assert launched == 1
    kernel, design = _flash_design(dtype, d, sq, h // hkv)
    assert names == {kernel} and _design_of_last_call() == design
    want = ref.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h", [(128, 16), (192, 8), (256, 4)])
def test_flash_kernel_reads_strided_views(card, dtype, d, h):
    """q sliced from a wider projection (head stride 2 D, not D), k the
    concatenation of a per-head part and one part expanded over the heads
    (MLA's ``torch.cat``) and v an expand over the KV heads (head stride 0),
    each read where it lies."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(3)
    s = 150
    q = torch.randn(1, s, h, 2 * d, generator=g, device=card).to(dt)[..., :d].transpose(1, 2)
    k_nope = torch.randn(1, s, h, d - 64, generator=g, device=card).to(dt)
    k_rope = torch.randn(1, s, 1, 64, generator=g, device=card).to(dt)
    k = torch.cat([k_nope, k_rope.expand(1, s, h, 64)], dim=-1).transpose(1, 2)
    v = torch.randn(1, s, 1, d, generator=g, device=card).to(dt).expand(1, s, h, d)
    v = v.transpose(1, 2)
    assert q.stride(1) == 2 * d and v.stride(1) == 0
    got, names, _ = _profiled(lambda: ops.flash_attention(q, k, v, causal=True))
    kernel, design = _flash_design(dtype, d, s, 1)
    assert names == {kernel} and _design_of_last_call() == design
    want = ref.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h,hkv,window", [(128, 16, 2, None), (192, 8, 8, None),
                                            (256, 16, 1, 64)])
@pytest.mark.parametrize("expand", [False, True], ids=["batch", "kv_expanded"])
def test_flash_kernel_batch_of_two(card, dtype, d, h, hkv, window, expand):
    """A batch of 2 (a batched prefill) at each served head dim, a chunk at a
    nonzero q_offset against a longer kv_len; ``kv_expanded``: k and v one
    slice expanded over the batch (batch stride 0)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(4)
    sq, sk, q_offset, kv_len = 150, 300, 100, 250
    q = torch.randn(2, sq, h, d, generator=g, device=card).to(dt).transpose(1, 2)
    k, v = (torch.randn(1 if expand else 2, sk, hkv, d, generator=g, device=card).to(dt)
            .expand(2, sk, hkv, d).transpose(1, 2) for _ in range(2))
    assert (k.stride(0) == 0) == expand
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len, window=window)
    got, names, launched = _profiled(lambda: ops.flash_attention(q, k, v, **kw),
                                     "flash_attention")
    assert launched == 1
    assert names == {_flash_design(dtype, d, sq, h // hkv)[0]}
    want = ref.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **(F32 if dtype == "float32" else BF16))


# every design: bf16 at the served head dims and at D 64 (64 queries x rep
# 4) on wgmma + TMA, float32 on the CUDA cores; a window on the
# recurrentgemma shape (the split design's device pair: test_flash_d64_designs)
DEVICE_OFFSET_CASES = [("bfloat16", 128, 16, 2, None), ("bfloat16", 192, 8, 8, None),
                       ("bfloat16", 256, 16, 1, 64), ("bfloat16", 64, 8, 2, None),
                       ("float32", 128, 16, 2, None)]


@pytest.mark.parametrize("q_offset", [0, 64, 48], ids=["0", "chunk", "page_not_chunk"])
@pytest.mark.parametrize("dtype,d,h,hkv,window", DEVICE_OFFSET_CASES)
def test_flash_device_offsets_bit_equal_to_host_offsets(card, dtype, d, h, hkv, window,
                                                        q_offset):
    """A 64-token chunk at ``q_offset`` (0, one chunk, or 48: a multiple of
    the 16-token page but not of the chunk) against a 256-row slot whose
    rows past ``kv_len`` hold finite garbage: (q_offset, kv_len) read from an
    int32 pair on the card (the K/V maps over all 256 rows) gives the
    host-offset call's bits, in one launch of the same kernel."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(q_offset)
    sq, sk = 64, 256
    kv_len = q_offset + sq
    q = torch.randn(1, sq, h, d, generator=g, device=card).to(dt).transpose(1, 2)
    k, v = (torch.randn(1, sk, hkv, d, generator=g, device=card).to(dt).transpose(1, 2)
            for _ in range(2))
    pair = torch.tensor([q_offset, kv_len], dtype=torch.int32, device=card)
    want = ops.flash_attention(q, k, v, window=window, q_offset=q_offset, kv_len=kv_len)
    got, names, launched = _profiled(
        lambda: ops.flash_attention(q, k, v, window=window, q_offset=pair[0], kv_len=pair[1]),
        "flash_attention")
    assert launched == 1 and names == {_flash_design(dtype, d, sq, h // hkv)[0]}
    assert torch.equal(got, want)
    # the pair built from int64 scalars (one stack and cast) gives them too
    pos = torch.tensor(q_offset, device=card)
    assert torch.equal(ops.flash_attention(q, k, v, window=window, q_offset=pos,
                                           kv_len=pos + sq), want)
    torch.testing.assert_close(got.float(), ref.flash_attention(
        q, k, v, window=window, q_offset=q_offset, kv_len=kv_len).float(),
        **(F32 if dtype == "float32" else BF16))


# bf16 at head dim 64: each design's contract.  b, h, hkv, sq, sk, q_offset,
# kv_len, window, causal, k/v expanded over the batch, q_offset and kv_len
# as an int32 pair on the card
FLASH_D64 = {
    "wgmma_causal_q_offset": (2, 8, 8, 300, 700, 400, None, None, True, False, False),
    "wgmma_kv_len": (2, 4, 4, 200, 500, 0, 333, None, False, False, False),
    "wgmma_device_pair": (1, 8, 2, 256, 1024, 256, 512, None, True, False, True),
    "wgmma_window": (1, 8, 8, 500, 500, 0, None, 100, True, False, False),
    "wgmma_batch_stride_0": (3, 4, 4, 200, 300, 0, None, None, False, True, False),
    "wgmma_fully_masked_rows": (1, 16, 2, 96, 160, 20, 30, 16, True, False, False),
    "wgmma_rows_17": (2, 4, 4, 17, 333, 316, None, None, True, False, False),
    "split_rows_16": (2, 16, 4, 4, 700, 696, None, None, True, False, False),
    "split_kv_len": (2, 4, 4, 3, 500, 0, 301, None, False, False, False),
    "split_device_pair": (2, 4, 4, 3, 500, 297, 300, None, True, False, True),
    "split_window": (2, 8, 2, 2, 600, 580, None, 100, True, False, False),
    "split_batch_stride_0": (3, 4, 4, 4, 257, 0, None, None, False, True, False),
    "split_fully_masked_rows": (2, 4, 4, 4, 64, 80, 40, 8, True, False, False),
    "split_sk_below_a_tile": (2, 4, 1, 4, 5, 0, None, None, False, False, False),
}


@pytest.mark.parametrize("case", list(FLASH_D64))
def test_flash_d64_designs(card, case):
    """Each bf16 D 64 design against the plain version in one launch, the
    same bits from a repeated call, and (device pair) the host-offset
    call's bits."""
    b, h, hkv, sq, sk, q_offset, kv_len, window, causal, expand, pair = FLASH_D64[case]
    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn(b, sq, h, 64, generator=g, device=card).bfloat16().transpose(1, 2)
    k, v = (torch.randn(1 if expand else b, sk, hkv, 64, generator=g, device=card).bfloat16()
            .expand(b, sk, hkv, 64).transpose(1, 2) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    host = ops.flash_attention(q, k, v, **kw)
    if pair:
        offsets = torch.tensor([q_offset, kv_len], dtype=torch.int32, device=card)
        kw.update(q_offset=offsets[0], kv_len=offsets[1])
    got, names, launched = _profiled(lambda: ops.flash_attention(q, k, v, **kw),
                                     "flash_attention")
    kernel, design = _flash_design("bfloat16", 64, sq, h // hkv)
    assert launched == 1 and names == {kernel} and _design_of_last_call() == design
    assert torch.equal(got, host) and torch.equal(ops.flash_attention(q, k, v, **kw), got)
    torch.testing.assert_close(got.float(), ref.flash_attention(q, k, v, **kw).float(), **BF16)


def _paged_design(dtype: str, d: int) -> tuple[str, str]:
    """(compiled kernel, the ``ops.PATHS`` entry's design) of a paged-decode
    call: bf16 on mma.sync, float32 on the CUDA cores, either one launch
    whose splits merge in a cluster."""
    if dtype == "float32":
        return f"paged_decode_fma<{d}>", "CUDA cores"
    return f"paged_decode_mma<{d}>", "mma.sync"


def _paged_plain(q, kp, vp, bt, lens):
    b, h, d = q.shape
    hkv = kp.shape[2]
    return ref.paged_decode_attention(q.view(b, hkv, h // hkv, d), kp.permute(2, 0, 1, 3),
                                      vp.permute(2, 0, 1, 3), bt, lens).view(b, h, d)


def _paged_call_checked(dtype, q, kp, vp, bt, lens):
    """One profiled call: exactly one launch, of the design ``ops.PATHS``
    names, and equal to the plain version."""
    got, names, launched = _profiled(lambda: ops.paged_attention(q, kp, vp, bt, lens),
                                     "paged_decode_attention")
    assert launched == 1
    kernel, design = _paged_design(dtype, q.shape[2])
    assert names == {kernel}
    path = ops.PATHS["paged_decode_attention"]
    assert path.startswith(design + ", cluster of ")
    assert int(path.rsplit(" ", 1)[1]) in (1, 2, 4, 8, 16)
    want = _paged_plain(q, kp, vp, bt, lens)
    torch.testing.assert_close(got.float(), want.float(), **(F32 if dtype == "float32" else BF16))
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# every call is one launch: the splits merge inside it
@pytest.mark.parametrize("p,lengths,kernels", [(8, [0, 5, 128, 70], 1), (1, [0, 5, 16, 9], 1)],
                         ids=["split_pages", "one_page_no_split"])
def test_paged_kernel_matches_plain(card, dtype, p, lengths, kernels):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(1)
    b, h, hkv, d, ps = 4, 16, 2, 128, 16
    lens = torch.tensor(lengths, dtype=torch.int32, device=card)
    bt = torch.randperm(b * p + 4, generator=g, device=card)[: b * p].reshape(b, p).int()
    bt[0] = -1
    bt[1, 1:] = -1
    if p > 2:
        bt[3, 2] = -1                                # a hole inside lane 3
    q = torch.randn(b, h, d, generator=g, device=card).to(dt)
    kp = torch.randn(b * p + 4, ps, hkv, d, generator=g, device=card).to(dt)
    vp = torch.randn(b * p + 4, ps, hkv, d, generator=g, device=card).to(dt)
    before = ops.LAUNCHES["paged_decode_attention"]
    got = ops.paged_attention(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode_attention"] == before + kernels
    want = ref.paged_decode_attention(q.view(b, hkv, h // hkv, d), kp.permute(2, 0, 1, 3),
                                      vp.permute(2, 0, 1, 3), bt, lens).view(b, h, d)
    torch.testing.assert_close(got.float(), want.float(), **(F32 if dtype == "float32" else BF16))
    assert torch.all(got[0] == 0)


# lane lengths over an 8-slot table of 16-token pages: empty, 1, 15, 16, 17,
# the full table, then a lane with a hole at slot 0, one with a hole inside
# its length and one whose every slot within its length is -1
PAGED_EDGE_LENS = [0, 1, 15, 16, 17, 128, 40, 70, 50]


def _paged_edge_inputs(card, dt, rep, d, hkv=2, slots=8, ps=16, seed=11):
    g = torch.Generator(device=card).manual_seed(seed)
    b = len(PAGED_EDGE_LENS)
    n_pages = b * slots + 3
    bt = torch.randperm(n_pages, generator=g, device=card)[: b * slots].reshape(b, slots).int()
    for i, n in enumerate(PAGED_EDGE_LENS):
        bt[i, -(-n // ps):] = -1
    bt[6, 0] = -1
    bt[7, 2] = -1
    bt[8] = -1
    lens = torch.tensor(PAGED_EDGE_LENS, dtype=torch.int32, device=card)
    q = torch.randn(b, hkv * rep, d, generator=g, device=card).to(dt)
    kp = torch.randn(n_pages, ps, hkv, d, generator=g, device=card).to(dt)
    vp = torch.randn(n_pages, ps, hkv, d, generator=g, device=card).to(dt)
    return q, kp, vp, bt, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [8, 16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_paged_kernel_edge_lengths_and_holes(card, dtype, rep, d):
    """Lengths 0, 1, 15, 16, 17 and the full table, holes at slot 0 and
    inside a length, a lane with nothing but holes, at rep 8 and 16 and each
    head dim: one launch, equal to the plain version; lanes that see nothing
    read zeros."""
    q, kp, vp, bt, lens = _paged_edge_inputs(card, getattr(torch, dtype), rep, d)
    got = _paged_call_checked(dtype, q, kp, vp, bt, lens)
    assert torch.all(got[0] == 0) and torch.all(got[8] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("view", ["layer_of_a_stack", "page_stride", "head_stride"])
def test_paged_kernel_reads_strided_pools(card, dtype, view):
    """Pools read where they lie: one layer of a per-layer stack (as the
    serving cache holds them), a page stride wider than a page (layers
    inside the page dim) and a head stride of 2 D (a slice of wider rows)."""
    dt = getattr(torch, dtype)
    q, kp, vp, bt, lens = _paged_edge_inputs(card, dt, 16, 128)
    n, ps, hkv, d = kp.shape
    if view == "layer_of_a_stack":
        stack = torch.zeros(3, 2, n, ps, hkv, d, dtype=dt, device=card)
        stack[1, 0], stack[1, 1] = kp, vp
        kv = stack[1, 0], stack[1, 1]
    elif view == "page_stride":
        wide = torch.zeros(n, 3, ps, hkv, d, dtype=dt, device=card)
        wide2 = torch.zeros(n, 3, ps, hkv, d, dtype=dt, device=card)
        wide[:, 1], wide2[:, 1] = kp, vp
        kv = wide[:, 1], wide2[:, 1]
    else:
        wide = torch.zeros(n, ps, hkv, 2 * d, dtype=dt, device=card)
        wide2 = torch.zeros(n, ps, hkv, 2 * d, dtype=dt, device=card)
        wide[..., d:], wide2[..., d:] = kp, vp
        kv = wide[..., d:], wide2[..., d:]
    assert not kv[0].is_contiguous() or view == "layer_of_a_stack"
    got = _paged_call_checked(dtype, q, kv[0], kv[1], bt, lens)
    torch.testing.assert_close(got, ops.paged_attention(q, kp, vp, bt, lens), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_in_a_cuda_graph(card, dtype):
    """A call captured once and replayed after ``lengths`` and
    ``block_table`` change in place gives the plain version's answer for
    the new contents: the kernel keeps no per-call host state."""
    q, kp, vp, bt, lens = _paged_edge_inputs(card, getattr(torch, dtype), 16, 128)
    ops.paged_attention(q, kp, vp, bt, lens)         # builds, plans, warms up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.paged_attention(q, kp, vp, bt, lens)
    graph.replay()
    torch.cuda.synchronize()
    tol = F32 if dtype == "float32" else BF16
    torch.testing.assert_close(out.float(), _paged_plain(q, kp, vp, bt, lens).float(), **tol)
    g = torch.Generator(device=card).manual_seed(12)
    lens.copy_(torch.tensor([128, 0, 33, 16, 1, 99, 64, 17, 128], dtype=torch.int32,
                            device=card))
    bt.copy_(torch.randperm(kp.shape[0], generator=g, device=card)[: bt.numel()]
             .reshape(bt.shape).int())
    bt[2, 1] = -1
    graph.replay()
    torch.cuda.synchronize()
    want = _paged_plain(q, kp, vp, bt, lens)
    torch.testing.assert_close(out.float(), want.float(), **tol)
    assert torch.all(out[1] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_at_rep_16_matches_plain(card, dtype):
    """qwen3-moe's decode shape: 64 query heads over 4 KV heads (rep 16,
    the kernel's MAX_REP), head_dim 128."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(7)
    b, h, hkv, d, ps, p = 4, 64, 4, 128, 16, 8
    assert h // hkv == ops.MAX_REP
    lens = torch.tensor([0, 128, 33, 100], dtype=torch.int32, device=card)
    bt = torch.randperm(b * p, generator=g, device=card).reshape(b, p).int()
    bt[0] = -1
    q = torch.randn(b, h, d, generator=g, device=card).to(dt)
    kp = torch.randn(b * p, ps, hkv, d, generator=g, device=card).to(dt)
    vp = torch.randn(b * p, ps, hkv, d, generator=g, device=card).to(dt)
    before = ops.LAUNCHES["paged_decode_attention"]
    got = ops.paged_attention(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode_attention"] > before
    want = ref.paged_decode_attention(q.view(b, hkv, h // hkv, d), kp.permute(2, 0, 1, 3),
                                      vp.permute(2, 0, 1, 3), bt, lens).view(b, h, d)
    torch.testing.assert_close(got.float(), want.float(), **(F32 if dtype == "float32" else BF16))


# (arch, prompt lengths, prefill chunk, decode path): mamba2's whole prompts
# are at most one 32-token chunk or a multiple of it; recurrentgemma (5
# layers, window 64) prefills past its window and decodes across it
SERVE_CASES = [
    ("qwen2.5-3b", (5, 19, 11), 8, "paged"),
    ("qwen2.5-3b", (5, 19, 11), 8, "gather"),
    ("mamba2-130m", (5, 32, 11), 0, "paged"),
    ("mamba2-130m", (5, 40, 11), 16, "paged"),
    ("mamba2-130m", (5, 40, 11), 16, "gather"),
    ("recurrentgemma-9b", (70, 5, 60), 0, "paged"),
    ("recurrentgemma-9b", (70, 5, 60), 16, "paged"),
    ("recurrentgemma-9b", (70, 5, 60), 16, "gather"),
    # the moe family: deepseek (MLA: flash at head_dim 48 in prefill, one
    # paged_gather launch per layer in the paged decode) and qwen3-moe
    ("deepseek-v3-671b", (21, 5, 40), 0, "paged"),
    ("deepseek-v3-671b", (21, 5, 40), 16, "paged"),
    ("deepseek-v3-671b", (21, 5, 40), 16, "gather"),
    ("qwen3-moe-235b-a22b", (21, 5, 40), 0, "paged"),
    ("qwen3-moe-235b-a22b", (21, 5, 40), 16, "gather"),
    # the vlm's text requests: the dense backbone's paths
    ("llava-next-mistral-7b", (21, 5, 40), 0, "paged"),
    ("llava-next-mistral-7b", (21, 5, 40), 16, "gather"),
]


@pytest.mark.parametrize("arch,lengths,chunk,path", SERVE_CASES)
def test_served_tokens_on_card_match_cpu(card, arch, lengths, chunk, path):
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serve import (
        AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine)

    hybrid = arch == "recurrentgemma-9b"
    over = dict(n_layers=5) if hybrid else {}
    model = build_model(dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **over))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=(n,)).astype(np.int32) for n in lengths]
    ecfg = EngineConfig(batch_slots=2, max_len=128 if hybrid else 64,
                        cache=CacheConfig(decode_path=path),
                        admission=AdmissionConfig(prefill_chunk=chunk))
    out = {}
    for dev, p in (("cpu", params), (card, tree_map(lambda t: t.to(card), params))):
        eng = ServeEngine(model, p, ecfg, device=dev)
        reqs = [Request(uid=i, prompt=pr, max_new_tokens=6) for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        ops.reset_launches()
        runs = eng.decode_graph.runs
        eng.run()
        # decode steps of the run: on the card each is one replay of the
        # engine's captured step
        steps = eng.decode_graph.runs - runs
        out[str(dev)] = [r.out_tokens for r in reqs]
    assert eng.decode_graph.graph is not None
    assert out["cpu"] == out["cuda"]
    kernel = "ssd_scan" if arch.startswith("mamba2") else "flash_attention"
    # MLA's chunked prefill is the absorbed contraction (plain torch), its
    # whole-prompt prefill the flash kernel
    assert (ops.LAUNCHES[kernel] > 0) == (arch != "deepseek-v3-671b" or chunk == 0)
    # the hybrid's windowed layers and MLA read their pages through
    # paged_gather on both paths, and never through the paged kernel: one
    # launch per windowed or MLA layer and paged decode step (k and v, or
    # latent and k_rope, together), one per gather decode step (every seq
    # leaf together; mamba2 has none)
    gathers = hybrid or arch == "deepseek-v3-671b"
    if path == "gather":
        want = steps * (kernel != "ssd_scan")
    else:
        per_step = {"recurrentgemma-9b": sum(reps * pattern.count("attn")
                                             for pattern, reps in model.segments),
                    "deepseek-v3-671b": model.cfg.n_layers}.get(arch, 0)
        want = steps * per_step
    assert steps > 0
    assert ops.LAUNCHES["paged_gather"] == want
    assert (want > 0) == (gathers or (path == "gather" and kernel != "ssd_scan"))
    if gathers:
        assert ops.LAUNCHES["paged_decode_attention"] == 0


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-large-v3"])
def test_multimodal_prefill_and_decode_on_card_match_cpu(card, arch):
    """Reduced llava (16 image tokens) and whisper (64 frames) in float32:
    prefill with patches or frames, then 10 greedy ``decode_step``s; the
    card's logits within 2e-4 x max(1, |logits|) of the CPU's and its
    tokens equal.  The prefill's attention is the flash kernel: once per
    layer for llava, once per encoder layer and twice per decoder layer for
    whisper."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.api import VISION_DIM
    from repro_torch.models.common import tree_map

    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    audio = cfg.family == "audio"
    rng = np.random.default_rng(2)
    b, s, new = 2, 5, 10
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s))).long()
    extra = torch.from_numpy(rng.standard_normal(
        (b, cfg.encoder.n_ctx, cfg.d_model) if audio else
        (b, cfg.vision.n_image_tokens, VISION_DIM)).astype(np.float32))
    n = s if audio else cfg.vision.n_image_tokens + s
    out = {}
    for dev, p in (("cpu", params), ("cuda", tree_map(lambda t: t.to(card), params))):
        ops.reset_launches()
        if audio:
            logits, prompt_cache = model.prefill(p, toks.to(dev), frames=extra.to(dev))
        else:
            logits, prompt_cache = model.prefill(p, toks.to(dev), extra_embeds=extra.to(dev))
        cache = tree_map(lambda sp: torch.zeros(sp.shape, dtype=sp.dtype, device=dev),
                         model.cache_specs(b, n + new))
        tree_map(lambda f, c: f[:, :, :c.shape[2]].copy_(c), cache, prompt_cache)
        flash = ops.LAUNCHES["flash_attention"]
        steps = [logits.cpu()]
        for i in range(new):
            tok = steps[-1][:, -1].argmax(-1)[:, None].to(dev)
            pos = n + i if audio else torch.full((b,), n + i, device=dev)
            logits, cache = model.decode_step(p, cache, tok, pos)
            steps.append(logits.cpu())
        out[dev] = steps
    assert flash == (cfg.encoder.n_layers + 2 * cfg.n_layers if audio else cfg.n_layers)
    for got, want in zip(out["cuda"], out["cpu"]):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=2e-4 * scale)
        assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens", [(3, 17, 0, 40), (64, 1, 5, 200)], ids=["short", "long"])
def test_paged_write_kernel_bit_equal_to_plain(card, dtype, lens):
    """Every pool of a layer's k and v, an MLA latent and k_rope, a 36-layer
    leaf and 8 pools (the most one launch takes) in one launch each: idle
    lanes, -1 pages and a page past the pool write nothing, the rest
    bit-equal to the plain version.  9 pools are refused, by the wrapper and
    by the launch entry."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(3)
    lanes, ps, slots = len(lens) + 2, 16, 16
    n_pages = lanes * slots
    bt = torch.randperm(n_pages, generator=g, device=card).reshape(lanes, slots).int()
    pos = torch.tensor(list(lens) + [30, 31], dtype=torch.long, device=card)
    active = torch.tensor([True, True, False, True, True, True], device=card)
    bt[1, 17 // ps] = -1                                  # lane 1 writes into a -1 slot
    bt[4, 30 // ps] = n_pages + 5                         # lane 4's page lies past the pool
    for rows in ([(1, (2, 128)), (1, (2, 128))], [(1, (512,)), (1, (64,))], [(36, (2, 128))],
                 [(2, (3, 5))] * ops.PAGED_WRITE_POOLS):
        pools = [torch.randn((l, n_pages, ps) + t, generator=g, device=card).to(dt)
                 for l, t in rows]
        new = [torch.randn((l, lanes) + t, generator=g, device=card).to(dt) for l, t in rows]
        want = [p.clone() for p in pools]
        ref.paged_write(want, new, bt, pos, active)
        ops.reset_launches()
        ops.paged_write(pools, new, bt, pos, active)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["paged_write"] == 1
        for p, w in zip(pools, want):
            assert torch.equal(p, w)
    pools, new = pools + pools[:1], new + new[:1]
    with pytest.raises(ValueError):
        ops.paged_write(pools, new, bt, pos, active)
    _, launch = ops._entry("paged_write_launch")
    args = [bt.data_ptr(), pos.data_ptr(), active.data_ptr(), lanes, slots, ps,
            torch.cuda.current_stream().cuda_stream]
    for p, r in zip(pools, new):
        args += [p.data_ptr(), r.data_ptr(), p.shape[0], p.shape[1], 15 * p.element_size()]
    assert launch(len(pools), (ctypes.c_longlong * len(args))(*args)) != 0   # refused
    assert ops.LAUNCHES["paged_write"] == 1


def _ssd_design(dtype: str) -> tuple[str, str]:
    """(compiled kernel, start of the ``ops.PATHS`` entry) an ``ssd_scan``
    call must take: mma.sync in bf16, the CUDA cores in float32."""
    if dtype == "bfloat16":
        return "ssd_scan_mma", "mma.sync bf16 split x3, cluster of "
    return "ssd_scan_fma", "CUDA cores, cluster of "


def _ssd_check(dtype, xh, bb, cc, dts, a, chunk, st, plain_dtype=torch.float32):
    """One ``ssd_scan`` call against the plain version (evaluated in
    ``plain_dtype``): one launch counted, one device kernel of the design's
    name profiled, ``ops.PATHS`` naming the design."""
    kernel, path = _ssd_design(dtype)
    (y, fin), got, launched = _profile(lambda: ops.ssd_scan(xh, bb, cc, dts, a, chunk, st),
                                       "ssd_scan")
    assert launched == 1
    assert ops.PATHS["ssd_scan"].startswith(path), ops.PATHS["ssd_scan"]
    assert len(got) == 1 and got[0][1] == 1 and got[0][0].split("<")[0] == kernel, got
    want_y, want_fin = ref.ssd_scan(xh, bb, cc, dts, a, chunk, st, dtype=plain_dtype)
    torch.testing.assert_close(y, want_y.float(), **F32)
    torch.testing.assert_close(fin, want_fin.float(), **F32)


def _ssd_inputs(card, dtype, b, s, h, p, n, init, pad, clip=False):
    """x, B and C as the model slices them out of one conv output; dt and a
    as the model's (``clip``: large enough that a 256-token chunk's seg
    spans more than 120); a distinct random state per batch row."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(5)
    conv = (torch.randn(b, s, h * p + 2 * n + pad, generator=g, device=card) * 0.5).to(dt)
    xh = conv[..., :h * p].reshape(b, s, h, p)
    bb, cc = conv[..., h * p:h * p + n], conv[..., h * p + n:h * p + 2 * n]
    if clip:
        dts = torch.rand(b, s, h, generator=g, device=card) * 0.5 + 0.5
        a = -(torch.rand(h, generator=g, device=card) + 1.0)
    else:
        dts = torch.rand(b, s, h, generator=g, device=card) * 0.49 + 0.01
        a = -(torch.rand(h, generator=g, device=card) + 0.5)
    st = torch.randn(b, h, p, n, generator=g, device=card) if init else None
    return xh, bb, cc, dts, a, st


# F32 holds for bf16 inputs too: kernel and plain version widen them to
# float32 and both write float32
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,init,pad", [
    (1, 512, 24, 64, 128, 256, False, 0),  # full-width mamba2-130m, a 512-token prompt
    (1, 256, 24, 64, 128, 256, True, 0),   # a chunked-prefill slice with carried state
    (2, 44, 4, 32, 16, 256, True, 0),      # a ragged 44-token slice
    (1, 96, 3, 8, 8, 32, False, 0),        # P under one 16-column slice, N = 8
    (2, 96, 2, 16, 12, 32, True, 1),       # rows that are not 16-byte aligned: element loads
    (4, 1024, 24, 64, 128, 256, False, 0),  # the eval's shape: 4 rows, four chunks
    (4, 1024, 24, 64, 128, 256, True, 0),   # the same from carried states
    (1, 1, 24, 64, 128, 256, True, 0),     # 1-token and 255-token slices: rows of the
    (1, 255, 24, 64, 128, 256, True, 0),   # cluster past the chunk's end
    (2, 256, 24, 64, 128, 256, True, 0),   # two rows, each its own carried state
    (1, 64, 8, 32, 16, 32, True, 0),       # the reduced model's widths, two chunks
])
def test_ssd_scan_kernel_matches_plain(card, dtype, b, s, h, p, n, chunk, init, pad):
    xh, bb, cc, dts, a, st = _ssd_inputs(card, dtype, b, s, h, p, n, init, pad)
    _ssd_check(dtype, xh, bb, cc, dts, a, chunk, st)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_kernel_keeps_the_decay_clip(card, dtype, init):
    """A chunk whose seg spans more than 120: the kernel computes the
    clipped factorization e_out * e_in as the plain version does, which
    then differs from exp(seg_i - seg_j).  There the clipped weights of
    whole runs of tokens hang on seg (|seg| ~ 290) to a few ulp and on
    float32 sums of e^60-sized terms: the plain version evaluated in float32
    (its serial cumsum on the card) is up to 3.2 times the tolerance from
    the exact result, so the kernel is held to it evaluated in float64."""
    xh, bb, cc, dts, a, st = _ssd_inputs(card, dtype, 1, 512, 24, 64, 128, init, 0, clip=True)
    span = (dts * a).reshape(1, 2, 256, 24).sum(2).abs().min()
    assert span > 120, span
    _ssd_check(dtype, xh, bb, cc, dts, a, 256, st, plain_dtype=torch.float64)


@pytest.mark.parametrize("dtype,row", [
    ("bfloat16", 16 * 2 * 128),            # a qwen2.5-3b page: 16 tokens x 2 heads x 128
    ("float32", 4 * 2 * 32),
    ("uint8", 13),                         # rows that are not 16-byte multiples
    ("int16", 7),
    ("bfloat16", 16 * 512),                # an MLA latent page: 16 tokens x 512
    ("bfloat16", 16 * 64),                 # and its rotary-key page: 16 x 64
])
def test_paged_gather_kernel_bit_equal_to_plain(card, dtype, row):
    g = torch.Generator(device=card).manual_seed(6)
    layers, n_pages, lanes, slots = 3, 40, 5, 8
    pool = (torch.randn(layers, n_pages, row, generator=g, device=card) * 100).to(
        getattr(torch, dtype))
    bt = torch.randperm(n_pages, generator=g, device=card)[: lanes * slots].reshape(
        lanes, slots).int()
    bt[0] = -1
    bt[1, 3:] = -1
    bt[2, 1] = -1                                            # a hole inside lane 2
    before = ops.LAUNCHES["paged_gather"]
    got = ops.paged_gather(pool, bt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_gather"] == before + 1
    assert torch.equal(got, ref.paged_gather(pool, bt))
    assert torch.all(got[:, 0] == 0)


def _gather_pools(card, specs, seed=7):
    """Pools of (leading dims, n_pages, row, dtype, base offset in elements:
    a pool that starts past its storage's 16-byte boundary)."""
    g = torch.Generator(device=card).manual_seed(seed)
    pools = []
    for lead, n_pages, row, dtype, shift in specs:
        numel = int(np.prod(lead + (n_pages, row)))
        flat = (torch.randn(numel + shift, generator=g, device=card) * 100).to(
            getattr(torch, dtype))
        pools.append(flat[shift:].view(lead + (n_pages, row)))
    return pools


def _holed_table(card, lanes, slots, n_pages, seed=8):
    g = torch.Generator(device=card).manual_seed(seed)
    bt = torch.randperm(n_pages, generator=g, device=card)[: lanes * slots].reshape(
        lanes, slots).int()
    bt[0] = -1
    bt[1, slots // 2:] = -1
    bt[2, 1] = -1                                            # a hole inside lane 2
    return bt


@pytest.mark.parametrize("label,specs,lanes,slots", [
    # an MLA layer's latent (16 x 512 bf16: 16 KiB) and k_rope (16 x 64: 2 KiB) pools
    ("mla", [((), 80, 16 * 512, "bfloat16", 0), ((), 80, 16 * 64, "bfloat16", 0)], 8, 9),
    # a recurrentgemma layer's k and v pools (16 x 256 bf16: 8 KiB each)
    ("k+v", [((), 80, 16 * 256, "bfloat16", 0), ((), 80, 16 * 256, "bfloat16", 0)], 8, 9),
    # rows that are no multiple of 16 bytes, and a base 2 bytes past one,
    # beside bulk-copied rows
    ("unaligned", [((2,), 40, 13, "uint8", 0), ((), 40, 7, "int16", 0),
                   ((), 40, 16 * 128, "bfloat16", 1), ((3,), 40, 64, "float32", 0)], 5, 8),
    # one layer and 36 layers in one call, and a 40 KiB row (bulk pieces)
    ("layers", [((), 70, 16 * 2 * 128, "bfloat16", 0), ((36,), 70, 16 * 2 * 128, "bfloat16", 0),
                ((2,), 70, 10240, "float32", 0)], 8, 8),
    # a table of 8 x 600 entries: past what a block keeps in shared memory
    ("long table", [((), 4810, 16 * 256, "bfloat16", 0), ((), 4810, 48, "float32", 0)], 8, 600),
])
def test_paged_gather_many_kernel_bit_equal_to_plain(card, label, specs, lanes, slots):
    pools = _gather_pools(card, specs)
    bt = _holed_table(card, lanes, slots, specs[0][1])
    before = ops.LAUNCHES["paged_gather"]
    got = ops.paged_gather_many(pools, bt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_gather"] == before + 1
    for out, pool in zip(got, pools):
        assert torch.equal(out, ref.paged_gather(pool, bt)), (label, tuple(pool.shape))
        assert torch.all(out[..., 0, :, :] == 0)


def test_paged_gather_many_past_one_table_launches_one_grid_per_table(card):
    cap = ops.paged_gather_capacity()
    specs = [((), 24, (16, 24, 13)[i % 3], ("bfloat16", "float32", "uint8")[i % 3], 0)
             for i in range(cap + 3)]
    pools = _gather_pools(card, specs, seed=9)
    bt = _holed_table(card, 4, 4, 24)
    before = ops.LAUNCHES["paged_gather"]
    got = ops.paged_gather_many(pools, bt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_gather"] == before + 2
    for out, pool in zip(got, pools):
        assert torch.equal(out, ref.paged_gather(pool, bt))


def _tol(dtype):
    return F32 if dtype == "float32" else BF16


def _conv_inputs(card, dt, n, h, w, ci, co, k, seed=2):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(n, h, w, ci, generator=g, device=card).to(dt)
    wt = (torch.randn(k, k, ci, co, generator=g, device=card) / (k * k * ci) ** 0.5).to(dt)
    b = (torch.randn(co, generator=g, device=card) * 0.5).to(dt)
    return x, wt, b


def _conv_path(dtype, ci):
    """The design the kernel takes: wgmma + TMA for bf16 with Ci >= 64."""
    return "wgmma" if dtype == "bfloat16" and ci >= 64 else "mma.sync"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# ragged pixel counts (not a multiple of the 128-pixel tile), Co not a
# multiple of 64, Ci = 3 (padded to 8), Ci past one 32-channel slice, stride 4;
# then the bf16 wgmma path: Ci 64 and 256, Co 64, 128, 96 and 512, ragged
# pixel counts, Ci past a 64-channel slice (130 -> 136), stride 2, conv5_x
@pytest.mark.parametrize("n,h,w,ci,co,k,s,p", [
    (2, 15, 13, 3, 64, 3, 1, 1),
    (1, 35, 35, 3, 96, 11, 4, 0),
    (3, 9, 11, 40, 72, 3, 2, 1),
    (1, 7, 7, 130, 6, 5, 1, 2),
    (2, 14, 14, 512, 512, 3, 1, 1),
    (2, 30, 29, 64, 64, 3, 1, 1),
    (1, 19, 23, 256, 128, 3, 2, 1),
    (3, 13, 11, 64, 512, 3, 1, 1),
    (2, 28, 28, 256, 96, 3, 1, 1),
    (16, 14, 14, 512, 512, 3, 1, 1),
])
def test_conv_kernel_matches_plain(card, dtype, n, h, w, ci, co, k, s, p):
    dt = getattr(torch, dtype)
    x, wt, _ = _conv_inputs(card, dt, n, h, w, ci, co, k)
    before = ops.LAUNCHES["stream_mac_conv"]
    got = ops.stream_mac_conv(x, wt, stride=(s, s), padding=(p, p))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["stream_mac_conv"] == before + 1
    assert ops.PATHS["stream_mac_conv"].startswith(_conv_path(dtype, ci))
    want = ref.stream_mac_conv(x, wt, stride=(s, s), padding=(p, p))
    assert got.shape == want.shape and got.dtype == dt
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("n,h,w,ci,co,k,s,p", [
    (2, 15, 13, 3, 64, 3, 1, 1), (1, 19, 23, 256, 128, 3, 2, 1), (2, 30, 29, 64, 72, 3, 1, 1)])
def test_conv_epilogue_bit_equal_to_unfused(card, dtype, relu, n, h, w, ci, co, k, s, p):
    """The fused bias and ReLU give the bits of conv, then add_, then relu_."""
    dt = getattr(torch, dtype)
    x, wt, b = _conv_inputs(card, dt, n, h, w, ci, co, k, seed=5)
    got = ops.stream_mac_conv(x, wt, stride=(s, s), padding=(p, p), bias=b, relu=relu)
    want = ops.stream_mac_conv(x, wt, stride=(s, s), padding=(p, p)).add_(b)
    if relu:
        want = want.relu_()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    plain = ref.stream_mac_conv(x, wt, stride=(s, s), padding=(p, p), bias=b, relu=relu)
    torch.testing.assert_close(got.float(), plain.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,hw,c,k,s", [
    (2, 13, 16, 3, 2), (2, 8, 5, 2, 2), (1, 7, 130, 3, 1), (3, 224, 64, 2, 2)])
def test_maxpool_kernel_bit_equal_to_plain(card, dtype, n, hw, c, k, s):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(n, hw, hw, c, generator=g, device=card).to(dt)
    before = ops.LAUNCHES["stream_maxpool"]
    got = ops.stream_maxpool(x, (k, k), (s, s))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["stream_maxpool"] == before + 1
    assert torch.equal(got, ref.stream_maxpool(x, (k, k), (s, s)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# M, N, K that do not fill a 64 x 128 tile or a k slice: 16-byte aligned
# rows, unaligned rows (element copies), and fc shapes that split K
@pytest.mark.parametrize("m,k,n", [
    (33, 264, 200), (200, 300, 100), (1, 7, 5), (16, 4096, 1000), (16, 25088, 512)])
def test_matmul_kernel_matches_plain(card, dtype, m, k, n):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(4)
    x = torch.randn(m, k, generator=g, device=card).to(dt)
    y = (torch.randn(k, n, generator=g, device=card) / k ** 0.5).to(dt)
    before = ops.LAUNCHES["tiled_matmul"]
    got = ops.tiled_matmul(x, y)
    again = ops.tiled_matmul(x, y)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["tiled_matmul"] == before + 2
    assert torch.equal(got, again)              # split partials summed in a fixed order
    torch.testing.assert_close(got.float(), ref.tiled_matmul(x, y).float(), **_tol(dtype))


# VGG16's fc6, fc7 and fc8 at batch 1, 16 (the weight stream) and 17 (tiles)
@pytest.mark.parametrize("m", [1, 16, 17])
@pytest.mark.parametrize("k,n", [(25088, 4096), (4096, 4096), (4096, 1000)],
                         ids=["fc6", "fc7", "fc8"])
def test_matmul_fc_shapes_deterministic(card, m, k, n):
    g = torch.Generator(device=card).manual_seed(6)
    x = torch.randn(m, k, generator=g, device=card).to(torch.bfloat16)
    y = (torch.randn(k, n, generator=g, device=card) / k ** 0.5).to(torch.bfloat16)
    got = ops.tiled_matmul(x, y)
    assert ops.PATHS["tiled_matmul"] == ("TMA weight stream 16x128" if m <= 16
                                         else "tiles 64x128")
    again = ops.tiled_matmul(x, y)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.tiled_matmul(x, y).float(), **BF16)


@pytest.mark.parametrize("m", [16, 17])
def test_matmul_launches_only_itself(card, m):
    """A split call is one kernel: no counter memset, no second pass."""
    g = torch.Generator(device=card).manual_seed(7)
    x = torch.randn(m, 25088, generator=g, device=card).to(torch.bfloat16)
    y = torch.randn(25088, 4096, generator=g, device=card).to(torch.bfloat16)
    ops.tiled_matmul(x, y)                      # first call: makes the counter buffer
    torch.cuda.synchronize()
    _, kernels, launched = _profile(lambda: [ops.tiled_matmul(x, y) for _ in range(3)],
                                    "tiled_matmul")
    assert launched == 3
    assert sum(n for _, n in kernels) == 3 and all("matmul_tiled" in k for k, _ in kernels), \
        kernels


@pytest.mark.parametrize("impl", ["kernel", "tiled"])
def test_convnet_logits_on_card_match_cpu(card, impl):
    from repro_torch.core import zoo
    from repro_torch.core.convnet import ConvNetExecutor, narrow_convnet
    from repro_torch.core.tiling import Tile4D
    from repro_torch.models.common import tree_map

    layers = narrow_convnet(zoo.vgg16(), channel_div=16, input_px=32)
    tiles = {l.name: Tile4D(10, 10, max(l.ci // 2, 1), l.co)
             for l in layers if l.kind == "conv"}
    exe = ConvNetExecutor(layers, impl=impl, tiles=tiles)
    params = exe.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 32, 32, 3))
                         .astype(np.float32))
    want = exe.apply(params, x)
    ops.reset_launches()
    got = exe.apply(tree_map(lambda t: t.to(card), params), x.to(card))
    torch.cuda.synchronize()
    # every T_Ci partial of the tiled schedule is a conv launch of its own
    convs = 13 if impl == "kernel" else sum(
        l.ci // tiles[l.name].tci for l in layers if l.kind == "conv")
    assert (ops.LAUNCHES["stream_mac_conv"], ops.LAUNCHES["stream_maxpool"],
            ops.LAUNCHES["tiled_matmul"]) == (convs, 5, 3)
    torch.testing.assert_close(got.cpu(), want, **F32)
    assert torch.equal(got.cpu().argmax(-1), want.argmax(-1))


def test_convnet_weight_grads_on_card_keep_the_cpu_zeros(card):
    """float32 ``impl="xla"`` gradients of the small ConvNet on the card with
    cuDNN on (TF32 off): every element that is exactly 0 on the CPU is 0 on
    the card, and the rest match.  cuDNN's own weight gradient (a Winograd
    transform at conv4) left 575 such elements near 5e-8."""
    from repro_torch.core.convnet import ConvNetExecutor, make_small_convnet
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.train.train_step import value_and_grad

    exe = ConvNetExecutor(make_small_convnet(10, 16, 16), impl="xla")
    params = exe.init(torch.Generator().manual_seed(0), "cpu")
    x, y = (torch.from_numpy(a) for a in
            SyntheticImageData(px=16, channels=3, classes=10, batch=32).next())
    _, want = value_and_grad(exe.loss_fn, params, x, y)
    tf32, on = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled = False, True
    try:
        _, got = value_and_grad(exe.loss_fn, tree_map(lambda t: t.to(card), params),
                                x.to(card), y.to(card))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled = tf32, on
    zeros = 0
    for (path, w), (_, g) in zip(tree_items(want), tree_items(got)):
        g = g.cpu()
        zeros += int((w == 0).sum())
        assert not bool(((w == 0) & (g != 0)).any()), path
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))
    assert zeros > 0                     # the net has dead channels to keep


# (streams' types, output type, in place): the optimizer's launches (sgd; the
# momentum's moment and weight updates, with f32 or bf16 grads), J = 3, 4, 8
GD_CASES = [
    (("bfloat16", "bfloat16"), "bfloat16", True),
    (("float32", "bfloat16"), "float32", True),
    (("float32", "float32"), "float32", True),
    (("bfloat16", "float32"), "bfloat16", True),
    (("float32",) * 3, "float32", False),
    (("float32",) * 4, "float32", False),
    (("bfloat16", "float32") * 4, "float32", False),
]


def _plain_foreach(leaves, coeffs):
    """The plain version of ``stream_gd_foreach`` on copies of ``leaves``."""
    copies = {}
    for leaf in leaves:
        for out, streams in leaf:
            for t in (out, *streams):
                if t is not ops.STAGE1 and id(t) not in copies:
                    copies[id(t)] = t.clone()
    plain = [[(copies[id(out)], [s if s is ops.STAGE1 else copies[id(s)] for s in streams])
              for out, streams in leaf] for leaf in leaves]
    ref.stream_gd_foreach(plain, [ops.coeffs_f32(c) for c in coeffs])
    return plain


def _gd_leaf(g, n, types, out_t, in_place, offset, two_stages, card):
    """One leaf: stage 1 over ``types`` (into the first stream, or a fresh
    output); with ``two_stages``, stage 2 w <- (w bf16, STAGE1) in place."""
    def new(dt):
        return torch.randn(n + offset, generator=g, device=card).to(getattr(torch, dt))[offset:]

    streams = [new(t) for t in types]
    out = streams[0] if in_place else new(out_t)
    leaf = [(out, streams)]
    if two_stages:
        w = new("bfloat16")
        leaf.append((w, [w, ops.STAGE1]))
    return leaf


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("m", [8 * 4099, 1003])
@pytest.mark.parametrize("types,out_t,in_place", GD_CASES)
@pytest.mark.parametrize("form", ["one leaf", "foreach", "two stages"])
def test_stream_gd_kernel_bit_equal_to_plain(card, form, types, out_t, in_place, m, offset):
    """Separate float32 products and sums in stream order on both sides: the
    same bits.  ``offset`` 1 puts every stream off 16 bytes (element path);
    m = 1003 leaves a tail past the last 8.  "one leaf" is ``stream_gd_into``;
    "foreach" one launch over leaves of 1, 7, 64 and m elements; "two stages"
    the same leaves with a second stage that reads the first's output (two
    stages take at most 4 streams each, so the 8-stream case keeps its
    first 4)."""
    g = torch.Generator(device=card).manual_seed(len(types))
    coeffs = [0.999, -0.05, 0.5, 1.0, -2.0, 0.25, 3.0, -0.125][:len(types)]
    before = ops.LAUNCHES["stream_gd"]
    if form == "one leaf":
        (out, streams), = _gd_leaf(g, m, types, out_t, in_place, offset, False, card)
        want = ref.stream_gd([t.clone() for t in streams], ops.coeffs_f32(coeffs),
                             getattr(torch, out_t))
        got = ops.stream_gd_into(out, streams, coeffs)
        torch.cuda.synchronize()
        assert got is out and ops.LAUNCHES["stream_gd"] == before + 1
        assert got.dtype == want.dtype and torch.equal(got, want)
        return
    two = form == "two stages"
    if two:
        types, coeffs = types[:4], coeffs[:4]
    stage_coeffs = [coeffs] + ([[0.999, -1e-3]] if two else [])
    leaves = [_gd_leaf(g, n, types, out_t, in_place, offset, two, card) for n in (1, 7, 64, m)]
    plain = _plain_foreach(leaves, stage_coeffs)
    ops.stream_gd_foreach(leaves, stage_coeffs)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["stream_gd"] == before + 1
    for leaf, want in zip(leaves, plain):
        for (got, _), (w, _) in zip(leaf, want):
            assert got.dtype == w.dtype and torch.equal(got, w)


@pytest.mark.parametrize("two_stages", [False, True], ids=["one stage", "two stages"])
def test_stream_gd_foreach_splits_a_long_leaf_list(card, two_stages):
    """A leaf list longer than one launch's table goes out in several
    launches, each counted, and still gives the plain version's bits."""
    cap = ops.stream_gd_capacity((2, 2) if two_stages else (2,))
    g = torch.Generator(device=card).manual_seed(5)
    leaves = []
    for i in range(cap + 3):
        m = torch.randn(1 + (i * 37) % 300, generator=g, device=card)
        grad = torch.randn(m.shape, generator=g, device=card).to(torch.bfloat16)
        leaf = [(m, [m, grad])]
        if two_stages:
            w = torch.randn(m.shape, generator=g, device=card).to(torch.bfloat16)
            leaf.append((w, [w, ops.STAGE1]))
        leaves.append(leaf)
    coeffs = [[0.9, 1.0]] + ([[0.999, -1e-3]] if two_stages else [])
    plain = _plain_foreach(leaves, coeffs)
    before = ops.LAUNCHES["stream_gd"]
    ops.stream_gd_foreach(leaves, coeffs)
    torch.cuda.synchronize()
    assert cap > 14 and ops.LAUNCHES["stream_gd"] == before + 2
    for leaf, want in zip(leaves, plain):
        for (got, _), (w, _) in zip(leaf, want):
            assert torch.equal(got, w)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_train_steps_on_card_match_cpu(card, opt, n_micro):
    """Reduced qwen2.5-3b in float32: the same weights and batches on the
    card (stream_gd kernel, cuBLAS in full float32) and on the CPU; losses,
    grad norms and parameters within 1e-4 (sum orders differ)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.optim import get_optimizer
    from repro_torch.train.train_step import make_train_step

    model = build_model(dataclasses.replace(get_arch("qwen2.5-3b").reduced(), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for dev in ("cpu", card):
        # adamw at its default lr (3e-4): its step lr * m / (sqrt(v) + eps)
        # turns sum-order noise in a gradient element near eps into a change
        # of up to lr (at lr 1e-2, 3.8e-4 on two of 65,536 elements)
        o = get_optimizer(opt, **({} if opt == "adamw" else {"lr": 1e-2}))
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        state = o.init(p)
        step = make_train_step(model, o, n_microbatches=n_micro)
        rng = np.random.default_rng(0)
        ops.reset_launches()
        metrics = []
        for _ in range(3):
            toks = torch.from_numpy(rng.integers(0, 512, size=(4, 25)).astype(np.int32)).to(dev)
            p, state, m = step(p, state, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[str(dev)] = (metrics, p, ops.LAUNCHES["stream_gd"])
    (cm, cp, cl), (gm, gp, gl) = runs["cpu"], runs["cuda"]
    per_step = {"sgd": 1, "momentum": 1, "adamw": 0}[opt]       # one launch over 14 leaves
    assert (cl, gl) == (0, 3 * per_step)
    np.testing.assert_allclose(gm, cm, rtol=1e-4)
    for (_, a), (_, b) in zip(tree_items(gp), tree_items(cp)):
        torch.testing.assert_close(a.cpu(), b, **F32)


# ---------------------------------------------------------------------------
# the host tier: swap-out read through paged_gather, round trips, restores
# staged on another thread
# ---------------------------------------------------------------------------


def _random_cache(card, arch, dtype, n_pages=24, host_pages=24):
    """A reduced ``arch`` paged cache on the card (2 lanes, 4-token pages)
    whose every pool holds random values."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items
    from repro_torch.serve import PagedKVCache

    model = build_model(dataclasses.replace(get_arch(arch).reduced(), dtype=dtype))
    cache = PagedKVCache(model, lanes=2, n_pages=n_pages, page_size=4, max_len=32,
                         device=card, host_pages=host_pages)
    g = torch.Generator(device=card).manual_seed(0)
    for _, x in tree_items(cache.pools):
        x.copy_(torch.randn(x.shape, generator=g, device=card).to(x.dtype))
    return cache


@pytest.mark.parametrize("arch,dtype", [("qwen2.5-3b", "bfloat16"), ("qwen2.5-3b", "float32"),
                                        ("recurrentgemma-9b", "bfloat16"),
                                        ("deepseek-v3-671b", "bfloat16")])
def test_swap_out_read_is_one_gather_launch(card, arch, dtype):
    """Every seq leaf of the cache tree comes off the card in one
    ``paged_gather_many`` launch, bit-equal to ``pool[:, idx]``, into pinned
    host tensors."""
    from repro_torch.models.common import tree_items
    from repro_torch.serve.paged_cache import read_pages
    from repro_torch.serve.paged_cache import _is_seq

    cache = _random_cache(card, arch, dtype)
    seq = [(path, x) for path, x in tree_items(cache.pools) if _is_seq(path)]
    assert len(seq) >= 2
    pages = [5, 0, 17, 3, 3, 11]
    before = ops.LAUNCHES["paged_gather"]
    got = read_pages(cache.pools, pages)
    assert ops.LAUNCHES["paged_gather"] == before + 1
    idx = torch.tensor(pages, device=card)
    for path, x in seq:
        assert got[path].is_pinned()
        assert torch.equal(got[path], x[:, idx].cpu()), path


def test_swap_out_read_splits_past_the_table_cache(card):
    """A dirty list longer than the table a block keeps in shared memory goes
    out in one launch per piece, each counted, the rows bit-equal."""
    from repro_torch.serve.paged_cache import read_pages

    cap = ops.paged_gather_table_cache()
    g = torch.Generator(device=card).manual_seed(1)
    pools = [{"s0_attn": {"k": torch.randn(2, 64, 4, 2, 8, generator=g, device=card),
                          "v": torch.randn(2, 64, 4, 2, 8, generator=g, device=card)}}]
    pages = torch.randint(0, 64, (cap + 5,), generator=g, device=card).tolist()
    before = ops.LAUNCHES["paged_gather"]
    got = read_pages(pools, pages)
    assert ops.LAUNCHES["paged_gather"] == before + 2
    idx = torch.tensor(pages, device=card)
    for leaf in ("k", "v"):
        assert torch.equal(got[(0, "s0_attn", leaf)], pools[0]["s0_attn"][leaf][:, idx].cpu())


def _snapshot(cache):
    from repro_torch.models.common import tree_items

    return {path: x.clone() for path, x in tree_items(cache.pools)}


def _assert_moved(cache, before, pages, new_pages, lane_from, lane_to):
    from repro_torch.models.common import tree_items
    from repro_torch.serve.paged_cache import _is_seq

    for path, a in tree_items(cache.pools):
        b = before[path]
        if _is_seq(path):
            for lp, pp in zip(pages, new_pages):
                assert torch.equal(b[:, lp], a[:, pp]), path
        else:
            assert torch.equal(b[:, lane_from], a[:, lane_to]), path


@pytest.mark.parametrize("arch,dtype", [("qwen2.5-3b", "bfloat16"),
                                        ("recurrentgemma-9b", "bfloat16"),
                                        ("recurrentgemma-9b", "float32"),
                                        ("mamba2-130m", "float32")])
def test_swap_roundtrip_on_card_bit_equal(card, arch, dtype):
    """swap-out → scramble → swap-in leaves the pages and the lane state
    bit-equal, in new pages and another lane."""
    from repro_torch.models.common import tree_items

    cache = _random_cache(card, arch, dtype)
    pages = cache.allocator.acquire(5)
    cache.assign_lane(0, pages)
    before = _snapshot(cache)
    handle = cache.swap_out(pages, lane=0, length=18)
    assert handle.clean_pages == 4 and len(handle.host_pages) == 5
    for _, x in tree_items(cache.pools):
        x.add_(1)
    cache.allocator.release(pages)
    cache.clear_lane(0)
    new_pages = cache.allocator.acquire(5)
    state = cache.swap_in(handle, new_pages)
    assert (state is None) == (not cache.has_state_leaves())
    if state is not None:
        cache.write_state(1, state)
    torch.cuda.synchronize()
    _assert_moved(cache, before, pages, new_pages, 0, 1)
    assert cache.host.stats["device_gets"] == len(list(tree_items(cache.pools)))


def test_restore_staged_on_another_thread(card):
    """A restore staged on a worker thread and scattered by the caller's
    thread gives the pools a synchronous restore gives, even when the host
    pages are freed and overwritten by another swap-out in between (each
    restore copies from a staging tensor of its own)."""
    import threading

    from repro_torch.models.common import tree_items

    cache = _random_cache(card, "recurrentgemma-9b", "bfloat16")
    pages = cache.allocator.acquire(5)
    before = _snapshot(cache)
    handle = cache.swap_out(pages, lane=0, length=18)
    staged = {}
    t = threading.Thread(target=lambda: staged.update(out=cache.stage_in(handle)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and "out" in staged
    host_pages = list(handle.host_pages)
    cache.host_free(handle)
    # another victim's swap-out takes the same host pages and overwrites them
    for _, x in tree_items(cache.pools):
        x.mul_(-1)
    other = cache.swap_out(pages, lane=1, length=18)
    assert sorted(other.host_pages) == sorted(host_pages)
    rows, state = staged["out"]
    new_pages = cache.allocator.acquire(5)
    cache.commit_swap_in(rows, new_pages)
    cache.write_state(0, state)
    torch.cuda.synchronize()
    _assert_moved(cache, before, pages, new_pages, 0, 0)
    # the synchronous restore of the other victim: its own (negated) rows
    sync_pages = cache.allocator.acquire(5)
    cache.write_state(1, cache.swap_in(other, sync_pages))
    torch.cuda.synchronize()
    for path, a in tree_items(cache.pools):
        if path[-1] in ("k", "v"):
            for lp, pp in zip(pages, sync_pages):
                assert torch.equal(-before[path][:, lp], a[:, pp]), path
        else:
            assert torch.equal(-before[path][:, 1], a[:, 1]), path


def _reduced_qwen(card):
    """Reduced qwen2.5-3b in float32 with seeded weights on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map

    model = build_model(dataclasses.replace(get_arch("qwen2.5-3b").reduced(), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return model, tree_map(lambda t: t.to(card), params)


def _serve_on_card(card, model, params, temps=(0.0,) * 6, generator=None, trace=False,
                   async_prefill=True, n_pages=7, **cache):
    """6 requests on 3 lanes of a 7-page pool of 4-token pages (the pool runs
    dry mid-decode); (tokens, engine)."""
    from repro_torch.serve import (
        AdmissionConfig, CacheConfig, EngineConfig, ObsConfig, Request, ServeEngine)

    eng = ServeEngine(model, params, EngineConfig(
        batch_slots=3, max_len=32,
        cache=CacheConfig(page_size=4, n_pages=n_pages, swap_token_cost=0.0, **cache),
        admission=AdmissionConfig(async_prefill=async_prefill, prefill_chunk=3),
        obs=ObsConfig(trace=trace)), device=card)
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(0, 512, size=(7 + i % 3,)).astype(np.int32),
                    max_new_tokens=9, temperature=t) for i, t in enumerate(temps)]
    for r in reqs:
        eng.submit(r)
    eng.run(generator)
    torch.cuda.synchronize()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


def test_traced_engine_on_card_gives_untraced_tokens(card, tmp_path):
    from repro_torch.obs.export import validate_lifecycles

    model, params = _reduced_qwen(card)
    plain, _ = _serve_on_card(card, model, params)
    traced, eng = _serve_on_card(card, model, params, trace=True)
    assert traced == plain
    trace = eng.save_trace(str(tmp_path / "trace.json"))
    assert set(validate_lifecycles(trace)) == set(range(6))
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"engine.step", "decode.batch", "prefill.chunk", "pages.free"} <= names
    assert eng.tracer.dropped == 0


def test_sampler_draws_stay_on_the_generators_device(card):
    from repro_torch.serve import sample_tokens

    g = torch.Generator(device=card).manual_seed(0)
    rows = torch.randn(5, 4096, generator=g, device=card)
    temps = torch.tensor([0.5, 1.0, 2.0, 0.8, 1e-4], device=card)
    draws = [sample_tokens(rows, temps, torch.Generator(device=card).manual_seed(9))
             for _ in range(2)]
    assert draws[0].device.type == "cuda" and draws[0].dtype == torch.long
    assert torch.equal(draws[0], draws[1])                 # one seed, one draw
    assert int(draws[0][4]) == int(rows[4].argmax())       # a cold row: its argmax
    model, params = _reduced_qwen(card)
    temps6 = (100.0, 0.0, 100.0, 0.8, 0.0, 2.0)
    runs = [_serve_on_card(card, model, params, temps6, torch.Generator(device=card).manual_seed(4),
                           async_prefill=False, n_pages=None)[0] for _ in range(2)]
    greedy, eng = _serve_on_card(card, model, params, temps6, async_prefill=False, n_pages=None)
    assert runs[0] == runs[1]
    assert runs[0][1] == greedy[1] and runs[0][4] == greedy[4]
    with pytest.raises(ValueError, match="generator"):
        eng.run(torch.Generator())                         # a CPU generator on a card engine


def test_sanitized_reduced_run_on_card_raises_nothing(card):
    from repro_torch.analysis import sanitizer

    model, params = _reduced_qwen(card)
    want, _ = _serve_on_card(card, model, params)
    sanitizer.enable()
    try:
        got, eng = _serve_on_card(card, model, params)
        shared, _ = _serve_on_card(card, model, params, n_pages=None, prefix_sharing=True)
    finally:
        sanitizer.disable()
    assert got == want and shared == want
    assert eng.cache.allocator.n_free == eng.cache.n_pages


def _graph_family(arch, dtype):
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    over = dict(n_layers=5) if arch == "recurrentgemma-9b" else {}
    model = build_model(dataclasses.replace(get_arch(arch).reduced(), dtype=dtype, **over))
    return model, model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")


# the reduced four families (the moe one with MLA and with GQA) on the
# forced-preemption cell: 3 lanes on 7 pages of 4 tokens, so lanes retire,
# admit and swap back in while the steps are compared
GRAPH_ARCHS = ["qwen2.5-3b", "mamba2-130m", "recurrentgemma-9b", "deepseek-v3-671b",
               "qwen3-moe-235b-a22b"]


def _captured_step_bit_equal_to_eager(arch, path, dtype):
    """A captured engine and an eager one (``cuda_graph=False``) stepped in
    lockstep on the same requests: after every step the replayed logits
    rows, the greedy tokens and every pool leaf equal the eager step's bit
    for bit, through lane retirements, admissions and swap-ins (the table,
    positions and flags rewritten in place).  Then n replays count n times
    one step's launches."""
    from repro_torch.models.common import tree_items
    from repro_torch.serve import (
        AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine)

    model, params = _graph_family(arch, dtype)
    engines = []
    for graph in (True, False):
        eng = ServeEngine(model, params, EngineConfig(
            batch_slots=3, max_len=32, cuda_graph=graph,
            cache=CacheConfig(page_size=4, n_pages=7, decode_path=path, swap_token_cost=0.0),
            admission=AdmissionConfig(async_prefill=False)), device="cuda")
        rng = np.random.default_rng(7)
        for i in range(5):
            eng.submit(Request(uid=i, max_new_tokens=12, prompt=rng.integers(
                0, model.cfg.vocab_size, size=(7,)).astype(np.int32)))
        engines.append(eng)
    cap, eager = engines
    assert cap.decode_graph.graph is not None and eager.decode_graph.graph is None
    steps = 0
    while cap.load or eager.load:
        more = [cap.step(), eager.step()]
        assert more[0] == more[1]
        assert cap.decode_graph.runs - 1 == eager.decode_graph.runs     # 1: the warm-up
        torch.cuda.synchronize()
        assert torch.equal(cap.decode_graph.rows, eager.decode_graph.rows)
        assert torch.equal(cap.decode_graph.greedy, eager.decode_graph.greedy)
        for (name, a), (_, b) in zip(tree_items(cap.cache.pools), tree_items(eager.cache.pools)):
            assert torch.equal(a, b), (steps, name)
        steps += 1
    assert eager.decode_graph.runs > 0
    assert cap.sched.n_swap_preemptions > 0
    assert [r.out_tokens for r in cap.completed] == [r.out_tokens for r in eager.completed]
    # replays count the captured launches
    per_step = cap.decode_graph.launches
    n_attn = sum(reps * sum(k != "ssm" and k != "rec" for k in pattern)
                 for pattern, reps in model.segments)
    # one write per attention layer on the paged path (k and v, or latent
    # and k_rope, together), one per step on the gather path; mamba2 none
    assert per_step.get("paged_write", 0) == (min(n_attn, 1) if path == "gather" else n_attn)
    ops.reset_launches()
    for _ in range(4):
        cap.decode_graph(cap.cache.pools)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        k: 4 * v for k, v in per_step.items() if v}


def _capture_waits_for_no_collection():
    """A collection due while an engine captures its step, with another
    captured engine garbage by then (engines are reference cycles), runs
    only after the capture: a graph destroyed while a stream captures
    invalidates the capture.  The new engine then serves the eager
    engine's tokens."""
    import gc

    from repro_torch.serve import (
        AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine, captured)

    model, params = _graph_family("qwen2.5-3b", "float32")
    ecfg = EngineConfig(batch_slots=3, max_len=32, cache=CacheConfig(page_size=4, n_pages=7),
                        admission=AdmissionConfig(async_prefill=False))
    held = [ServeEngine(model, params, ecfg, device="cuda")]
    run, thresholds = captured.CapturedDecode._run, gc.get_threshold()

    def run_dropping_the_old_engine(self):
        if torch.cuda.is_current_stream_capturing() and held:
            held.clear()                    # garbage now, freed by the next collection
            gc.set_threshold(1)             # which the next allocation would run
        run(self)

    captured.CapturedDecode._run = run_dropping_the_old_engine
    try:
        engines = [ServeEngine(model, params, ecfg, device="cuda"),
                   ServeEngine(model, params, dataclasses.replace(ecfg, cuda_graph=False),
                               device="cuda")]
    finally:
        captured.CapturedDecode._run = run
        gc.set_threshold(*thresholds)
    assert not held and engines[0].decode_graph.graph is not None
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=(7,)).astype(np.int32)
               for _ in range(3)]
    got = []
    for eng in engines:
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        got.append([r.out_tokens for r in reqs])
    assert got[0] == got[1]


EXTEND_ARCHS = ["qwen2.5-3b", "mamba2-130m", "recurrentgemma-9b"]


def _captured_extend_bit_equal_to_eager(arch, dtype):
    """A captured engine and an eager one (``cuda_graph=False``) with 8-token
    prefill chunks, stepped in lockstep (inline admission) on prompts of
    full chunks and a tail: after every step each prefill slot's logits row
    and tree, the pools and the tokens equal the eager engine's bit for bit;
    a full chunk is one replay (flash: one launch per attention layer, as
    captured)."""
    from repro_torch.models.common import tree_items
    from repro_torch.serve import (
        AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine)

    model, params = _graph_family(arch, dtype)
    engines = []
    for graph in (True, False):
        eng = ServeEngine(model, params, EngineConfig(
            batch_slots=2, max_len=48, cuda_graph=graph, cache=CacheConfig(page_size=4),
            admission=AdmissionConfig(prefill_chunk=8, async_prefill=False)), device="cuda")
        rng = np.random.default_rng(7)
        for i, n in enumerate((21, 5, 16, 13)):
            eng.submit(Request(uid=i, max_new_tokens=6, prompt=rng.integers(
                0, model.cfg.vocab_size, size=(n,)).astype(np.int32)))
        engines.append(eng)
    cap, eager = engines
    cs, es = cap.prefill_slots, eager.prefill_slots
    assert all(g is not None for g in cs.graphs) and es.graphs == [None, None]
    while cap.load or eager.load:
        assert cap.step() == eager.step()
        assert cs.runs - 1 == es.runs and cs.eager_runs == es.eager_runs   # 1: the warm-up
        torch.cuda.synchronize()
        for a, b, ta, tb in zip(cs.rows, es.rows, cs.trees, es.trees):
            assert torch.equal(a, b)
            for (name, x), (_, y) in zip(tree_items(ta), tree_items(tb)):
                assert torch.equal(x, y), name
        for (name, a), (_, b) in zip(tree_items(cap.cache.pools), tree_items(eager.cache.pools)):
            assert torch.equal(a, b), name
    assert es.runs == 5 and es.eager_runs == 3 and cs.in_use == 0
    assert [r.out_tokens for r in cap.completed] == [r.out_tokens for r in eager.completed]
    n_attn = sum(reps * sum(k in ("dense", "attn") for k in pattern)
                 for pattern, reps in model.segments)
    assert cs.launches.get("flash_attention", 0) == n_attn
    assert cs.launches.get("ssd_scan", 0) == (model.cfg.n_layers if arch == "mamba2-130m" else 0)
    ops.reset_launches()
    slot = cs.take()
    cs.zero(slot)
    for i in range(3):
        cs(slot, cs.trees[slot], params, np.zeros(8, np.int32), 8 * i)
    torch.cuda.synchronize()
    cs.release(slot)
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        k: 3 * v for k, v in cs.launches.items() if v}


def _extend_capture_checks_and_failures():
    """A captured slot refuses a reallocated tree and reallocated
    parameters; a step that reads the device back fails its capture, and
    the engine raises instead of running the extend eagerly."""
    from repro_torch.models.common import tree_map
    from repro_torch.serve import AdmissionConfig, EngineConfig, ServeEngine, captured

    model, params = _graph_family("qwen2.5-3b", "float32")
    ecfg = EngineConfig(batch_slots=2, max_len=32,
                        admission=AdmissionConfig(prefill_chunk=8, async_prefill=False))
    slots = ServeEngine(model, params, ecfg, device="cuda").prefill_slots
    toks = np.zeros(8, np.int32)
    slots(0, slots.trees[0], params, toks, 0)
    slots.trees[0] = tree_map(torch.clone, slots.trees[0])
    for slot, p in ((0, params), (1, tree_map(torch.clone, params))):
        try:
            slots(slot, slots.trees[slot], p, toks, 8)
        except RuntimeError as e:
            assert "reallocated" in str(e)
        else:
            raise AssertionError("a reallocated slot or parameter set was not refused")
    run = captured.CapturedExtend._run

    def reads_back(self, slot, p):
        run(self, slot, p)
        if torch.cuda.is_current_stream_capturing():
            int(self.rows[slot].argmax())

    captured.CapturedExtend._run = reads_back
    try:
        ServeEngine(model, params, ecfg, device="cuda")
    except RuntimeError:
        pass
    else:
        raise AssertionError("a capture that read the device back did not raise")
    finally:
        captured.CapturedExtend._run = run


def _router_on_card_matches_cpu(policy):
    """Reduced qwen2.5-3b in float32 routed over two cubes (``CubeRouter``)
    on the card and on the CPU, the same weights and waves of requests (for
    ``prefix_affinity``: a shared prompt made resident on one cube, then
    four extensions of it and one other prompt): the same cube choices and
    tokens, each card engine its own captured step and pools over the one
    parameter set."""
    from repro_torch.models.common import tree_map
    from repro_torch.serve import (
        AdmissionConfig, CacheConfig, CubeRouter, EngineConfig, Request)

    model, params = _graph_family("qwen2.5-3b", "float32")
    prefix = policy == "prefix_affinity"
    ecfg = EngineConfig(batch_slots=2, max_len=48,
                        cache=CacheConfig(page_size=4, n_pages=24, prefix_sharing=prefix),
                        admission=AdmissionConfig(async_prefill=False,
                                                  prefill_chunk=4 if prefix else 0))
    rng = np.random.default_rng(11)
    draw = lambda n: rng.integers(0, model.cfg.vocab_size, size=(n,)).astype(np.int32)  # noqa: E731
    if prefix:
        shared = draw(12)
        waves = [[shared], [np.concatenate([shared, draw(3 + i)]) for i in range(4)] + [draw(9)]]
    else:
        waves = [[draw(int(n)) for n in rng.integers(5, 12, size=6)]]
    out = {}
    for dev, p in (("cpu", tree_map(lambda t: t.cpu(), params)), ("cuda", params)):
        router = CubeRouter(model, p, ecfg, n_cubes=2, policy=policy, device=dev)
        cubes, toks, uid = [], [], 0
        for wave in waves:
            reqs = [Request(uid=uid + i, prompt=pr, max_new_tokens=6) for i, pr in enumerate(wave)]
            uid += len(wave)
            cubes += [router.submit(r) for r in reqs]
            router.run()
            toks += [r.out_tokens for r in reqs]
        out[dev] = (cubes, toks)
        if dev == "cuda":
            e0, e1 = router.engines
            assert e0.decode_graph.graph is not None and e1.decode_graph.graph is not None
            assert e0.params is e1.params is p
    assert out["cpu"] == out["cuda"]


def _migration_on_card_matches_cpu(arch):
    """A request exported mid-decode (through the wire format and a pickle)
    and landed on a second engine by put-then-signal, and one checkpointed
    and adopted as a shadow, on the card and on the CPU (reduced, float32):
    the same tokens, equal to the uninterrupted run's; on the card the
    receiving engines' pools keep their storage and their captured steps
    replay after the landing."""
    import pickle

    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.serve import (
        AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine)
    from repro_torch.serve.cube_proc import pack_payload, unpack_payload

    model, params = _graph_family(arch, "float32")
    ecfg = EngineConfig(batch_slots=2, max_len=32,
                        cache=CacheConfig(page_size=4, n_pages=16, swap_token_cost=0.0),
                        admission=AdmissionConfig(async_prefill=False))

    def reqs():
        rng = np.random.default_rng(7)
        return [Request(uid=i, max_new_tokens=10, prompt=rng.integers(
            0, model.cfg.vocab_size, size=(7,)).astype(np.int32)) for i in range(3)]

    def drain(eng):
        while eng.load or eng.pending_migrations():
            eng.step()
        return {r.uid: r.out_tokens for r in eng.completed}

    def started(dev, p):
        eng = ServeEngine(model, p, ecfg, device=dev)
        for r in reqs():
            eng.submit(r)
        for _ in range(6):
            eng.step()
        uid = next(u for u in eng.inflight_uids()
                   if any(s.req.uid == u for s in eng.sched.running.values()))
        return eng, uid

    def ptrs(eng):
        return {path: t.data_ptr() for path, t in tree_items(eng.cache.pools)}

    out = {}
    for dev, p in (("cpu", tree_map(lambda t: t.cpu(), params)), ("cuda", params)):
        base = ServeEngine(model, p, ecfg, device=dev)
        for r in reqs():
            base.submit(r)
        want = drain(base)
        a, uid = started(dev, p)
        b = ServeEngine(model, p, ecfg, device=dev)
        before, runs = ptrs(b), b.decode_graph.runs
        payload = unpack_payload(pickle.loads(pickle.dumps(pack_payload(a.export_request(uid)))))
        assert payload["kind"] == "pages"
        assert b.migrate_put("m0", payload) == "pages"
        b.migrate_signal("m0")
        migrated = {**drain(a), **drain(b)}
        assert migrated == want and ptrs(b) == before
        assert b.telemetry()["migrations"]["resumed"] == 1
        a, uid = started(dev, p)
        c = ServeEngine(model, p, ecfg, device=dev)
        c.shadow_put(uid, unpack_payload(pack_payload(a.checkpoint_request(uid))))
        c.shadow_signal(uid)
        assert drain(a) == want
        before_c = ptrs(c)
        assert c.adopt_shadow(uid)
        adopted = drain(c)
        assert adopted == {uid: want[uid]} and ptrs(c) == before_c
        out[dev] = (want, migrated, adopted)
        if dev == "cuda":
            assert b.decode_graph.graph is not None and b.decode_graph.runs > runs
    assert out["cpu"] == out["cuda"]


# The tests that capture engines' decode steps run in a process of their
# own: once they had run, the profiles of later tests in the same process
# (H100, torch 2.11) held no device kernel, or only some, where the
# profiled kernel tests check names and counts.
_CHILD = """
import json, sys, traceback
sys.path.insert(0, sys.argv[1])
import test_torch_cuda as t
out = {}
for name, args in json.loads(sys.argv[2]):
    try:
        getattr(t, name)(*args)
        out[name + repr(tuple(args))] = "ok"
    except Exception:
        out[name + repr(tuple(args))] = traceback.format_exc()
print("CHILD " + json.dumps(out))
"""
ROUTER_POLICIES = ["hash", "least_loaded", "prefix_affinity"]
MIGRATION_ARCHS = ["qwen2.5-3b", "mamba2-130m", "recurrentgemma-9b", "deepseek-v3-671b"]
_CHILD_CASES = ([("_captured_step_bit_equal_to_eager", [a, p, d]) for a in GRAPH_ARCHS
                 for p in ("paged", "gather") for d in ("float32", "bfloat16")]
                + [("_capture_waits_for_no_collection", [])]
                + [("_router_on_card_matches_cpu", [p]) for p in ROUTER_POLICIES]
                + [("_migration_on_card_matches_cpu", [a]) for a in MIGRATION_ARCHS]
                + [("_captured_extend_bit_equal_to_eager", [a, d]) for a in EXTEND_ARCHS
                   for d in ("float32", "bfloat16")]
                + [("_extend_capture_checks_and_failures", [])])


@pytest.fixture(scope="module")
def _captured_in_child():
    """Every case of ``_CHILD_CASES`` run in one child process: name and
    arguments -> "ok" or the traceback."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(here.parent / "src"), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(here), json.dumps(_CHILD_CASES)],
                          env=env, capture_output=True, text=True, timeout=900)
    line = [x for x in proc.stdout.splitlines() if x.startswith("CHILD ")]
    assert proc.returncode == 0 and line, proc.stderr[-4000:]
    return json.loads(line[-1].split(" ", 1)[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["paged", "gather"])
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_captured_step_bit_equal_to_eager(card, _captured_in_child, arch, path, dtype):
    """``_captured_step_bit_equal_to_eager`` (run in the child process)."""
    got = _captured_in_child[f"_captured_step_bit_equal_to_eager{(arch, path, dtype)!r}"]
    assert got == "ok", got


def test_capture_waits_for_no_collection(card, _captured_in_child):
    """``_capture_waits_for_no_collection`` (run in the child process)."""
    got = _captured_in_child["_capture_waits_for_no_collection()"]
    assert got == "ok", got


@pytest.mark.parametrize("path", ["paged", "gather"])
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_eager_step_reads_nothing_back(card, arch, path):
    """The decode step run eagerly (``cuda_graph=False``) with lanes
    decoding raises nothing under ``set_sync_debug_mode("error")``: no host
    read, so capture has nothing to break on."""
    from repro_torch.serve import (
        AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine)

    model, params = _graph_family(arch, "bfloat16")
    eng = ServeEngine(model, params, EngineConfig(
        batch_slots=3, max_len=32, cuda_graph=False,
        cache=CacheConfig(page_size=4, decode_path=path),
        admission=AdmissionConfig(async_prefill=False)), device=card)
    rng = np.random.default_rng(7)
    for i in range(2):
        eng.submit(Request(uid=i, max_new_tokens=8, prompt=rng.integers(
            0, model.cfg.vocab_size, size=(7,)).astype(np.int32)))
    while len(eng.sched.running) < 2:
        eng.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.decode_graph(eng.cache.pools)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    eng.run()


@pytest.mark.parametrize("policy", ROUTER_POLICIES)
def test_router_on_card_matches_cpu(card, _captured_in_child, policy):
    """``_router_on_card_matches_cpu`` (run in the child process)."""
    got = _captured_in_child[f"_router_on_card_matches_cpu{(policy,)!r}"]
    assert got == "ok", got


@pytest.mark.parametrize("arch", MIGRATION_ARCHS)
def test_migration_on_card_matches_cpu(card, _captured_in_child, arch):
    """``_migration_on_card_matches_cpu`` (run in the child process)."""
    got = _captured_in_child[f"_migration_on_card_matches_cpu{(arch,)!r}"]
    assert got == "ok", got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", EXTEND_ARCHS)
def test_captured_extend_bit_equal_to_eager(card, _captured_in_child, arch, dtype):
    """``_captured_extend_bit_equal_to_eager`` (run in the child process)."""
    got = _captured_in_child[f"_captured_extend_bit_equal_to_eager{(arch, dtype)!r}"]
    assert got == "ok", got


def test_extend_capture_checks_and_failures(card, _captured_in_child):
    """``_extend_capture_checks_and_failures`` (run in the child process)."""
    got = _captured_in_child["_extend_capture_checks_and_failures()"]
    assert got == "ok", got
