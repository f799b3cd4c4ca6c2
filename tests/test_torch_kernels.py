"""The port's attention wrappers and plain kernels against the JAX package's.

The same numpy inputs (float32, from a seed) go through
``repro_torch.kernels`` on the CPU (the plain PyTorch versions) and through
the JAX oracle (``repro.kernels.ref``) and the Pallas kernel in interpret
mode (``repro.kernels.ops``).  Tolerance: float32 atol = rtol = 1e-5 — both
sides compute in float32 and only the summation order differs (XLA:CPU vs
PyTorch).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
# every kernel the port counts launches of
KERNELS = ("paged_decode_attention", "flash_attention", "stream_mac_conv", "stream_maxpool",
           "tiled_matmul", "ssd_scan", "paged_gather", "stream_gd")

# id, b, h, hkv, sq, sk, d, causal, window, q_offset, kv_len
FLASH_CASES = [
    ("causal_rep1", 1, 2, 2, 16, 16, 32, True, None, 0, None),
    ("noncausal_rep2_sq_ne_sk", 2, 4, 2, 10, 30, 64, False, None, 0, None),
    ("causal_rep4_q_offset", 1, 8, 2, 8, 24, 32, True, None, 16, None),
    ("window", 1, 4, 2, 32, 32, 32, True, 8, 0, None),
    ("kv_len", 1, 4, 2, 8, 32, 32, True, None, 12, 20),
    ("fully_masked_rows", 1, 4, 2, 4, 16, 32, True, 4, 20, 8),
    # the ratios and head dims the card's wgmma design serves: rep 16 at D 128
    # (qwen3-moe), and at D 256 a windowed chunk at an offset (recurrentgemma)
    ("rep16_d128", 1, 16, 1, 24, 24, 128, True, None, 0, None),
    ("rep16_d256_window_chunk", 1, 16, 1, 8, 40, 256, True, 16, 24, 36),
]


def _flash_inputs(b, h, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_matches_jax(case):
    _, b, h, hkv, sq, sk, d, causal, window, q_offset, kv_len = case
    q, k, v = _flash_inputs(b, h, hkv, sq, sk, d)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len).numpy()
    # the JAX kernels take no kv_len: hand them the first kv_len rows
    n = sk if kv_len is None else kv_len
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k[:, :, :n]), jnp.asarray(v[:, :, :n])
    want = np.asarray(jref.flash_attention(jq, jk, jv, causal=causal, window=window,
                                           q_offset=q_offset))
    np.testing.assert_allclose(got, want, **TOL)
    pallas = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                             q_offset=q_offset, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    if case[0] == "fully_masked_rows":
        assert np.all(got == 0.0)


# (dtype, head dim) -> the design the card launches; the table ``flash_path`` holds
FLASH_DESIGNS = [(torch.float32, d, "CUDA cores") for d in tops.FLASH_HEAD_DIMS] + [
    (torch.bfloat16, 32, "mma.sync 64x64"), (torch.bfloat16, 48, "mma.sync 64x64"),
    (torch.bfloat16, 64, "mma.sync 64x64"), (torch.bfloat16, 128, "wgmma+TMA 128x128"),
    (torch.bfloat16, 192, "wgmma+TMA 128x64"), (torch.bfloat16, 256, "wgmma+TMA 128x64")]


@pytest.mark.parametrize("dtype,d,path", FLASH_DESIGNS,
                         ids=[f"{str(t)[6:]}-{d}" for t, d, _ in FLASH_DESIGNS])
def test_flash_design_table(dtype, d, path):
    assert tops.flash_path(dtype, d) == path
    assert path in tops.FLASH_PATHS


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 96), (torch.float32, 512),
                                     (torch.float16, 128)])
def test_flash_design_table_refuses_what_has_no_design(dtype, d):
    with pytest.raises(ValueError, match="no design"):
        tops.flash_path(dtype, d)


def _paged_inputs(h, hkv, d=32, ps=4, lens=(5, 0, 11), seed=0):
    """Ragged lanes: an empty lane, -1 tails and a -1 hole inside lane 2."""
    rng = np.random.default_rng(seed)
    b, p = len(lens), 4
    n = b * p + 2
    bt = rng.permutation(n)[: b * p].reshape(b, p).astype(np.int32)
    for i, length in enumerate(lens):
        bt[i, -(-length // ps):] = -1
    bt[2, 1] = -1
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((n, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n, ps, hkv, d)).astype(np.float32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


# h, hkv, head dim, page size, lane lengths; rep 8 and 16 at D 128, PS 16 are
# the served shapes (qwen2.5-3b, qwen3-moe): lane 2 fills its table, a hole at slot 1
PAGED_CASES = [(4, 4, 32, 4, (5, 0, 11)), (4, 2, 32, 4, (5, 0, 11)), (8, 2, 32, 4, (5, 0, 11)),
               (16, 2, 128, 16, (37, 0, 64)), (32, 2, 128, 16, (37, 0, 64))]


@pytest.mark.parametrize("h,hkv,d,ps,lens", PAGED_CASES,
                         ids=["rep1", "rep2", "rep4", "rep8_d128_ps16", "rep16_d128_ps16"])
def test_paged_attention_matches_jax(h, hkv, d, ps, lens):
    q, kp, vp, bt, lens = _paged_inputs(h, hkv, d, ps, lens)
    b = q.shape[0]
    got = tops.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                               torch.from_numpy(vp), torch.from_numpy(bt),
                               torch.from_numpy(lens)).numpy()
    jk = jnp.asarray(kp).transpose(2, 0, 1, 3)
    jv = jnp.asarray(vp).transpose(2, 0, 1, 3)
    want = np.asarray(jref.paged_decode_attention(
        jnp.asarray(q).reshape(b, hkv, h // hkv, d), jk, jv, jnp.asarray(bt),
        jnp.asarray(lens))).reshape(b, h, d)
    np.testing.assert_allclose(got, want, **TOL)
    pallas = np.asarray(jops.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    assert np.all(got[1] == 0.0)                     # the empty lane reads zeros
    # the plain version alone, in the oracle's own layout
    plain = tref.paged_decode_attention(
        torch.from_numpy(q).reshape(b, hkv, h // hkv, d),
        torch.from_numpy(kp).permute(2, 0, 1, 3), torch.from_numpy(vp).permute(2, 0, 1, 3),
        torch.from_numpy(bt), torch.from_numpy(lens)).numpy().reshape(b, h, d)
    np.testing.assert_allclose(plain, want, **TOL)


# sm count, lanes, KV heads, table slots, the card's cluster cap -> blocks per pair
PAGED_PLANS = [
    (132, 8, 2, 64, 16, 8),       # qwen2.5-3b decode: 16 pairs x 8 = 128 blocks
    (132, 8, 4, 128, 16, 4),      # qwen3-moe decode: 32 pairs x 4
    (132, 1, 2, 64, 16, 16),      # one lane: the non-portable cluster of 16
    (132, 1, 2, 64, 8, 8),        # ... where the card fits only 8
    (132, 3, 2, 6, 16, 4),        # the reduced model (phase 3): capped by the 6 slots
    (132, 64, 8, 64, 16, 1),      # 512 pairs fill the card unsplit
    (132, 8, 2, 1, 16, 1),        # one slot
    (114, 8, 2, 64, 16, 4),       # a card of 114 SMs
]


@pytest.mark.parametrize("sm,lanes,hkv,slots,cap,want", PAGED_PLANS)
def test_paged_plan_is_a_function_of_the_shape(sm, lanes, hkv, slots, cap, want):
    c = tops.paged_plan(sm, lanes, hkv, slots, cap)
    assert c == want
    pairs = lanes * hkv
    assert c & (c - 1) == 0 and 1 <= c <= min(cap, tops.MAX_CLUSTER)
    assert c == 1 or (c <= slots and pairs * c <= sm)
    assert pairs * c >= pairs                        # every pair has its blocks
    # the largest such: doubling breaks a limit
    assert 2 * c > min(cap, slots) or pairs * 2 * c > sm
    assert tops.paged_plan(sm, lanes, hkv, slots, cap) == c


def test_cpu_calls_launch_nothing_and_other_devices_raise():
    tops.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(1, 4, 2, 8, 8, 32))
    tops.flash_attention(q, k, v)
    qp, kp, vp, bt, lens = (torch.from_numpy(a) for a in _paged_inputs(4, 2))
    tops.paged_attention(qp, kp, vp, bt, lens)
    tops.ssd_scan(torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 4), torch.zeros(1, 8, 4),
                  torch.zeros(1, 8, 2), torch.zeros(2), 4)
    tops.paged_gather(kp.flatten(1), bt)
    tops.stream_gd(torch.zeros(2, 8), [1.0, -0.1])
    assert tops.LAUNCHES == dict.fromkeys(KERNELS, 0)
    # a tensor on neither the CPU nor a card is refused, never run plain
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tops.paged_attention(qp.to("meta"), kp.to("meta"), vp.to("meta"), bt, lens)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tops.paged_gather(kp.flatten(1).to("meta"), bt)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tops.stream_gd(torch.zeros(2, 8, device="meta"), [1.0, -0.1])
    assert tops.LAUNCHES == dict.fromkeys(KERNELS, 0)
