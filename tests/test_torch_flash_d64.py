"""The port's bf16 head-dim-64 flash designs, as far as the CPU can hold them.

On the card ``ops.flash_path`` sends bf16 at head dim 64 to wgmma + TMA when
a (batch, KV head) pair has more than ``ops.FLASH_SPLIT_ROWS`` query rows
(Sq * rep), and else to a design that packs the pair's rows into one 16-row
mma.sync tile and splits its keys over a thread-block cluster
(``csrc/flash_attention.cu``'s ``flash_split_mma``).  The CPU has neither
kernel.  Here ``ops.flash_split_plan``, the split's cluster size, is checked
as a pure function of the shape, and ``split_model``, a plain PyTorch model of
the split and its merge, is held against the plain version
(``kernels.ref``), the JAX oracle and the Pallas kernel in interpret mode.
The model takes the kernel's ranges and order: a block's share of the
16-key tiles some row may see, every fourth tile to each of its four warps,
the warps' (m, l, acc) merged in warp order, then the blocks' in rank order,
a state that saw no key weighted by 0.  Tolerance: float32 atol = rtol =
1e-5 (only the order of the sums differs).
"""
import math

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
TILE, WARPS = 16, 4                  # keys per warp tile, warps per block


def _split_range(s: int, cluster: int, lo: int, hi: int) -> tuple[int, int]:
    """Keys [r_lo, r_hi) of block ``s`` of ``cluster``: its share of the
    16-key tiles of [lo, hi)."""
    tiles = -(-(hi - lo) // TILE) if hi > lo else 0
    per = -(-tiles // cluster)
    t0 = min(s * per, tiles)
    t1 = min(t0 + per, tiles)
    return lo + t0 * TILE, min(lo + t1 * TILE, hi)


def _fold(state, scores, vals):
    """One tile's scores (base 2, -inf where masked) into (m, l, acc)."""
    m, l, acc = state
    m_new = torch.maximum(m, scores.max(-1).values)
    alpha = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp2(m - m_new))
    p = torch.where(scores == -math.inf, torch.zeros_like(scores),
                    torch.exp2(scores - m_new[:, None]))
    return m_new, l * alpha + p.sum(-1), acc * alpha[:, None] + p @ vals


def _merge(states):
    """(m, l, acc) states merged in order, each weighted by 2^(m - max m);
    a state with m = -inf weighs 0."""
    mx = torch.stack([m for m, _, _ in states]).max(0).values
    den, num = 0.0, 0.0
    for m, l, acc in states:
        w = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp2(m - mx))
        den = den + w * l
        num = num + w[:, None] * acc
    return mx, den, num


def split_model(q, k, v, cluster, causal=True, window=None, q_offset=0, kv_len=None):
    """Float32 output (B, H, Sq, D) of the split design with ``cluster``
    blocks per (batch, KV head) pair.  Row r of a pair's tile is query
    r % Sq of head g * rep + r // Sq."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    assert sq * rep <= tops.FLASH_SPLIT_ROWS
    sl2 = d ** -0.5 * math.log2(math.e)
    kv_end = min(sk, sk if kv_len is None else kv_len)
    hi = min(kv_end, q_offset + sq) if causal else kv_end
    lo = max(0, q_offset - window + 1) // TILE * TILE if window else 0
    qpos = (q_offset + torch.arange(sq)).repeat(rep)
    out = torch.zeros(b, h, sq, d)
    for bi in range(b):
        for g in range(hkv):
            qr = q[bi, g * rep:(g + 1) * rep].reshape(rep * sq, d).float()
            blocks = []
            for s in range(cluster):
                r_lo, r_hi = _split_range(s, cluster, lo, hi)
                n = -(-(r_hi - r_lo) // TILE) if r_hi > r_lo else 0
                warps = []
                for w in range(WARPS):
                    state = (torch.full((rep * sq,), -math.inf), torch.zeros(rep * sq),
                             torch.zeros(rep * sq, d))
                    for i in range(w, n, WARPS):
                        keys = r_lo + i * TILE + torch.arange(TILE)
                        ok = (keys < r_hi)[None, :].expand(rep * sq, TILE)
                        if causal:
                            ok = ok & (qpos[:, None] >= keys[None, :])
                        if window:
                            ok = ok & (qpos[:, None] - keys[None, :] < window)
                        rows = keys.clamp(max=sk - 1)          # past r_hi: read as zeros
                        kt = torch.where((keys < r_hi)[:, None], k[bi, g, rows].float(), 0.0)
                        vt = torch.where((keys < r_hi)[:, None], v[bi, g, rows].float(), 0.0)
                        scores = torch.where(ok, (qr @ kt.T) * sl2, -math.inf)
                        state = _fold(state, scores, vt)
                    warps.append(state)
                blocks.append(_merge(warps))
            _, den, num = _merge(blocks)
            inv = torch.where(den > 0, 1.0 / torch.where(den > 0, den, 1.0), 0.0)
            out[bi, g * rep:(g + 1) * rep] = (num * inv[:, None]).reshape(rep, sq, d)
    return out


def _inputs(b, h, hkv, sq, sk, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


# id, b, h, hkv, sq, sk, causal, window, q_offset, kv_len, cluster, pallas
SPLIT_CASES = [
    # whisper's cross-attention at 2 of its 20 heads and fewer frames, the
    # cluster flash_split_plan gives it on a card of 132 SMs
    ("cross_planned", 1, 2, 2, 4, 200, False, None, 0, None, None, True),
    # 13 tiles over 4 blocks: 4, 4, 4, 1
    ("uneven_splits", 1, 2, 2, 4, 200, False, None, 0, None, 4, False),
    # 2 tiles over 4 blocks: blocks 2 and 3 see no key
    ("empty_split", 1, 2, 1, 4, 32, False, None, 0, None, 4, True),
    ("kv_len_short", 1, 2, 2, 3, 150, False, None, 0, 77, 4, False),
    # whisper's decoder prompt: causal, Sk below one tile
    ("decoder_prompt", 2, 2, 2, 4, 4, True, None, 0, None, 1, True),
    ("causal_offset", 1, 2, 2, 4, 130, True, None, 90, 94, 2, False),
    ("window_offset", 1, 8, 2, 2, 160, True, 40, 130, None, 4, False),
    # the whole chunk past the window's reach: every row reads zeros
    ("fully_masked_rows", 1, 4, 4, 4, 64, True, 4, 80, 40, 2, False),
    # 16 rows: rep 4 x 4 queries, and rep 16 x 1 (a decode step's shape)
    ("rows_16_rep4", 1, 8, 2, 4, 100, True, None, 96, None, 2, True),
    ("rows_16_rep16", 1, 16, 1, 1, 70, True, None, 69, None, 8, False),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_model_matches_plain(case):
    name, b, h, hkv, sq, sk, causal, window, q_offset, kv_len, cluster, pallas = case
    q, k, v = _inputs(b, h, hkv, sq, sk)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    if cluster is None:
        cluster = tops.flash_split_plan(132, b, hkv, sk)
    assert tops.flash_path(torch.bfloat16, 64, sq, h // hkv) == "mma.sync split-K 16x16"
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = split_model(tq, tk, tv, cluster, kv_len=kv_len, **kw).numpy()
    plain = tref.flash_attention(tq, tk, tv, kv_len=kv_len, **kw).numpy()
    np.testing.assert_allclose(got, plain, **TOL)
    # the JAX kernels take no kv_len: hand them the first kv_len rows
    n = sk if kv_len is None else kv_len
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k[:, :, :n]), jnp.asarray(v[:, :, :n])
    np.testing.assert_allclose(got, np.asarray(jref.flash_attention(jq, jk, jv, **kw)), **TOL)
    if pallas:
        np.testing.assert_allclose(
            got, np.asarray(jops.flash_attention(jq, jk, jv, interpret=True, **kw)), **TOL)
    if name == "fully_masked_rows":
        assert np.all(got == 0.0)


def test_split_model_device_pair_form():
    """The device-offset form: C is planned from the slot's Sk rows (1,024:
    8 blocks), and the kernel finds the visible keys from the pair it reads,
    so 5 of the 8 blocks see none and merge with weight 0."""
    q, k, v = _inputs(1, 4, 4, 4, 1024)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    cluster = tops.flash_split_plan(132, 1, 4, 1024)
    assert cluster == 8
    pair = torch.tensor([36, 40], dtype=torch.int32)
    seen = [_split_range(s, cluster, 0, 40) for s in range(cluster)]
    assert sum(hi > lo for lo, hi in seen) == 3
    got = split_model(tq, tk, tv, cluster, q_offset=36, kv_len=40)
    plain = tref.flash_attention(tq, tk, tv, q_offset=pair[0], kv_len=pair[1])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    # the wrapper's CPU path takes the pair and gives the host form's bits
    host = tops.flash_attention(tq, tk, tv, q_offset=36, kv_len=40)
    assert torch.equal(tops.flash_attention(tq, tk, tv, q_offset=pair[0], kv_len=pair[1]), host)


# sm count, batch, KV heads, Sk -> blocks per pair (at most 8, the portable cluster)
SPLIT_PLANS = [
    (132, 8, 20, 1500, 2),     # whisper's cross-attention: 160 pairs x 2 = 320 blocks
    (132, 8, 20, 4, 1),        # its decoder prompt: Sk below one tile
    (132, 1, 20, 1500, 8),     # one request: the cluster's cap
    (132, 1, 2, 1000, 8),      # 63 tiles over 8 blocks: Sk a multiple of no C
    (132, 1, 2, 100, 1),       # 7 tiles: fewer than 4 a block at C = 2
    (132, 1, 2, 128, 2),       # 8 tiles: 4 a block at C = 2
    (132, 64, 8, 4096, 1),     # 512 pairs fill the card unsplit
    (114, 8, 20, 1500, 2),     # a card of 114 SMs
]


@pytest.mark.parametrize("sm,b,hkv,sk,want", SPLIT_PLANS)
def test_flash_split_plan_is_a_function_of_the_shape(sm, b, hkv, sk, want):
    c = tops.flash_split_plan(sm, b, hkv, sk)
    assert c == want
    pairs, tiles, cap = b * hkv, -(-sk // TILE), tops.FLASH_SPLIT_MAX_CLUSTER
    assert c & (c - 1) == 0 and 1 <= c <= cap
    assert c == 1 or (tiles >= WARPS * c and pairs * c // 2 < 2 * sm)
    # the smallest that puts two blocks on every SM, unless a limit stops it
    assert pairs * c >= 2 * sm or 2 * c > cap or 2 * c * WARPS > tiles
    assert tops.flash_split_plan(sm, b, hkv, sk) == c
    # every block of the planned split but the last has the same tile count
    shares = [_split_range(s, c, 0, sk) for s in range(c)]
    assert shares[0][0] == 0 and shares[-1][1] == sk
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(shares, shares[1:]))
