"""The port's multi-head latent attention (``repro_torch.models.mla``)
against the JAX package's ``repro.models.mla``, on the CPU.

Both sides run the reduced deepseek-v3-671b in float32 (the JAX package's
bf16 MLA does not run on this CPU): 4 heads, q_lora 64, kv_lora 32,
qk_nope 32 + qk_rope 16 (head_dim 48 in prefill), v_head_dim 32.  The
weights are the first layer's attention of the JAX ``model.init(
jax.random.key(0))`` tree; inputs and caches come from numpy with a seed.

* ``mla_attention`` (prefill through the flash plain version, V padded to
  48) and its latent cache within atol = rtol = 1e-5;
* ``mla_decode`` at one scalar position and at per-lane positions, and
  ``mla_extend`` over two chunks into one cache, within 1e-5, caches too;
* ``mla_decode_paged`` bit-equal to the gather path (``gather_views``,
  ``mla_decode``, ``absorb_decode``) and within 1e-5 of JAX's; idle lanes
  and lanes whose page is unallocated write nothing;
* the plain flash version at head_dim 48 and 192 against the Pallas kernel
  in interpret mode at atol = rtol = 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models.common import DEFAULT_RULES, AxisRules  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.serve.paged_cache import absorb_decode, gather_views  # noqa: E402

ARCH = "deepseek-v3-671b"
RULES = AxisRules(DEFAULT_RULES)
TOL = dict(atol=1e-5, rtol=1e-5)
PS = 8


@pytest.fixture(scope="module")
def layer():
    jcfg = dataclasses.replace(jax_arch(ARCH).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    jparams = jax_build(jcfg).init(jax.random.key(0))
    jp = jax.tree.map(lambda a: a[0], jparams["seg0"]["s0_dense"]["attn"])
    return jcfg, cfg, jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


def _x(b, s, cfg, seed):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _caches(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    m = cfg.mla
    return {"latent": rng.standard_normal((b, t, m.kv_lora_rank)).astype(np.float32),
            "k_rope": rng.standard_normal((b, t, m.qk_rope_head_dim)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,s", [(1, 9), (2, 40)])
def test_mla_attention_prefill_matches_jax(layer, b, s):
    jcfg, cfg, jp, p = layer
    x = _x(b, s, cfg, s)
    jy, jcache = jmla.mla_attention(jcfg, jp, jnp.asarray(x), RULES,
                                    jnp.arange(s, dtype=jnp.int32))
    tables = tmla.mla_rope_tables(cfg, torch.arange(s)[None])
    y, cache = tmla.mla_attention(cfg, p, torch.from_numpy(x), tables)
    _close(y, jy)
    assert set(cache) == {"latent", "k_rope"} and cache["k_rope"].shape == (b, s, 16)
    for n in cache:
        _close(cache[n], jcache[n])


def test_mla_decode_scalar_position_matches_jax(layer):
    jcfg, cfg, jp, p = layer
    x, caches, pos = _x(3, 1, cfg, 1), _caches(cfg, 3, 24, 2), 17
    jy, jc = jmla.mla_decode(jcfg, jp, jnp.asarray(x), _j(caches), jnp.int32(pos), RULES)
    tc = _t(caches)
    y, got = tmla.mla_decode(cfg, p, torch.from_numpy(x), tc, pos,
                             tmla.mla_rope_tables(cfg, torch.full((1, 1), pos)))
    assert got is tc
    _close(y, jy)
    for n in got:
        _close(got[n], jc[n])


def test_mla_decode_per_lane_positions_matches_jax(layer):
    jcfg, cfg, jp, p = layer
    x, caches = _x(3, 1, cfg, 3), _caches(cfg, 3, 24, 4)
    positions = np.array([0, 23, 9], np.int32)
    jy, jc = jmla.mla_decode(jcfg, jp, jnp.asarray(x), _j(caches), jnp.asarray(positions),
                             RULES)
    pos = torch.from_numpy(positions).long()
    y, got = tmla.mla_decode(cfg, p, torch.from_numpy(x), _t(caches), pos,
                             tmla.mla_rope_tables(cfg, pos[:, None]))
    _close(y, jy)
    for n in got:
        _close(got[n], jc[n])


def test_mla_extend_two_chunks_matches_jax(layer):
    """A 13-token chunk at 0 and a 7-token chunk at 13 into one 24-row cache."""
    jcfg, cfg, jp, p = layer
    x = _x(1, 20, cfg, 5)
    zeros = {n: np.zeros_like(a) for n, a in _caches(cfg, 1, 24, 0).items()}
    jc, tc = _j(zeros), _t(zeros)
    for start, stop in ((0, 13), (13, 20)):
        chunk = x[:, start:stop]
        jy, jc = jmla.mla_extend(jcfg, jp, jnp.asarray(chunk), jc, jnp.int32(start), RULES)
        tables = tmla.mla_rope_tables(cfg, start + torch.arange(stop - start)[None])
        y, tc = tmla.mla_extend(cfg, p, torch.from_numpy(chunk), tc, start, tables)
        _close(y, jy)
    for n in tc:
        _close(tc[n], jc[n])
        assert not tc[n][:, 20:].any()


def _paged_inputs(cfg, seed):
    """Pools of 12 pages of 8 tokens, 3 lanes x 4 slots; lane 2 is idle and
    lane 1 holds two pages."""
    rng = np.random.default_rng(seed)
    m = cfg.mla
    pools = {"latent": rng.standard_normal((12, PS, m.kv_lora_rank)).astype(np.float32),
             "k_rope": rng.standard_normal((12, PS, m.qk_rope_head_dim)).astype(np.float32)}
    bt = rng.permutation(12).reshape(3, 4).astype(np.int32)
    bt[1, 2:] = -1
    positions = np.array([29, 15, 0], np.int32)
    active = np.array([True, True, False])
    return pools, bt, positions, active


def test_mla_decode_paged_bit_equal_to_gather_and_matches_jax(layer):
    """The paged decode against the gather path as the engine runs it
    (``gather_views`` of the pools, ``mla_decode`` on the views, the written
    rows folded back by ``absorb_decode``): the same active-lane outputs and
    pools, bit for bit; and JAX's ``mla_decode_paged`` within 1e-5."""
    jcfg, cfg, jp, p = layer
    pools, bt, positions, active = _paged_inputs(cfg, 6)
    x = torch.from_numpy(_x(3, 1, cfg, 7))
    btt, pos, act = (torch.from_numpy(bt), torch.from_numpy(positions).long(),
                     torch.from_numpy(active))
    tables = tmla.mla_rope_tables(cfg, pos[:, None])
    paged = _t(pools)
    y, got = tmla.mla_decode_paged(cfg, p, x, paged, btt, pos, act, tables)
    assert got is paged
    stacked = {n: t[None] for n, t in _t(pools).items()}            # one layer
    views = gather_views([{"l": stacked}], btt)
    want, _ = tmla.mla_decode(cfg, p, x, {n: t[0] for n, t in views[0]["l"].items()}, pos,
                              tables)
    absorb_decode([{"l": stacked}], views, btt, pos, act, PS)
    assert torch.equal(y[act], want[act])
    for n in paged:
        assert torch.equal(paged[n], stacked[n][0]), n
    jy, jpools = jmla.mla_decode_paged(jcfg, jp, jnp.asarray(x.numpy()), _j(pools),
                                       jnp.asarray(bt), jnp.asarray(positions),
                                       jnp.asarray(active), RULES)
    _close(y[:2], np.asarray(jy)[:2])
    for n in got:
        _close(got[n], jpools[n])


def test_mla_decode_paged_unallocated_and_idle_lanes_write_nothing(layer):
    _, cfg, _, p = layer
    pools, bt, _, active = _paged_inputs(cfg, 8)
    pos = torch.tensor([29, 17, 3])                     # lane 1's third page is -1
    btt, act = torch.from_numpy(bt), torch.from_numpy(active)
    got = _t(pools)
    tmla.mla_decode_paged(cfg, p, torch.from_numpy(_x(3, 1, cfg, 9)), got, btt, pos, act,
                          tmla.mla_rope_tables(cfg, pos[:, None]))
    changed = {(pg, off) for n in got for pg, off in
               torch.nonzero((got[n] != torch.from_numpy(pools[n])).any(-1)).tolist()}
    assert changed == {(int(bt[0, 29 // PS]), 29 % PS)}


@pytest.mark.parametrize("d,sq,sk,q_offset", [(48, 40, 40, 0), (192, 24, 24, 0),
                                              (48, 8, 32, 16)])
def test_flash_plain_at_mla_head_dims_matches_pallas(d, sq, sk, q_offset):
    """The flash wrapper on the CPU (its plain version) at head_dim 48
    (reduced MLA) and 192 (published), H = Hkv, against the Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(d + sq)
    q = rng.standard_normal((1, 4, sq, d)).astype(np.float32)
    k = rng.standard_normal((1, 4, sk, d)).astype(np.float32)
    v = rng.standard_normal((1, 4, sk, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    kv_len = q_offset + sq
    got = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                               scale=scale, q_offset=q_offset, kv_len=kv_len).numpy()
    # the Pallas op has no kv_len: causality hides the keys past it here
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                scale=scale, q_offset=q_offset, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
