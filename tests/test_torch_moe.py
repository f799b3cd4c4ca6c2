"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe``, on the CPU, in float32.

Router and expert weights come from numpy with a seed, in the shapes of
``moe_specs`` of the reduced deepseek-v3-671b (4 experts, top 2, one
shared expert) and qwen3-moe-235b-a22b (no shared expert).

* ``_dispatch_masks``: dispatch bit-equal to JAX's and combine within
  1e-6 (the renormalised weights divide in another order), over group,
  token, expert, top-k and capacity counts, cases that drop included; the
  trimmed masks are the untrimmed ones' filled columns;
* ``moe_ffn`` within atol = rtol = 1e-5 of JAX's for ``drop=True`` with the
  default groups (ragged token counts and multiples of 32) and for
  ``drop=False, n_groups=1``, with and without the shared expert, trimmed
  or not; the aux loss within 1e-6 relative; the group heuristic equal;
* ``expert_ffn`` with ``expert_block`` > 0 equal to ``expert_block`` 0.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import DEFAULT_RULES, AxisRules  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.common import activation, tree_items  # noqa: E402

RULES = AxisRules(DEFAULT_RULES)
TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(arch):
    return (dataclasses.replace(jax_arch(arch).reduced(), dtype="float32"),
            dataclasses.replace(get_arch(arch).reduced(), dtype="float32"))


def _params(cfg, seed):
    """{nested moe params} as numpy float32, weights scaled by fan-in."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, s in tree_items(tmoe.moe_specs(cfg)):
        a = rng.standard_normal(s.shape).astype(np.float32) * s.shape[-2] ** -0.5
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return out


def _tree(params, as_tensor):
    if isinstance(params, dict):
        return {k: _tree(v, as_tensor) for k, v in params.items()}
    return torch.from_numpy(params.copy()) if as_tensor else jnp.asarray(params)


def _gates(g, t, e, seed):
    """(JAX, torch) router probabilities of random logits (no ties)."""
    logits = np.random.default_rng(seed).standard_normal((g, t, e)).astype(np.float32) * 2
    gates = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    return gates, torch.from_numpy(np.array(gates))


# (G, T, E, k, capacity): capacities from no drops to most pairs dropped
MASK_CASES = [(1, 8, 4, 2, 8), (2, 13, 4, 2, 4), (3, 48, 8, 2, 5), (1, 40, 16, 4, 3),
              (4, 9, 256, 8, 4), (1, 64, 128, 8, 64)]


@pytest.mark.parametrize("g,t,e,k,cap", MASK_CASES, ids=[str(c) for c in MASK_CASES])
def test_dispatch_masks_equal_jax(g, t, e, k, cap):
    jgates, gates = _gates(g, t, e, seed=t * e + k)
    jdisp, jcomb = jmoe._dispatch_masks(jgates, k, cap)
    disp, comb = tmoe._dispatch_masks(gates, k, cap)
    assert disp.shape == (g, t, e, cap) and disp.dtype == torch.float32
    assert np.array_equal(disp.numpy(), np.asarray(jdisp))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jcomb), atol=1e-6, rtol=0)
    # each kept pair fills one slot; the drops are the pairs past capacity
    kept = int(disp.sum())
    assert kept <= g * t * k
    if cap < t * k // e:
        assert kept < g * t * k
    trimmed, tcomb = tmoe._dispatch_masks(gates, k, cap, True)
    width = trimmed.shape[-1]
    assert 1 <= width <= cap
    assert torch.equal(trimmed, disp[..., :width]) and torch.equal(tcomb, comb[..., :width])
    assert not disp[..., width:].any()


def test_group_heuristic_equals_jax():
    """n_groups_for against the group count JAX's moe_ffn picks, read off the
    dispatch shape through a spy."""
    jcfg, cfg = _cfgs("qwen3-moe-235b-a22b")
    p = _params(cfg, 0)
    seen = []
    orig = jmoe._dispatch_masks

    def spy(gates, k, capacity):
        seen.append(gates.shape[0])
        return orig(gates, k, capacity)

    jmoe._dispatch_masks = spy
    try:
        for b, s in ((1, 7), (2, 13), (2, 32), (3, 32), (1, 96), (4, 9), (2, 4096)):
            x = np.zeros((b, s, cfg.d_model), np.float32)
            jmoe.moe_ffn(jcfg, _tree(p, False), jnp.asarray(x), RULES)
            assert tmoe.n_groups_for(b, s) == seen[-1], (b, s)
    finally:
        jmoe._dispatch_masks = orig


# (arch, B, S, n_groups, drop, trim)
FFN_CASES = [
    ("deepseek-v3-671b", 2, 13, None, True, False),     # ragged: groups = the batch
    ("deepseek-v3-671b", 2, 32, None, True, False),     # 64 tokens: 32 groups of 2
    ("qwen3-moe-235b-a22b", 1, 37, None, True, False),
    ("qwen3-moe-235b-a22b", 3, 32, None, True, True),
    ("deepseek-v3-671b", 1, 40, 1, False, False),       # chunked prefill
    ("deepseek-v3-671b", 1, 40, 1, False, True),
    ("qwen3-moe-235b-a22b", 5, 1, 1, False, False),     # decode: one token per lane
    ("qwen3-moe-235b-a22b", 1, 64, 1, False, True),
]


@pytest.mark.parametrize("arch,b,s,groups,drop,trim", FFN_CASES,
                         ids=["-".join(map(str, c)) for c in FFN_CASES])
def test_moe_ffn_and_aux_match_jax(arch, b, s, groups, drop, trim):
    jcfg, cfg = _cfgs(arch)
    p = _params(cfg, b * s)
    x = np.random.default_rng(s).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn(jcfg, _tree(p, False), jnp.asarray(x), RULES, n_groups=groups,
                            drop=drop)
    y, aux = tmoe.moe_ffn(cfg, _tree(p, True), torch.from_numpy(x), n_groups=groups,
                          drop=drop, trim=trim)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert aux.dtype == torch.float32
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    assert ("shared" in p) == (arch == "deepseek-v3-671b")


def test_drop_and_no_drop_differ_where_the_reference_does():
    """Capacity drops change the output of the tokens they drop (the
    whole-prompt prefill against the chunked path of the reference); with
    capacity >= the demand, drop=True equals drop=False."""
    jcfg, cfg = _cfgs("qwen3-moe-235b-a22b")
    p = _tree(_params(cfg, 1), True)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 48, cfg.d_model)).astype(np.float32))
    # capacity 12 of the 24 pairs an expert gets on average: drops
    tight = dataclasses.replace(cfg, capacity_factor=0.5)
    dropped, _ = tmoe.moe_ffn(tight, p, x, n_groups=1, drop=True)
    full, _ = tmoe.moe_ffn(cfg, p, x, n_groups=1, drop=False)
    assert not torch.allclose(dropped, full, atol=1e-3)
    roomy = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    same, _ = tmoe.moe_ffn(roomy, p, x, n_groups=1, drop=True)
    torch.testing.assert_close(same, full, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("block", [1, 2, 3])
def test_expert_block_equals_all_experts(block):
    rng = np.random.default_rng(block)
    g, e, c, d, f = 2, 4, 5, 16, 24
    xe = torch.from_numpy(rng.standard_normal((g, e, c, d)).astype(np.float32))
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((e, d, f), (e, d, f), (e, f, d))]
    act = activation("silu")
    whole = tmoe.expert_ffn(xe, *w, act=act, expert_block=0)
    assert torch.equal(tmoe.expert_ffn(xe, *w, act=act), whole)           # None = 0
    torch.testing.assert_close(tmoe.expert_ffn(xe, *w, act=act, expert_block=block), whole,
                               atol=0, rtol=0)
    jwant = jmoe.expert_ffn(jnp.asarray(xe.numpy()), *(jnp.asarray(t.numpy()) for t in w),
                            act=jax.nn.silu, expert_block=0)
    np.testing.assert_allclose(whole.numpy(), np.asarray(jwant), **TOL)
