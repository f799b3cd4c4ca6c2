"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's ``repro.models.rglru``, on the CPU.

Both sides run ``dataclasses.replace(get_arch("recurrentgemma-9b").reduced(),
dtype="float32", n_layers=5)``; the weights are the JAX
``model.init(jax.random.key(0))`` tree converted by ``repro_torch.convert``,
inputs come from numpy with a seed.

* ``linear_scan`` (the doubling scan) against a step-by-step recurrence and
  ``jax.lax.associative_scan``, at lengths that are and are not powers of
  two, float32 1e-5;
* ``rglru_block`` with and without a carried state at S = 37, ``rglru_extend``
  and ``rglru_decode`` against JAX within 1e-5 (y, h and the conv state);
* the block equals its own step-by-step decode within 1e-5;
* the block's gradients (every parameter, the input and the carried state)
  against ``jax.grad`` within 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.common import DEFAULT_RULES, AxisRules  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402

ARCH = "recurrentgemma-9b"
RULES = AxisRules(DEFAULT_RULES)
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs():
    jcfg = dataclasses.replace(jax_arch(ARCH).reduced(), dtype="float32", n_layers=5)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32", n_layers=5)
    return jcfg, cfg


@pytest.fixture(scope="module")
def layer():
    """(JAX cfg, port cfg, JAX mix params, port mix params) of seg0's first
    rec layer."""
    jcfg, cfg = _cfgs()
    jparams = jax_build(jcfg).init(jax.random.key(0))
    mix = jax.tree.map(lambda a: np.asarray(a[0]), jparams["seg0"]["s0_rec"]["mix"])
    return jcfg, cfg, jax.tree.map(jnp.asarray, mix), convert.params_from_numpy(mix)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    w = cfg.rglru.lru_width
    return (rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
            rng.normal(size=(b, w)).astype(np.float32) * 0.5,
            rng.normal(size=(b, cfg.rglru.d_conv - 1, w)).astype(np.float32) * 0.5)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("s", [1, 2, 16, 37, 64, 100])
def test_linear_scan_matches_recurrence_and_associative_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.2, 1.0, size=(2, s, 24)).astype(np.float32)
    b = rng.normal(size=(2, s, 24)).astype(np.float32)
    h = trglru.linear_scan(_t(a), _t(b))
    want = np.zeros_like(b)
    prev = np.zeros((2, 24), np.float32)
    for t in range(s):
        prev = a[:, t] * prev + b[:, t]
        want[:, t] = prev
    _close(h, want)

    def comb(l, r):
        return (l[0] * r[0], r[0] * l[1] + r[1])

    _, jh = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    _close(h, jh)


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_rglru_block_matches_jax(layer, carried):
    jcfg, cfg, jp, tp = layer
    x, h0, conv0 = _inputs(cfg, 2, 37, seed=1)
    kw = dict(state=h0, conv_state=conv0) if carried else {}
    jy, jc = jrglru.rglru_block(jcfg, jp, jnp.asarray(x), RULES,
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    y, c = trglru.rglru_block(cfg, tp, _t(x), **{k: _t(v) for k, v in kw.items()})
    assert c["h"].dtype == torch.float32 and c["conv"].shape == conv0.shape
    _close(y, jy)
    _close(c["h"], jc["h"])
    _close(c["conv"], jc["conv"])


def test_rglru_extend_and_decode_match_jax(layer):
    jcfg, cfg, jp, tp = layer
    x, h0, conv0 = _inputs(cfg, 3, 20, seed=2)
    jcache = {"h": jnp.asarray(h0), "conv": jnp.asarray(conv0)}
    cache = {"h": _t(h0), "conv": _t(conv0)}
    for xs in (x[:, :13], x[:, 13:14], x[:, 14:]):          # ragged extends
        jy, jcache = jrglru.rglru_extend(jcfg, jp, jnp.asarray(xs), jcache, RULES)
        y, cache = trglru.rglru_extend(cfg, tp, _t(xs), cache)
        _close(y, jy)
        for n in ("h", "conv"):
            _close(cache[n], jcache[n])
    for t in range(3):
        xs = x[:, t:t + 1]
        jy, jcache = jrglru.rglru_decode(jcfg, jp, jnp.asarray(xs), jcache, RULES)
        y, cache = trglru.rglru_decode(cfg, tp, _t(xs), cache)
        _close(y, jy)
        for n in ("h", "conv"):
            _close(cache[n], jcache[n])


def test_block_equals_step_by_step_decode(layer):
    _, cfg, _, tp = layer
    x, h0, conv0 = _inputs(cfg, 2, 37, seed=3)
    y, c = trglru.rglru_block(cfg, tp, _t(x), state=_t(h0), conv_state=_t(conv0))
    cache = {"h": _t(h0), "conv": _t(conv0)}
    ys = []
    for t in range(x.shape[1]):
        yt, cache = trglru.rglru_decode(cfg, tp, _t(x[:, t:t + 1]), cache)
        ys.append(yt)
    _close(y, torch.cat(ys, dim=1).numpy())
    _close(c["h"], cache["h"].numpy())
    _close(c["conv"], cache["conv"].numpy())


def test_rglru_block_grads_match_jax(layer):
    """d/d(params, x, h0) of sum(y · u) + sum(h_last · v), with the carried
    state folded into step 0."""
    jcfg, cfg, jp, tp = layer
    x, h0, conv0 = _inputs(cfg, 2, 37, seed=4)
    rng = np.random.default_rng(5)
    u = rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    v = rng.normal(size=h0.shape).astype(np.float32)

    def jloss(p, xx, hh):
        y, c = jrglru.rglru_block(jcfg, p, xx, RULES, state=hh,
                                  conv_state=jnp.asarray(conv0))
        return jnp.sum(y * u) + jnp.sum(c["h"] * v)

    jgp, jgx, jgh = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(x), jnp.asarray(h0))
    p = {k: t.clone().requires_grad_(True) for k, t in tp.items()}
    xx, hh = _t(x).requires_grad_(True), _t(h0).requires_grad_(True)
    y, c = trglru.rglru_block(cfg, p, xx, state=hh, conv_state=_t(conv0))
    (torch.sum(y * _t(u)) + torch.sum(c["h"] * _t(v))).backward()
    for k in sorted(p):
        _close(p[k].grad, jgp[k], GRAD_TOL)
    _close(xx.grad, jgx, GRAD_TOL)
    _close(hh.grad, jgh, GRAD_TOL)
