"""The port's mamba2 slice against the JAX package, on the CPU.

Inputs come from numpy with a seed; weights are the JAX
``model.init(jax.random.key(0))`` tree converted by ``repro_torch.convert``.
On the JAX side the Pallas ``ssd_scan`` runs in interpret mode beside its
oracle ``repro.kernels.ref.ssd_scan``.

* the plain ``ssd_scan`` against the JAX kernel and oracle on the shapes of
  ``tests/test_kernels.py::test_ssd_scan``, at that test's tolerances
  (float32 5e-4: the chunked form against the sequential recurrence;
  bfloat16 2e-2: the JAX side rounds its output to bf16);
* ``ssd_chunked`` (y and final state), ``ssm_block``, ``ssm_extend``,
  ``ssm_decode`` and the reduced mamba2-130m model (``prefill``,
  ``extend_step``, ``decode_step_paged``) against JAX in float32 at
  atol = rtol = 1e-4 (the same algorithm, summed in another order);
* engine tokens equal to the JAX engine's (``preempt_policy="recompute"``,
  the port's only policy): whole-prompt, chunked prefill in sync and async
  modes with idle lanes, and recompute preemption;
* the reference gap: a whole-prompt prefill of a ragged length above the
  chunk raises on both sides.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import DEFAULT_RULES, AxisRules  # noqa: E402
from repro.tune.registry import resolve_tuned  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
RULES = AxisRules(DEFAULT_RULES)
ARCH = "mamba2-130m"


def _cfgs(chunk=None):
    jcfg = dataclasses.replace(jax_arch(ARCH).reduced(), dtype="float32",
                               decode_unroll_layers=False)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    if chunk is not None:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=chunk))
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = _cfgs()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build_model(cfg), params


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): leaf
            for path, leaf in flat}


def _layer(params, r=0):
    """Layer r's ``mix`` parameters: (JAX numpy tree, port tensors)."""
    jp = jax.tree.map(lambda a: jnp.asarray(a[r]), params[1]["seg0"]["s0_ssm"]["mix"])
    return jp, {k: v[r] for k, v in params[3]["seg0"]["s0_ssm"]["mix"].items()}


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 32, 2, 8, 8, 8),
    (2, 64, 4, 8, 16, 16),
    (2, 64, 4, 8, 16, 64),       # single chunk
    (1, 128, 3, 16, 8, 32),
    (1, 512, 24, 64, 128, 256),  # mamba2-130m's widths: a 512-token prompt
])
def test_plain_ssd_scan_matches_jax_kernel(b, s, h, p, n, chunk, dtype):
    rng = np.random.default_rng(0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xh = jnp.asarray(rng.normal(size=(b, s, h, p)), jdt) * 0.5
    bb = jnp.asarray(rng.normal(size=(b, s, n)), jdt) * 0.5
    cc = jnp.asarray(rng.normal(size=(b, s, n)), jdt) * 0.5
    dts = jnp.asarray(rng.uniform(0.01, 0.5, size=(b, s, h)), jnp.float32)
    a = -jnp.asarray(rng.uniform(0.5, 1.5, size=(h,)), jnp.float32)

    def port(x):
        t = torch.from_numpy(np.array(x, np.float32))
        return t.to(getattr(torch, dtype))

    y, final = tops.ssd_scan(port(xh), port(bb), port(cc), _t(dts), _t(a), chunk)
    assert y.dtype == torch.float32 and final.shape == (b, h, p, n)
    tol = dict(rtol=5e-4, atol=5e-4) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for want in (jops.ssd_scan(xh, bb, cc, dts, a, chunk=chunk, interpret=True),
                 jref.ssd_scan(xh, bb, cc, dts, a)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want, np.float32), **tol)


def test_plain_ssd_scan_keeps_the_decay_clip():
    """A chunk whose seg spans more than 120 (dt 0.5-1 and a -1 to -2 over
    256 tokens): the plain version computes the clipped factorization
    e_out * e_in of the Pallas kernel (in interpret mode) at its float32
    tolerance, where the sequential oracle, which does not clip, differs."""
    rng = np.random.default_rng(1)
    b, s, h, p, n, chunk = 1, 512, 4, 16, 32, 256
    xh = jnp.asarray(rng.normal(size=(b, s, h, p)), jnp.float32) * 0.5
    bb = jnp.asarray(rng.normal(size=(b, s, n)), jnp.float32) * 0.5
    cc = jnp.asarray(rng.normal(size=(b, s, n)), jnp.float32) * 0.5
    dts = jnp.asarray(rng.uniform(0.5, 1.0, size=(b, s, h)), jnp.float32)
    a = -jnp.asarray(rng.uniform(1.0, 2.0, size=(h,)), jnp.float32)
    span = np.abs(np.asarray(dts * a).reshape(b, s // chunk, chunk, h).sum(2)).min()
    assert span > 120, span
    y, _ = tops.ssd_scan(_t(xh), _t(bb), _t(cc), _t(dts), _t(a), chunk)
    want = np.asarray(jops.ssd_scan(xh, bb, cc, dts, a, chunk=chunk, interpret=True))
    np.testing.assert_allclose(y.numpy(), want, rtol=5e-4, atol=5e-4)
    oracle = np.asarray(jref.ssd_scan(xh, bb, cc, dts, a))
    assert np.abs(y.numpy() - oracle).max() > 1e-2


@pytest.mark.parametrize("bf16", [True, False])
def test_ssd_plan_covers_every_head_and_row(bf16):
    """The launch plan as a pure function of the shape: one cluster per
    (batch row, head), every 16-row tile of a chunk in exactly one block of
    it (block r takes tiles r, r + cluster, ...), at most one state strip
    per warp, the cluster a power of two within 8."""
    warps, strip_cols = (8, 16) if bf16 else (4, 32)
    for sms in (132, 8):
        for batch, heads, p, n, q in [(1, 24, 64, 128, 256), (1, 24, 64, 128, 44),
                                      (4, 24, 64, 128, 256), (1, 24, 64, 128, 1),
                                      (1, 24, 64, 128, 255), (2, 4, 32, 16, 32),
                                      (1, 3, 8, 8, 32), (2, 2, 16, 12, 32), (1, 8, 32, 16, 8),
                                      (1, 24, 64, 128, 512), (3, 8, 64, 64, 64),
                                      (1, 2, 64, 256, 128)]:
            plan = tops.ssd_plan(sms, batch, heads, p, n, q, bf16)
            assert plan.cluster in (1, 2, 4, 8) and plan.warps == warps
            assert plan.blocks == batch * heads * plan.cluster >= batch * heads
            assert plan.rows % 16 == 0 and 16 <= plan.rows <= 64
            tiles = -(-q // 16)
            owners = np.zeros(tiles, int)
            for r in range(plan.cluster):
                for k in range(plan.rows // 16):
                    if r + plan.cluster * k < tiles:
                        owners[r + plan.cluster * k] += 1
            assert (owners == 1).all(), (batch, heads, p, n, q, plan)
            strips = -(-p // 16) * -(-(-(-n // 16) * 16) // strip_cols)
            assert plan.strips == strips <= warps * plan.cluster, (p, n, plan)
    with pytest.raises(ValueError, match="no design"):
        tops.ssd_plan(132, 1, 2, 128, 16, 64, bf16)       # P over 64
    with pytest.raises(ValueError, match="no design"):
        tops.ssd_plan(132, 1, 2, 64, 16, 1024, bf16)      # a chunk over 512


def _ssd_split_emulation(xh, bb, cc, dt, a, chunk, init, score_terms, state_terms,
                         update_terms):
    """``ssd_scan`` as the bf16 kernel computes it: C.B^T of exact bf16
    values, the three float32 operands of its tensor-core products (scores
    * dt * e_in, the state copy that C.S reads, dt * exp(seg_last - seg) *
    x) each replaced by the sum of its first bf16 terms, every product
    exact (float64 here)."""
    def terms(v, k):
        v = v.float()
        out = torch.zeros_like(v, dtype=torch.float64)
        for _ in range(k):
            t = v.to(torch.bfloat16).float()
            out += t.double()
            v = v - t
        return out

    x, bm, cm = xh.double(), bb.double(), cc.double()
    bsz, sl, h, p = x.shape
    state = init.double()
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    ys = []
    for s0 in range(0, sl, chunk):
        xs, bs, cs = x[:, s0:s0 + chunk], bm[:, s0:s0 + chunk], cm[:, s0:s0 + chunk]
        d = dt[:, s0:s0 + chunk].float()
        seg = torch.cumsum((d * a.float()).double(), 1).float()
        mid = 0.5 * (seg[:, :1] + seg[:, -1:])
        e_out = torch.exp(torch.clamp(seg - mid, -60.0, 60.0))
        e_in = torch.exp(torch.clamp(mid - seg, -60.0, 60.0))
        scores = torch.einsum("bin,bjn->bij", cs, bs).float().masked_fill(~causal, 0.0)
        w = terms(scores[..., None] * (d * e_in)[:, None], score_terms)      # (B, i, j, H)
        y = torch.einsum("bijh,bjhp->bihp", w, xs) * e_out.double()[..., None]
        y = y + (torch.einsum("bin,bhpn->bihp", cs, terms(state, state_terms))
                 * torch.exp(seg).double()[..., None])
        ws = terms((d * torch.exp(seg[:, -1:] - seg))[..., None] * xs.float(), update_terms)
        state = (state * torch.exp(seg[:, -1]).double()[:, :, None, None]
                 + torch.einsum("bjhp,bjn->bhpn", ws, bs))
        ys.append(y)
    return torch.cat(ys, 1).float(), state.float()


@pytest.mark.parametrize("regime", ["served", "clip"])
def test_ssd_split_terms_hold_the_card_tolerance(regime):
    """The bf16 kernel's split at phase 2's shapes (mamba2-130m, 512 tokens
    in 256-token chunks, a carried state): three bf16 terms of the scores
    and of the state copy and two of the update stay within the card
    check's atol = rtol = 1e-4 of the plain version; one bf16 rounding of
    the same operands does not."""
    g = torch.Generator().manual_seed(5)
    b, s, h, p, n, chunk = 1, 512, 24, 64, 128, 256
    conv = (torch.randn(b, s, h * p + 2 * n, generator=g) * 0.5).to(torch.bfloat16)
    xh = conv[..., :h * p].reshape(b, s, h, p)
    bb, cc = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    if regime == "clip":
        dt = torch.rand(b, s, h, generator=g) * 0.5 + 0.5
        a = -(torch.rand(h, generator=g) + 1.0)
    else:
        dt = torch.rand(b, s, h, generator=g) * 0.49 + 0.01
        a = -(torch.rand(h, generator=g) + 0.5)
    st = torch.randn(b, h, p, n, generator=g)
    want_y, want_fin = tops.ssd_scan(xh, bb, cc, dt, a, chunk, st)

    def worst(got, want):
        return float(((got - want).abs() / (1e-4 + 1e-4 * want.abs())).max())

    y, fin = _ssd_split_emulation(xh, bb, cc, dt, a, chunk, st, 3, 3, 2)
    assert worst(y, want_y) <= 1.0 and worst(fin, want_fin) <= 1.0
    y1, fin1 = _ssd_split_emulation(xh, bb, cc, dt, a, chunk, st, 1, 1, 1)
    assert worst(y1, want_y) > 1.0 and worst(fin1, want_fin) > 1.0


def test_ssd_scan_refuses_a_ragged_length_and_other_devices():
    x = torch.zeros(1, 40, 2, 8)
    bc = torch.zeros(1, 40, 8)
    dt, a = torch.zeros(1, 40, 2), torch.zeros(2)
    with pytest.raises(ValueError, match="not a multiple of the chunk 32"):
        tops.ssd_scan(x, bc, bc, dt, a, 32)
    tops.ssd_scan(x, bc, bc, dt, a, 64)                  # one 40-token chunk
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tops.ssd_scan(x.to("meta"), bc.to("meta"), bc.to("meta"), dt.to("meta"),
                      a.to("meta"), 8)


# ---------------------------------------------------------------------------
# ssd_chunked and the layer functions
# ---------------------------------------------------------------------------


def _ssd_inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    sc = cfg.ssm
    h, p, n = sc.n_heads(cfg.d_model), sc.head_dim, sc.d_state
    return (rng.normal(size=(b, s, h, p)).astype(np.float32) * 0.5,
            rng.normal(size=(b, s, n)).astype(np.float32) * 0.5,
            rng.normal(size=(b, s, n)).astype(np.float32) * 0.5,
            rng.normal(size=(b, s, h)).astype(np.float32),
            rng.normal(size=(h,)).astype(np.float32) * 0.3,
            rng.uniform(0.5, 1.5, size=(h,)).astype(np.float32),
            rng.normal(size=(b, h, p, n)).astype(np.float32))


# whole chunks of 8, 16 and 32 tokens, and a 44-token extend slice against
# a 64-token chunk (one ragged chunk)
@pytest.mark.parametrize("chunk,seq", [(8, 64), (16, 64), (32, 64), (64, 44)],
                         ids=["chunk8", "chunk16", "chunk32", "ragged_slice"])
@pytest.mark.parametrize("init", ["zero", "carried"])
def test_ssd_chunked_matches_jax(chunk, seq, init):
    jcfg, cfg = _cfgs(chunk)
    xh, bb, cc, dt, a_log, d_skip, st = _ssd_inputs(cfg, 2, seq, seed=chunk)
    st = st if init == "carried" else None
    jargs = [jnp.asarray(v) for v in (xh, bb, cc, dt, a_log, d_skip)]
    # the JAX @tunable lookup finds no tuned chunk for these shapes: it runs
    # cfg.ssm.chunk, which is what the port runs
    assert resolve_tuned("ssd.chunked", jcfg, *jargs)["chunk"] is None
    jy, jfin = jssm.ssd_chunked(jcfg, *jargs, None if st is None else jnp.asarray(st))
    y, fin = tssm.ssd_chunked(cfg, *(_t(v) for v in (xh, bb, cc, dt, a_log, d_skip)),
                              None if st is None else _t(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), **TOL)


def test_ssm_block_extend_decode_match_jax(models):
    cfg = models[2].cfg
    jp, tp = _layer(models)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 45, cfg.d_model)).astype(np.float32)
    # block: a whole 32-token prompt
    jy, jc = jssm.ssm_block(models[0].cfg, jp, jnp.asarray(x[:, :32]), RULES)
    y, st, cv = tssm.ssm_block(cfg, tp, _t(x[:, :32]))
    for got, want in ((y, jy), (st, jc["state"]), (cv, jc["conv"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # extend: 13 ragged tokens carried on from the block, then 45 (two slices)
    for xs in (x[:, 32:], x):
        jy, jc = jssm.ssm_extend(models[0].cfg, jp, jnp.asarray(xs), jc, RULES)
        y, st, cv = tssm.ssm_extend(cfg, tp, _t(xs), st, cv)
        for got, want in ((y, jy), (st, jc["state"]), (cv, jc["conv"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # decode: one token per lane from the carried state
    jy, jc = jssm.ssm_decode(models[0].cfg, jp, jnp.asarray(x[:, :1]), jc, RULES)
    y, st, cv = tssm.ssm_decode(cfg, tp, _t(x[:, :1]), st, cv)
    for got, want in ((y, jy), (st, jc["state"]), (cv, jc["conv"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _close_trees(cache, jcache):
    jc = _jax_paths(jcache)
    for path, t in tree_items(cache):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(jc[path], np.float32), **TOL)


def _close_logits(logits, jlogits):
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert np.array_equal(logits.numpy().argmax(-1), np.asarray(jlogits).argmax(-1))


@pytest.mark.parametrize("seq", [11, 64])
def test_prefill_logits_and_state(models, seq):
    jmodel, jparams, model, params = models
    toks = np.random.default_rng(seq).integers(0, 512, size=(2, seq)).astype(np.int32)
    jlogits, jcache = jmodel.prefill(jparams, jnp.asarray(toks))
    logits, cache = model.prefill(params, torch.from_numpy(toks).long())
    _close_logits(logits, jlogits)
    _close_trees(cache, jcache)


def test_extend_step_logits_and_state(models):
    jmodel, jparams, model, params = models
    toks = np.random.default_rng(1).integers(0, 512, size=(1, 50)).astype(np.int32)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jmodel.cache_specs(1, 64))
    cache = [{k: {n: torch.zeros(s.shape, dtype=s.dtype) for n, s in v.items()}
              for k, v in seg.items()} for seg in model.cache_specs(1, 64)]
    for start, stop in ((0, 5), (5, 9), (9, 50)):          # the last is 41: two slices
        chunk = toks[:, start:stop]
        jlogits, jcache = jmodel.extend_step(jparams, jcache, jnp.asarray(chunk),
                                             jnp.asarray(start, jnp.int32))
        logits, cache = model.extend_step(params, cache, torch.from_numpy(chunk).long(),
                                          start)
        _close_logits(logits, jlogits)
    _close_trees(cache, jcache)


def test_decode_step_paged_steps_active_lanes_only(models):
    """Three lanes with random states; lane 2 is idle and keeps its state."""
    jmodel, jparams, model, params = models
    rng = np.random.default_rng(2)
    specs = model.cache_page_specs(3, 8, 4)
    state = {n: rng.normal(size=s.shape).astype(np.float32) for n, s in specs[0]["s0_ssm"].items()}
    toks = rng.integers(0, 512, size=(3, 1)).astype(np.int32)
    bt = np.full((3, 4), -1, np.int32)
    positions = np.array([6, 8, 0], np.int32)
    active = np.array([True, True, False])
    jpools = [{"s0_ssm": {n: jnp.asarray(v) for n, v in state.items()}}]
    jlogits, jpools = jmodel.decode_step_paged(
        jparams, jpools, jnp.asarray(bt), jnp.asarray(toks), jnp.asarray(positions),
        jnp.asarray(active))
    pools = [{"s0_ssm": {n: torch.from_numpy(v.copy()) for n, v in state.items()}}]
    logits, pools = model.decode_step_paged(
        params, pools, torch.from_numpy(bt), torch.from_numpy(toks).long(),
        torch.from_numpy(positions).long(), torch.from_numpy(active))
    _close_logits(logits[torch.from_numpy(active)], np.asarray(jlogits)[active])
    _close_trees(pools, jpools)
    for n, v in state.items():
        assert np.array_equal(pools[0]["s0_ssm"][n][:, 2].numpy(), v[:, 2])
        assert not np.array_equal(pools[0]["s0_ssm"][n][:, 0].numpy(), v[:, 0])


def test_whole_prompt_ragged_above_chunk_raises_on_both_sides(models):
    """The reference gap: ``ssd_chunked`` needs S % min(chunk, S) == 0."""
    jmodel, jparams, model, params = models
    toks = np.zeros((1, 40), np.int32)                     # chunk 32
    with pytest.raises(AssertionError):
        jmodel.prefill(jparams, jnp.asarray(toks))
    with pytest.raises(ValueError, match="40-token sequence is not a multiple of the 32"):
        model.prefill(params, torch.from_numpy(toks).long())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# name: (engine knobs, prompt lengths, new tokens)
SETTINGS = {
    # whole prompts of at most one chunk (32) or a multiple of it
    "whole": (dict(batch_slots=3, max_len=96), (5, 32, 11, 20, 64), 4),
    # chunk 4 under a 12-token budget, ragged prompts past the chunk
    "chunked_sync": (dict(batch_slots=3, max_len=64, prefill_chunk=4, max_step_tokens=12,
                          async_prefill=False), (11, 40, 7, 19), 5),
    "chunked_async": (dict(batch_slots=3, max_len=64, prefill_chunk=4, max_step_tokens=12),
                      (11, 40, 7, 19), 5),
    # 3 lanes on a 7-page pool of 4-token pages: the pool runs dry mid-decode
    # (inline admission: the preemption count would depend on the admission
    # thread's timing)
    "recompute": (dict(batch_slots=3, max_len=32, page_size=4, n_pages=7,
                       async_prefill=False), (7, 7, 7), 10),
}


def _engine_cfgs(knobs):
    cache = {k: knobs[k] for k in ("page_size", "n_pages", "decode_path") if k in knobs}
    adm = {k: knobs[k] for k in ("prefill_chunk", "async_prefill", "max_step_tokens")
           if k in knobs}
    return dict(batch_slots=knobs["batch_slots"], max_len=knobs["max_len"]), cache, adm


def serve_both(models, knobs, lengths, max_new, seed=0):
    """(JAX tokens, port tokens, JAX engine, port engine) for one setting."""
    jmodel, jparams, model, params = models
    top, cache, adm = _engine_cfgs(knobs)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 512, size=(n,)).astype(np.int32) for n in lengths]
    jeng = jserve.ServeEngine(jmodel, jparams, jserve.EngineConfig(
        **top, cache=jserve.CacheConfig(preempt_policy="recompute", **cache),
        admission=jserve.AdmissionConfig(**adm)))
    teng = tserve.ServeEngine(model, params, tserve.EngineConfig(
        **top, cache=tserve.CacheConfig(**cache), admission=tserve.AdmissionConfig(**adm)),
        device="cpu")
    out = []
    for eng, cls in ((jeng, jserve.Request), (teng, tserve.Request)):
        reqs = [cls(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done for r in reqs)
        out.append({r.uid: r.out_tokens for r in reqs})
    return out[0], out[1], jeng, teng


@pytest.mark.parametrize("name", list(SETTINGS))
def test_engine_tokens_match_jax_engine(models, name):
    knobs, lengths, max_new = SETTINGS[name]
    want, got, jeng, teng = serve_both(models, knobs, lengths, max_new)
    assert got == want
    assert teng.cache.has_state_leaves()
    assert teng.cache.allocator.n_free == teng.cache.n_pages
    teng.cache.check_invariant()
    st = teng.stats
    assert st["lane_step_sum"] < st["lane_slot_sum"]          # lanes sat idle
    if name == "recompute":
        assert teng.sched.n_preemptions > 0 and jeng.sched.n_preemptions > 0
    if not knobs.get("async_prefill", True):
        assert st["steps"] == jeng.stats["steps"]


def test_launcher_serves_mamba2_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
         "--requests", "2", "--prefill-chunk", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "mamba2-130m-smoke: 2 requests, 32 tokens" in proc.stdout
