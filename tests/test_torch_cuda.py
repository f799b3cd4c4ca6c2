"""Card-only tests of the port: each CUDA kernel against its plain version,
and the served tokens on the card against the CPU.

Marked ``cuda``; they skip (from a fixture, so every pytest worker collects
the same tests) when no card is present.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda

# float32 on both sides; the kernel sums in another order than the plain version
F32 = dict(atol=1e-4, rtol=1e-4)
# bfloat16: both round the output to bf16 (one ulp near 1 is 2^-8)
BF16 = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h,hkv,sq,sk,q_offset,kv_len,window", [
    (128, 16, 2, 77, 77, 0, None, None),
    (32, 4, 2, 16, 64, 20, 36, None),
    (64, 8, 8, 100, 100, 0, None, 16),
])
def test_flash_kernel_matches_plain(card, dtype, d, h, hkv, sq, sk, q_offset, kv_len, window):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(1, sq, h, d, generator=g, device=card).to(dt).transpose(1, 2)
    k = torch.randn(1, sk, hkv, d, generator=g, device=card).to(dt).transpose(1, 2)
    v = torch.randn(1, sk, hkv, d, generator=g, device=card).to(dt).transpose(1, 2)
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len, window=window)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# a split call launches the partial pass and the merge; an unsplit one, one kernel
@pytest.mark.parametrize("p,lengths,kernels", [(8, [0, 5, 128, 70], 2), (1, [0, 5, 16, 9], 1)],
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


def test_served_tokens_on_card_match_cpu(card):
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serve import AdmissionConfig, EngineConfig, Request, ServeEngine

    model = build_model(dataclasses.replace(get_arch("qwen2.5-3b").reduced(), dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=(n,)).astype(np.int32) for n in (5, 19, 11)]
    ecfg = EngineConfig(batch_slots=2, max_len=64, admission=AdmissionConfig(prefill_chunk=8))
    out = {}
    for dev, p in (("cpu", params), (card, tree_map(lambda t: t.to(card), params))):
        eng = ServeEngine(model, p, ecfg, device=dev)
        reqs = [Request(uid=i, prompt=pr, max_new_tokens=6) for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out[str(dev)] = [r.out_tokens for r in reqs]
    assert out["cpu"] == out["cuda"]
