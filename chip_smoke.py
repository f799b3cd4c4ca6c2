#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times [--src DIR]

Run from the root of a checkout (it imports ``src/repro_torch`` beside it;
it never imports JAX or the ``repro`` package).  It drives the port's
paths: paged-KV serving of qwen2.5-3b, ConvNet inference of VGG16, serving
of mamba2-130m, the gather decode path, training of qwen2.5-3b, ConvNet
training (VGG16), training of mamba2-130m, serving of recurrentgemma-9b
(its training runs reduced: full width does not fit one card) and serving
and training of the moe family (deepseek-v3-671b and qwen3-moe-235b-a22b).
Every serving path runs at full width; all but the moe family's at full
depth (``MOE_DEPTH``, ``MOE_TRAIN``: 671 B and 235 B parameters do not
fit one card).  Phases, each fatal:

1. build the eight CUDA kernels from ``src/repro_torch/kernels/csrc``
   (``nvcc``, printing the ``-Xptxas -v`` register report) and name the card;
2. hold each kernel against its plain PyTorch version on the card at its
   path's shapes, in bfloat16 and float32 (attention: qwen2.5-3b's 16 query
   heads, 2 KV heads, head_dim 128, page size 16; conv: a VGG16 layer of
   each spatial size, its conv1 and AlexNet's conv1, each with the design
   it took and its bias + ReLU epilogue held bit-equal to the kernel
   followed by ``add_`` and ``relu_``; pool: VGG16's pool1; matmul: fc6,
   fc7 and fc8, two calls bit-equal; all at batch 16; ``ssd_scan``:
   full-width mamba2-130m, a 512-token prompt in 256-token chunks from zero
   and from a carried state, a 256-token served slice, ragged 44-, 1- and
   255-token slices, phase 14's eval shape (B 4, 1,024 tokens, from zero and
   carried), B 2 with distinct carried states and a prompt whose seg spans
   more than 120 (the decay clip engages; held to the plain version
   evaluated in float64, whose float32 evaluation is itself off there),
   each one launch of the design's
   kernel by the profiler's name (``ssd_scan_mma`` in bf16,
   ``ssd_scan_fma`` in float32) with ``ops.PATHS`` logged; recurrentgemma-9b's
   shapes besides (16 query heads over 1 KV head, head_dim 256, window
   2,048: ``flash_attention`` on a 3,072-token prompt and on a 1,024-token
   chunk at offset 2,048 against a 4,096-row cache holding 3,072), and the
   moe family's (``flash_attention`` at deepseek-v3's MLA prefill, 128
   heads = KV heads of head_dim 192, on a 1,024-token prompt and a chunk,
   at qwen3-moe's 64 query heads over 4 KV heads of 128 on a 1,024-token
   prompt, and the reduced model's head_dim 48; ``paged_decode_attention``
   at qwen3-moe's 64 query heads over 4 KV heads, on ragged lanes and at
   its served context of ~1,036 tokens over 128 slots), logged with their
   times but not in the JSON line; each paged case logs its design
   (``ops.PATHS``) and its launches per call (one); each flash case logs the design it took
   (``ops.PATHS``) and must have launched its design's compiled kernel
   by the profiler's name (``flash_kernel_name``); four flash cases run at
   batch 2, two of them with k and v one slice expanded over the batch;
   the served flash shapes (qwen2.5-3b's 512-token
   prefill, recurrentgemma's prompt and chunk, the MLA and qwen3-moe
   prompts) and the three paged-decode shapes are timed by CUDA events, by the
   profiler's device time and by the host's issue time per call against
   SDPA in turns, each paged row beside the device time of an empty
   kernel's launch (the floor under any launch) and its own device time
   with every lane empty, ``ssd_scan``'s prompt and served slice by the
   same three alone, beside the design's bound and the float32 one;
   ``paged_gather``, one launch per call,
   bit-equal, 8 lanes with -1 holes: a full-width qwen2.5-3b cache leaf
   (36 layers, 64 slots; the JSON line's case), one recurrentgemma
   attention layer's k pool (256 slots of 16 x 256) and its k + v, one
   deepseek MLA layer's latent pool (128 slots of 16 x 512) and its latent
   + k_rope (16 x 64), each timed by CUDA events, by the profiler's device
   time and by the host's issue time per call, against ``index_select``
   (one per pool) in turns, beside the bound;
   ``stream_gd``: full-width qwen2.5-3b's largest leaf, seg0's mlp.w_up, in
   the sgd launch, the two mixed-type in-place momentum launches, J = 3
   and 4 in float32 and the fused two-stage momentum launch, and the
   full-width VGG16 parameter tree (32 leaves) in one sgd and one fused
   momentum launch, each bit-equal), and time kernel, plain version, one
   PyTorch library call (SDPA, ``F.conv2d``, ``F.max_pool2d``,
   ``torch.matmul``, ``index_select``, ``torch.add``; never used by the
   port; none computes ``ssd_scan``) and the bound; the fused momentum
   and the VGG16 tree are timed beside one launch per leaf and stage (and
   the tree's sgd beside ``torch._foreach_add_``);
3. serve the same requests with the reduced qwen2.5-3b engine in float32 on
   the card and on the CPU (plain kernels), whole-prompt and chunked
   prefill: the greedy tokens must be identical;
4. serve 16 requests at the full width of qwen2.5-3b (36 layers, bf16,
   seeded random weights) with 8 lanes, max_len 1024 and 16-token pages;
   every request must finish, both attention kernels must have launched,
   ``paged_decode_attention`` exactly once per layer per decode step;
5. run a narrow VGG16 (channels / 16, 32-px input) in float32 on the card
   (kernels) and on the CPU (plain versions) with the same weights: the
   logits must agree within 1e-4 and the argmax must be equal;
6. run full-width VGG16 (224 x 224, batch 16, bf16, seeded He-init
   weights): finite logits, 13 conv, 5 pool and 3 fc kernel launches per
   forward and at most 11 other launches (the conv layers' bias and ReLU
   run in the kernel's epilogue), images/s, a profiler split of device
   time per layer type and the conv kernels' TFLOP/s; and two images in
   float32 on the card against the CPU;
7. serve the same requests with the reduced mamba2-130m engine in float32 on
   the card and on the CPU, whole-prompt and chunked prefill: identical
   greedy tokens;
8. serve 16 requests of 128-512 prompt tokens at the full width of
   mamba2-130m (24 layers, bf16, seeded random weights) with 8 lanes,
   256-token prefill chunks and 32 new tokens each: every request finishes,
   ``ssd_scan`` launches; tok/s, prefill ms (with ``ssd_scan``'s device
   group and launches, 24 per slice), decode-step ms and the device-busy
   share (the decode step runs no port kernel: it is the plain
   ``ssm_decode``);
9. the gather decode path: reduced qwen2.5-3b in float32 with
   ``decode_path="gather"`` gives the CPU's tokens and the card's paged
   tokens; full-width qwen2.5-3b with it serves 16 requests through
   ``paged_gather``, one launch per decode step (both seq leaves), and its
   decode step is timed beside the paged path's;
10. train reduced qwen2.5-3b in float32 on the card and on the CPU from the
    same weights and batches, 4 steps of sgd, momentum and adamw with 1 and
    2 microbatches: losses and grad norms within 1e-4 relative at every
    step, parameters within 1e-4, one ``stream_gd`` launch per sgd or
    momentum step; and a card Trainer run with a crash
    injected at step 6 resumes from its checkpoint (under ``build/``) to
    step 12 with the clean run's final loss;
11. train full-width qwen2.5-3b through ``repro_torch.launch.train --full``
    (bf16, seeded random weights, momentum, seq 1024, global batch 8 in 4
    microbatches, remat full) for 6 steps: every loss finite, one
    ``stream_gd`` launch per step (14 leaves, two stages); step ms, trained
    tokens/s, peak memory and a profiled step's split into
    forward+backward, update (against its one-pass bound, 16 B per
    parameter, and the two-pass one) and the rest;
12. train ``examples/torch_train_convnet.py``'s small net in float32 on the
    card and on the CPU from the same weights and batches, 6 steps of
    momentum and of adamw, each with cuDNN and without (the float32 weight
    gradient skips cuDNN's Winograd transform, whose ~5e-8 where the CPU's
    gradient is exactly 0 adamw amplified): losses within 1e-4 relative at
    every step, parameters within 1e-4, one ``stream_gd`` launch per
    momentum step, and the card's checkpoint restores bit-exactly; then the
    first step's weight gradients with no stray non-zero against the CPU
    in float32, and in bf16 (cuDNN's weight gradient) the exact zeros of
    the CPU and of the card counted and logged;
13. train full-width VGG16 (``impl="xla"``: cuDNN convolutions through
    autograd, 224 x 224, batch 32, bf16 weights from a seeded He init,
    float32 momentum at lr 3e-3) for 6 steps on ``SyntheticImageData``
    batches put on the card beforehand: every loss finite, one
    ``stream_gd`` launch per step (32 leaves); step ms (median of steps
    2-6), the host's batch-generation ms apart, trained images/s, peak
    memory and a profiled step's split (the update against its bound,
    14 B per parameter); then the trained weights through
    ``impl="kernel"`` (``stream_mac_conv``, ``stream_maxpool``,
    ``tiled_matmul``) on 16 images: logits within the bf16 tolerance of
    phase 2 of ``impl="xla"``'s, and the argmax agreement;
14. train reduced mamba2-130m as phase 10 does qwen2.5-3b (64 tokens, two
    32-token chunks), card against CPU; then full-width mamba2-130m
    through ``repro_torch.launch.train --full`` (bf16, momentum, seq 1024,
    global batch 16 in 8 microbatches, remat full, the differentiable
    plain-torch SSD) for 6 steps: every loss finite, one ``stream_gd``
    launch per step; step ms, trained tokens/s, peak memory, the profiled
    split; and an eval loss of the trained weights through ``ssd_scan``
    (``impl="kernel"``) within the bf16 tolerance of ``impl="xla"``'s;
15. serve the same requests with reduced recurrentgemma-9b (5 layers: a
    ``("rec", "rec", "attn")`` segment and a ``("rec", "rec")`` remainder;
    window 64) in float32 on the card and on the CPU, whole-prompt and
    chunked prefill, prompts past the window and decode across it: the
    card's paged and gather tokens equal the CPU's;
16. serve 16 requests of 1,024-3,072 prompt tokens (half past the
    2,048-token window) at the full width and depth of recurrentgemma-9b
    (38 layers, bf16, seeded random weights) with 8 lanes, max_len 4,096,
    16-token pages, 1,024-token prefill chunks and 64 new tokens each:
    every request finishes, ``flash_attention`` launches 12 times per
    prefill slice and ``paged_gather`` 12 times per decode step (the local
    attention layers' windowed paged decode, k and v in one launch),
    ``paged_decode_attention``
    never; tok/s, peak memory, the prefill ms per 1,024-token slice with its
    profiled split (flash, the RG-LRU scan, matmuls, the rest) and the
    decode-step ms with its busy share and launches per step;
17. train reduced recurrentgemma-9b (5 layers, 96 tokens) as phase 10 does
    qwen2.5-3b, card against CPU;
18. serve the same requests with reduced deepseek-v3-671b (MLA, head_dim
    48 in prefill) and reduced qwen3-moe-235b-a22b in float32 on the card
    and on the CPU, whole-prompt and chunked prefill: the card's paged and
    gather tokens equal the CPU's;
19. serve 16 requests of 256-1,536 prompt tokens (whole-prompt prefill:
    the flash kernel and the capacity-drop dispatch) at the published
    widths of deepseek-v3-671b cut to 5 layers (its 3 dense layers and 2
    MoE layers; bf16, seeded random weights), 8 lanes, max_len 2,048,
    16-token pages, 32 new tokens each: every request finishes, one
    ``flash_attention`` launch per layer per prefill, one ``paged_gather``
    per layer per decode step, no ``paged_decode_attention``; tok/s, peak
    memory, a 1,024-token whole prompt and a 2,048-token prompt in
    1,024-token chunks with their profiled splits (cuBLAS, flash, the MoE
    dispatch range, the rest) and the decode step with its busy share and
    launches;
20. the same for qwen3-moe-235b-a22b cut to 10 layers, whose GQA layers
    decode through ``paged_decode_attention`` (64 over 4 heads), exactly
    one launch per layer per decode step;
21. train reduced deepseek-v3-671b and qwen3-moe-235b-a22b (80 tokens) as
    phase 10 does qwen2.5-3b, card against CPU, with each step's aux loss
    logged and held to the CPU's and the routed expert choices compared
    dispatch for dispatch;
22. train qwen3-moe-235b-a22b at published widths cut to 2 layers
    (``MOE_TRAIN``: bf16, seeded random weights, momentum, batch 8 x 1,024
    tokens, remat full, the capacity-drop dispatch, the chunked-scan
    attention) through ``Trainer`` for 6 steps: every loss finite, one
    ``stream_gd`` launch per step; step ms, trained tokens/s, peak memory
    beside ``launch.train.training_bytes``, the forward's and backward's
    peaks, the step's work against its bound, one layer's attention timed
    alone, a profiled step's split (the MoE dispatch and the attention as
    ranges); then the eval loss through ``flash_attention`` (one launch per
    layer, D 128 at 64/4 heads) within the bf16 tolerance of ``impl="xla"``;
23. the same for deepseek-v3-671b cut to 4 layers (its 3 dense layers and
    1 MoE layer), sgd, batch 4 x 1,024; flash at D 192, 128 = 128 heads.

``--kernel-times`` runs only phase 2's timed
rows (the served bf16 flash prefill shapes and the three paged-decode
shapes, each held to its plain version and timed against SDPA in turns, and
``ssd_scan``'s prompt and served slice in bf16 and float32, timed alone)
and prints one JSON line of their times; ``--src`` names the
``src`` directory whose ``repro_torch`` it times, so another commit
unpacked under ``build/`` (``git archive``) can be timed in the same call,
one process each: parent, change, change, parent.

A kernel's ``launches`` in the JSON line sums its counts over the paths
that drive it (serving, VGG16 inference, the gather path, the three
training paths, recurrentgemma-9b serving and reduced training, the moe
family's serving and training), each counted from 0 around its own run.
Then it prints one JSON line with each kernel's numbers, the card's name
and power limit, and, last, ``{"ok": true, "device": {...}}``.  Without a
card, or without the package beside it, it exits non-zero and prints no
result.
"""
import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM device memory
PEAK_FLOPS = {"torch.bfloat16": 989e12,        # dense tensor-core bf16
              "torch.float32": 67e12}          # float32 outside the tensor cores
TOL = {"torch.bfloat16": (2e-2, 2e-2),         # both sides round to bf16 (one ulp
       "torch.float32": (1e-4, 1e-4)}          # near 1 is 2^-8); f32: sum order
H, HKV, D, PS = 16, 2, 128, 16                 # qwen2.5-3b attention widths
CNN_BATCH = 16                                 # images per VGG16 forward
SERVE_KERNELS = ("paged_decode_attention", "flash_attention")
CNN_KERNELS = ("stream_mac_conv", "stream_maxpool", "tiled_matmul")
SSM = dict(h=24, p=64, n=128, chunk=256)       # mamba2-130m's SSD widths
RG = dict(h=16, hkv=1, d=256, window=2048, chunk=1024)   # recurrentgemma-9b's attention
# deepseek-v3's MLA: heads, qk_nope + qk_rope, latent, qk_rope
MLA = dict(h=128, d=192, rank=512, rope=64)
QM = dict(h=64, hkv=4)                         # qwen3-moe's attention heads (head_dim 128)
# the served flash prefill shapes that phase 2 times in bf16 against SDPA
FLASH_SERVED = {
    "prefill": dict(sq=512, sk=512, q_offset=0, kv_len=512, window=None),   # qwen2.5-3b
    "rg prompt": dict(sq=3072, sk=3072, q_offset=0, kv_len=3072, window=RG["window"],
                      h=RG["h"], hkv=RG["hkv"], d=RG["d"]),
    "rg chunk": dict(sq=1024, sk=4096, q_offset=2048, kv_len=3072, window=RG["window"],
                     h=RG["h"], hkv=RG["hkv"], d=RG["d"]),
    "mla prompt": dict(sq=1024, sk=1024, q_offset=0, kv_len=1024, window=None, h=MLA["h"],
                       hkv=MLA["h"], d=MLA["d"]),
    "qwen3-moe prompt": dict(sq=1024, sk=1024, q_offset=0, kv_len=1024, window=None,
                             h=QM["h"], hkv=QM["hkv"]),
}
# the full-width moe models served on one card, cut in depth only (their
# published depths, 61 and 94 layers, take 1.3 TB and 470 GB in bf16):
# deepseek-v3-671b keeps its 3 dense layers and 2 of its 58 MoE layers
# (26.62 B parameters, 53.24 GB; 6 layers would take 76.3 GB), qwen3-moe
# 10 of its 94 MoE layers (26.12 B, 52.26 GB)
MOE_DEPTH = {"deepseek-v3-671b": 5, "qwen3-moe-235b-a22b": 10}
# kernel: (its source, the TPU kernel it replaces, the library yardstick)
KERNELS = {
    "paged_decode_attention": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                               "src/repro/kernels/paged_attn.py:130", "SDPA"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:87", "SDPA"),
    "stream_mac_conv": ("src/repro_torch/kernels/csrc/stream_mac_conv.cu",
                        "src/repro/kernels/stream_mac_conv.py:85", "F.conv2d"),
    "stream_maxpool": ("src/repro_torch/kernels/csrc/stream_maxpool.cu",
                       "src/repro/kernels/stream_maxpool.py:31", "F.max_pool2d"),
    "tiled_matmul": ("src/repro_torch/kernels/csrc/tiled_matmul.cu",
                     "src/repro/kernels/tiled_matmul.py:38", "torch.matmul"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:89", None),
    "paged_gather": ("src/repro_torch/kernels/csrc/paged_gather.cu",
                     "src/repro/kernels/paged_attn.py:45", "index_select"),
    "stream_gd": ("src/repro_torch/kernels/csrc/stream_gd.cu",
                  "src/repro/kernels/stream_gd.py:28", "torch.add"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(text: str) -> list[str]:
    """One line per kernel instantiation from nvcc's ``-Xptxas -v`` output:
    registers, spills (shared memory is dynamic, sized at launch)."""
    out, name, spill = [], None, ""
    int_arg = {"maxpool_valid": "V", "matmul_tiled": "aligned",
               "stream_gd_update": "J1, J2", "conv_igemm_wgmma": "BN",
               "ssd_scan_mma": "VEC, PP, TMA", "ssd_scan_fma": "VEC, PP"}   # else head_dim
    types = {"f": "f32", "13__nv_bfloat16": "bf16", "5uint4": "16 B", "5uint2": "8 B",
             "j": "4 B", "t": "2 B", "h": "1 B", None: ""}
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '.*?(paged_decode_mma|paged_decode_fma|"
                      r"flash_attn_fwd|flash_attn_mma|flash_attn_wgmma|conv_igemm_wgmma|conv_igemm|"
                      r"maxpool_valid|matmul_tiled_stream|matmul_tiled|"
                      r"ssd_scan_mma|ssd_scan_fma|paged_gather_bulk|stream_gd_update)"
                      r"(?:I(13__nv_bfloat16|5uint4|5uint2|f|j|t|h)?(?:L[ib](\d+)E)?"
                      r"(?:Li(\d+)E)?(?:Lb(\d+)E)?)?", line)
        if m:
            label = int_arg.get(m.group(1), "D")
            vals = [x for x in m.group(3, 4, 5) if x]
            names = label.split(", ")
            ints = (", ".join(f"{k}={v}" for k, v in zip(names, vals)) if len(names) == len(vals)
                    else f"{label}={', '.join(vals)}" if vals else "")
            args = [types[m.group(2)], ints]
            args = ", ".join(x for x in args if x)
            name = f"{m.group(1)}<{args}>" if args else m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 50) -> float:
    """Median device time of one call, each launched after a 64 MB write
    that evicts the 50 MB L2 (the real caller finds its operands cold)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def check_close(name, out, plain, dtype) -> float:
    atol, rtol = TOL[str(dtype)]
    err = (out.float() - plain.float()).abs()
    ok = bool((err <= atol + rtol * plain.float().abs()).all())
    rel = float(err.max() / plain.float().abs().max().clamp_min(1e-30))
    log(f"  {name} {dtype}: max_abs_err {float(err.max()):.3e} max_rel_err {rel:.3e} "
        f"(atol {atol:g}, rtol {rtol:g}) -> {'ok' if ok else 'MISMATCH'}")
    if not ok or not torch.isfinite(out).all():
        raise SystemExit(f"chip_smoke: {name} {dtype} disagrees with its plain version")
    return float(err.max())


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def in_turns(kernel, library, lib_name: str, calls: int = 1000) -> dict:
    """Event (``time_ms``), device (``device_ms``, cold) and host-issue
    (``host_ms`` over ``calls`` calls) time per call of ``kernel`` and of
    ``library`` (None: the kernel alone), taken in turns (kernel, library,
    library, kernel); logs each and returns {metric: (kernel, library)},
    the means of the two turns (library None where there is none)."""
    got = {}
    for metric, how in (("event", time_ms), ("device", lambda f: device_ms(f, 20, cold=True)),
                        ("host", lambda f: host_ms(f, calls))):
        if library is None:
            k1, k2 = how(kernel), how(kernel)
            got[metric] = ((k1 + k2) / 2, None)
            log(f"    {metric:6s} ms per call: kernel {k1:.4f} / {k2:.4f}")
            continue
        k1, l1, l2, k2 = how(kernel), how(library), how(library), how(kernel)
        got[metric] = ((k1 + k2) / 2, (l1 + l2) / 2)
        log(f"    {metric:6s} ms per call: kernel {k1:.4f} / {k2:.4f}, {lib_name} {l1:.4f} / "
            f"{l2:.4f}")
    return got


def timed_row(name, err, kernel, plain, library, nbytes, flops, dtype, shape,
              plain_iters=50, turns=False, calls=200) -> dict:
    """The kernels-line entry of one checked case: kernel, plain and
    library times and the bound (``dtype`` names the peak rate).  With
    ``turns`` the kernel and the library are timed by ``in_turns`` (issue
    over ``calls`` calls: few enough that the launch queue never fills) and
    the row also holds their device and host-issue times."""
    source, replaces, lib_name = KERNELS[name]
    b_ms, b_by = bound(nbytes, flops, dtype)
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by, "shape": shape}
    if turns:
        log(f"  timing {shape} in turns:")
        got = in_turns(kernel, library, lib_name or "", calls)
        row.update(ms=got["event"][0], library_ms=got["event"][1],
                   device_ms=got["device"][0], host_ms=got["host"][0],
                   library_device_ms=got["device"][1], library_host_ms=got["host"][1])
        log(f"    device time at {100 * b_ms / row['device_ms']:.0f} % of the bound"
            + ("" if library is None else
               f"; kernel / {lib_name}: event {row['ms'] / row['library_ms']:.2f}, device "
               f"{row['device_ms'] / row['library_device_ms']:.2f}"))
    else:
        row.update(ms=time_ms(kernel), library_ms=None if library is None else time_ms(library))
    row["plain_ms"] = time_ms(plain, plain_iters)
    return row


def log_row(row) -> None:
    lib = KERNELS[row["name"]][2]
    lib = (f"{lib} {row['library_ms']:.4f} ms" if lib else
           "no single PyTorch call computes it")
    extra = ""
    if "device_ms" in row:
        extra = f"; device {row['device_ms']:.4f} ms, host issue {row['host_ms']:.4f} ms"
        if row["library_device_ms"] is not None:
            extra += (f" ({KERNELS[row['name']][2]} device {row['library_device_ms']:.4f}, "
                      f"host {row['library_host_ms']:.4f})")
    if row.get("floor_ms") is not None:
        extra += f"; empty-launch floor {row['floor_ms']:.4f} ms (device)"
    if "empty_ms" in row:
        extra += f"; every lane empty {row['empty_ms']:.4f} ms (device)"
    log(f"  timing {row['shape']}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"{lib}, bound {row['bound_ms']:.4f} ms ({row['bound_by']}){extra}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


# lane lengths of the paged-decode cases: ragged up to 1,024 tokens over 64
# slots (two tables with holes), and qwen3-moe's served decode (phase 20:
# 8 lanes at ~1,036 tokens, max_len 2,048 = 128 slots, no holes)
PAGED_RAGGED = [0, 1, 17, 100, 1024, 513, 64, 999]
PAGED_SERVED_MOE = [1036, 1029, 1041, 1033, 1038, 1031, 1044, 1036]


def empty_launch_ms() -> float | None:
    """Device time (profiler) of one launch of a kernel that does nothing:
    the floor no single launch goes under.  None for a ``repro_torch``
    whose library has no such kernel (an older commit)."""
    import ctypes

    from repro_torch.kernels import build

    fn = getattr(build.library("paged_attn"), "paged_decode_empty_launch", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    return device_ms(lambda: fn(stream), 50)


def profiled_kernels(fn) -> list[str]:
    """The names of the device kernels one call of ``fn`` launches."""
    return [name for name, _ in profiled_launches(fn)]


def paged_case(dtype, timed: bool, h=H, hkv=HKV, label="qwen2.5-3b", lens=None,
               slots=1024 // PS, holes=True, floor=None, design=True):
    """Paged decode of 8 lanes (``lens``, default ``PAGED_RAGGED``) over
    ``slots``-slot tables, with holes in two tables when ``holes``; ``h``
    query heads over ``hkv`` KV heads of head_dim D.  With ``design`` a call
    must be one launch of the compiled kernel its dtype calls for
    (``paged_decode_mma<D>`` in bf16, ``paged_decode_fma<D>`` in float32).
    Timed, the row also
    holds ``floor`` (``empty_launch_ms``), logged beside the bound, and the
    device time of the same call with every lane empty (``empty_ms``): the
    kernel's work around its loads (staging, merging, barriers) alone."""
    from repro_torch.kernels import ops, ref

    F = torch.nn.functional
    lens = PAGED_RAGGED if lens is None else lens
    b, p = len(lens), slots
    n_pages = b * p + 8
    gen = torch.Generator(device="cuda").manual_seed(1)
    perm = torch.randperm(n_pages, generator=gen, device="cuda")[: b * p]
    bt = perm.reshape(b, p).to(torch.int32)
    for i, n in enumerate(lens):
        bt[i, -(-n // PS):] = -1
    if holes:
        bt[3, 2] = -1                             # a hole inside lane 3's length
        bt[6, 0] = -1                             # and one at lane 6's start
    q = torch.randn(b, h, D, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(n_pages, PS, hkv, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(n_pages, PS, hkv, D, generator=gen, device="cuda").to(dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")

    def plain():
        return ref.paged_decode_attention(
            q.view(b, hkv, h // hkv, D), kp.permute(2, 0, 1, 3), vp.permute(2, 0, 1, 3),
            bt, ln).view(b, h, D)

    def kernel():
        return ops.paged_attention(q, kp, vp, bt, ln)

    before = ops.LAUNCHES["paged_decode_attention"]
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    launched = ops.LAUNCHES["paged_decode_attention"] - before
    err = check_close(f"paged_decode_attention[{label}]", out, want, dtype)
    names = profiled_kernels(kernel)
    log(f"    design: {ops.PATHS.get('paged_decode_attention', 'one design')}, {launched} "
        f"launch(es) a call; profiled kernels: {names}")
    expected = f"paged_decode_{'mma' if dtype == torch.bfloat16 else 'fma'}<{D}>"
    if design and (launched != 1 or names != [expected]):
        raise SystemExit(f"chip_smoke: paged_decode_attention[{label}] made {launched} "
                         f"launches of {names}, expected one of {expected}")
    if not timed:
        return None
    # tokens this run's tables really hold: positions < length on pages != -1
    valid = (torch.arange(p * PS, device="cuda")[None] < ln[:, None].long()) & (
        bt >= 0).repeat_interleave(PS, dim=1)
    tokens = int(valid.sum())
    item = q.element_size()
    nbytes = 2 * b * h * D * item + tokens * hkv * D * 2 * item + bt.numel() * 4 + b * 4
    flops = 4.0 * tokens * h * D
    # library yardstick: SDPA over a pre-gathered contiguous view (gather untimed)
    idx = bt.long().clamp(0, n_pages - 1)
    kg = kp[idx].reshape(b, p * PS, hkv, D).transpose(1, 2).contiguous()
    vg = vp[idx].reshape(b, p * PS, hkv, D).transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask, enable_gqa=True)

    row = timed_row("paged_decode_attention", err, kernel, plain, library, nbytes, flops,
                    dtype, f"{label}: 8 lanes, {tokens} tokens, {p} slots, H={h} Hkv={hkv} "
                    f"D={D} PS={PS} {dtype}", turns=True)
    row["floor_ms"] = floor
    none = torch.zeros_like(ln)
    row["empty_ms"] = device_ms(lambda: ops.paged_attention(q, kp, vp, bt, none), 20, cold=True)
    return row


def flash_kernel_name(dtype, d) -> str:
    """The compiled kernel ``flash_attention`` must launch for ``dtype`` and
    head dim ``d``: the CUDA-core loop in float32, mma.sync at bf16 D <= 64,
    wgmma + TMA at the served bf16 head dims."""
    if dtype == torch.float32:
        return f"flash_attn_fwd<float, {d}>"
    return f"flash_attn_mma<{d}>" if d <= 64 else f"flash_attn_wgmma<{d}>"


def flash_case(dtype, label, sq, sk, q_offset, kv_len, window, timed, h=H, hkv=HKV, d=D,
               turns=False, b=1, expand=False, design=True):
    """One flash case at batch ``b`` against its plain version, logging the
    design it took and (``design``) holding the profiled kernel to
    ``flash_kernel_name``; ``expand``: k and v one slice expanded over the
    batch (stride 0).  Timed, its row (``turns``: by ``in_turns`` against
    SDPA)."""
    from repro_torch.kernels import ops, ref

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(2)
    # the model's (B, S, H, D) projections, viewed as (B, H, S, D)
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    k, v = (torch.randn(1 if expand else b, sk, hkv, d, generator=gen, device="cuda")
            .to(dtype).expand(b, sk, hkv, d).transpose(1, 2) for _ in range(2))
    kw = dict(causal=True, window=window, q_offset=q_offset, kv_len=kv_len)

    def kernel():
        return ops.flash_attention(q, k, v, **kw)

    def plain():
        return ref.flash_attention(q, k, v, **kw)

    out, want = kernel(), plain()
    torch.cuda.synchronize()
    err = check_close(f"flash_attention[{label}]", out, want, dtype)
    path = ops.PATHS.get("flash_attention")
    names = profiled_kernels(kernel)
    log(f"    design: {path}; profiled kernel: {names}")
    if design and names != [flash_kernel_name(dtype, d)]:
        raise SystemExit(f"chip_smoke: flash_attention[{label}] launched {names}, expected "
                         f"{flash_kernel_name(dtype, d)}")
    if not timed:
        return None
    qpos = torch.arange(sq, device="cuda")[:, None] + q_offset
    kpos = torch.arange(sk, device="cuda")[None, :]
    mask = (kpos < kv_len) & (qpos >= kpos)
    if window is not None:
        mask &= (qpos - kpos) < window
    # the keys some query sees: the window's span, not the whole cache
    keys = int(mask.any(0).sum())
    pairs = int(mask.sum())
    item = q.element_size()
    nbytes = b * 2 * sq * h * d * item + (1 if expand else b) * keys * hkv * d * 2 * item
    flops = 4.0 * b * pairs * h * d

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

    return timed_row("flash_attention", err, kernel, plain, library, nbytes, flops, dtype,
                     f"{label}: Sq={sq} Sk={sk} q_offset={q_offset} kv_len={kv_len} "
                     f"window={window} H={h} Hkv={hkv} D={d} {dtype}", turns=turns)


def conv_case(dtype, l, label, timed):
    from repro_torch.kernels import ops, ref

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(CNN_BATCH, l.yi, l.xi, l.ci, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(l.kx, l.ky, l.ci, l.co, generator=gen, device="cuda")
         * (2.0 / (l.kx * l.ky * l.ci)) ** 0.5).to(dtype)
    stride, pad = (l.sy, l.sx), (l.py, l.px)

    def kernel():
        return ops.stream_mac_conv(x, w, stride, pad)

    def plain():
        return ref.stream_mac_conv(x, w, stride, pad)

    out, want = kernel(), plain()
    torch.cuda.synchronize()
    path = ops.PATHS["stream_mac_conv"]
    err = check_close(f"stream_mac_conv[{label}] ({path})", out, want, dtype)
    # the fused bias + ReLU epilogue against the kernel, then add_ and relu_
    b = (torch.randn(l.co, generator=gen, device="cuda") * 0.5).to(dtype)
    fused = ops.stream_mac_conv(x, w, stride, pad, bias=b, relu=True)
    same = torch.equal(fused, kernel().add_(b).relu_())
    log(f"  stream_mac_conv[{label}] {dtype}: bias + ReLU epilogue bit-equal to add_, relu_: "
        f"{same}")
    if not same:
        raise SystemExit(f"chip_smoke: the fused conv epilogue differs ({label}, {dtype})")
    if not timed:
        return None
    nbytes = (x.numel() + w.numel() + out.numel()) * x.element_size()
    flops = 2.0 * out.numel() * l.kx * l.ky * l.ci
    # yardstick: cuDNN on the same memory (NHWC is channels-last NCHW)
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def library():
        return F.conv2d(xc, wc, stride=stride, padding=pad)

    return timed_row("stream_mac_conv", err, kernel, plain, library, nbytes, flops, dtype,
                     f"{label}: {CNN_BATCH}x{l.yi}x{l.xi}x{l.ci} -> {l.co}, {l.kx}x{l.ky} "
                     f"stride {l.sx} pad {l.px}, {dtype}", plain_iters=20)


def pool_case(dtype, l, label, timed):
    from repro_torch.kernels import ops, ref

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(CNN_BATCH, l.yi, l.xi, l.ci, generator=gen, device="cuda").to(dtype)
    win, stride = (l.ky, l.kx), (l.sy, l.sx)

    def kernel():
        return ops.stream_maxpool(x, win, stride)

    def plain():
        return ref.stream_maxpool(x, win, stride)

    out, want = kernel(), plain()
    torch.cuda.synchronize()
    same = torch.equal(out, want)
    log(f"  stream_maxpool[{label}] {dtype}: bit-equal to the plain version: {same}")
    if not same:
        raise SystemExit(f"chip_smoke: stream_maxpool {dtype} differs from its plain version")
    if not timed:
        return None
    nbytes = (x.numel() + out.numel()) * x.element_size()
    xc = x.permute(0, 3, 1, 2)

    def library():
        return F.max_pool2d(xc, win, stride)

    # one comparison per window tap, on the CUDA cores (the float32 rate)
    return timed_row("stream_maxpool", 0.0, kernel, plain, library, nbytes,
                     float(out.numel() * l.kx * l.ky), torch.float32,
                     f"{label}: {CNN_BATCH}x{l.yi}x{l.xi}x{l.ci}, window {l.kx}x{l.ky} "
                     f"stride {l.sx}, {dtype}")


def fc_case(dtype, l, label, timed):
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(8)
    k = l.kx * l.ky * l.ci
    x = torch.randn(CNN_BATCH, k, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(k, l.co, generator=gen, device="cuda") * (2.0 / k) ** 0.5).to(dtype)

    def kernel():
        return ops.tiled_matmul(x, w)

    def plain():
        return ref.tiled_matmul(x, w)

    out, want = kernel(), plain()
    torch.cuda.synchronize()
    path = ops.PATHS["tiled_matmul"]
    err = check_close(f"tiled_matmul[{label}] ({path})", out, want, dtype)
    if not torch.equal(out, kernel()):
        raise SystemExit(f"chip_smoke: tiled_matmul[{label}] {dtype} differs between calls")
    if not timed:
        return None
    nbytes = (x.numel() + w.numel() + out.numel()) * x.element_size()

    def library():
        return torch.matmul(x, w)

    return timed_row("tiled_matmul", err, kernel, plain, library, nbytes,
                     2.0 * CNN_BATCH * k * l.co, dtype,
                     f"{label}: ({CNN_BATCH}, {k}) @ ({k}, {l.co}), {dtype}")


def ssd_kernel_name(dtype) -> str:
    """The compiled kernel ``ssd_scan`` must launch: mma.sync in bf16, the
    CUDA cores in float32."""
    return "ssd_scan_mma" if dtype == torch.bfloat16 else "ssd_scan_fma"


def profiled_launches(fn) -> list[tuple[str, int]]:
    """(name, launches) of each device kernel one call of ``fn`` launches.  A
    profile that holds no kernel at all (the tracer now and then drops a
    profile's kernel records) is taken again, up to three times."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        got = sorted((e.key.replace("(anonymous namespace)::", "").replace("void ", "")
                      .split("(")[0][:60], e.count) for e in prof.key_averages()
                     if str(getattr(e, "device_type", "")).endswith("CUDA"))
        if got:
            return got
    return got


def ssd_bounds(dtype, batch, seq, carried) -> tuple[float, float, float]:
    """(bytes, operations of the design, float32 operations) of one
    ``ssd_scan`` call at mamba2-130m's widths.  Bytes: x, B, C and dt read
    once, y written in float32, the state read (carried) and written.  The
    float32 figure is every product once (the causal halves of the head-free
    C.B^T and of the y product, C.S and the update), at the CUDA cores'
    rate: the bound the first version of the kernel was held to.  The bf16
    design issues C.B^T once, the y product and C.S in three bf16 terms and
    the update in two."""
    h, p, n, chunk = SSM["h"], SSM["p"], SSM["n"], SSM["chunk"]
    q = min(chunk, seq)
    nc, tri = seq // q, q * (q + 1) / 2
    f32 = 2.0 * batch * nc * (tri * (n + h * p) + 2 * q * n * h * p)
    ops = f32 if dtype == torch.float32 else 2.0 * batch * nc * (
        tri * n + 3 * tri * h * p + (3 + 2) * q * n * h * p)
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (batch * seq * (h * p + 2 * n) * item + batch * seq * h * 4 + h * 4
              + batch * seq * h * p * 4 + (2 if carried else 1) * batch * h * p * n * 4)
    return nbytes, ops, f32


def ssd_case(dtype, label, seq, carried, timed, batch=1, clip=False, design=True):
    """``ssd_scan`` at mamba2-130m's widths, x/B/C strided views of one conv
    output as the model hands them over, ``batch`` rows (each its own
    carried state); ``clip``: dt and a large enough that a chunk's seg spans
    more than 120, so the decay clip engages.  Logs the design
    (``ops.PATHS``) and the profiled kernels: one launch of
    ``ssd_kernel_name`` (``design``: else it fails).  Timed, its row by
    ``in_turns``, with the design's bound and the float32 one beside it."""
    from repro_torch.kernels import ops, ref

    h, p, n, chunk = SSM["h"], SSM["p"], SSM["n"], SSM["chunk"]
    gen = torch.Generator(device="cuda").manual_seed(10)
    conv = (torch.randn(batch, seq, h * p + 2 * n, generator=gen, device="cuda") * 0.5).to(dtype)
    xh = conv[..., :h * p].reshape(batch, seq, h, p)
    bb, cc = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    if clip:
        dt = torch.rand(batch, seq, h, generator=gen, device="cuda") * 0.5 + 0.5
        a = -(torch.rand(h, generator=gen, device="cuda") + 1.0)
    else:
        dt = torch.rand(batch, seq, h, generator=gen, device="cuda") * 0.49 + 0.01
        a = -(torch.rand(h, generator=gen, device="cuda") + 0.5)
    st = torch.randn(batch, h, p, n, generator=gen, device="cuda") if carried else None
    q = min(chunk, seq)
    if clip:
        span = float((dt * a).reshape(batch, seq // q, q, h).sum(2).abs().max())
        log(f"  ssd_scan[{label}]: the largest span of seg in a chunk is {span:.1f}")
        if span <= 120:
            raise SystemExit(f"chip_smoke: ssd_scan[{label}] does not engage the clip")

    def kernel():
        return ops.ssd_scan(xh, bb, cc, dt, a, chunk, st)

    def plain():
        return ref.ssd_scan(xh, bb, cc, dt, a, chunk, st)

    (y, fin), (want_y, want_fin) = kernel(), plain()
    torch.cuda.synchronize()
    if clip:
        # where the clip engages, whole runs of tokens carry clipped weights
        # that hang on seg to a few ulp and on float32 sums of e^60-sized
        # terms: the plain version evaluated in float32 is itself up to 3.2x
        # the tolerance from the exact result (its serial cumsum on the
        # card; on the CPU it depends on the host), so the kernel is held to
        # the plain version evaluated in float64 and the float32 one is logged
        gap = float((want_y - y).abs().max())
        want_y, want_fin = ref.ssd_scan(xh, bb, cc, dt, a, chunk, st, dtype=torch.float64)
        log(f"  ssd_scan[{label}]: the plain version in float32 is {gap:.3e} from the kernel's "
            "y; held to the plain version in float64:")
    # y and the state are float32 whatever the inputs: float32 tolerance
    err = max(check_close(f"ssd_scan[{label}] y", y, want_y, torch.float32),
              check_close(f"ssd_scan[{label}] final state", fin, want_fin, torch.float32))
    got = profiled_launches(kernel)
    log(f"    design: {ops.PATHS.get('ssd_scan')}; profiled: "
        f"{got or 'nothing recorded (the tracer dropped the profile; not measured)'}")
    if design and got and (len(got) != 1 or got[0][1] != 1
                   or got[0][0].split("<")[0] != ssd_kernel_name(dtype)):
        raise SystemExit(f"chip_smoke: ssd_scan[{label}] launched {got}, expected one "
                         f"{ssd_kernel_name(dtype)}")
    if not timed:
        return None
    nbytes, ops_n, f32 = ssd_bounds(dtype, batch, seq, carried)
    row = timed_row("ssd_scan", err, kernel, plain, None, nbytes, ops_n, dtype,
                    f"{label}: B={batch} S={seq} H={h} P={p} N={n} chunk={chunk} {dtype}",
                    turns=True)
    row["bound_f32_ms"] = bound(nbytes, f32, torch.float32)[0]
    log(f"    bound {row['bound_ms']:.4f} ms ({row['bound_by']}; bytes at 3.35 TB/s "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}, the design's products "
        f"{ops_n / PEAK_FLOPS[str(dtype)] * 1e3:.4f}); every product once at float32's "
        f"67 TFLOP/s {row['bound_f32_ms']:.4f} ms (the first version's bound)")
    return row


# phase 2's ssd_scan cases: (label, tokens, carried state, batch, clip, timed in bf16);
# the timed rows are the prompt (two chunks from zero) and the served slice (one
# chunk with a carried state: what phase 8 launches)
SSD_CASES = [("prompt", 512, False, 1, False, True),
             ("served slice", 256, True, 1, False, True),
             ("carried", 512, True, 1, False, False),
             ("ragged slice", 44, True, 1, False, False),
             ("1-token slice", 1, True, 1, False, False),
             ("255-token slice", 255, True, 1, False, False),
             ("eval, B 4", 1024, False, 4, False, False),
             ("eval, B 4 carried", 1024, True, 4, False, False),
             ("B 2 carried", 256, True, 2, False, False),
             ("clip", 512, True, 1, True, False)]


# the lanes' lengths in tokens of phase 2's gather tables (-1 past them)
QWEN_LENS = (0, 1, 17, 100, 1024, 513, 64, 999)
RG_LENS = (0, 1, 17, 2100, 4096, 513, 3000, 999)
MLA_LENS = (0, 1, 17, 1100, 2048, 513, 1500, 999)
# (label, pools as (leading layers or None, row elements), slots, lane lengths)
GATHER_CASES = [
    ("qwen2.5-3b leaf, 36 layers", [(36, PS * HKV * D)], 1024 // PS, QWEN_LENS),
    ("recurrentgemma layer's k pool", [(None, PS * RG["hkv"] * RG["d"])], 4096 // PS,
     RG_LENS),
    ("recurrentgemma layer's k + v", [(None, PS * RG["hkv"] * RG["d"])] * 2, 4096 // PS,
     RG_LENS),
    ("MLA layer's latent pool", [(None, PS * MLA["rank"])], 2048 // PS, MLA_LENS),
    ("MLA layer's latent + k_rope", [(None, PS * MLA["rank"]), (None, PS * MLA["rope"])],
     2048 // PS, MLA_LENS),
]


def host_ms(fn, calls: int = 1000) -> float:
    """Host time to issue one call: ``calls`` calls back to back on the
    host's clock, then one synchronise outside the timed span."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e3


def gather_case(dtype, timed: bool, label: str, specs, slots: int, lens):
    """``paged_gather_many`` of the pools ``specs`` ((leading layers or
    None, row elements) each) through one table of 8 lanes x ``slots``
    slots of 16-token pages with -1 past each lane's length and a hole in
    lane 3: bit-equal to the plain version, one launch.  Timed, it logs
    the event time (``time_ms``), the device time (``device_ms``, cold) and
    the host's issue time per call (``host_ms``) of the kernel and of one
    ``index_select`` per pool, taken in turns (kernel, library, library,
    kernel), beside the bound, and returns the kernels-line entry."""
    from repro_torch.kernels import ops, ref

    lanes = len(lens)
    n_pages = lanes * slots + 8
    gen = torch.Generator(device="cuda").manual_seed(11)
    pools = [torch.randn(*(() if layers is None else (layers,)), n_pages, f, generator=gen,
                         device="cuda").to(dtype) for layers, f in specs]
    bt = torch.randperm(n_pages, generator=gen, device="cuda")[: lanes * slots].reshape(
        lanes, slots).to(torch.int32)
    for i, n in enumerate(lens):
        bt[i, -(-n // PS):] = -1
    bt[3, 2] = -1                                   # a hole inside lane 3
    idx = bt.long().clamp(0, n_pages - 1).reshape(-1)

    def kernel():
        return ops.paged_gather_many(pools, bt)

    def plain():
        return ref.paged_gather_many(pools, bt)

    def library():          # the same copies, holes read as page 0 (not zeroed)
        return [torch.index_select(p, p.dim() - 2, idx) for p in pools]

    before = ops.LAUNCHES["paged_gather"]
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    launched = ops.LAUNCHES["paged_gather"] - before
    same = all(torch.equal(o, w) for o, w in zip(out, want))
    log(f"  paged_gather {dtype} ({label}: {lanes} x {slots} slots, {len(pools)} pool(s) in "
        f"{launched} launch): bit-equal to the plain version: {same}")
    if not same or launched != 1:
        raise SystemExit(f"chip_smoke: paged_gather {dtype} {label} differs from its plain "
                         f"version or took {launched} launches")
    del out, want
    if not timed:
        return None
    filled = int((bt >= 0).sum())
    nbytes = sum((layers or 1) * (lanes * slots + filled) * f * pool.element_size()
                 for (layers, f), pool in zip(specs, pools)) + bt.numel() * 4
    b_ms, b_by = bound(nbytes, 0.0, dtype)
    got = in_turns(kernel, library, f"index_select x {len(pools)}")
    dev = got["device"][0]
    log(f"    bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB): kernel device time at "
        f"{100 * b_ms / dev:.0f} % of it, index_select's at {100 * b_ms / got['device'][1]:.0f} "
        f"%; event time kernel / index_select {got['event'][0] / got['event'][1]:.2f}")
    source, replaces, _ = KERNELS["paged_gather"]
    return {"name": "paged_gather", "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": 0.0, "ms": got["event"][0], "plain_ms": time_ms(plain),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": got["event"][1],
            "shape": f"{label}, {lanes} lanes x {slots} slots ({filled} filled) {dtype}"}


# ---------------------------------------------------------------------------
# phases 5 and 6: ConvNet inference
# ---------------------------------------------------------------------------


def vgg16_forward(smi: str) -> dict[str, int]:
    """Full-width VGG16 in bf16 at batch 16: the launch counts of one
    forward (returned), images/s over several, and a profiler split of
    device time."""
    from repro_torch.core import zoo
    from repro_torch.core.convnet import ConvNetExecutor
    from repro_torch.kernels import ops

    layers = zoo.vgg16()
    exe = ConvNetExecutor(layers)
    t0 = time.perf_counter()
    params = exe.init(torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(CNN_BATCH, 224, 224, 3, generator=gen, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for p in params.values() for t in p.values())
    log(f"  init: {n_params / 1e6:.1f} M parameters in {time.perf_counter() - t0:.1f} s; "
        f"{exe.flops_per_example() / 2e9:.2f} GMAC per image")
    for _ in range(2):                                # warm-up: first launches
        exe.apply(params, x)
    torch.cuda.synchronize()
    ops.reset_launches()
    logits = exe.apply(params, x)
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in CNN_KERNELS}
    log(f"  one forward: logits {tuple(logits.shape)} {logits.dtype}, kernel launches "
        f"{launches}")
    if logits.shape != (CNN_BATCH, 1000) or not torch.isfinite(logits).all():
        raise SystemExit(f"chip_smoke: bad VGG16 logits {tuple(logits.shape)}")
    kinds = [l.kind for l in layers]
    want = {"stream_mac_conv": kinds.count("conv"), "stream_maxpool": kinds.count("pool"),
            "tiled_matmul": kinds.count("fc")}
    if launches != want:
        raise SystemExit(f"chip_smoke: VGG16 forward launched {launches}, want {want}")

    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.apply(params, x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    fwd = statistics.median(times)
    log(f"  forward of {CNN_BATCH} images: median {fwd * 1e3:.2f} ms over {len(times)} "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = "
        f"{CNN_BATCH / fwd:.1f} images/s ({smi})")

    steps = 3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            exe.apply(params, x)
        torch.cuda.synchronize()
    groups: dict[str, float] = {}
    counts: dict[str, int] = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        g = ("conv (stream_mac_conv)" if "conv_igemm" in name else
             "pool (stream_maxpool)" if "maxpool_valid" in name else
             "fc (tiled_matmul)" if "matmul_tiled" in name else
             "other (fc bias and ReLU, Ci pad)")
        groups[g] = groups.get(g, 0.0) + us / 1e3 / steps
        counts[g] = counts.get(g, 0) + e.count // steps
    busy = sum(groups.values())
    if busy == 0:
        log("  profiler: no device time recorded (breakdown not measured)")
        return launches
    log(f"  profiler ({steps} forwards): device busy {busy:.3f} ms per forward = "
        f"{100 * busy / (fwd * 1e3):.1f} % of the unprofiled forward")
    for g in sorted(groups, key=groups.get, reverse=True):
        log(f"    {g}: {groups[g]:.3f} ms per forward ({100 * groups[g] / busy:.1f} % of busy) "
            f"over {counts[g]} launches")
    conv_ms = groups.get("conv (stream_mac_conv)", 0.0)
    conv_flops = CNN_BATCH * sum(l.flops for l in layers if l.kind == "conv")
    log(f"    conv: {conv_flops / 1e9:.1f} GFLOP per forward at "
        f"{conv_flops / (conv_ms * 1e-3) / 1e12:.1f} TFLOP/s "
        f"({100 * conv_flops / (conv_ms * 1e-3) / PEAK_FLOPS['torch.bfloat16']:.1f} % of "
        f"the bf16 peak; {smi})")
    other = [g for g in counts if g.startswith("other")]
    if other and counts[other[0]] > 11:
        raise SystemExit(f"chip_smoke: {counts[other[0]]} launches besides the kernels per "
                         "VGG16 forward (bias and ReLU should be in the conv epilogue)")
    return launches


def vgg16_card_vs_cpu(layers, batch, px) -> None:
    """float32 logits of the same weights and images on the card (kernels)
    and on the CPU (plain versions)."""
    from repro_torch.core.convnet import ConvNetExecutor
    from repro_torch.models.common import tree_map

    exe = ConvNetExecutor(layers)
    params = exe.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((batch, px, px, 3))
                         .astype(np.float32))
    t0 = time.perf_counter()
    want = exe.apply(params, x)
    t_cpu = time.perf_counter() - t0
    got = exe.apply(tree_map(lambda t: t.to("cuda"), params), x.to("cuda")).cpu()
    err = (got - want).abs()
    ok = bool((err <= 1e-4 + 1e-4 * want.abs()).all()) and torch.equal(
        got.argmax(-1), want.argmax(-1))
    log(f"  {len(layers)} layers, {batch} images of {px}x{px}: card vs CPU logits max_abs_err "
        f"{float(err.max()):.3e} (|logit| max {float(want.abs().max()):.3f}; atol = rtol = "
        f"1e-4), argmax {got.argmax(-1).tolist()} vs {want.argmax(-1).tolist()} -> "
        f"{'ok' if ok else 'MISMATCH'} (CPU forward {t_cpu:.1f} s)")
    if not ok:
        raise SystemExit("chip_smoke: VGG16 logits differ between card and CPU")


def device_ms(fn, iters: int = 10, cold: bool = False) -> float:
    """Mean device time per call of the kernels ``fn`` launches, from the
    profiler: the host's issue of the call is not in it.  ``cold`` runs
    each call after a 64 MB write that evicts the 50 MB L2, as ``time_ms``
    does, and leaves that write's own kernel out.  A profile that holds no
    device time at all (the tracer now and then drops a profile's kernel
    records) is taken again, up to three times."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                if cold:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA")
                    and not (cold and any(w in e.key.lower() for w in ("fill", "memset"))))
        if total > 0:
            return total / iters / 1e3
    raise SystemExit("chip_smoke: three profiles in a row recorded no device time")


def stream_gd_cases() -> dict:
    """``stream_gd`` in each form a training step launches it, each bit-equal
    to the plain version.  On the largest full-width qwen2.5-3b leaf (seg0's
    mlp.w_up, 36 x 2048 x 11008 elements): sgd (bf16 w, bf16 g, in place),
    the two one-stage momentum launches (f32 m from a bf16 g, then bf16 w
    from the f32 m), J = 3 and 4 in float32, and the fused two-stage
    momentum step (also bit-equal to the two one-stage calls).  On the
    full-width VGG16 parameter tree (32 leaves): sgd (bf16 w and g) and
    fused momentum (bf16 w, f32 g and m), one launch each.  The row times
    the w_up sgd launch; its library yardstick is ``torch.add(w, g,
    alpha=-lr, out=w)`` (Eq. 1 with C0 = 1, one call).  The fused momentum
    is timed beside the two launches, the tree beside one launch per leaf
    and stage and beside ``torch._foreach_add_``, each against its bound."""
    from repro_torch.core import zoo
    from repro_torch.kernels import ops, ref

    shape = (36, 2048, 11008)
    m_el = 36 * 2048 * 11008
    gen = torch.Generator(device="cuda").manual_seed(9)
    bf, f32 = torch.bfloat16, torch.float32
    w = torch.randn(shape, generator=gen, device="cuda").mul_(0.02).to(bf)
    g = torch.randn(shape, generator=gen, device="cuda").mul_(1e-3).to(bf)
    m = torch.randn(shape, generator=gen, device="cuda").mul_(1e-3)
    lr, wd, beta = 1e-3, 0.01, 0.9
    sgd_c = (1.0 - lr * wd, -lr)
    mom_c = [(beta, 1.0), sgd_c]

    def verdict(label, same):
        log(f"  stream_gd[{label}]: bit-equal to the plain version: {same}")
        if not same:
            raise SystemExit(f"chip_smoke: stream_gd {label} differs from its plain version")

    def check(label, out, streams, coeffs):
        want = ref.stream_gd(streams, ops.coeffs_f32(coeffs), out.dtype)
        got = ops.stream_gd_into(out, streams, coeffs)
        torch.cuda.synchronize()
        verdict(label, torch.equal(got, want))
        del want

    def check_foreach(label, leaves, coeffs):
        """One launch over ``leaves`` against the plain version on copies."""
        copies = {}
        for leaf in leaves:
            for out, streams in leaf:
                for t in (out, *streams):
                    if t is not ops.STAGE1 and id(t) not in copies:
                        copies[id(t)] = t.clone()
        plain = [[(copies[id(out)], [s if s is ops.STAGE1 else copies[id(s)] for s in streams])
                  for out, streams in leaf] for leaf in leaves]
        ref.stream_gd_foreach(plain, [ops.coeffs_f32(c) for c in coeffs])
        before = ops.LAUNCHES["stream_gd"]
        ops.stream_gd_foreach(leaves, coeffs)
        torch.cuda.synchronize()
        launched = ops.LAUNCHES["stream_gd"] - before
        verdict(f"{label}, {launched} launch(es)",
                launched == 1 and all(torch.equal(o, p[0]) for leaf, pl in zip(leaves, plain)
                                      for (o, _), p in zip(leaf, pl)))

    check("sgd: w bf16 <- (w bf16, g bf16), in place", w, (w, g), sgd_c)
    check("momentum 1: m f32 <- (m f32, g bf16), in place", m, (m, g), (beta, 1.0))
    check("momentum 2: w bf16 <- (w bf16, m f32), in place", w, (w, m), sgd_c)
    x = [torch.randn(shape, generator=gen, device="cuda") for _ in range(3)]
    out = torch.empty(shape, device="cuda")
    check("J=3 float32", out, x, (0.5, -1.0, 0.25))
    check("J=4 float32", out, x + [m], (0.5, -1.0, 0.25, 2.0))
    del x, out
    torch.cuda.empty_cache()
    # the fused step against the two one-stage launches, then against the plain version
    w2, m2 = w.clone(), m.clone()
    ops.stream_gd_into(m2, (m2, g), (beta, 1.0))
    ops.stream_gd_into(w2, (w2, m2), sgd_c)
    ops.stream_gd_foreach([((m, (m, g)), (w, (w, ops.STAGE1)))], mom_c)
    torch.cuda.synchronize()
    verdict("fused momentum: m f32, w bf16 <- one two-stage launch = the two one-stage "
            "launches", torch.equal(w, w2) and torch.equal(m, m2))
    del w2, m2
    check_foreach("fused momentum on w_up", [((m, (m, g)), (w, (w, ops.STAGE1)))], mom_c)
    torch.cuda.empty_cache()

    def sgd_kernel():
        return ops.stream_gd_into(w, (w, g), sgd_c)

    def sgd_plain():
        return ref.stream_gd((w, g), ops.coeffs_f32(sgd_c), bf)

    def library():
        return torch.add(w, g, alpha=-lr, out=w)

    def momentum_two():
        ops.stream_gd_into(m, (m, g), (beta, 1.0))
        return ops.stream_gd_into(w, (w, m), sgd_c)

    def momentum_fused():
        ops.stream_gd_foreach([((m, (m, g)), (w, (w, ops.STAGE1)))], mom_c)

    row = timed_row("stream_gd", 0.0, sgd_kernel, sgd_plain, library, 6.0 * m_el,
                    3.0 * m_el, f32, f"sgd, seg0 mlp.w_up {shape} bf16 in place")
    log(f"  w_up sgd, device time alone (profiler): kernel {device_ms(sgd_kernel):.4f} ms, "
        f"torch.add {device_ms(library):.4f} ms")
    two_ms, fused_ms = time_ms(momentum_two, 20), time_ms(momentum_fused, 20)
    log(f"  w_up momentum step, same call: fused (1 launch) {fused_ms:.4f} ms against its "
        f"bound {bound(14.0 * m_el, 6.0 * m_el, f32)[0]:.4f} ms (14 B per element); two "
        f"launches {two_ms:.4f} ms against {bound(18.0 * m_el, 6.0 * m_el, f32)[0]:.4f} ms "
        "(18 B)")
    del w, g, m
    torch.cuda.empty_cache()

    # the full-width VGG16 parameter tree: 13 conv and 3 fc layers, w and b each
    shapes = [s for l in zoo.vgg16() if l.kind != "pool" for s in ((l.kx, l.ky, l.ci, l.co),
                                                                   (l.co,))]
    n_el = sum(math.prod(s) for s in shapes)
    ws = [torch.randn(s, generator=gen, device="cuda").mul_(0.02).to(bf) for s in shapes]
    gs = [torch.randn(s, generator=gen, device="cuda").mul_(1e-3).to(bf) for s in shapes]
    g32 = [torch.randn(s, generator=gen, device="cuda").mul_(1e-3) for s in shapes]
    ms = [torch.randn(s, generator=gen, device="cuda").mul_(1e-3) for s in shapes]
    sgd_leaves = [((w, (w, g)),) for w, g in zip(ws, gs)]
    mom_leaves = [((m, (m, g)), (w, (w, ops.STAGE1))) for w, g, m in zip(ws, g32, ms)]
    log(f"  full-width VGG16 parameter tree: {len(shapes)} leaves, {n_el / 1e6:.1f} M elements")
    check_foreach("VGG16 tree sgd: w bf16 <- (w bf16, g bf16)", sgd_leaves, [sgd_c])
    check_foreach("VGG16 tree fused momentum: m f32 <- (m f32, g f32), w bf16 <- (w, m)",
                  mom_leaves, mom_c)

    def tree_sgd():
        ops.stream_gd_foreach(sgd_leaves, [sgd_c])

    def tree_sgd_per_leaf():
        for w, g in zip(ws, gs):
            ops.stream_gd_into(w, (w, g), sgd_c)

    def tree_library():
        torch._foreach_add_(ws, gs, alpha=-lr)

    def tree_momentum():
        ops.stream_gd_foreach(mom_leaves, mom_c)

    def tree_momentum_per_leaf():
        for w, g, m in zip(ws, g32, ms):
            ops.stream_gd_into(m, (m, g), (beta, 1.0))
            ops.stream_gd_into(w, (w, m), sgd_c)

    log("  (VGG16 tree: each event window holds the host's issue of the call's launches "
        "as well as the device work, which is what one launch per step saves)")
    lib_ms, lib_dev = time_ms(tree_library, 20), device_ms(tree_library)
    for label, one, per_leaf, nb, per_leaf_label in (
            ("sgd", tree_sgd, tree_sgd_per_leaf, 6.0, "per leaf"),
            ("fused momentum", tree_momentum, tree_momentum_per_leaf, 16.0,
             "per leaf and stage")):
        lib = (f", torch._foreach_add_ {lib_ms:.4f} ms (device {lib_dev:.4f})"
               if one is tree_sgd else "")
        log(f"  VGG16 tree {label}, same call: one launch {time_ms(one, 20):.4f} ms (device "
            f"{device_ms(one):.4f}), one launch {per_leaf_label} {time_ms(per_leaf, 20):.4f} ms "
            f"(device {device_ms(per_leaf):.4f}){lib}; bound "
            f"{bound(nb * n_el, 3.0 * n_el, f32)[0]:.4f} ms ({nb:g} B per element)")
    del ws, gs, g32, ms, sgd_leaves, mom_leaves
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving engine
# ---------------------------------------------------------------------------


def serve(model, params, ecfg, prompts, max_new, device):
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(model, params, ecfg, device=device)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    if device == "cuda":
        torch.cuda.synchronize()
    return reqs, done, eng


def kernel_group(name: str) -> str:
    """The device group of a kernel, by its name."""
    name = name.lower()
    if "paged_decode_mma" in name or "paged_decode_fma" in name:
        return "paged_decode_attention"
    if "flash_attn" in name:
        return "flash_attention"
    if "ssd_scan_m" in name or "ssd_scan_f" in name or "ssd_chunk_scan" in name:
        return "ssd_scan"
    if "paged_gather" in name:
        return "paged_gather"
    if any(t in name for t in ("gemm", "gemv", "cutlass", "nvjet", "cublas", "matmul")):
        return "matmul (cuBLAS)"
    return "other (elementwise, norms, copies)"


def range_kernels(prof, name: str) -> list[tuple[str, float]]:
    """(name, µs) of every device kernel launched inside the host ranges
    called ``name``: the profiler links each kernel to the op that launched
    it, and the ops nest under the range."""
    out = []

    def walk(e):
        out.extend((k.name, k.duration) for k in getattr(e, "kernels", ()))
        for c in e.cpu_children:
            walk(c)

    for e in prof.events():
        if e.name == name and not str(getattr(e, "device_type", "")).endswith("CUDA"):
            walk(e)
    return out


def device_groups(fn, steps: int, ranges=()) -> tuple[dict, dict, list]:
    """Device time (ms per call of ``fn``) and launches per call by kernel
    class, and the top kernels, from a torch.profiler window of ``steps``
    calls.  Each name in ``ranges`` is a ``record_function`` range: the
    kernels launched inside it become a group of their own, taken out of
    the groups they fall in by name."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    groups: dict[str, float] = {}
    launches: dict[str, float] = {}
    top = []
    for e in prof.key_averages():
        # a range also shows as a device-side annotation whose span includes
        # the gaps between its kernels: not a kernel, not counted
        if e.key in ranges or not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3 / steps
        launches[g] = launches.get(g, 0) + e.count / steps
        top.append((us / 1e3 / steps, e.count / steps, e.key[:90]))
    for name in ranges:
        kernels = range_kernels(prof, name)
        if not kernels:
            log(f"  profiler: no kernel linked to the {name!r} range (not measured)")
            continue
        label = f"{name} (taken out of the groups above)"
        for kname, us in kernels:
            g = kernel_group(kname)
            groups[g] = groups.get(g, 0.0) - us / 1e3 / steps
            launches[g] = launches.get(g, 0) - 1 / steps
            groups[label] = groups.get(label, 0.0) + us / 1e3 / steps
            launches[label] = launches.get(label, 0) + 1 / steps
    return groups, launches, sorted(top, reverse=True)[:8]


def log_groups(what: str, wall_ms: float, groups, launches, top) -> None:
    busy = sum(groups.values())
    if busy == 0:
        log("  profiler: no device time recorded (breakdown not measured)")
        return
    log(f"  profiler: device busy {busy:.3f} ms per {what} = {100 * busy / wall_ms:.1f} % of "
        f"the unprofiled {what}, idle {100 * (1 - busy / wall_ms):.1f} %")
    log(f"    {sum(launches.values()):g} kernel launches per {what}")
    for g in sorted(groups, key=groups.get, reverse=True):
        log(f"    {g}: {groups[g]:.3f} ms per {what} over {launches[g]:g} launches")
    for ms, n, name in top:
        log(f"      {ms:.3f} ms, {n:g} launches: {name}")


def decode_breakdown(model, params, vocab, steps: int = 10, prefill_chunk: int = 0,
                     decode_path: str = "paged", profile: bool = True, prompt: int = 512,
                     max_len: int = 1024, ranges=()) -> float:
    """Decode-step time of 8 running lanes at ~``prompt + 8``-token contexts
    (sync admission, so nothing else runs), and device time per kernel
    class from a torch.profiler window over as many more steps.  Returns
    the step's wall ms."""
    from repro_torch.serve import (
        AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine)

    eng = ServeEngine(model, params, EngineConfig(
        batch_slots=8, max_len=max_len, cache=CacheConfig(page_size=PS, decode_path=decode_path),
        admission=AdmissionConfig(async_prefill=False, prefill_chunk=prefill_chunk)),
        device="cuda")
    rng = np.random.default_rng(5)
    for i in range(8):
        eng.submit(Request(uid=i, max_new_tokens=64, prompt=rng.integers(
            0, vocab, size=(prompt,)).astype(np.int32)))
    s = eng.sched
    while len(s.running) < 8 or s.waiting or s.admitting or s.ready:
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    ctx = int(np.mean([st.length for st in s.running.values()]))
    log(f"  decode step ({decode_path} path), 8 lanes at ~{ctx}-token contexts: {step_ms:.3f} "
        f"ms wall (mean of {steps} synced steps, {8 / step_ms * 1e3:.1f} tok/s)")
    if profile:
        log_groups("step", step_ms, *device_groups(eng.step, steps, ranges))
    eng.run()
    return step_ms


def serve_full_width(model, params, prompts, ecfg, kernels, smi, max_new: int = 32,
                     on_reset=None):
    """The measured full-width run: every request finishes with ``max_new``
    tokens inside the vocabulary, and each kernel in ``kernels`` launched.
    ``on_reset`` runs where the launch counts are set to 0.  Returns
    (requests, launch counts of this run)."""
    from repro_torch.kernels import ops

    serve(model, params, ecfg, prompts[:1], 2, "cuda")        # warm-up: first launches
    ops.reset_launches()
    if on_reset is not None:
        on_reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs, done, eng = serve(model, params, ecfg, prompts, max_new, "cuda")
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    stats = eng.stats
    peak = torch.cuda.max_memory_allocated() / 2**30
    gen_tokens = sum(len(r.out_tokens) for r in reqs)
    log(f"  requests done: {len(done)}/{len(reqs)}; prompt tokens prefilled "
        f"{stats['prefill_tokens']}; decode tokens {stats['decode_tokens']} over "
        f"{stats['steps']} steps; generated {gen_tokens} tokens in {wall:.2f} s = "
        f"{gen_tokens / wall:.1f} tok/s end to end ({smi})")
    log(f"  peak device memory {peak:.2f} GiB; kernel launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if len(done) != len(reqs) or not all(r.done and len(r.out_tokens) == max_new
                                         for r in reqs):
        raise SystemExit("chip_smoke: not every full-width request finished")
    if min(launches[k] for k in kernels) <= 0:
        raise SystemExit("chip_smoke: a kernel of the main path never launched")
    vocab = model.cfg.padded_vocab
    if not all(0 <= t < vocab for r in reqs for t in r.out_tokens):
        raise SystemExit("chip_smoke: a sampled token lies outside the vocabulary")
    return reqs, launches


def card_vs_cpu_tokens(arch, cases, smi, **over) -> None:
    """The same requests through the reduced ``arch`` engine in float32 on
    the card and on the CPU; each case is (label, prompt lengths, engine
    config, and the decode path whose card tokens must equal too).
    ``over`` replaces fields of the reduced config."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map

    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **over)
    model = build_model(cfg)
    params_cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
    for label, lengths, ecfg, also in cases:
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
                   for n in lengths]
        got = {}
        runs = [("cuda", params_gpu, ecfg), ("cpu", params_cpu, ecfg)]
        if also:
            runs.append((f"cuda {also}", params_gpu, dataclasses.replace(
                ecfg, cache=dataclasses.replace(ecfg.cache, decode_path=also))))
        for name, params, e in runs:
            reqs, done, _ = serve(model, params, e, prompts, 12, name.split()[0])
            if len(done) != len(prompts):
                raise SystemExit(f"chip_smoke: {name} engine finished {len(done)} requests")
            got[name] = [r.out_tokens for r in reqs]
        same = all(v == got["cpu"] for v in got.values())
        log(f"  {label}: {len(prompts)} requests x 12 tokens, card tokens "
            f"{'identical to' if same else 'DIFFER from'} CPU tokens"
            + (f" and to the card's {also}-path tokens" if also else ""))
        if not same:
            for name, toks in got.items():
                log(f"  {name}: {toks}")
            raise SystemExit("chip_smoke: greedy tokens differ between card and CPU")


def prefill_ms(model, params, vocab, seq: int, chunk: int, ranges=(),
               whole: bool = False, group: str | None = None) -> float:
    """One ``seq``-token prompt prefilled in ``chunk``-token slices (as the
    engine's chunked prefill runs it), or with ``whole`` in one
    ``DecoderLM.prefill``: wall ms and the device split (``group``: that
    kernel group's line once more, with its launches).  Returns the wall
    ms."""
    from repro_torch.models.common import tree_map

    toks = torch.as_tensor(np.random.default_rng(6).integers(0, vocab, size=(1, seq)),
                           device="cuda").long()

    def run():
        if whole:
            return model.prefill(params, toks)[0]
        cache = tree_map(lambda sp: torch.zeros(sp.shape, dtype=sp.dtype, device="cuda"),
                         model.cache_specs(1, seq))
        for i in range(0, seq, chunk):
            logits, cache = model.extend_step(params, cache, toks[:, i:i + chunk], i)
        return logits

    run()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    how = "whole" if whole else f"in {chunk}-token slices"
    log(f"  prefill of one {seq}-token prompt {how}: {ms:.3f} ms wall "
        f"(median of 5) = {seq / ms * 1e3:.0f} prompt tokens/s")
    groups, launches, top = device_groups(run, 3, ranges)
    log_groups("prefill", ms, groups, launches, top)
    if group is not None:
        log(f"  {group} in the prefill: {groups.get(group, 0.0):.3f} ms of device time over "
            f"{launches.get(group, 0):g} launches")
    return ms


# ---------------------------------------------------------------------------
# phase 16: full-width recurrentgemma-9b serving
# ---------------------------------------------------------------------------


def host_range(module, names, label: str):
    """Wrap each named function of ``module`` in a ``record_function`` range
    called ``label`` (for the profiler's split); returns the undo."""
    plain = {name: getattr(module, name) for name in names}

    def ranged(fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return call

    for name, fn in plain.items():
        setattr(module, name, ranged(fn))
    return lambda: [setattr(module, name, fn) for name, fn in plain.items()]


def scan_range():
    """The RG-LRU doubling scan in a range named ``rglru_scan``."""
    from repro_torch.models import rglru

    return host_range(rglru, ("linear_scan",), "rglru_scan")


def dispatch_range():
    """The MoE routing and dispatch (``moe._dispatch``) and the combine
    (``moe._combine``) in a range named ``moe_dispatch``."""
    from repro_torch.models import moe

    return host_range(moe, ("_dispatch", "_combine"), "moe_dispatch")


def count_calls(model, names) -> dict[str, int]:
    """Wrap each named method of ``model`` to count its calls; returns the
    live counts (reset them with ``update``)."""
    calls = dict.fromkeys(names, 0)

    def counted(name):
        fn = getattr(model, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        setattr(model, name, wrapped)

    for name in names:
        counted(name)
    return calls


def serve_recurrentgemma(smi) -> dict:
    """16 requests of 1,024-3,072 prompt tokens (half past the 2,048-token
    window) at the full width and depth of recurrentgemma-9b, bf16, seeded
    random weights, 8 lanes, max_len 4,096, 1,024-token prefill chunks, 64
    new tokens each.  Holds: every request finishes; 12 ``flash_attention``
    launches per prefill slice, 12 ``paged_gather`` launches per decode step
    (one per attention layer: k and v together) and no
    ``paged_decode_attention``; the engine's first token equals a
    direct chunked prefill's.  Returns this run's launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.serve import AdmissionConfig, CacheConfig, EngineConfig

    cfg = get_arch("recurrentgemma-9b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_items(params))
    n_attn = sum(reps * pattern.count("attn") for pattern, reps in model.segments)
    log(f"  {cfg.n_layers} layers as {model.segments}, d_model {cfg.d_model}, lru_width "
        f"{cfg.rglru.lru_width}, attention H={RG['h']} Hkv={RG['hkv']} D={RG['d']} window "
        f"{RG['window']}; {n_params / 1e9:.3f} B parameters in {time.perf_counter() - t0:.1f} s")
    calls = count_calls(model, ("extend_step", "decode_step_paged"))
    ecfg = EngineConfig(batch_slots=8, max_len=4096, cache=CacheConfig(page_size=PS),
                        admission=AdmissionConfig(prefill_chunk=RG["chunk"]))
    rng = np.random.default_rng(16)
    lengths = np.concatenate([rng.integers(RG["window"] + 1, 3073, size=8),
                              rng.integers(1024, RG["window"] + 1, size=8)])
    rng.shuffle(lengths)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),)).astype(np.int32)
               for n in lengths]
    log(f"  prompt lengths {sorted(int(n) for n in lengths)}")
    reqs, run = serve_full_width(model, params, prompts, ecfg, ("flash_attention",
                                                                "paged_gather"), smi,
                                 max_new=64, on_reset=lambda: calls.update(
                                     extend_step=0, decode_step_paged=0))
    log(f"  {calls['extend_step']} prefill slices, {calls['decode_step_paged']} decode steps; "
        f"flash_attention {run['flash_attention']} launches, paged_gather "
        f"{run['paged_gather']}, paged_decode_attention {run['paged_decode_attention']}")
    if run["flash_attention"] != n_attn * calls["extend_step"]:
        raise SystemExit(f"chip_smoke: {run['flash_attention']} flash launches, expected "
                         f"{n_attn} per prefill slice")
    if run["paged_gather"] != n_attn * calls["decode_step_paged"]:
        raise SystemExit(f"chip_smoke: {run['paged_gather']} paged_gather launches, "
                         f"expected {n_attn} per decode step")
    if run["paged_decode_attention"]:
        raise SystemExit("chip_smoke: the windowed layers launched paged_decode_attention")
    # the engine's first token agrees with a direct chunked prefill
    cache = tree_map(lambda sp: torch.zeros(sp.shape, dtype=sp.dtype, device="cuda"),
                     model.cache_specs(1, len(prompts[0])))
    toks = torch.as_tensor(prompts[0], device="cuda")[None].long()
    for i in range(0, toks.shape[1], RG["chunk"]):
        logits, cache = model.extend_step(params, cache, toks[:, i:i + RG["chunk"]], i)
    if logits.shape[-1] != cfg.padded_vocab or not torch.isfinite(logits).all():
        raise SystemExit(f"chip_smoke: bad recurrentgemma prefill logits {tuple(logits.shape)}")
    if int(logits[0, -1].argmax()) != reqs[0].out_tokens[0]:
        raise SystemExit("chip_smoke: recurrentgemma engine's first token differs from a "
                         "direct chunked prefill")
    log("  chunked-prefill logits finite; first token matches the engine")
    undo = scan_range()
    try:
        ms = prefill_ms(model, params, cfg.vocab_size, 3 * RG["chunk"], RG["chunk"],
                        ranges=("rglru_scan",))
    finally:
        undo()
    log(f"  = {ms / 3:.3f} ms per {RG['chunk']}-token prefill slice ({smi})")
    decode_breakdown(model, params, cfg.vocab_size, prefill_chunk=RG["chunk"], prompt=2560,
                     max_len=4096)
    return run


# ---------------------------------------------------------------------------
# phases 19 and 20: the moe family at full width, cut in depth
# ---------------------------------------------------------------------------


def serve_moe(arch: str, smi) -> dict:
    """16 requests of 256-1,536 prompt tokens, whole-prompt prefill, 32 new
    tokens each, 8 lanes, max_len 2,048, 16-token pages, at the published
    widths of ``arch`` cut to ``MOE_DEPTH[arch]`` layers, bf16, seeded random
    weights.  Holds: every request finishes; one ``flash_attention`` launch
    per attention layer per prefill; deepseek's MLA reads its pages with one
    ``paged_gather`` launch per layer per decode step and never launches
    ``paged_decode_attention``, qwen3-moe's GQA layers launch it exactly
    once per layer per step;
    the engine's first token equals a direct prefill's.  Then a 1,024-token
    whole prompt and a 2,048-token prompt in 1,024-token chunks are timed
    with their device split, and the decode step with its.  Returns this
    run's launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items
    from repro_torch.serve import AdmissionConfig, CacheConfig, EngineConfig

    cfg = dataclasses.replace(get_arch(arch), n_layers=MOE_DEPTH[arch])
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_items(params))
    attn = (f"MLA {cfg.n_heads} heads, q_lora {cfg.mla.q_lora_rank}, kv_lora "
            f"{cfg.mla.kv_lora_rank}" if cfg.mla else
            f"GQA {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}")
    log(f"  {cfg.n_layers} of {get_arch(arch).n_layers} layers as {model.segments}, d_model "
        f"{cfg.d_model}, {attn}, {cfg.n_experts} experts top-{cfg.experts_per_token} "
        f"(+{cfg.n_shared_experts} shared) of {cfg.moe_d_ff}; {n_params / 1e9:.3f} B "
        f"parameters ({torch.cuda.memory_allocated() / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    calls = count_calls(model, ("prefill", "decode_step_paged"))
    ecfg = EngineConfig(batch_slots=8, max_len=2048, cache=CacheConfig(page_size=PS),
                        admission=AdmissionConfig(prefill_chunk=0))
    rng = np.random.default_rng(19)
    lengths = rng.integers(256, 1537, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),)).astype(np.int32)
               for n in lengths]
    log(f"  prompt lengths {sorted(int(n) for n in lengths)}")
    mla = cfg.mla is not None
    kernels = ("flash_attention", "paged_gather" if mla else "paged_decode_attention")
    reqs, run = serve_full_width(model, params, prompts, ecfg, kernels, smi,
                                 on_reset=lambda: calls.update(prefill=0, decode_step_paged=0))
    log(f"  {calls['prefill']} prefills, {calls['decode_step_paged']} decode steps; "
        f"flash_attention {run['flash_attention']} launches, paged_gather "
        f"{run['paged_gather']}, paged_decode_attention {run['paged_decode_attention']}")
    if run["flash_attention"] != cfg.n_layers * calls["prefill"]:
        raise SystemExit(f"chip_smoke: {run['flash_attention']} flash launches, expected "
                         f"{cfg.n_layers} per prefill")
    if mla and (run["paged_gather"] != cfg.n_layers * calls["decode_step_paged"]
                or run["paged_decode_attention"]):
        raise SystemExit("chip_smoke: MLA's paged decode should launch one paged_gather per "
                         "layer and step and no paged_decode_attention")
    if not mla and run["paged_decode_attention"] != cfg.n_layers * calls["decode_step_paged"]:
        raise SystemExit("chip_smoke: a GQA layer's decode step should launch the paged kernel "
                         "exactly once")
    logits, _ = model.prefill(params, torch.as_tensor(prompts[0], device="cuda")[None].long())
    if logits.shape != (1, 1, cfg.padded_vocab) or not torch.isfinite(logits).all():
        raise SystemExit(f"chip_smoke: bad {arch} prefill logits {tuple(logits.shape)}")
    if int(logits[0, -1].argmax()) != reqs[0].out_tokens[0]:
        raise SystemExit(f"chip_smoke: {arch} engine's first token differs from a direct "
                         "prefill")
    log("  prefill logits finite, shape (1, 1, V); first token matches the engine")
    undo = dispatch_range()
    try:
        whole = prefill_ms(model, params, cfg.vocab_size, 1024, 1024,
                           ranges=("moe_dispatch",), whole=True)
        chunked = prefill_ms(model, params, cfg.vocab_size, 2048, 1024,
                             ranges=("moe_dispatch",))
        log(f"  = {whole:.3f} ms per 1,024-token whole prompt (the served path), "
            f"{chunked / 2:.3f} ms per 1,024-token chunked-prefill slice ({smi})")
        decode_breakdown(model, params, cfg.vocab_size, prompt=1024, max_len=2048,
                         ranges=("moe_dispatch",))
    finally:
        undo()
    log(f"  peak device memory over the phase {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")
    return run


# ---------------------------------------------------------------------------
# phases 10 and 11: training
# ---------------------------------------------------------------------------


# learning rates of phase 10: adamw at its default (3e-4).  Its step is
# lr * m / (sqrt(v) + eps), which for a gradient element near eps turns
# sum-order noise into a change of up to lr: at lr 1e-2 two of 65,536
# elements moved 3.8e-4 apart between card and CPU (both right)
LR = {"sgd": {"lr": 1e-2}, "momentum": {"lr": 1e-2}, "adamw": {}}


def record_routing(model):
    """Record what the moe family's training forward routes: each call's
    aux loss (``model.forward``) and each dispatch's router probabilities
    (``moe._dispatch_masks``).  Returns (auxes, gates, undo)."""
    from repro_torch.models import moe

    auxes, gates = [], []
    plain_forward, plain_masks = model.forward, moe._dispatch_masks

    def forward(*args, **kwargs):
        logits, aux = plain_forward(*args, **kwargs)
        auxes.append(aux.detach())
        return logits, aux

    def masks(g, *args, **kwargs):
        gates.append(g.detach().cpu())
        return plain_masks(g, *args, **kwargs)

    model.forward, moe._dispatch_masks = forward, masks

    def undo():
        del model.forward
        moe._dispatch_masks = plain_masks

    return auxes, gates, undo


def routing_flips(cpu_gates, card_gates, k: int) -> int:
    """(token, rank) expert choices that differ between the CPU's and the
    card's dispatches, call for call; logs the first few with the gate
    values of the two choices on both sides."""
    flips = 0
    for call, (a, b) in enumerate(zip(cpu_gates, card_gates)):
        ia, ib = torch.topk(a, k, dim=-1)[1], torch.topk(b, k, dim=-1)[1]
        for g, t, r in (ia != ib).nonzero().tolist():
            if flips < 5:
                x, y = int(ia[g, t, r]), int(ib[g, t, r])
                log(f"    routing flip: dispatch {call}, group {g}, token {t}, rank {r}: CPU "
                    f"expert {x} ({float(a[g, t, x]):.9g} vs {float(a[g, t, y]):.9g}), card "
                    f"expert {y} ({float(b[g, t, y]):.9g} vs {float(b[g, t, x]):.9g})")
            flips += 1
    return flips


def train_card_vs_cpu(arch: str, seq: int, **over) -> int:
    """Reduced ``arch`` in float32 (``over`` replaces config fields): 4
    steps of each optimizer with 1 and 2 microbatches from the same weights
    and batches on the card and on the CPU; losses and grad norms within
    1e-4 relative at every step, parameters within 1e-4 (atol = rtol).  For
    the moe family also each step's aux loss (the mean over its
    microbatches' forwards) within 1e-4 relative, logged on both sides, and
    the routing's expert choices compared call for call (``routing_flips``).
    Returns the card's ``stream_gd`` launches."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.optim import get_optimizer
    from repro_torch.train.train_step import make_train_step

    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("chip_smoke: TF32 matmuls are on; float32 would not be float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **over)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(10)
    total = 0
    batches = [rng.integers(0, cfg.vocab_size, size=(4, seq + 1)).astype(np.int32)
               for _ in range(4)]
    moe = cfg.family == "moe"
    for opt in ("sgd", "momentum", "adamw"):
        for n_micro in (1, 2):
            runs = {}
            for dev in ("cpu", "cuda"):
                o = get_optimizer(opt, **LR[opt])
                p = tree_map(lambda t, d=dev: t.to(d, copy=True), params)
                state = o.init(p)
                step = make_train_step(model, o, n_microbatches=n_micro)
                if moe:
                    auxes, gates, undo = record_routing(model)
                ops.reset_launches()
                metrics = []
                try:
                    for toks in batches:
                        t = torch.from_numpy(toks).to(dev)
                        p, state, mt = step(p, state, {"tokens": t[:, :-1], "targets": t[:, 1:]})
                        metrics.append((float(mt["loss"]), float(mt["grad_norm"])))
                finally:
                    if moe:
                        undo()
                aux = (np.array([float(a) for a in auxes]).reshape(len(batches), n_micro)
                       .mean(1) if moe else None)
                runs[dev] = (np.array(metrics), p, ops.LAUNCHES["stream_gd"], aux,
                             gates if moe else None)
            (cm, cp, _, caux, cgates), (gm, gp, launches, gaux, ggates) = (runs["cpu"],
                                                                         runs["cuda"])
            rel = float(np.max(np.abs(gm - cm) / np.abs(cm)))
            perr = max(float(((a.cpu() - b).abs() / (1e-4 + 1e-4 * b.abs())).max())
                       for (_, a), (_, b) in zip(tree_items(gp), tree_items(cp)))
            log(f"  {opt}, {n_micro} microbatch(es): losses {['%.5f' % x for x in gm[:, 0]]}, "
                f"max rel diff of loss/grad norm {rel:.2e}, params at {perr:.3f} of the "
                f"1e-4 tolerance; {launches} stream_gd launches on the card")
            if rel > 1e-4 or perr > 1.0 or not np.isfinite(gm).all():
                raise SystemExit(f"chip_smoke: {opt} training on the card differs from the CPU")
            if moe:
                aux_rel = float(np.max(np.abs(gaux - caux) / np.abs(caux)))
                flips = routing_flips(cgates, ggates, cfg.experts_per_token)
                log(f"    aux loss per step: card {['%.7f' % x for x in gaux]}, CPU "
                    f"{['%.7f' % x for x in caux]}, max rel diff {aux_rel:.2e}; {flips} of "
                    f"{sum(g[..., 0].numel() for g in cgates) * cfg.experts_per_token} routed "
                    f"(token, rank) choices differ over {len(cgates)} dispatches")
                if aux_rel > 1e-4:
                    raise SystemExit(f"chip_smoke: {opt} aux loss on the card differs from the "
                                     "CPU")
            want = {"sgd": 1, "momentum": 1, "adamw": 0}[opt] * len(batches)
            if launches != want:
                raise SystemExit(f"chip_smoke: {launches} stream_gd launches, expected {want}")
            total += launches
    return total


def train_fault_on_card() -> None:
    """The Trainer on the card (reduced qwen2.5-3b, sgd, checkpoints every 4
    steps under build/): a crash injected at step 6 restores step 4 and
    resumes to step 12 with the clean run's final loss."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.dist.fault import FaultInjector
    from repro_torch.models import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_arch("qwen2.5-3b").reduced()
    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    for label, fault in (("faulty", FaultInjector(fail_at={6})), ("clean", None)):
        data = SyntheticLMData(cfg, batch=2, seq=16, device="cuda")
        tcfg = TrainerConfig(total_steps=12, ckpt_dir=str(root / label), ckpt_every=4,
                             optimizer="sgd", lr=1e-3, log_every=100)
        tr = Trainer(build_model(cfg), data, tcfg, fault_injector=fault, device="cuda")
        out[label] = tr.run_with_restarts(0)
    shutil.rmtree(root, ignore_errors=True)
    (fs, fr), (cs, cr) = out["faulty"], out["clean"]
    log(f"  Trainer with a crash at step 6: {fr} restart(s), step {fs.step}, last loss "
        f"{fs.losses[-1]:.6f}; clean run: step {cs.step}, last loss {cs.losses[-1]:.6f}")
    if (fr, fs.step, cr, cs.step) != (1, 12, 0, 12) or \
            abs(fs.losses[-1] - cs.losses[-1]) > 1e-4 * abs(cs.losses[-1]):
        raise SystemExit("chip_smoke: crash -> restore -> resume did not reproduce the clean run")


def profile_split(fn, ranges=()) -> dict:
    """``fn()`` under torch.profiler: device ms of all kernels, of the update
    (``stream_gd`` kernels), of the gradient sums, division and norm (the
    ``train_step.accumulate`` ranges), of cuBLAS and cuDNN, and the largest
    kernels.  The rest of the device time is the forward and backward (whose
    kernels autograd launches from its own thread).  Each name in
    ``ranges`` (a ``host_range``) also gets the device ms of the kernels
    linked to it: the forward's and the remat recompute's, not the
    backward's (autograd launches those outside the range)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    split = {"busy": 0.0, "update": 0.0, "update_launches": 0, "accumulate": 0.0,
             "library": 0.0, "launches": 0, "top": [],
             "ranges": {name: sum(us for _, us in range_kernels(prof, name)) / 1e3
                        for name in ranges}}
    library = ("gemm", "gemv", "cutlass", "nvjet", "cublas", "matmul", "cudnn", "conv",
               "xmma", "implicit", "wgrad", "dgrad")
    for e in prof.key_averages():
        cuda = str(getattr(e, "device_type", "")).endswith("CUDA")
        # a range also shows as a device-side annotation spanning its kernels
        # and the gaps between them: not a kernel, not counted
        if e.key.startswith(("train_step.", "ProfilerStep")) or e.key in ranges:
            if not cuda and e.key == "train_step.accumulate":
                split["accumulate"] += e.device_time_total / 1e3
            continue
        if not cuda:
            continue
        ms = e.self_device_time_total / 1e3
        split["busy"] += ms
        split["launches"] += e.count
        split["top"].append((ms, e.count, e.key[:100]))
        name = e.key.lower()
        if "stream_gd" in name:
            split["update"] += ms
            split["update_launches"] += e.count
        elif any(t in name for t in library):
            split["library"] += ms
    if split["busy"] == 0:
        raise SystemExit("chip_smoke: the profiler recorded no device time for a step")
    return split


def step_split(tr, state, ranges=()) -> tuple[float, dict]:
    """One more step of the Trainer ``tr`` under the profiler: its wall ms
    (profiler on) and ``profile_split``'s split."""
    tr.tcfg.total_steps = state.step + 1
    split = profile_split(lambda: tr.run(state), ranges)
    return state.step_s[-1] * 1e3, split


def log_split(wall_ms, split, step_ms, bytes_update, n_params, two_pass=False) -> None:
    """Print a profiled step: busy and idle share of the unprofiled step,
    forward+backward, the update against its bound (``bytes_update`` at
    3.35 TB/s) and the rest."""
    busy = split["busy"]
    bound_update = bytes_update / HBM_BYTES_PER_S * 1e3
    fb = busy - split["update"] - split["accumulate"]
    log(f"  profiled step: {wall_ms:.1f} ms wall (profiler on), device busy {busy:.1f} ms "
        f"over {split['launches']} launches = {100 * busy / step_ms:.1f} % of the unprofiled "
        f"step, idle {100 * (1 - busy / step_ms):.1f} %")
    log(f"    forward+backward (remat recompute included): {fb:.2f} ms "
        f"({100 * fb / busy:.1f} %), of which cuBLAS/cuDNN {split['library']:.2f} ms")
    two = (f"; two one-stage passes would move {(bytes_update + 4 * n_params) / 1e9:.1f} GB, "
           f"bound {(bytes_update + 4 * n_params) / HBM_BYTES_PER_S * 1e3:.2f} ms"
           if two_pass else "")
    log(f"    update (stream_gd, {split['update_launches']} launch(es)): {split['update']:.3f} ms "
        f"({100 * split['update'] / busy:.1f} %) against a bound of {bound_update:.3f} ms "
        f"({bytes_update / 1e9:.2f} GB, {bytes_update / n_params:.0f} B per parameter, at "
        f"3.35 TB/s){two}")
    log(f"    rest (float32 gradient sums, division, grad norm): {split['accumulate']:.2f} ms "
        f"({100 * split['accumulate'] / busy:.1f} %)")
    for name, ms in split["ranges"].items():
        log(f"    the {name!r} range's kernels (forward and remat recompute; its backward "
            f"is not linked to it): {ms:.2f} ms ({100 * ms / busy:.1f} %)"
            if ms else f"    profiler: no kernel linked to the {name!r} range (not measured)")
    for ms, n, name in sorted(split["top"], reverse=True)[:10]:
        log(f"      {ms:.2f} ms, {n} launches: {name}")


def update_bytes(leaves, grad_size=None) -> int:
    """Bytes of one fused momentum update: m (f32) and w read, g read, m and
    w written, each once (``grad_size``: the gradients' element size when it
    is not the weight's, as for float32 microbatch sums)."""
    return sum(t.numel() * (4 + (grad_size or t.element_size()) + t.element_size()
                            + 4 + t.element_size()) for t in leaves)


def train_full_width(smi, arch: str, batch: int, seq: int, lr: str):
    """Full-width ``arch`` through the launcher (``--full``: bf16, seeded
    random weights, ``cfg.train_microbatches`` microbatches, remat full),
    momentum, 6 steps.  Every loss finite and one stream_gd launch per step;
    prints step ms, tokens/s, peak memory and a profiled step's split.
    Returns (stream_gd launches, trainer, state)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.common import tree_items

    steps = 6
    gc.collect()                      # earlier phases' engines and weights
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    tr, state, restarts = train_main(
        ["--arch", arch, "--full", "--optimizer", "momentum", "--steps", str(steps),
         "--batch", str(batch), "--seq", str(seq), "--lr", lr])
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["stream_gd"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg = tr.model.cfg
    leaves = [t for _, t in tree_items(state.params)]
    n_params = sum(t.numel() for t in leaves)
    log(f"  {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, remat {cfg.remat}, "
        f"{tr.tcfg.n_microbatches} microbatches; {n_params / 1e9:.4f} B parameters in "
        f"{len(leaves)} leaves")
    log(f"  losses {['%.4f' % x for x in state.losses]}; restarts {restarts}")
    step_ms = statistics.median(state.step_s[1:]) * 1e3
    log(f"  step {step_ms:.1f} ms (median of steps 2-{steps}; first step "
        f"{state.step_s[0] * 1e3:.1f} ms), {batch * seq / step_ms * 1e3:.0f} trained tokens/s, "
        f"peak device memory {peak:.2f} GiB, {held:.2f} GiB of it held before the run ({smi})")
    log(f"  stream_gd launches {launches} = {launches / steps:g} per step")
    if state.step != steps or not all(np.isfinite(state.losses)):
        raise SystemExit(f"chip_smoke: full-width {arch} training gave a non-finite loss")
    if launches != steps:
        raise SystemExit(f"chip_smoke: {launches} stream_gd launches, expected {steps}")
    wall_ms, split = step_split(tr, state)
    # the grads are float32 sums with more than one microbatch
    grad_size = 4 if tr.tcfg.n_microbatches > 1 else None
    log_split(wall_ms, split, step_ms, update_bytes(leaves, grad_size), n_params, two_pass=True)
    return launches, tr, state


# the moe models trained at published widths on one card, cut in depth only
# (launch.train's training_bytes, weights + gradients + optimizer state
# without activations): qwen3-moe-235b-a22b 2 of 94 layers (6.220 B
# parameters, momentum 49.8 GB), deepseek-v3-671b its 3 dense layers and 1
# of its 58 MoE layers (15.111 B, sgd 60.5 GB)
MOE_TRAIN = {
    "qwen3-moe-235b-a22b": dict(over=dict(n_layers=2), optimizer="momentum", batch=8),
    "deepseek-v3-671b": dict(over=dict(n_layers=4), optimizer="sgd", batch=4),
}
MOE_TRAIN_SEQ = 1024
EVAL_ROWS = 4                                  # rows of a fresh batch that eval_kernel_vs_xla takes
# (label, heads, KV heads, head dim) of flash_attention in phases 22 and 23's kernel evals
EVAL_FLASH = [("qwen3-moe eval", QM["h"], QM["hkv"], D),
              ("deepseek-v3 eval", MLA["h"], MLA["h"], MLA["d"])]


def moe_step_work(cfg, batch: int, seq: int) -> dict:
    """Multiply-adds of one training forward at these shapes: ``macs`` of
    the layers' bf16 matmuls (attention projections, the dense MLPs, the
    router, the shared expert and the experts over their whole capacity
    slab), ``head`` of the LM head, ``attn`` of the float32 chunked-scan
    attention (every pair of chunks, masked or not; MLA's V padded to
    qk_nope + qk_rope); and the dispatch's ``groups``, ``capacity`` per
    expert, slab ``rows`` per MoE layer and routed (token, expert) ``pairs``."""
    from repro_torch.models.moe import n_groups_for

    tokens = batch * seq
    d, h, e, k = cfg.d_model, cfg.n_heads, cfg.n_experts, cfg.experts_per_token
    f = cfg.moe_d_ff or cfg.d_ff
    groups = n_groups_for(batch, seq)
    cap = max(int(tokens // groups * k * cfg.capacity_factor / e), 4)
    rows = groups * e * cap
    if cfg.mla:
        m = cfg.mla
        dqk = m.qk_nope_head_dim + m.qk_rope_head_dim
        proj = (d * m.q_lora_rank + m.q_lora_rank * h * dqk
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim) + h * m.v_head_dim * d)
        dv = dqk
    else:
        proj = 2 * d * h * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
        dqk = dv = cfg.hd
    span = -(-seq // cfg.attn_chunk) * min(cfg.attn_chunk, seq)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    per_token = (cfg.n_layers * proj + cfg.first_dense_layers * 3 * d * cfg.d_ff
                 + n_moe * (d * e + 3 * d * f * cfg.n_shared_experts))
    return dict(macs=per_token * tokens + n_moe * rows * 3 * d * f,
                head=d * cfg.padded_vocab * tokens,
                attn=cfg.n_layers * batch * h * span * span * (dqk + dv),
                groups=groups, capacity=cap, rows=rows, pairs=tokens * k)


def attention_ms(cfg, batch: int, seq: int) -> tuple[float, float]:
    """Device ms of one layer's chunked-scan attention (``attend(impl="xla")``,
    as the training forward calls it) at the step's shapes, bf16 inputs from
    a seed: the forward alone and the forward with its backward."""
    from repro_torch.models.attention import attend

    gen = torch.Generator(device="cuda").manual_seed(0)
    if cfg.mla:
        m = cfg.mla
        d = m.qk_nope_head_dim + m.qk_rope_head_dim
        hkv, scale = cfg.n_heads, d ** -0.5
    else:
        d, hkv, scale = cfg.hd, cfg.n_kv_heads, None
    q, k, v = (torch.randn(batch, seq, h, d, generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()
               for h in (cfg.n_heads, hkv, hkv))
    dout = torch.randn(batch, seq, cfg.n_heads, d, generator=gen, device="cuda",
                       dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            attend(q, k, v, causal=True, scale=scale, impl="xla", chunk=cfg.attn_chunk)

    def fwd_bwd():
        out = attend(q, k, v, causal=True, scale=scale, impl="xla", chunk=cfg.attn_chunk)
        torch.autograd.grad(out, (q, k, v), dout)

    return device_ms(fwd, 3), device_ms(fwd_bwd, 3)


def train_moe_full_width(smi, arch: str) -> tuple[int, int]:
    """``arch`` at published widths cut to ``MOE_TRAIN[arch]``'s depth, bf16,
    seeded random weights, through ``Trainer`` (remat full, 1 microbatch,
    ``MOE_TRAIN_SEQ`` tokens a row) for 6 steps: every loss finite and one
    ``stream_gd`` launch per step; prints step ms (median of steps 2-6),
    trained tokens/s, peak device memory beside ``training_bytes``, where
    the memory peaks (an extra step's forward and backward apart), with sgd
    that step's update of a leaf past 2^31 elements held to the plain
    version (``sgd_update_past_2_31``), the step's work against its bound, a profiled step's split (the MoE dispatch
    and the chunked-scan attention as ranges, the attention's backward
    timed alone), then the eval loss of the trained weights through
    ``flash_attention`` (one launch per layer) against ``impl="xla"``.
    Returns (stream_gd launches, flash_attention launches)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.launch.train import training_bytes
    from repro_torch.models import attention, build_model
    from repro_torch.models.common import tree_items
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.train.trainer import Trainer, TrainerConfig

    run = MOE_TRAIN[arch]
    steps, batch, seq, opt = 6, run["batch"], MOE_TRAIN_SEQ, run["optimizer"]
    full = get_arch(arch)
    cfg = dataclasses.replace(full, **run["over"])
    model = build_model(cfg)
    reduced = ", ".join(f"{k}: {getattr(full, k)} -> {v}" for k, v in run["over"].items())
    log(f"  reduced = {{{reduced}}}: segments {model.segments}, d_model {cfg.d_model}, "
        + (f"MLA {cfg.n_heads} heads (q_lora {cfg.mla.q_lora_rank}, kv_lora "
           f"{cfg.mla.kv_lora_rank}, attention head dim "
           f"{cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim})" if cfg.mla else
           f"GQA {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, qk_norm {cfg.qk_norm}")
        + f", {cfg.n_experts} experts top-{cfg.experts_per_token} (+{cfg.n_shared_experts} "
        f"shared) of {cfg.moe_d_ff}, vocab {cfg.vocab_size}; remat {cfg.remat}, attention "
        f"chunk {cfg.attn_chunk}; {opt}, batch {batch} x seq {seq}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    need = training_bytes(model, opt, 1)
    data = SyntheticLMData(cfg, batch=batch, seq=seq, device="cuda")
    tr = Trainer(model, data, TrainerConfig(total_steps=steps, optimizer=opt, lr=1e-4,
                                            log_every=100), device="cuda")
    t0 = time.perf_counter()
    state = tr.init_state(0)
    torch.cuda.synchronize()
    leaves = [t for _, t in tree_items(state.params)]
    n_params = sum(t.numel() for t in leaves)
    log(f"  {n_params / 1e9:.3f} B parameters in {len(leaves)} leaves, initialised in "
        f"{time.perf_counter() - t0:.1f} s; weights + gradients + {opt} state "
        f"(training_bytes) {need / 1e9:.1f} GB")
    ops.reset_launches()
    state = tr.run(state)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["stream_gd"]
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(state.step_s[1:]) * 1e3
    log(f"  losses {['%.4f' % x for x in state.losses]}")
    log(f"  step {step_ms:.1f} ms (median of steps 2-{steps}; first step "
        f"{state.step_s[0] * 1e3:.1f} ms), {batch * seq / step_ms * 1e3:.0f} trained tokens/s, "
        f"peak device memory {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB) against "
        f"training_bytes' {need / 1e9:.1f} GB ({smi})")
    log(f"  stream_gd launches {launches} = {launches / steps:g} per step")
    if state.step != steps or not all(np.isfinite(state.losses)):
        raise SystemExit(f"chip_smoke: {arch} training gave a non-finite loss")
    if launches != steps:
        raise SystemExit(f"chip_smoke: {launches} stream_gd launches, expected {steps}")
    # where the memory peaks: one more batch's forward, then its backward
    batch_x = data.next()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwd = {}

    def loss_fn(params, b):
        out = model.loss(params, b)
        fwd["peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return out

    _, grads = value_and_grad(loss_fn, state.params, batch_x)
    bwd, after = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    log(f"  memory: {held / 1e9:.2f} GB held between steps (weights + {opt} state); an extra "
        f"step's forward peaks at {fwd['peak'] / 1e9:.2f} GB, its backward at "
        f"{bwd / 1e9:.2f} GB, {after / 1e9:.2f} GB held with its gradients")
    sgd_update_past_2_31(tr, state, grads)
    del grads
    work = moe_step_work(cfg, batch, seq)
    flops = 8 * work["macs"] + 6 * work["head"]          # forward, recompute, backward
    attn_flops = 8 * work["attn"]
    upd = (update_bytes(leaves) if opt == "momentum" else
           sum(3 * t.numel() * t.element_size() for t in leaves))
    bound_ms = (flops / PEAK_FLOPS["torch.bfloat16"] + attn_flops / PEAK_FLOPS["torch.float32"]
                + upd / HBM_BYTES_PER_S) * 1e3
    log(f"  dispatch: {work['groups']} groups of {batch * seq // work['groups']} tokens, "
        f"capacity {work['capacity']} per expert: {work['rows']} slab rows per MoE layer for "
        f"{work['pairs']} routed (token, expert) pairs ({work['rows'] / work['pairs']:.2f}x "
        "the routed work)")
    log(f"  work per step: {flops / 1e12:.1f} TFLOP of bf16 matmuls (forward, remat recompute "
        f"and backward; the experts over their slab), {attn_flops / 1e12:.2f} TFLOP of float32 "
        f"chunked-scan attention, an update of {upd / 1e9:.1f} GB: bound {bound_ms:.1f} ms "
        f"(989 TFLOP/s bf16, 67 TFLOP/s float32, 3.35 TB/s); the step at "
        f"{100 * bound_ms / step_ms:.0f} % of it")
    fwd_ms, fwd_bwd_ms = attention_ms(cfg, batch, seq)
    attn_step = cfg.n_layers * (fwd_ms + fwd_bwd_ms)
    log(f"  chunked-scan attention alone, one layer: forward {fwd_ms:.2f} ms, forward + "
        f"backward {fwd_bwd_ms:.2f} ms; x {cfg.n_layers} layers with the remat recompute = "
        f"{attn_step:.1f} ms, {100 * attn_step / step_ms:.1f} % of the step")
    undo = [dispatch_range(), host_range(attention, ("flash_attention_xla",),
                                         "chunked_attention")]
    try:
        wall_ms, split = step_split(tr, state, ranges=("moe_dispatch", "chunked_attention"))
    finally:
        for u in undo:
            u()
    log_split(wall_ms, split, step_ms, upd, n_params)
    flash = eval_kernel_vs_xla(tr, state, "flash_attention")
    del tr, state, data, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return launches, flash


def sgd_update_past_2_31(tr, state, grads, piece: int = 1 << 28) -> None:
    """For an sgd trainer whose largest leaf has more than 2^31 elements:
    one more update through its optimizer (one ``stream_gd`` launch over the
    whole tree, as each step makes), then that leaf's elements from 2^31 -
    2^20 to its end held bit-equal to the plain version on copies taken
    before, ``piece`` elements at a time.  The launch is a comparison's and
    is not among the phase's counted launches."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.common import tree_items

    path, w = max(tree_items(state.params), key=lambda kv: kv[1].numel())
    if tr.tcfg.optimizer != "sgd" or w.numel() <= 2**31:
        return
    g = dict(tree_items(grads))[path]
    path = "/".join(map(str, path))
    start = 2**31 - 2**20
    w0, g0 = w.view(-1)[start:].clone(), g.view(-1)[start:].clone()
    before = ops.LAUNCHES["stream_gd"]
    tr.optimizer.update(grads, state.opt_state, state.params)
    torch.cuda.synchronize()
    launched = ops.LAUNCHES["stream_gd"] - before
    coeffs = ops.coeffs_f32((1.0, -tr.tcfg.lr))     # the Trainer's sgd: no weight decay
    tail = w.view(-1)[start:]
    same = all(torch.equal(tail[i:i + piece],
                           ref.stream_gd((w0[i:i + piece], g0[i:i + piece]), coeffs, w.dtype))
               for i in range(0, tail.numel(), piece))
    log(f"  one more sgd update ({launched} stream_gd launch over the tree): {path} "
        f"{tuple(w.shape)} = {w.numel() / 1e9:.3f} G elements, elements {start} to "
        f"{w.numel() - 1} (past 2^31) bit-equal to the plain version: {same}")
    del w0, g0
    if launched != 1 or not same:
        raise SystemExit(f"chip_smoke: stream_gd's update of {path} past element 2^31 "
                         "differs from its plain version")


def save_params_once(params, step) -> None:
    """Time one synchronous checkpoint of the full-width parameters (6.2 GB,
    under build/, deleted after) where the disk has room for three."""
    from repro_torch.models.common import tree_items
    from repro_torch.train import checkpoint

    nbytes = sum(t.numel() * t.element_size() for _, t in tree_items(params))
    root = ROOT / "build" / "chip_smoke_full_ckpt"
    free = shutil.disk_usage(ROOT).free
    if free < 3 * nbytes:
        log(f"  checkpoint of the parameters: not measured ({free / 1e9:.1f} GB free, "
            f"{nbytes / 1e9:.1f} GB to write)")
        return
    t0 = time.perf_counter()
    checkpoint.save(str(root), step, params, keep=1)
    dt = time.perf_counter() - t0
    ok = checkpoint.latest_step(str(root)) == step
    shutil.rmtree(root, ignore_errors=True)
    log(f"  checkpoint of the parameters ({nbytes / 1e9:.2f} GB, host copy + npz + fsync'd "
        f"META): {dt:.1f} s = {nbytes / dt / 1e9:.2f} GB/s; complete: {ok}")
    if not ok:
        raise SystemExit("chip_smoke: the full-width checkpoint is incomplete")


# ---------------------------------------------------------------------------
# phases 12 and 13: ConvNet training
# ---------------------------------------------------------------------------

CNN_TRAIN_BATCH = 32                           # the JAX example's default batch


def load_example(name: str):
    """An ``examples/<name>.py`` of the checkout, as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def convnet_train_card_vs_cpu(ex) -> None:
    """``examples/torch_train_convnet.py``'s small net in float32 from the
    same weights and batches, 6 steps of momentum and of adamw (the
    example's settings) on the card, with cuDNN and without, and on the
    CPU: losses within 1e-4 relative at every step, parameters within 1e-4
    (atol = rtol), one stream_gd launch per momentum step, and the card's
    checkpoint (under build/) restores bit-exactly.

    The card's float32 weight gradient skips cuDNN (``conv2d_exact_wgrad``):
    cuDNN computes conv4's with a Winograd transform, which left ~5e-8
    where the true gradient is exactly 0 (a dead channel) and adamw (eps
    1e-8) turned that into steps of ~0.8 lr.  The first step's gradients
    are held to have no stray non-zero against the CPU; in bf16, which
    keeps cuDNN's weight gradient, the same count is logged."""
    from repro_torch.core.convnet import ConvNetExecutor, make_small_convnet
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.train import checkpoint
    from repro_torch.train.train_step import value_and_grad

    steps = 6
    init = ConvNetExecutor(make_small_convnet(10, 16, 16), impl="xla").init(
        torch.Generator().manual_seed(0), "cpu")
    root = ROOT / "build" / "chip_smoke_convnet_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def run(opt, dev, cudnn):
        ops.reset_launches()
        ckpt = str(root / f"{opt}_{dev}_{cudnn}")
        enabled = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = cudnn
        try:
            losses, params, _ = ex.train(steps=steps, opt=opt, ckpt=ckpt, device=dev,
                                         init_params=init, ckpt_every=3)
        finally:
            torch.backends.cudnn.enabled = enabled
        return np.array(losses), params, ops.LAUNCHES["stream_gd"], ckpt

    def gap(card, cpu):
        rel = float(np.max(np.abs(card[0] - cpu[0]) / np.abs(cpu[0])))
        perr = max(float(((a.cpu() - b).abs() / (1e-4 + 1e-4 * b.abs())).max())
                   for (_, a), (_, b) in zip(tree_items(card[1]), tree_items(cpu[1])))
        return rel, perr

    cpu = {opt: run(opt, "cpu", True) for opt in ("momentum", "adamw")}
    for opt in ("momentum", "adamw"):
        for cudnn in (True, False):
            card = run(opt, "cuda", cudnn)
            gl, gp, launches, ckpt = card
            rel, perr = gap(card, cpu[opt])
            got, extra, step = checkpoint.restore(ckpt, gp, device="cuda")
            exact = step == steps and extra == {"data": {"seed": 0, "step": steps}} and all(
                torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(got), tree_items(gp)))
            log(f"  {opt}, cuDNN {'on' if cudnn else 'off'}: card losses "
                f"{['%.5f' % x for x in gl]}, max rel diff to the CPU {rel:.2e}, params at "
                f"{perr:.3f} of the 1e-4 tolerance; {launches} stream_gd launches on the "
                f"card; checkpoint of step {step} restores bit-exactly: {exact}")
            if rel > 1e-4 or perr > 1.0 or not np.isfinite(gl).all():
                raise SystemExit(f"chip_smoke: ConvNet {opt} training on the card differs "
                                 "from the CPU")
            want = steps if opt == "momentum" else 0
            if launches != want:
                raise SystemExit(f"chip_smoke: {launches} stream_gd launches, expected {want}")
            if not exact:
                raise SystemExit("chip_smoke: the ConvNet checkpoint does not restore "
                                 "bit-exactly")

    # the first step's weight gradients, card (cuDNN on) against CPU: exact
    # zeros per leaf, and the card's elements that are 0 on the CPU but not here
    exe = ConvNetExecutor(make_small_convnet(10, 16, 16), impl="xla")
    x, y = (torch.from_numpy(a) for a in
            SyntheticImageData(px=16, channels=3, classes=10, batch=32).next())

    def grads(dtype, dev):
        p = tree_map(lambda t: t.to(dev, dtype, copy=True), init)
        return value_and_grad(exe.loss_fn, p, x.to(dev, dtype), y.to(dev))[1]

    def count(label, want, got, held):
        zeros = {".".join(path): (int((w == 0).sum()), int((g.cpu() == 0).sum()),
                                  int(((w == 0) & (g.cpu() != 0)).sum()))
                 for (path, w), (_, g) in zip(tree_items(want), tree_items(got))
                 if path[-1] == "w"}
        stray = sum(s for _, _, s in zeros.values())
        log(f"    {label}: weight-gradient exact zeros (CPU, card, stray: 0 on the CPU and "
            f"not on the card) {zeros}; {stray} stray")
        if held and stray:
            raise SystemExit(f"chip_smoke: {label}: {stray} weight-gradient elements are 0 on "
                             "the CPU and not on the card")
        return stray

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    f32 = grads(torch.float32, "cpu")
    with torch.profiler.profile(activities=acts) as prof:
        card = grads(torch.float32, "cuda")
        torch.cuda.synchronize()
    log("  step 1's weight gradients, card (cuDNN on) against the CPU:")
    count("float32 (im2col weight gradient)", f32, card, True)
    wgrad = sorted({e.key.split("(")[0][:80] for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA")
                    and "wgrad" in e.key.lower()})
    log(f"    float32 weight-gradient kernels from cuDNN: {wgrad or 'none'}")
    count("bf16 (cuDNN's weight gradient)", grads(torch.bfloat16, "cpu"),
          grads(torch.bfloat16, "cuda"), False)
    shutil.rmtree(root, ignore_errors=True)


def vgg16_train(ex, smi) -> dict[str, int]:
    """Full-width VGG16 training on the card: ``impl="xla"``, 224 x 224,
    batch 32, bf16 weights from a seeded He init, float32 momentum (lr 3e-3),
    6 steps on batches of ``SyntheticImageData`` put on the card beforehand.
    Then the trained weights through ``impl="kernel"`` on 16 images against
    ``"xla"``.  Returns the launches of the path: stream_gd in training,
    the three ConvNet kernels in the kernel forward."""
    from repro_torch.core import zoo
    from repro_torch.core.convnet import ConvNetExecutor
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_items

    steps = 6
    gc.collect()
    torch.cuda.empty_cache()
    layers = zoo.vgg16()
    exe = ConvNetExecutor(layers, impl="xla")
    opt = ex.make_optimizer("momentum")
    params = exe.init(torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    state = opt.init(params)
    step = ex.make_step(exe, opt)
    leaves = [t for _, t in tree_items(params)]
    n_params = sum(t.numel() for t in leaves)
    t0 = time.perf_counter()
    data = SyntheticImageData(px=224, channels=3, classes=1000, batch=CNN_TRAIN_BATCH)
    t_templates = time.perf_counter() - t0
    batches, gen_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        x, y = data.next()
        gen_ms.append((time.perf_counter() - t0) * 1e3)
        batches.append((torch.from_numpy(x).to("cuda", torch.bfloat16),
                        torch.from_numpy(y).to("cuda")))
    torch.cuda.synchronize()
    log(f"  {n_params / 1e6:.1f} M parameters in {len(leaves)} leaves; "
        f"{3 * exe.flops_per_example() * CNN_TRAIN_BATCH / 1e12:.2f} TFLOP per step "
        f"(3 x the forward); data: class templates {t_templates:.1f} s once, then "
        f"{statistics.median(gen_ms):.1f} ms per batch of {CNN_TRAIN_BATCH} on the host "
        f"(median, not in the step time)")
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, step_s = [], []
    for x, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, x, y)
        losses.append(float(loss))                   # waits for the step
        step_s.append(time.perf_counter() - t0)
    launches = ops.LAUNCHES["stream_gd"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = statistics.median(step_s[1:]) * 1e3
    log(f"  losses {['%.4f' % x for x in losses]}")
    log(f"  step {step_ms:.2f} ms (median of steps 2-{steps}; first step "
        f"{step_s[0] * 1e3:.1f} ms) = {CNN_TRAIN_BATCH / step_ms * 1e3:.1f} trained images/s, "
        f"peak device memory {peak:.2f} GiB, {held:.2f} GiB of it held before the steps; "
        f"stream_gd launches {launches} = {launches / steps:g} per step ({smi})")
    if not all(np.isfinite(losses)):
        raise SystemExit("chip_smoke: full-width VGG16 training gave a non-finite loss")
    if launches != steps:
        raise SystemExit(f"chip_smoke: {launches} stream_gd launches, expected {steps}")
    t0 = time.perf_counter()
    split = profile_split(lambda: step(params, state, *batches[0]))
    wall_ms = (time.perf_counter() - t0) * 1e3
    log_split(wall_ms, split, step_ms, update_bytes(leaves), n_params)

    n = 16
    kexe = ConvNetExecutor(layers)                    # impl="kernel"
    x16 = batches[-1][0][:n]
    ops.reset_launches()
    with torch.no_grad():
        got = kexe.apply(params, x16)
        torch.cuda.synchronize()
        run = {k: ops.LAUNCHES[k] for k in CNN_KERNELS}
        want = exe.apply(params, x16)
    kinds = [l.kind for l in layers]
    expect = {"stream_mac_conv": kinds.count("conv"), "stream_maxpool": kinds.count("pool"),
              "tiled_matmul": kinds.count("fc")}
    log(f"  trained weights, {n} images through impl='kernel': launches {run}")
    check_close("VGG16 logits, kernel against xla", got, want, torch.bfloat16)
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    log(f"  argmax agreement {same}/{n}")
    if run != expect:
        raise SystemExit(f"chip_smoke: the kernel forward launched {run}, want {expect}")
    del params, state, batches, data
    torch.cuda.empty_cache()
    return {"stream_gd": launches, **run}


def eval_kernel_vs_xla(tr, state, kernel: str) -> int:
    """The eval loss of the trained weights on ``EVAL_ROWS`` rows of a fresh batch of
    the trainer's stream with ``impl="kernel"`` (``kernel``: ``ssd_scan`` for
    mamba2, ``flash_attention`` for the attention layers) and with
    ``impl="xla"``, within the bf16 tolerance; one launch of ``kernel`` per
    layer.  Returns its launches."""
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import make_eval_step

    cfg = tr.model.cfg
    batch = {k: v[:EVAL_ROWS] for k, v in tr.data.next().items()}
    ops.reset_launches()
    got = make_eval_step(tr.model, "kernel")(state.params, batch)
    torch.cuda.synchronize()
    launches = ops.LAUNCHES[kernel]
    want = make_eval_step(tr.model, "xla")(state.params, batch)
    log(f"  eval loss on a fresh batch {tuple(batch['tokens'].shape)}: kernel "
        f"{float(got):.5f}, xla {float(want):.5f}; {kernel} launches {launches}")
    check_close(f"{cfg.name} eval loss, kernel against xla", got, want, torch.bfloat16)
    if launches != cfg.n_layers:
        raise SystemExit(f"chip_smoke: {launches} {kernel} launches, expected one per layer")
    return launches


# the paged-decode rows --kernel-times takes: (label, heads, KV heads, lens, slots, holes)
PAGED_TIMED = [("qwen2.5-3b", H, HKV, PAGED_RAGGED, 1024 // PS, True),
               ("qwen3-moe", QM["h"], QM["hkv"], PAGED_RAGGED, 1024 // PS, True),
               ("qwen3-moe served", QM["h"], QM["hkv"], PAGED_SERVED_MOE, 2048 // PS, False)]


def kernel_times(src: Path) -> int:
    """``--kernel-times``: phase 2's timed rows alone, of the ``repro_torch``
    under ``src``: the served flash shapes and the three paged-decode rows in
    bf16, and ``ssd_scan``'s prompt and served slice in bf16 and float32.
    Each case is held to its plain version; its design is logged, not
    checked (another commit has other designs)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smi_line()
    log(f"== kernels at the served shapes, {src} ({smi})")
    out = {"src": str(src), "device": smi, "rows": {}}
    keys = ("ms", "device_ms", "host_ms", "library_ms", "library_device_ms", "library_host_ms",
            "bound_ms")
    for label, shape in FLASH_SERVED.items():
        row = flash_case(torch.bfloat16, label, timed=True, turns=True, design=False, **shape)
        log_row(row)
        out["rows"][label] = {k: row[k] for k in keys}
    floor = empty_launch_ms()
    for label, h, hkv, lens, slots, holes in PAGED_TIMED:
        row = paged_case(torch.bfloat16, True, h, hkv, f"paged {label}", lens, slots, holes,
                         floor, design=False)
        log_row(row)
        out["rows"][f"paged {label}"] = {k: row[k] for k in keys + ("floor_ms", "empty_ms")}
    for dtype in (torch.bfloat16, torch.float32):
        for label, seq, carried, batch, clip, timed in SSD_CASES:
            if timed:
                row = ssd_case(dtype, label, seq, carried, True, batch, clip, design=False)
                log_row(row)
                out["rows"][f"ssd {label} {dtype}"] = {k: row[k] for k in keys + (
                    "plain_ms", "bound_f32_ms")}
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel-times", action="store_true",
                    help="time only phase 2's served flash, paged-decode and ssd_scan rows")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch is run (default: beside this "
                         "script)")
    args = ap.parse_args()
    if not (args.src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {args.src}/repro_torch is not beside this script; run it from "
              "the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs the port on "
              "the card", file=sys.stderr)
        return 1
    if args.kernel_times:
        return kernel_times(args.src)
    from repro_torch.configs import get_arch
    from repro_torch.core import zoo
    from repro_torch.core.convnet import narrow_convnet
    from repro_torch.kernels import build, ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.serve import AdmissionConfig, CacheConfig, EngineConfig
    t_start = time.perf_counter()

    # -- phase 1 ----------------------------------------------------------------
    log("== phase 1: build and identify")
    t0 = time.perf_counter()
    logs = build.build()
    log(f"  nvcc: built {sorted(logs) or 'nothing (already built)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    if logs:
        log("  ptxas -v per kernel (the ring buffers are dynamic shared memory, sized at "
            "launch; ptxas reports only the static part):")
    for text in logs.values():
        for line in ptxas_report(text):
            log(f"    {line}")
    log(f"    paged_gather_bulk: {ops.paged_gather_smem(8 * 256)} bytes of dynamic shared memory "
        f"per bulk-copy block at an 8 x 256 table, {ops.paged_gather_smem(8 * 64)} at 8 x 64")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"  device: {kind} (count {torch.cuda.device_count()}); nvidia-smi: {smi}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 2 ----------------------------------------------------------------
    log("== phase 2: kernels against their plain versions "
        f"(H={H}, Hkv={HKV}, D={D}, PS={PS})")
    rows = {}
    floor = empty_launch_ms()
    log(f"  an empty kernel's launch takes {floor:.4f} ms of device time (profiler): the floor "
        "under any single launch")
    flash_cases = {"prefill": FLASH_SERVED["prefill"],
                   "chunk": dict(sq=128, sk=1024, q_offset=384, kv_len=512, window=None),
                   "window": dict(sq=512, sk=512, q_offset=0, kv_len=512, window=128)}
    for dtype in (torch.float32, torch.bfloat16):
        timed = dtype == torch.bfloat16
        row = paged_case(dtype, timed, floor=floor)
        if row:
            rows["paged_decode_attention"] = row
        for label, shape in flash_cases.items():
            row = flash_case(dtype, label, timed=timed, turns=label == "prefill", **shape)
            if row:
                log_row(row)
                rows.setdefault("flash_attention", row)
    log_row(rows["paged_decode_attention"])
    log(f"  recurrentgemma-9b attention (H={RG['h']}, Hkv={RG['hkv']}, D={RG['d']}, "
        f"window {RG['window']}; bf16 runs wgmma + TMA, float32 the CUDA cores):")
    for dtype in (torch.float32, torch.bfloat16):
        for label in ("rg prompt", "rg chunk"):
            row = flash_case(dtype, label, timed=dtype == torch.bfloat16, turns=True,
                             **FLASH_SERVED[label])
            if row:                 # logged, not in the JSON line
                log_row(row)
    vgg = {l.name: l for l in zoo.vgg16()}
    # (label: the VGG paper's name and the zoo's, layer); the JSON line keeps conv3_2
    conv_cases = [("conv1_1 (conv0)", vgg["conv0"]), ("conv1_2 (conv1)", vgg["conv1"]),
                  ("conv2_2 (conv4)", vgg["conv4"]), ("conv3_2 (conv7)", vgg["conv7"]),
                  ("conv4_2 (conv11)", vgg["conv11"]), ("conv5_2 (conv15)", vgg["conv15"]),
                  ("alexnet conv1", zoo.alexnet()[0])]
    log(f"  ConvNet kernels at batch {CNN_BATCH}:")
    for dtype in (torch.float32, torch.bfloat16):
        timed = dtype == torch.bfloat16
        for label, layer in conv_cases:
            row = conv_case(dtype, layer, label, timed)
            if row:
                log_row(row)
                if label.startswith("conv3_2"):
                    rows["stream_mac_conv"] = row
        row = pool_case(dtype, vgg["pool2"], "pool1 (pool2)", timed)
        if row:
            log_row(row)
            rows["stream_maxpool"] = row
        for fc in ("fc6", "fc7", "fc8"):            # the JSON line keeps fc6
            row = fc_case(dtype, vgg[fc], fc, timed)
            if row:
                log_row(row)
                rows.setdefault("tiled_matmul", row)
    log("  mamba2-130m SSD scan (H=24, P=64, N=128, chunk 256; bf16 on mma.sync, float32 "
        "on the CUDA cores, one launch a call):")
    for dtype in (torch.float32, torch.bfloat16):
        for label, seq, carried, batch, clip, timed in SSD_CASES:
            row = ssd_case(dtype, label, seq, carried, timed and dtype == torch.bfloat16,
                           batch, clip)
            if row:
                log_row(row)
                rows.setdefault("ssd_scan", row)        # the JSON line keeps the prompt
    log(f"  the moe family: deepseek-v3's MLA prefill (H = Hkv = {MLA['h']}, D = {MLA['d']}: "
        f"qk_nope + qk_rope, V padded), qwen3-moe's prefill (H {QM['h']} over Hkv "
        f"{QM['hkv']}, D = {D}), the reduced MLA's D = 48, qwen3-moe's paged decode "
        "(rep 16 = MAX_REP) on ragged lanes and at its served context (~1,036 tokens, 128 "
        "slots):")
    for dtype in (torch.float32, torch.bfloat16):
        timed = dtype == torch.bfloat16
        row = flash_case(dtype, "mla prompt", timed=timed, turns=True,
                         **FLASH_SERVED["mla prompt"])
        row_q = flash_case(dtype, "qwen3-moe prompt", timed=timed, turns=True,
                           **FLASH_SERVED["qwen3-moe prompt"])
        flash_case(dtype, "mla chunk", 256, 1024, 512, 768, None, False, MLA["h"], MLA["h"],
                   MLA["d"])
        flash_case(dtype, "reduced mla", 100, 100, 0, 100, None, False, 4, 4, 48)
        row_p = paged_case(dtype, timed, QM["h"], QM["hkv"], "qwen3-moe", floor=floor)
        row_s = paged_case(dtype, timed, QM["h"], QM["hkv"], "qwen3-moe served",
                           lens=PAGED_SERVED_MOE, slots=2048 // PS, holes=False, floor=floor)
        for r in (row, row_q, row_p, row_s):       # logged, not in the JSON line
            if r:
                log_row(r)
    log("  flash_attention at batch 2 (a batched prefill, as make_eval_step gives it) at "
        "each served head dim; 'k/v expanded': one slice over the batch (stride 0):")
    for dtype in (torch.float32, torch.bfloat16):
        for d, h, hkv, sq, sk, off, kvl, win, expand in (
                (128, 16, 2, 200, 200, 0, 200, None, False),
                (192, 8, 8, 150, 300, 100, 250, None, True),
                (256, 16, 1, 333, 333, 0, 333, 100, False),
                (256, 16, 1, 100, 400, 250, 350, 64, True)):
            flash_case(dtype, f"batch 2, D {d}, q_offset {off}"
                       + (", k/v expanded" if expand else ""), sq, sk, off, kvl, win, False,
                       h, hkv, d, b=2, expand=expand)
    log("  flash_attention at the shapes of phases 22 and 23's kernel evals (make_eval_step "
        "on 4 rows of 1,024 tokens, bf16): qwen3-moe's GQA and deepseek-v3's MLA:")
    for label, h, hkv, d in EVAL_FLASH:
        flash_case(torch.bfloat16, label, MOE_TRAIN_SEQ, MOE_TRAIN_SEQ, 0, MOE_TRAIN_SEQ, None,
                   False, h, hkv, d, b=EVAL_ROWS)
    log("  paged_gather, one launch per call: a full-width qwen2.5-3b cache leaf (the gather "
        "path), one recurrentgemma attention layer's pools and one deepseek MLA layer's (the "
        "paged decodes), alone and in the pairs a decode step gathers together:")
    for dtype in (torch.float32, torch.bfloat16):
        for label, specs, slots, lens in GATHER_CASES:
            row = gather_case(dtype, dtype == torch.bfloat16, label, specs, slots, lens)
            if row:
                log_row(row)
                rows.setdefault("paged_gather", row)      # the JSON line keeps the leaf
    log("  stream_gd on full-width qwen2.5-3b's largest leaf (seg0 mlp.w_up):")
    rows["stream_gd"] = stream_gd_cases()
    log_row(rows["stream_gd"])
    log(f"  (times: median CUDA-event time per call, L2 flushed before each; {smi})")

    # -- phase 3 ----------------------------------------------------------------
    log("== phase 3: reduced qwen2.5-3b in float32, card against CPU")
    card_vs_cpu_tokens("qwen2.5-3b", [
        (f"prefill_chunk={chunk}", (5, 40, 17, 33, 9, 26),
         EngineConfig(batch_slots=3, max_len=96, cache=CacheConfig(page_size=PS),
                      admission=AdmissionConfig(prefill_chunk=chunk)), None)
        for chunk in (0, 16)], smi)

    # -- phase 4 ----------------------------------------------------------------
    log("== phase 4: full-width qwen2.5-3b (bf16, random weights) on the card")
    cfg = get_arch("qwen2.5-3b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_items(params))
    log(f"  init: {n_params / 1e9:.3f} B parameters in {time.perf_counter() - t0:.1f} s")
    ecfg = EngineConfig(batch_slots=8, max_len=1024, cache=CacheConfig(page_size=PS))
    rng = np.random.default_rng(4)
    qwen_prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),)).astype(np.int32)
                    for n in rng.integers(128, 513, size=16)]
    calls = count_calls(model, ("decode_step_paged",))
    reqs, run = serve_full_width(model, params, qwen_prompts, ecfg, SERVE_KERNELS, smi,
                                 on_reset=lambda: calls.update(decode_step_paged=0))
    launches = {k: run[k] for k in SERVE_KERNELS}
    log(f"  {calls['decode_step_paged']} decode steps, paged_decode_attention "
        f"{run['paged_decode_attention']} launches ({cfg.n_layers} layers)")
    if run["paged_decode_attention"] != cfg.n_layers * calls["decode_step_paged"]:
        raise SystemExit("chip_smoke: paged_decode_attention should launch once per layer "
                         "per decode step")
    paged_tokens = [r.out_tokens for r in reqs]
    # the engine's first token agrees with a direct prefill, whose logits are finite
    logits, _ = model.prefill(params, torch.as_tensor(qwen_prompts[0],
                                                      device="cuda")[None].long())
    if logits.shape != (1, 1, cfg.padded_vocab) or not torch.isfinite(logits).all():
        raise SystemExit(f"chip_smoke: bad prefill logits {tuple(logits.shape)}")
    if int(logits[0, -1].argmax()) != reqs[0].out_tokens[0]:
        raise SystemExit("chip_smoke: engine's first token differs from a direct prefill")
    log("  prefill logits finite, shape (1, 1, V); first token matches the engine")
    decode_breakdown(model, params, cfg.vocab_size)
    del model, params
    torch.cuda.empty_cache()

    # -- phase 5 ----------------------------------------------------------------
    log("== phase 5: narrow VGG16 (channels / 16, 32 px) in float32, card against CPU")
    vgg16_card_vs_cpu(narrow_convnet(zoo.vgg16(), channel_div=16, input_px=32), 8, 32)

    # -- phase 6 ----------------------------------------------------------------
    log(f"== phase 6: full-width VGG16 (224 x 224, batch {CNN_BATCH}, bf16, random weights) "
        "on the card")
    launches.update(vgg16_forward(smi))
    log("  full width in float32, two images, card against CPU:")
    vgg16_card_vs_cpu(zoo.vgg16(), 2, 224)

    # -- phase 7 ----------------------------------------------------------------
    log("== phase 7: reduced mamba2-130m in float32, card against CPU")
    card_vs_cpu_tokens("mamba2-130m", [
        ("whole prompts (<= one 32-token chunk or a multiple)", (5, 32, 17, 9, 26, 64),
         EngineConfig(batch_slots=3, max_len=96, cache=CacheConfig(page_size=PS)), None),
        ("prefill_chunk=16", (5, 40, 17, 33, 9, 26),
         EngineConfig(batch_slots=3, max_len=96, cache=CacheConfig(page_size=PS),
                      admission=AdmissionConfig(prefill_chunk=16)), None)], smi)

    # -- phase 8 ----------------------------------------------------------------
    log("== phase 8: full-width mamba2-130m (bf16, random weights) on the card")
    cfg = get_arch("mamba2-130m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.n_layers} layers, d_model {cfg.d_model}, SSD H={SSM['h']} P={SSM['p']} "
        f"N={SSM['n']} chunk {SSM['chunk']}; "
        f"{sum(t.numel() for _, t in tree_items(params)) / 1e6:.1f} M parameters")
    ecfg = EngineConfig(batch_slots=8, max_len=1024, cache=CacheConfig(page_size=PS),
                        admission=AdmissionConfig(prefill_chunk=SSM["chunk"]))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),)).astype(np.int32)
               for n in rng.integers(128, 513, size=16)]
    reqs, run = serve_full_width(model, params, prompts, ecfg, ("ssd_scan",), smi)
    launches["ssd_scan"] = run["ssd_scan"]
    cache = tree_map(lambda sp: torch.zeros(sp.shape, dtype=sp.dtype, device="cuda"),
                     model.cache_specs(1, len(prompts[0])))
    toks = torch.as_tensor(prompts[0], device="cuda")[None].long()
    for i in range(0, toks.shape[1], SSM["chunk"]):
        logits, cache = model.extend_step(params, cache, toks[:, i:i + SSM["chunk"]], i)
    if logits.shape[-1] != cfg.padded_vocab or not torch.isfinite(logits).all():
        raise SystemExit(f"chip_smoke: bad mamba2 prefill logits {tuple(logits.shape)}")
    if int(logits[0, -1].argmax()) != reqs[0].out_tokens[0]:
        raise SystemExit("chip_smoke: mamba2 engine's first token differs from a direct "
                         "chunked prefill")
    log("  chunked-prefill logits finite; first token matches the engine")
    prefill_ms(model, params, cfg.vocab_size, 512, SSM["chunk"], group="ssd_scan")
    decode_breakdown(model, params, cfg.vocab_size, prefill_chunk=SSM["chunk"])
    log("  (the decode step runs no port kernel: ssm_decode is plain torch, as the "
        "JAX package leaves it to XLA)")
    del model, params
    torch.cuda.empty_cache()

    # -- phase 9 ----------------------------------------------------------------
    log("== phase 9: the gather decode path")
    card_vs_cpu_tokens("qwen2.5-3b", [
        ("decode_path=gather, prefill_chunk=16", (5, 40, 17, 33, 9, 26),
         EngineConfig(batch_slots=3, max_len=96,
                      cache=CacheConfig(page_size=PS, decode_path="gather"),
                      admission=AdmissionConfig(prefill_chunk=16)), "paged")], smi)
    cfg = get_arch("qwen2.5-3b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    log("  full-width qwen2.5-3b (bf16, phase 4's weights and requests), decode_path=gather:")
    ecfg = EngineConfig(batch_slots=8, max_len=1024,
                        cache=CacheConfig(page_size=PS, decode_path="gather"))
    calls = count_calls(model, ("decode_step",))
    reqs, run = serve_full_width(model, params, qwen_prompts, ecfg, ("paged_gather",), smi,
                                 on_reset=lambda: calls.update(decode_step=0))
    launches["paged_gather"] = run["paged_gather"]
    log(f"  {calls['decode_step']} decode steps, paged_gather {run['paged_gather']} launches")
    if run["paged_gather"] != calls["decode_step"]:
        raise SystemExit("chip_smoke: the gather path should launch one paged_gather per "
                         "decode step (every seq leaf in one launch)")
    same = sum(r.out_tokens == t for r, t in zip(reqs, paged_tokens))
    log(f"  {same}/{len(reqs)} requests gave the paged path's tokens (bf16: the plain "
        "decode attention rounds otherwise than the paged kernel)")
    paged_ms = decode_breakdown(model, params, cfg.vocab_size, profile=False)
    gather_ms = decode_breakdown(model, params, cfg.vocab_size, decode_path="gather")
    log(f"  decode step, same call: paged {paged_ms:.3f} ms, gather {gather_ms:.3f} ms "
        f"({gather_ms / paged_ms:.2f}x)")
    del model, params
    torch.cuda.empty_cache()

    # -- phase 10 ---------------------------------------------------------------
    log("== phase 10: reduced qwen2.5-3b training in float32, card against CPU")
    train_card_vs_cpu("qwen2.5-3b", 32)
    train_fault_on_card()

    # -- phase 11 ---------------------------------------------------------------
    log("== phase 11: full-width qwen2.5-3b training (bf16, random weights, momentum) "
        "on the card")
    launches["stream_gd"], tr, state = train_full_width(smi, "qwen2.5-3b", 8, 1024, "1e-4")
    save_params_once(state.params, state.step)
    del tr, state
    torch.cuda.empty_cache()

    # -- phase 12 ---------------------------------------------------------------
    log("== phase 12: ConvNet training (examples/torch_train_convnet.py's small net, "
        "float32), card against CPU")
    ex = load_example("torch_train_convnet")
    convnet_train_card_vs_cpu(ex)

    # -- phase 13 ---------------------------------------------------------------
    log(f"== phase 13: full-width VGG16 training (224 x 224, batch {CNN_TRAIN_BATCH}, bf16, "
        "float32 momentum, impl='xla') on the card")
    for name, n in vgg16_train(ex, smi).items():
        launches[name] += n

    # -- phase 14 ---------------------------------------------------------------
    log("== phase 14: mamba2-130m training")
    log("  reduced mamba2-130m in float32, card against CPU (64 tokens, two 32-token chunks):")
    train_card_vs_cpu("mamba2-130m", 64)
    log("  full-width mamba2-130m (bf16, random weights, momentum) through the launcher:")
    n, tr, state = train_full_width(smi, "mamba2-130m", 16, 1024, "1e-4")
    launches["stream_gd"] += n
    launches["ssd_scan"] += eval_kernel_vs_xla(tr, state, "ssd_scan")
    del tr, state
    torch.cuda.empty_cache()

    # -- phase 15 ---------------------------------------------------------------
    log("== phase 15: reduced recurrentgemma-9b (5 layers, window 64) in float32, "
        "card against CPU")
    card_vs_cpu_tokens("recurrentgemma-9b", [
        (f"prefill_chunk={chunk}, paged and gather", (70, 5, 100, 33, 61, 90),
         EngineConfig(batch_slots=3, max_len=128, cache=CacheConfig(page_size=PS),
                      admission=AdmissionConfig(prefill_chunk=chunk)), "gather")
        for chunk in (0, 16)], smi, n_layers=5)

    # -- phase 16 ---------------------------------------------------------------
    log("== phase 16: full-width recurrentgemma-9b (bf16, random weights) on the card")
    run = serve_recurrentgemma(smi)
    for name in ("flash_attention", "paged_gather"):
        launches[name] += run[name]
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 17 ---------------------------------------------------------------
    log("== phase 17: reduced recurrentgemma-9b training (5 layers) in float32, card "
        "against CPU (96 tokens: past the window, two attention chunks)")
    launches["stream_gd"] += train_card_vs_cpu("recurrentgemma-9b", 96, n_layers=5)

    # -- phase 18 ---------------------------------------------------------------
    log("== phase 18: reduced deepseek-v3-671b and qwen3-moe-235b-a22b in float32, card "
        "against CPU")
    for arch in MOE_DEPTH:
        card_vs_cpu_tokens(arch, [
            (f"{arch}, prefill_chunk={chunk}, paged and gather", (21, 5, 40, 13, 33, 9),
             EngineConfig(batch_slots=3, max_len=64, cache=CacheConfig(page_size=PS),
                          admission=AdmissionConfig(prefill_chunk=chunk)), "gather")
            for chunk in (0, 16)], smi)

    # -- phases 19 and 20 ---------------------------------------------------------
    for phase, arch in zip((19, 20), MOE_DEPTH):
        log(f"== phase {phase}: {arch} at published widths, {MOE_DEPTH[arch]} layers (bf16, "
            "random weights) on the card")
        torch.cuda.reset_peak_memory_stats()
        run = serve_moe(arch, smi)
        for name in ("flash_attention", "paged_gather", "paged_decode_attention"):
            launches[name] += run[name]
        gc.collect()
        torch.cuda.empty_cache()

    # -- phase 21 ---------------------------------------------------------------
    log("== phase 21: reduced deepseek-v3-671b and qwen3-moe-235b-a22b training in float32, "
        "card against CPU (80 tokens: two 64-token attention chunks)")
    for arch in MOE_DEPTH:
        log(f"  {arch}:")
        launches["stream_gd"] += train_card_vs_cpu(arch, 80)

    # -- phases 22 and 23 ---------------------------------------------------------
    for phase, arch in zip((22, 23), MOE_TRAIN):
        log(f"== phase {phase}: {arch} training at published widths, cut in depth (bf16, "
            "random weights) on the card")
        n, flash = train_moe_full_width(smi, arch)
        launches["stream_gd"] += n
        launches["flash_attention"] += flash

    for name in KERNELS:
        rows[name]["launches"] = launches[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: rows[n][k] for k in keys} for n in KERNELS]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
