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
and training of the moe family (deepseek-v3-671b and qwen3-moe-235b-a22b),
the serving engine's memory tiers (swap preemption through the host
tier, prefix sharing with host retire), and its observability and request
semantics (the ring-buffer tracer, the runtime sanitizer, sampling,
``eos_id``, ``admission_inflight``), its decode step captured as one
CUDA graph per engine and its chunked-prefill step as one per prefill slot,
each against the same step run eagerly, and routing over
cubes (in-process engines and worker processes) with migration between
engines, and the vlm (llava-next-mistral-7b: the dense backbone with its
patch projector) and the audio family (whisper-large-v3: the encoder /
decoder).  Every serving
engine replays its decode step as a graph (``EngineConfig.cuda_graph``, on
by default): every per-step launch check multiplies by the engine's
``decode_graph.runs``, its warm-up and one replay per step; and every
chunked prefill replays its full chunks as graphs (its tails and the moe
family's chunks run eagerly), so a per-chunk check multiplies by the
slots' ``runs`` (the warm-up and one replay per full chunk) plus their
``eager_runs``.
Every training path runs through the captured training step
(``train.captured.CapturedTrainStep``, ``TrainerConfig.cuda_graph`` on by
default): on the card a step's first call is a real step run eagerly, the
step is then captured as one CUDA graph, and every later step replays it,
so a per-step launch check counts the warm-up and the replays.
Every serving path runs at full width; all but the moe family's at full
depth (``MOE_DEPTH``, ``MOE_TRAIN``: 671 B and 235 B parameters do not
fit one card).  Phases, each fatal (phase 34 runs after phase 30, phase
35 after phase 34 and phase 36 after phase 35, phases 32 and 33 after phase
24, phases 37 and 38 after phase 33, before phase 31):

1. build the nine CUDA kernels from ``src/repro_torch/kernels/csrc``
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
   chunk at offset 2,048 against a 4,096-row cache holding 3,072), the
   captured chunked prefill's flash calls in their device-offset form
   (q_offset and kv_len read from an int32 pair on the card, K/V over the
   whole slot, whose rows past kv_len hold garbage): qwen2.5-3b's 256-token
   chunk at offset 256 in a 1,024-row slot and recurrentgemma's 1,024-token
   chunk at offset 2,048 in a 4,096-row slot with window 2,048, bit-equal
   to the host-offset form, event and device ms of both forms and of SDPA
   in turns beside the bound, and the
   the vlm and audio families' (``flash_attention`` at whisper-large-v3's
   non-causal encoder, 8 requests x 20 heads = KV heads of 64 over 1,500 x
   1,500 frames, on the wgmma + TMA design, and its cross-attention, 4
   queries over the 1,500 frames, on the split-key cluster design, each
   logged beside the mma.sync design's figures it replaced; every bf16
   head-dim-64 design's contract besides (``FLASH_D64``: causal with
   q_offset, kv_len < Sk, the device pair bit-equal to host offsets, a
   window, k and v expanded over the batch, fully masked rows, 16 and 17
   query rows per KV head); at llava-next-mistral-7b's image + text
   prefill, 2,944 causal tokens, 32 over 8 heads of 128;
   ``paged_decode_attention`` at llava's rep 4 and served contexts, each
   timed in bf16 against SDPA), the
   moe family's (``flash_attention`` at deepseek-v3's MLA prefill, 128
   heads = KV heads of head_dim 192, on a 1,024-token prompt and a chunk,
   at qwen3-moe's 64 query heads over 4 KV heads of 128 on a 1,024-token
   prompt, and the reduced model's head_dim 48; ``paged_decode_attention``
   at qwen3-moe's 64 query heads over 4 KV heads, on ragged lanes and at
   its served context of ~1,036 tokens over 128 slots), logged with their
   times but not in the JSON line; each paged case logs its design
   (``ops.PATHS``) and its launches per call (one); each flash case logs the design it took
   (``ops.PATHS``), must have launched its design's compiled kernel
   by the profiler's name (``flash_kernel_name``) and must give the same
   bits when called again; four flash cases run at
   batch 2, two of them with k and v one slice expanded over the batch;
   the served flash shapes (qwen2.5-3b's 512-token
   prefill, recurrentgemma's prompt and chunk, the MLA and qwen3-moe
   prompts, whisper's encoder and cross-attention, llava's prefill) and the
   four paged-decode shapes are timed by CUDA events, by the
   profiler's device time and by the host's issue time per call against
   SDPA in turns (SDPA given no mask where every key is seen and
   ``is_causal`` where the mask is the plain causal one, else the mask),
   each paged row beside the device time of an empty kernel's launch (the floor under any launch) and its own device time
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
   the tree's sgd beside ``torch._foreach_add_``); ``paged_write`` (the
   decode step's drop-mode write, beyond the TPU set), one launch,
   bit-equal to the plain version with an idle lane and a -1 page, on one
   full-width qwen2.5-3b layer's k and v (the JSON line's case, timed
   against the bytes its writing lanes move) and on all 36 layers';
3. serve the same requests with the reduced qwen2.5-3b engine in float32 on
   the card and on the CPU (plain kernels), whole-prompt and chunked
   prefill: the greedy tokens must be identical, on the card with the
   captured decode step (every step a replay) and with the eager one (so
   too in phases 7, 15, 18 and 24); with chunked prefill the captured
   engines replay their extend graphs (phases 7, 9 and 15 too; phase 18's
   moe family runs its chunks eagerly on the slots);
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
   ``ssd_scan`` launches once per layer per chunk (a full chunk one replay
   of its slot's graph); tok/s, prefill ms (with ``ssd_scan``'s device
   group and launches, 24 per slice), then one 256-token chunk at offset
   256 captured against the same static-buffer step eager (wall ms, busy
   share, kernels), decode-step ms and the device-busy share (the decode
   step runs no port kernel: it is the plain ``ssm_decode``);
9. the gather decode path: reduced qwen2.5-3b in float32 with
   ``decode_path="gather"`` gives the CPU's tokens and the card's paged
   tokens; full-width qwen2.5-3b with it serves 16 requests through
   ``paged_gather``, one launch per decode step (both seq leaves), and its
   decode step is timed beside the paged path's;
10. train reduced qwen2.5-3b in float32 on the card (captured: a warm-up
    step, then 3 replays) and on the CPU from the same weights and batches,
    4 steps of sgd, momentum and adamw with 1 and 2 microbatches: losses
    and grad norms within 1e-4 relative at every step, parameters within
    1e-4, one ``stream_gd`` launch per sgd or momentum step; and a card
    Trainer run with a crash injected at step 6 resumes from its checkpoint
    (under ``build/``) to step 12 with the clean run's final loss, the
    restored state getting a captured step of its own;
11. train full-width qwen2.5-3b through ``repro_torch.launch.train --full``
    (bf16, seeded random weights, momentum, seq 1024, global batch 8 in 4
    microbatches, remat full) for 6 steps: every loss finite, one
    ``stream_gd`` launch per step (14 leaves, two stages), one graph
    replayed from step 2; step ms, trained tokens/s, peak memory and a
    profiled eager step's split into forward+backward, update (against its
    one-pass bound, 16 B per parameter, and the two-pass one) and the rest;
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
    batches put on the card beforehand, through the ConvNet example's step
    captured: every loss finite, one ``stream_gd`` launch per step (32
    leaves), one graph replayed from step 2; step ms (median of steps
    2-6), the host's batch-generation ms apart, trained images/s, peak
    memory and a profiled eager step's split (the update against its
    bound, 14 B per parameter); then the trained weights through
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
    phases 22 and 23 run with the allocator's expandable segments (with
    fixed segments deepseek-v3's captured step reserves 77.2 of ~78.2 usable
    GiB) and drop the graph (and its memory pool) before their extra eager
    step;
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
    prefill slice (a full slice one replay, each tail eager) and
    ``paged_gather`` 12 times per decode step (the local
    attention layers' windowed paged decode, k and v in one launch),
    ``paged_decode_attention``
    never; tok/s, peak memory, the prefill ms per 1,024-token slice with its
    profiled split (flash, the RG-LRU scan, matmuls, the rest), one
    1,024-token slice at offset 2,048 captured against eager (wall ms, busy
    share, kernels) and the decode-step ms with its busy share and launches
    per step;
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
    dispatch for dispatch (from a third, eager card run, whose losses equal
    the captured run's bit for bit: the recorder reads the router back);
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
    1 MoE layer), sgd, batch 4 x 1,024; flash at D 192, 128 = 128 heads;
24. the memory tiers on reduced qwen2.5-3b, mamba2-130m, recurrentgemma-9b
    and deepseek-v3-671b in float32, card against CPU: the forced-preemption
    cell of tests/test_tiered_cache.py (3 lanes on 7 pages of 4 tokens)
    with swap at swap_token_cost 0 (inline admission, and async admission
    with the decode loop started once every request is ready, so the
    admission thread stages each swap-in while the loop replays the step;
    captured and eager step each), recompute and the gather path, and the
    prefix rounds of tests/test_prefix_cache.py with every index page
    retired to the host tier between rounds: the tokens equal the CPU's
    and one another, swaps, swap-ins, hits and (where the family has
    pages) retired and restored pages fire, and every page not held by the
    prefix index comes back;
25. (run right after phase 4, on its model) full-width qwen2.5-3b under
    page pressure: phase 4's 16 requests with 64 new tokens each on 8
    lanes, inline admission, unpressured, on ``PRESSURE_PAGES`` (112)
    pages with swap preemption (the default cost model, a host tier of
    twice the pool) and with recompute: every request finishes, at least
    4 swap preemptions, the swap run's tokens equal the unpressured run's
    (else the first diverging request and token are reported as a fault),
    it prefills the prompts' tokens only, ``paged_gather`` launches once
    per swap-out batch and ``paged_decode_attention`` once per layer per
    decode step; tok/s of the three runs, each swap-out's and swap-in's
    pages, bytes and ms beside a pinned copy of the same size, the
    recompute run's extra prefill tokens, and a profiled decode step after
    a swap-in;
26. (after phase 25) full-width qwen2.5-3b prefix sharing: 16 requests of
    one 512-token system prompt + 64-256 own tokens, 32 new each, 256-token
    chunks, async admission, ``prefix_sharing`` off and on: identical
    tokens, hits, prefill tokens saved = hit tokens, one fork per request
    with a partly filled tail page; tok/s and the mean time to first token
    of both; then every index page retired to the host tier (one
    ``paged_gather`` read) and 4 requests replayed: host-restored pages,
    identical tokens;
27. (after phase 26) full-width qwen2.5-3b observability and request
    semantics on phase 4's requests and tokens: a traced
    (``ObsConfig(trace=True)``) and an untraced engine, 3 runs each in
    turns, tokens identical to phase 4's, every traced lifecycle valid
    (``validate_lifecycles``), nothing dropped, the traced / untraced tok/s
    ratio printed beside the JAX package's 0.95 gate (not a gate here);
    phase 25's swap run under the sanitizer (``sanitizer.enable()``): no
    ``SanitizerError``, phase 25's tokens, both wall times;
    ``trace_annotations=True`` under the profiler: one ``decode.batch``
    range per decode step holding its 36 paged-decode kernels; temperature
    0.8 with no generator and ``admission_inflight`` 1, and
    ``admission_inflight`` 3: phase 4's tokens; two runs of 8 requests with
    one seed of a card generator (inline admission) at temperature 0.8 and
    at 1e4 (near uniform: the draws leave the greedy path): identical
    sampled tokens, greedy prefill tokens; ``eos_id`` set to the token of
    phase 4's that a request produced first at the latest step (this random
    model repeats its first token): every request stops at its first such
    token; and set to a hot sampled request's token at a step >= 3: the
    same seed stops it there;
28. (after phase 27) full-width qwen2.5-3b, the captured decode step
    against the eager one (``cuda_graph=False``): two traced engines, 3
    runs each of phase 4's requests in turns, tokens equal to phase 4's
    request for request, tok/s and the tracer's ``decode.batch`` spans;
    the 8-lane decode step of each in turns (wall ms, and from one profiled
    step the device-busy share and kernels per step; the profiled replay
    holds one paged decode and one ``paged_write`` kernel per layer, as
    the capture counted); 5 replays count 5 times the captured step's
    launches.  Phases 4, 8, 16, 19 and 20 log
    their captured step's wall ms and busy share beside the eager step's
    figures measured before the step was captured (``EAGER_STEP``);
29. (after phase 28, on phase 4's model) routing: two in-process cubes
    (``CubeRouter``) on the card over one parameter set, each with its own
    pools and captured step: phase 4's 16 requests under ``hash`` and
    ``least_loaded`` against a single engine in turns, tokens equal to phase
    4's request for request, routed counts, tok/s and the merged trace (one
    process per cube); phase 26's shared-prompt requests under
    ``prefix_affinity`` (the first alone, then 15 that follow it to its
    cube), phase 26's tokens; ``DenseSlotEngine`` on phase 4's requests (the
    share of phase 4's tokens it gives), and reduced float32, card against
    CPU: dense tokens = paged tokens;
30. (after phase 29) migration at full width: engine A takes phase 4's
    requests; after 6 steps every running one is ``export_request``ed,
    packed, pickled and landed on engine B by ``migrate_put`` /
    ``migrate_signal``; then every in-flight one is ``checkpoint_request``ed
    into a shadow on B, A dropped and the shadows adopted: tokens equal to
    phase 4's, payload bytes and the export, wire, put and restore ms, one
    ``paged_gather`` read per running request, B's pools kept;
34. (after phase 30, on phase 4's model) chunked prefill at full width:
    phase 4's 16 requests with 256-token chunks and async admission
    through a captured engine and an eager one (``cuda_graph=False``), 3
    runs each in turns: tokens equal between the two and across runs,
    request for request; per run one replay per full chunk, one eager
    tail per prompt that has one, and one ``flash_attention`` launch per
    layer per chunk; tok/s of each; one 256-token chunk at offset 256 of
    each in turns (wall ms, device-busy share, kernels);
35. (after phase 34) the kernel autotuner (``repro_torch.tune``) into a
    table under ``chiprun_out/``, never the committed one: ``tune_kernel``
    over the four canonical cutouts (full schema, winner <= default, each
    entry's times logged with the card's name and power limit); every valid
    config of each space against the default config (``lane_block``
    bit-equal; ``chunk`` of ``flash_attention_xla`` and of ``ssd_chunked``'s
    kernel form within the float32 tolerance, the SSD on phase 2's unclipped
    draws at the cutout's shapes, its clipped canonical draws logged;
    ``expert_block`` bit-equal or within the float32 tolerance, as cuBLAS
    may take another GEMM for fewer experts); ``ssd_scan`` at mamba2-130m's
    served widths at every chunk of the space against its plain version; a
    full-width mamba2-130m prefill of its 256-token served slice under
    ``capture()``, its ``ssd.chunked`` cutout materialized and tuned into
    the table, the prefill rerun under it with ``ssd_scan`` at the winner's
    chunk (``ops.PATHS``; an entry of chunk 64 as well where the winner is
    the default's) and its logits against the untuned prefill's: bit-equal
    at the default's chunk, within the bf16 tolerance where no 256-token
    chunk's seg spans 120, logged where one does (the decay clip makes the
    chunk part of the function, as in the reference); the same with
    ``a_log`` setting the per-token decays in Mamba-2's dt range, where the
    clip never engages, held to the bf16 tolerance; the host us of one
    resolve (mean of 10,000) per kernel and
    the phase's wall time;
36. (after phase 35, on phase 4's model) the port's repro-lint
    (``python -m repro_torch.analysis.lint``) exits 0 over the checkout's
    package on this machine's Python (rule count and wall time logged); an
    engine with 256-token chunks and one prefill slot captures its decode
    step and its chunked extend while ``sys.setprofile`` records the
    functions of ``repro_torch.models``, ``repro_torch.kernels.ops`` and
    ``repro_torch.serve.captured`` each captured step enters, and every one
    lies in ``capture-safety``'s static closure (the captures hold
    ``paged_decode_attention`` and ``paged_write`` once per layer and
    ``flash_attention`` once per layer in its device-offset form); a small
    ``@captured_step`` with an ``.item()`` is flagged ``graph-host-read``
    and its capture raises, the same step without the read is not flagged,
    captures and replays equal to its eager run; and 2 ``Trainer`` steps of
    eight reduced float32 models (every family, each optimizer, 2
    microbatches and remat full among them) capture their training step
    while ``sys.setprofile`` records what the step enters on this thread
    (``repro_torch.train``, ``.optim`` and ``.tune`` too): every function
    in the closure, each graph one ``stream_gd`` launch (adamw none);
31. (last) ``CubeProcRouter`` with 2 worker processes on the card, reduced
    qwen2.5-3b as the JAX package's worker builds it: tokens equal to a card
    engine built the same way here, a ``drain_cube`` and a worker SIGKILLed
    mid-drive (``recovery_s``), tokens unchanged; each worker ships its own
    launch counts up with its telemetry, every worker must have launched
    paged_decode_attention, flash_attention and paged_write, and the kernels
    line counts the workers' launches for this phase;
32. (after phase 24) reduced llava-next-mistral-7b and whisper-large-v3 in
    float32, card against CPU: llava's text requests through the engine
    (paged and gather, whole and chunked prefill), its prefill over 16
    image + 9 text tokens and 12 greedy ``decode_step``s; whisper's
    ``prefill(frames)`` and 16 greedy ``decode_step``s for 2 lanes: card
    tokens equal the CPU's, logits within 2e-4 x max(1, |logits|);
33. (after phase 32) both at published widths (bf16, seeded random
    weights), each freed before the next: llava-next-mistral-7b (32
    layers, 7.26 B parameters) serves phase 4's mix of 16 text requests
    through the engine (tok/s, one flash launch per layer per prefill, one
    ``paged_decode_attention`` and one ``paged_write`` per layer per decode
    step, the captured step's ms and busy share), then 4 image requests of
    2,880 patches + 64 text tokens through ``VLM.prefill`` (one flash launch
    per layer; time to first token, the prefill's device split) and 32
    greedy ``decode_step``s of the 4 together; whisper-large-v3 (32 + 32
    layers) takes 8 requests of 1,500 frames and a 4-token prompt through
    ``EncDecLM.prefill`` (96 flash launches: 32 in the encoder, 2 per
    decoder layer) and 64 greedy ``decode_step``s: encoder, prefill and
    decode-step ms, busy shares, tok/s;
37. (after phase 33) the captured training step against the eager one
    (``cuda_graph=False``), 4 runs in turns (captured, eager, eager,
    captured), each from the same seeded weights over the same batches:
    reduced qwen2.5-3b in float32 (sgd, momentum, adamw; 1 and 2
    microbatches; 4 steps a run), full-width qwen2.5-3b (momentum, 8 x
    1,024 in 4 microbatches) and mamba2-130m (momentum, 16 x 1,024 in 8)
    through ``Trainer`` (3 steps a run), full-width VGG16 (batch 32; 4
    steps) through the ConvNet example's step: losses and final weights
    bit-equal across the 4 runs, one ``stream_gd`` launch per sgd or
    momentum step, one graph replayed from step 2 per captured run; per
    run the losses, step wall ms (median of steps 2-N), the first step's,
    the capture's seconds and peak memory (allocated and reserved), and
    from one profiled step of each mode its device-busy share and launches;
38. (after phase 37) the vlm and audio families' training: reduced
    llava-next-mistral-7b and whisper-large-v3 in float32 as phase 10
    (batches with the synthetic stream's patches or frames), card against
    CPU; then whisper-large-v3 at published widths and depth through
    ``repro_torch.launch.train --full`` (sgd, 4 rows of 1,500 frames + 448
    tokens in 4 microbatches) and llava-next-mistral-7b at published widths
    cut to 8 of 32 layers (``VLM_TRAIN``; sgd, 2 rows of 2,880 patches +
    512 tokens) through ``Trainer``, 6 captured steps each: finite losses,
    one ``stream_gd`` launch per step, step ms, a replay's busy share and
    launches, peak memory.

``--kernel-times`` runs only phase 2's timed
rows (the served bf16 flash prefill shapes and the four paged-decode
shapes, each held to its plain version and timed against SDPA in turns, and
``ssd_scan``'s prompt and served slice in bf16 and float32, timed alone)
and prints one JSON line of their times; ``--src`` names the
``src`` directory whose ``repro_torch`` it times, so another commit
unpacked under ``build/`` (``git archive``) can be timed in the same call,
one process each: parent, change, change, parent.

A kernel's ``launches`` in the JSON line sums its counts over the paths
that drive it (serving, VGG16 inference, the gather path, the three
training paths, recurrentgemma-9b serving and reduced training, the moe
family's serving and training, the memory tiers' runs of phases 24-26,
phases 27 and 28's runs, the routed, dense and migrated runs of phases 29
and 30, phase 34's runs, phase 35's tuning, config checks and prefills, phase
36's capture warm-ups,
phase 33's llava and whisper runs, phases 37 and 38's training runs and phase
31's workers), each
counted from 0 around its own run; a graph replay counts the launches its
capture made.
Then it prints one JSON line with each kernel's numbers, the card's name
and power limit, and, last, ``{"ok": true, "device": {...}}``.  Without a
card, or without the package beside it, it exits non-zero and prints no
result.
"""
import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# the card's published peaks (``repro_torch.core.roofline.H100``: device
# memory bytes/s, dense tensor-core bf16 and float32-outside-the-tensor-cores
# FLOP/s), set by ``use_roofline``
HBM_BYTES_PER_S = 0.0
PEAK_FLOPS: dict[str, float] = {}
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
# llava-next-mistral-7b: 32 query heads over 8 KV heads of 128, and its image
# requests (2,880 patch embeddings + 64 text tokens, 32 new); whisper-large-v3:
# 20 heads of 64 (MHA) over 1,500 encoder frames, 8 requests of a 4-token
# prompt and 64 new tokens
LLAVA = dict(h=32, hkv=8, image=2880, text=64, requests=4, new=32)
WHISPER = dict(h=20, d=64, n_ctx=1500, batch=8, prompt=4, new=64)
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
    # whisper-large-v3's non-causal encoder and its cross-attention (the
    # 4-token prompt over the 1,500 frames), 8 requests; llava's image + text
    # prefill
    "whisper encoder": dict(sq=WHISPER["n_ctx"], sk=WHISPER["n_ctx"], q_offset=0,
                            kv_len=WHISPER["n_ctx"], window=None, h=WHISPER["h"],
                            hkv=WHISPER["h"], d=WHISPER["d"], b=WHISPER["batch"], causal=False),
    "whisper cross": dict(sq=WHISPER["prompt"], sk=WHISPER["n_ctx"], q_offset=0,
                          kv_len=WHISPER["n_ctx"], window=None, h=WHISPER["h"],
                          hkv=WHISPER["h"], d=WHISPER["d"], b=WHISPER["batch"], causal=False),
    "llava prefill": dict(sq=LLAVA["image"] + LLAVA["text"], sk=LLAVA["image"] + LLAVA["text"],
                          q_offset=0, kv_len=LLAVA["image"] + LLAVA["text"], window=None,
                          h=LLAVA["h"], hkv=LLAVA["hkv"]),
}
# bf16 head dim 64 beyond whisper's served rows: each design's contract at
# whisper's widths (20 heads = KV heads of 64), on wgmma + TMA (more than 16
# query rows per KV head) and on the split-key cluster (at most 16); 16 and
# 17 rows are the two sides of the threshold
FLASH_D64 = {
    "wgmma, causal, q_offset": dict(b=2, h=20, hkv=20, sq=300, sk=1000, q_offset=700,
                                    kv_len=1000, window=None),
    "wgmma, kv_len < Sk": dict(b=2, h=20, hkv=20, sq=500, sk=1500, q_offset=0, kv_len=1103,
                               window=None, causal=False),
    "wgmma, device pair": dict(b=1, h=20, hkv=20, sq=256, sk=1024, q_offset=256, kv_len=512,
                               window=None, pair=True),
    "wgmma, window": dict(b=1, h=20, hkv=20, sq=600, sk=600, q_offset=0, kv_len=600,
                          window=128),
    "wgmma, k/v expanded over the batch": dict(b=3, h=20, hkv=20, sq=200, sk=300, q_offset=0,
                                               kv_len=300, window=None, causal=False,
                                               expand=True),
    "wgmma, fully masked rows": dict(b=1, h=16, hkv=2, sq=96, sk=160, q_offset=20, kv_len=30,
                                     window=16),
    "wgmma, 17 rows a KV head": dict(b=8, h=20, hkv=20, sq=17, sk=1500, q_offset=0,
                                     kv_len=1500, window=None, causal=False),
    "split, 16 rows a KV head (4 queries x rep 4)": dict(b=8, h=16, hkv=4, sq=4, sk=1500,
                                                         q_offset=0, kv_len=1500, window=None,
                                                         causal=False),
    "split, causal, q_offset": dict(b=8, h=20, hkv=20, sq=4, sk=700, q_offset=696, kv_len=700,
                                    window=None),
    "split, kv_len < Sk": dict(b=8, h=20, hkv=20, sq=4, sk=1500, q_offset=0, kv_len=1103,
                               window=None, causal=False),
    "split, device pair": dict(b=8, h=20, hkv=20, sq=4, sk=1024, q_offset=297, kv_len=301,
                               window=None, pair=True),
    "split, window": dict(b=2, h=8, hkv=2, sq=2, sk=600, q_offset=580, kv_len=600, window=100),
    "split, k/v expanded over the batch": dict(b=3, h=20, hkv=20, sq=4, sk=1500, q_offset=0,
                                               kv_len=1500, window=None, causal=False,
                                               expand=True),
    "split, fully masked rows": dict(b=2, h=4, hkv=4, sq=4, sk=64, q_offset=80, kv_len=40,
                                     window=8),
    "split, whisper's decoder prompt": dict(b=8, h=20, hkv=20, sq=4, sk=4, q_offset=0,
                                            kv_len=4, window=None),
}
# whisper's rows on the design they replaced (mma.sync 64x64): event, device
# and host ms per call, and SDPA's event and device ms, as this script
# measured them before the redesign (NVIDIA H100 80GB HBM3, 700.00 W)
FLASH_D64_BEFORE = {"whisper encoder": (1.0635, 0.9623, 0.0483, 0.2558, 0.2400),
                    "whisper cross": (0.1047, 0.1003, 0.0562, 0.0813, 0.0415)}
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
    # beyond the TPU set: the reference's drop-mode scatter, left to XLA
    "paged_write": ("src/repro_torch/kernels/csrc/paged_write.cu",
                    "src/repro/models/transformer.py:153", None),
}
# the eager decode steps of 8 lanes as this script measured them before the
# step was captured (wall ms, device-busy share; NVIDIA H100 80GB HBM3 at
# 700 W), beside which phases 4, 8, 16, 19 and 20 log the captured step
EAGER_STEP = {"qwen2.5-3b": (31.71, 16.8), "mamba2-130m": (20.71, 13.5),
              "recurrentgemma-9b": (56.00, 23.2), "deepseek-v3-671b": (25.91, 74.0),
              "qwen3-moe-235b-a22b": (22.76, 82.0)}


T_START = time.perf_counter()


def use_roofline() -> None:
    """Read the card's peaks from ``src/repro_torch/core/roofline.py`` beside
    this script, the copy the tuner's prune reads (loaded as a file of its
    own: ``--src`` may name a tree that has none)."""
    global HBM_BYTES_PER_S, PEAK_FLOPS
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_roofline", ROOT / "src" / "repro_torch" / "core" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    HBM_BYTES_PER_S = mod.H100.hbm_bw
    PEAK_FLOPS = {"torch.bfloat16": mod.H100.peak_flops, "torch.float32": mod.H100.peak_flops_f32}


def log(msg: str) -> None:
    """Print a line; a phase's header ("== ...") carries the seconds since
    the script started."""
    if msg.startswith("== "):
        msg = f"{msg} [{time.perf_counter() - T_START:.1f} s]"
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
                      r"flash_attn_fwd|flash_attn_mma|flash_attn_wgmma|flash_split_mma|"
                      r"conv_igemm_wgmma|conv_igemm|"
                      r"maxpool_valid|matmul_tiled_stream|matmul_tiled|"
                      r"ssd_scan_mma|ssd_scan_fma|paged_gather_bulk|stream_gd_update|"
                      r"paged_write_rows)"
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
# llava's served decode (phase 33: 8 lanes of 128-512-token prompts partway
# through their 32 new tokens, max_len 1,024 = 64 slots, no holes)
PAGED_SERVED_LLAVA = [151, 538, 302, 417, 229, 486, 355, 263]


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


def flash_kernel_name(dtype, d, sq, rep) -> str:
    """The compiled kernel ``flash_attention`` must launch for ``dtype``,
    head dim ``d``, ``sq`` queries and ``rep`` query heads per KV head: the
    CUDA-core loop in float32, mma.sync at bf16 D 32 and 48, the split-key
    cluster at bf16 D 64 with at most 16 rows per KV head, wgmma + TMA
    else."""
    if dtype == torch.float32:
        return f"flash_attn_fwd<float, {d}>"
    if d < 64:
        return f"flash_attn_mma<{d}>"
    return "flash_split_mma<64>" if d == 64 and sq * rep <= 16 else f"flash_attn_wgmma<{d}>"


def flash_mask(sq, sk, q_offset, kv_len, window, causal):
    """(the (Sq, Sk) mask of visible keys, the keys some query sees: the
    window's span, not the whole cache, and the visible (q, k) pairs)."""
    qpos = torch.arange(sq, device="cuda")[:, None] + q_offset
    kpos = torch.arange(sk, device="cuda")[None, :]
    mask = (kpos < kv_len).expand(sq, sk).clone()
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask, int(mask.any(0).sum()), int(mask.sum())


def flash_case(dtype, label, sq, sk, q_offset, kv_len, window, timed, h=H, hkv=HKV, d=D,
               turns=False, b=1, expand=False, design=True, causal=True, pair=False):
    """One flash case at batch ``b`` against its plain version, logging the
    design it took, requiring the same bits from a second call and
    (``design``) holding the profiled kernel to ``flash_kernel_name``;
    ``expand``: k and v one slice expanded over the batch (stride 0);
    ``pair``: q_offset and kv_len as an int32 pair on the card, whose call
    must give the host-offset call's bits.  Timed, its row (``turns``: by
    ``in_turns`` against SDPA, given no mask where every key is seen and
    ``is_causal`` where the mask is the plain causal one, else the mask)."""
    from repro_torch.kernels import ops, ref

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(2)
    # the model's (B, S, H, D) projections, viewed as (B, H, S, D)
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    k, v = (torch.randn(1 if expand else b, sk, hkv, d, generator=gen, device="cuda")
            .to(dtype).expand(b, sk, hkv, d).transpose(1, 2) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    host = ops.flash_attention(q, k, v, **kw) if pair else None
    if pair:
        offsets = torch.tensor([q_offset, kv_len], dtype=torch.int32, device="cuda")
        kw.update(q_offset=offsets[0], kv_len=offsets[1])

    def kernel():
        return ops.flash_attention(q, k, v, **kw)

    def plain():
        return ref.flash_attention(q, k, v, **kw)

    out, want = kernel(), plain()
    torch.cuda.synchronize()
    err = check_close(f"flash_attention[{label}]", out, want, dtype)
    if not torch.equal(kernel(), out):
        raise SystemExit(f"chip_smoke: flash_attention[{label}]: a second call gave other bits")
    if pair and not torch.equal(out, host):
        raise SystemExit(f"chip_smoke: flash_attention[{label}]: the device-offset form differs "
                         "from the host-offset form")
    path = ops.PATHS.get("flash_attention")
    names = profiled_kernels(kernel)
    want_name = flash_kernel_name(dtype, d, sq, h // hkv)
    log(f"    design: {path}; profiled kernel: {names}; a second call bit-equal"
        + ("; device offsets bit-equal to host offsets" if pair else ""))
    if design and names != [want_name]:
        raise SystemExit(f"chip_smoke: flash_attention[{label}] launched {names}, expected "
                         f"{want_name}")
    if not timed:
        return None
    mask, keys, pairs = flash_mask(sq, sk, q_offset, kv_len, window, causal)
    item = q.element_size()
    nbytes = b * 2 * sq * h * d * item + (1 if expand else b) * keys * hkv * d * 2 * item
    flops = 4.0 * b * pairs * h * d

    plain_causal = causal and sq == sk == kv_len and q_offset == 0 and window is None
    sdpa = (dict(is_causal=True) if plain_causal else
            {} if bool(mask.all()) else dict(attn_mask=mask))

    def library():
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **sdpa)

    return timed_row("flash_attention", err, kernel, plain, library, nbytes, flops, dtype,
                     f"{label}: B={b} Sq={sq} Sk={sk} q_offset={q_offset} kv_len={kv_len} "
                     f"window={window} causal={causal} H={h} Hkv={hkv} D={d} {dtype}",
                     turns=turns)


# the chunked-prefill step's flash shapes in its device-offset form (the
# captured extend reads q_offset and kv_len on the card, and K/V over the
# whole slot): qwen2.5-3b's 256-token chunk at offset 256 in a 1,024-row
# slot, recurrentgemma-9b's 1,024-token chunk at offset 2,048 in a 4,096-row
# slot, window 2,048
FLASH_OFFSET = {
    "qwen2.5-3b chunk": dict(sq=256, sk=1024, q_offset=256, window=None),
    "rg chunk": dict(sq=RG["chunk"], sk=4096, q_offset=2048, window=RG["window"], h=RG["h"],
                     hkv=RG["hkv"], d=RG["d"]),
}


def flash_offset_case(label, sq, sk, q_offset, window, h=H, hkv=HKV, d=D) -> dict:
    """A bf16 chunk of ``sq`` queries at ``q_offset`` against an ``sk``-row
    slot whose rows past kv_len = q_offset + sq hold finite garbage:
    (q_offset, kv_len) read from an int32 pair on the card must give the
    host-offset call's bits in one launch of the same kernel; then event
    and cold device ms of the device-offset form, the host-offset form and
    SDPA (given the mask) in turns (D H S S H D).  Returns the row."""
    from repro_torch.kernels import ops, ref

    F = torch.nn.functional
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(1, sq, h, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    k, v = (torch.randn(1, sk, hkv, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
            for _ in range(2))
    kv_len = q_offset + sq
    pair = torch.tensor([q_offset, kv_len], dtype=torch.int32, device="cuda")

    def device_form():
        return ops.flash_attention(q, k, v, window=window, q_offset=pair[0], kv_len=pair[1])

    def host_form():
        return ops.flash_attention(q, k, v, window=window, q_offset=q_offset, kv_len=kv_len)

    got, want = device_form(), host_form()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit(f"chip_smoke: flash_attention[{label}]: the device-offset form differs "
                         "from the host-offset form")
    def plain():
        return ref.flash_attention(q, k, v, window=window, q_offset=pair[0], kv_len=pair[1])

    err = check_close(f"flash_attention[{label}, device offsets]", got, plain(), dtype)
    names = profiled_kernels(device_form)
    if names != [flash_kernel_name(dtype, d, sq, h // hkv)]:
        raise SystemExit(f"chip_smoke: flash_attention[{label}, device offsets] launched {names}")
    mask, keys, pairs = flash_mask(sq, sk, q_offset, kv_len, window, True)
    item = q.element_size()
    b_ms, b_by = bound(2 * sq * h * d * item + keys * hkv * d * 2 * item,
                       4.0 * pairs * h * d, dtype)

    def library():
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, attn_mask=mask)

    times = {"device": [], "host": [], "sdpa": []}
    fns = {"device": device_form, "host": host_form, "sdpa": library}
    for name in ("device", "host", "sdpa", "sdpa", "host", "device"):
        times[name].append((time_ms(fns[name]), device_ms(fns[name], 20, cold=True)))
    row = {name: tuple(statistics.mean(x[i] for x in t) for i in (0, 1))
           for name, t in times.items()}
    plain_ms = time_ms(plain, 10)
    log(f"  flash_attention[{label}] B=1 Sq={sq} Sk={sk} q_offset={q_offset} kv_len={kv_len} "
        f"window={window} H={h} Hkv={hkv} D={d} bf16: device offsets bit-equal to host "
        f"offsets (max_abs_err vs plain {err:.3e}); {names[0]}")
    for name, what in (("device", "device-offset form"), ("host", "host-offset form  "),
                       ("sdpa", "SDPA (the mask)   ")):
        log(f"    {what}: event {row[name][0]:.4f} ms, device {row[name][1]:.4f} ms")
    log(f"    plain version (the same device pair) {plain_ms:.4f} ms; bound {b_ms:.4f} ms "
        f"({b_by}); device-offset device time at {100 * b_ms / row['device'][1]:.0f} % of it")
    return {"shape": label, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "plain_ms": plain_ms, **row}


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
    profile's kernel records, at times for several seconds in a row) is
    taken again after a pause, up to eight times, each empty one logged."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(8):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        got = sorted((e.key.replace("(anonymous namespace)::", "").replace("void ", "")
                      .split("(")[0][:60], e.count) for e in prof.key_averages()
                     if str(getattr(e, "device_type", "")).endswith("CUDA"))
        if got:
            return got
        log(f"    (profile {attempt + 1} held no kernel record; taken again)")
        time.sleep(0.5 * (attempt + 1))
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


# the write positions of phase 2's paged_write cases: lane 0 idle, lane 3's
# page a -1 slot (both write nothing)
WRITE_POS = (0, 1, 17, 100, 1023, 513, 64, 999)
# (label, layers, pools): one full-width qwen2.5-3b layer's k and v (the paged
# path: one launch per layer and step) and all 36 layers' (the gather path:
# one launch per step)
WRITE_CASES = [("qwen2.5-3b layer's k + v", 1, 2), ("qwen2.5-3b k + v leaves, 36 layers", 36, 2)]


def paged_write_case(dtype, timed: bool, label: str, layers: int, n_pools: int,
                     slots: int = 1024 // PS):
    """``paged_write`` of ``n_pools`` pools of (``layers``, 8 x ``slots``
    pages, 16, 2 x 128) for 8 lanes at ``WRITE_POS``: bit-equal to the plain
    version (idle and -1 lanes write nothing), one launch.  Timed, the
    kernels-line entry: event times of the kernel and the plain version, the
    bound by the bytes this call's writing lanes move (each written row read
    and written once, each lane's position, flag and table entry read
    once)."""
    from repro_torch.kernels import ops, ref

    lanes = len(WRITE_POS)
    n_pages = lanes * slots
    gen = torch.Generator(device="cuda").manual_seed(13)
    pools = [torch.randn(layers, n_pages, PS, HKV, D, generator=gen, device="cuda").to(dtype)
             for _ in range(n_pools)]
    rows = [torch.randn(layers, lanes, HKV, D, generator=gen, device="cuda").to(dtype)
            for _ in range(n_pools)]
    bt = torch.randperm(n_pages, generator=gen, device="cuda").reshape(lanes, slots).int()
    pos = torch.tensor(WRITE_POS, dtype=torch.long, device="cuda")
    active = torch.tensor([p > 0 for p in WRITE_POS], device="cuda")
    bt[3, WRITE_POS[3] // PS] = -1
    want = [p.clone() for p in pools]
    ref.paged_write(want, rows, bt, pos, active)
    before = ops.LAUNCHES["paged_write"]
    ops.paged_write(pools, rows, bt, pos, active)
    torch.cuda.synchronize()
    launched = ops.LAUNCHES["paged_write"] - before
    same = all(torch.equal(p, w) for p, w in zip(pools, want))
    log(f"  paged_write {dtype} ({label}: {lanes} lanes, {n_pools} pools in {launched} "
        f"launch): bit-equal to the plain version: {same}")
    if not same or launched != 1:
        raise SystemExit(f"chip_smoke: paged_write {dtype} {label} differs from its plain "
                         f"version or took {launched} launches")
    if not timed:
        return None
    writing = lanes - 2
    nbytes = 2 * writing * layers * n_pools * HKV * D * pools[0].element_size() + lanes * 13
    b_ms, b_by = bound(nbytes, 0.0, dtype)
    log(f"  timing {label} {dtype} ({nbytes} bytes moved, bound {b_ms:.3g} ms):")
    got = in_turns(lambda: ops.paged_write(pools, rows, bt, pos, active), None, "", 200)
    source, replaces, _ = KERNELS["paged_write"]
    return {"name": "paged_write", "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": 0.0, "ms": got["event"][0], "device_ms": got["device"][0],
            "host_ms": got["host"][0], "library_device_ms": None, "library_host_ms": None,
            "plain_ms": time_ms(lambda: ref.paged_write(want, rows, bt, pos, active)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": f"{label}, {lanes} lanes ({writing} writing), {n_pools} pools of "
                     f"{layers} x {n_pages} x {PS} x {HKV} x {D} {dtype}"}


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
    does, and leaves that write's own kernel out.  The tracer now and then
    drops kernel records: a profile that holds no device time, or a count
    of kernels that is no multiple of ``iters`` (records of some calls
    lost, which would read as a faster call), is taken again, up to three
    times; the third such profile's time is kept and logged as short."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                if cold:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        kept = [e for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and not (cold and any(w in e.key.lower() for w in ("fill", "memset")))]
        total = sum(e.self_device_time_total for e in kept)
        launches = sum(e.count for e in kept)
        if total > 0 and launches % iters == 0:
            return total / iters / 1e3
        if total > 0 and attempt == 2:
            log(f"    (profiles held {launches} kernel records for {iters} calls three times; "
                "this device time counts only those)")
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


def serve(model, params, ecfg, prompts, max_new, device, generator=None, temperature=0.0):
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(model, params, ecfg, device=device)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new, temperature=temperature)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    done = eng.run(generator)
    if device == "cuda":
        torch.cuda.synchronize()
    return reqs, done, eng


def kernel_group(name: str) -> str:
    """The device group of a kernel, by its name."""
    name = name.lower()
    if "paged_decode_mma" in name or "paged_decode_fma" in name:
        return "paged_decode_attention"
    if "flash_attn" in name or "flash_split" in name:
        return "flash_attention"
    if "ssd_scan_m" in name or "ssd_scan_f" in name or "ssd_chunk_scan" in name:
        return "ssd_scan"
    if "paged_gather" in name:
        return "paged_gather"
    if "paged_write" in name:
        return "paged_write"
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


def log_groups(what: str, wall_ms: float, groups, launches, top) -> float | None:
    """Logs the profiled split; returns the device-busy share of ``wall_ms``
    in percent (None: the profile recorded no device time)."""
    busy = sum(groups.values())
    if busy == 0:
        log("  profiler: no device time recorded (breakdown not measured)")
        return None
    log(f"  profiler: device busy {busy:.3f} ms per {what} = {100 * busy / wall_ms:.1f} % of "
        f"the unprofiled {what}, idle {100 * (1 - busy / wall_ms):.1f} %")
    log(f"    {sum(launches.values()):g} kernel launches per {what}")
    for g in sorted(groups, key=groups.get, reverse=True):
        log(f"    {g}: {groups[g]:.3f} ms per {what} over {launches[g]:g} launches")
    for ms, n, name in top:
        log(f"      {ms:.3f} ms, {n:g} launches: {name}")
    return 100 * busy / wall_ms


def decode_breakdown(model, params, vocab, steps: int = 10, prefill_chunk: int = 0,
                     decode_path: str = "paged", profile: bool = True, prompt: int = 512,
                     max_len: int = 1024, ranges=(), cuda_graph: bool = True,
                     eager=None) -> float:
    """Decode-step time of 8 running lanes at ~``prompt + 8``-token contexts
    (sync admission, so nothing else runs), and device time per kernel
    class from a torch.profiler window over as many more steps; the step is
    a graph replay unless ``cuda_graph`` is False.  ``eager`` (wall ms,
    busy %) is the eager step before capture, logged beside.  Returns the
    step's wall ms."""
    from repro_torch.serve import (
        AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine)

    eng = ServeEngine(model, params, EngineConfig(
        batch_slots=8, max_len=max_len, cuda_graph=cuda_graph,
        cache=CacheConfig(page_size=PS, decode_path=decode_path),
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
    how = "one graph replay" if cuda_graph else "eager"
    log(f"  decode step ({decode_path} path, {how}), 8 lanes at ~{ctx}-token contexts: "
        f"{step_ms:.3f} ms wall (mean of {steps} synced steps, {8 / step_ms * 1e3:.1f} tok/s)")
    if profile:
        busy = log_groups("step", step_ms, *device_groups(eng.step, steps, ranges))
        if eager is not None:
            shown = "not measured" if busy is None else f"{busy:.1f} %"
            log(f"  captured step {step_ms:.3f} ms, device busy {shown}; the eager step "
                f"before capture {eager[0]:.2f} ms, busy {eager[1]:.1f} % (NVIDIA H100 80GB "
                "HBM3, 700 W)")
    eng.run()
    return step_ms


def serve_full_width(model, params, prompts, ecfg, kernels, smi, max_new: int = 32,
                     on_reset=None):
    """The measured full-width run: every request finishes with ``max_new``
    tokens inside the vocabulary, and each kernel in ``kernels`` launched.
    ``on_reset`` runs where the launch counts are set to 0.  Returns
    (requests, launch counts of this run, the engine)."""
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
    return reqs, launches, eng


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
        runs = [("cuda", params_gpu, ecfg), ("cuda eager", params_gpu,
                                            dataclasses.replace(ecfg, cuda_graph=False)),
                ("cpu", params_cpu, ecfg)]
        if also:
            runs.append((f"cuda {also}", params_gpu, dataclasses.replace(
                ecfg, cache=dataclasses.replace(ecfg.cache, decode_path=also))))
        for name, params, e in runs:
            reqs, done, eng = serve(model, params, e, prompts, 12, name.split()[0])
            if len(done) != len(prompts):
                raise SystemExit(f"chip_smoke: {name} engine finished {len(done)} requests")
            if name.startswith("cuda") and name != "cuda eager":
                decode_runs(eng, f"{arch} {label} {name}")
                if e.admission.prefill_chunk:
                    extend_runs(eng, f"{arch} {label} {name}")
            if name == "cuda eager" and eng.prefill_slots is not None \
                    and any(g is not None for g in eng.prefill_slots.graphs):
                raise SystemExit("chip_smoke: the eager engine captured its extend")
            got[name] = [r.out_tokens for r in reqs]
        same = all(v == got["cpu"] for v in got.values())
        # the moe family's chunks run eagerly on the slots
        chunked = ecfg.admission.prefill_chunk > 0 and cfg.family != "moe"
        moe_chunks = ecfg.admission.prefill_chunk > 0 and cfg.family == "moe"
        log(f"  {label}: {len(prompts)} requests x 12 tokens, card tokens (captured decode "
            f"step{' and extend' if chunked else ''}"
            f"{', the moe extend eager on the slots' if moe_chunks else ''}, and eager) "
            f"{'identical to' if same else 'DIFFER from'} CPU tokens"
            + (f" and to the card's {also}-path tokens (captured)" if also else ""))
        if not same:
            for name, toks in got.items():
                log(f"  {name}: {toks}")
            raise SystemExit("chip_smoke: greedy tokens differ between card and CPU")


def prefill_ms(model, params, vocab, seq: int, chunk: int, ranges=(),
               whole: bool = False, group: str | None = None) -> float:
    """One ``seq``-token prompt prefilled in ``chunk``-token slices (as the
    engine's chunked prefill runs it), or with ``whole`` in one
    ``DecoderLM.prefill``: wall ms and the device split (``group``: that
    kernel group's line once more, with its launches).  Returns (the wall
    ms, the device-busy % or None)."""
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
    busy = log_groups("prefill", ms, groups, launches, top)
    if group is not None:
        log(f"  {group} in the prefill: {groups.get(group, 0.0):.3f} ms of device time over "
            f"{launches.get(group, 0):g} launches")
    return ms, busy


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


def decode_runs(eng, label: str) -> int:
    """The runs of ``eng``'s decode step on the card: its warm-up and one
    graph replay per engine step that decoded (the count every per-step
    launch check multiplies).  Fails unless the step was captured and
    replayed."""
    dg = eng.decode_graph
    if dg.graph is None or dg.runs < 2:
        raise SystemExit(f"chip_smoke: {label}: the decode step was not captured and "
                         f"replayed ({dg.runs} runs)")
    return dg.runs


def extend_runs(eng, label: str) -> tuple[int, int]:
    """(runs of the static-buffer extend: the warm-up and one graph replay per
    full chunk; chunks run eagerly: prompt tails) of ``eng``'s prefill
    slots, the counts a per-chunk launch check multiplies.  Fails unless
    every slot's extend was captured and replayed, or, for the moe family
    (whose extend reads the device back), unless nothing was captured and
    every chunk ran eagerly."""
    sl = eng.prefill_slots
    if sl is None:
        raise SystemExit(f"chip_smoke: {label}: the engine has no prefill slots")
    if eng.model.cfg.family == "moe":
        if sl.static or any(g is not None for g in sl.graphs) or sl.eager_runs < 1:
            raise SystemExit(f"chip_smoke: {label}: the moe extend should run eagerly on the "
                             "slots")
    elif any(g is None for g in sl.graphs) or sl.runs < 2:
        raise SystemExit(f"chip_smoke: {label}: the extend was not captured and replayed "
                         f"({sl.runs} runs)")
    return sl.runs, sl.eager_runs


def chunk_profile(eng, vocab: int, position: int, reps: int = 5):
    """One full prefill chunk through ``eng``'s slots at ``position`` (the
    slot first filled up to it): (median wall ms of ``reps`` synced chunks,
    device-busy %, device ms and launches per kernel group from one profiled
    chunk; the share None and the groups empty where three profiles
    recorded no device kernel).  On a captured engine the chunk is one graph
    replay."""
    sl = eng.prefill_slots
    c = sl.chunk
    toks = np.random.default_rng(8).integers(0, vocab, size=(position + c,)).astype(np.int32)
    slot = sl.take()
    sl.zero(slot)
    try:
        tree = sl.trees[slot]
        for p in range(0, position, c):
            sl(slot, tree, eng.params, toks[p:p + c], p)

        def run():
            return sl(slot, tree, eng.params, toks[position:], position)

        run()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        busy, groups, launches = None, {}, {}
        for _ in range(3):
            groups, launches, _ = device_groups(run, 1)
            if groups:
                busy = 100 * sum(groups.values()) / ms
                break
    finally:
        sl.release(slot)
    return ms, busy, groups, launches


def chunk_vs_eager(model, params, vocab: int, chunk: int, position: int, max_len: int,
                   smi: str, engines=None) -> dict:
    """One ``chunk``-token prefill chunk at ``position``, captured (one graph
    replay) and eager (``cuda_graph=False``: the same static-buffer step),
    in turns (C E E C): wall ms, device-busy share and kernel launches per
    chunk; ``engines`` ({True: captured, False: eager}) or two inline
    engines of 8 lanes built here.  Returns {captured: [(ms, busy, groups,
    launches)] * 2}."""
    from repro_torch.serve import AdmissionConfig, CacheConfig, EngineConfig, ServeEngine

    if engines is None:
        engines = {g: ServeEngine(model, params, EngineConfig(
            batch_slots=8, max_len=max_len, cuda_graph=g, cache=CacheConfig(page_size=PS),
            admission=AdmissionConfig(prefill_chunk=chunk, async_prefill=False)),
            device="cuda") for g in (True, False)}
    got = {True: [], False: []}
    for g in (True, False, False, True):
        got[g].append(chunk_profile(engines[g], vocab, position))
    for g in (True, False):
        (m1, b1, _, k1), (m2, b2, _, k2) = got[g]
        busy = ("not measured" if b1 is None or b2 is None else f"{b1:.1f} % / {b2:.1f} %")
        log(f"  one {chunk}-token prefill chunk at offset {position}, "
            f"{'captured (one replay)' if g else 'eager (cuda_graph=False)'}: {m1:.3f} / "
            f"{m2:.3f} ms wall (in turns), device busy {busy}, "
            f"{sum(k1.values()):g} / {sum(k2.values()):g} kernels ({smi})")
    ratio = sum(x[0] for x in got[True]) / sum(x[0] for x in got[False])
    log(f"  captured chunk / eager chunk (wall): {ratio:.3f}")
    groups, launches = got[True][0][2:]
    log("  the captured chunk's device split: " + ", ".join(
        f"{k} {groups[k]:.3f} ms over {launches[k]:g}"
        for k in sorted(groups, key=groups.get, reverse=True)))
    return got


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
    ecfg = EngineConfig(batch_slots=8, max_len=4096, cache=CacheConfig(page_size=PS),
                        admission=AdmissionConfig(prefill_chunk=RG["chunk"]))
    rng = np.random.default_rng(16)
    lengths = np.concatenate([rng.integers(RG["window"] + 1, 3073, size=8),
                              rng.integers(1024, RG["window"] + 1, size=8)])
    rng.shuffle(lengths)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),)).astype(np.int32)
               for n in lengths]
    log(f"  prompt lengths {sorted(int(n) for n in lengths)}")
    reqs, run, eng = serve_full_width(model, params, prompts, ecfg, ("flash_attention",
                                                                     "paged_gather"), smi,
                                      max_new=64)
    runs = decode_runs(eng, "recurrentgemma-9b")
    slices, tails = extend_runs(eng, "recurrentgemma-9b")
    full = sum(len(p) // RG["chunk"] for p in prompts)
    log(f"  {slices - 1} full prefill slices (graph replays) + 1 warm-up, {tails} tail slices "
        f"(eager), {runs - 1} decode steps (graph replays) + 1 warm-up; flash_attention "
        f"{run['flash_attention']} launches, paged_gather {run['paged_gather']}, paged_write "
        f"{run['paged_write']}, paged_decode_attention {run['paged_decode_attention']}")
    if slices - 1 != full or tails != sum(1 for p in prompts if len(p) % RG["chunk"]):
        raise SystemExit(f"chip_smoke: {slices - 1} replays and {tails} eager slices, expected "
                         f"{full} full slices and a tail per prompt")
    if run["flash_attention"] != n_attn * (slices + tails):
        raise SystemExit(f"chip_smoke: {run['flash_attention']} flash launches, expected "
                         f"{n_attn} per prefill slice (a replay counts its captured launches)")
    if run["paged_gather"] != n_attn * runs or run["paged_write"] != run["paged_gather"]:
        raise SystemExit(f"chip_smoke: {run['paged_gather']} paged_gather and "
                         f"{run['paged_write']} paged_write launches, expected {n_attn} each "
                         "per decode step")
    if run["paged_decode_attention"]:
        raise SystemExit("chip_smoke: the windowed layers launched paged_decode_attention")
    # the engine's first token agrees with a direct chunked prefill
    cache = tree_map(lambda sp: torch.zeros(sp.shape, dtype=sp.dtype, device="cuda"),
                     model.cache_specs(1, len(prompts[0])))
    toks = torch.as_tensor(prompts[0], device="cuda")[None].long()
    for i in range(0, toks.shape[1], RG["chunk"]):
        logits, cache = model.extend_step(params, cache, toks[:, i:i + RG["chunk"]], i,
                                          last_only=True)
    if logits.shape != (1, 1, cfg.padded_vocab) or not torch.isfinite(logits).all():
        raise SystemExit(f"chip_smoke: bad recurrentgemma prefill logits {tuple(logits.shape)}")
    if int(logits[0, -1].argmax()) != reqs[0].out_tokens[0]:
        raise SystemExit("chip_smoke: recurrentgemma engine's first token differs from a "
                         "direct chunked prefill")
    log("  chunked-prefill logits finite; first token matches the engine")
    undo = scan_range()
    try:
        ms, _ = prefill_ms(model, params, cfg.vocab_size, 3 * RG["chunk"], RG["chunk"],
                           ranges=("rglru_scan",))
    finally:
        undo()
    log(f"  = {ms / 3:.3f} ms per {RG['chunk']}-token prefill slice, eager, every slice's "
        f"logits ({smi})")
    chunk_vs_eager(model, params, cfg.vocab_size, RG["chunk"], 2 * RG["chunk"], 4096, smi)
    decode_breakdown(model, params, cfg.vocab_size, prefill_chunk=RG["chunk"], prompt=2560,
                     max_len=4096, eager=EAGER_STEP["recurrentgemma-9b"])
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
    calls = count_calls(model, ("prefill",))
    ecfg = EngineConfig(batch_slots=8, max_len=2048, cache=CacheConfig(page_size=PS),
                        admission=AdmissionConfig(prefill_chunk=0))
    rng = np.random.default_rng(19)
    lengths = rng.integers(256, 1537, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),)).astype(np.int32)
               for n in lengths]
    log(f"  prompt lengths {sorted(int(n) for n in lengths)}")
    mla = cfg.mla is not None
    kernels = ("flash_attention", "paged_gather" if mla else "paged_decode_attention")
    reqs, run, eng = serve_full_width(model, params, prompts, ecfg, kernels, smi,
                                      on_reset=lambda: calls.update(prefill=0))
    runs = decode_runs(eng, arch)
    log(f"  {calls['prefill']} prefills, {runs - 1} decode steps (graph replays) + 1 "
        f"warm-up; flash_attention {run['flash_attention']} launches, paged_gather "
        f"{run['paged_gather']}, paged_write {run['paged_write']}, paged_decode_attention "
        f"{run['paged_decode_attention']}")
    if run["flash_attention"] != cfg.n_layers * calls["prefill"]:
        raise SystemExit(f"chip_smoke: {run['flash_attention']} flash launches, expected "
                         f"{cfg.n_layers} per prefill")
    if run["paged_write"] != cfg.n_layers * runs:
        raise SystemExit("chip_smoke: every layer's decode step should write its rows with "
                         "one paged_write launch")
    if mla and (run["paged_gather"] != cfg.n_layers * runs or run["paged_decode_attention"]):
        raise SystemExit("chip_smoke: MLA's paged decode should launch one paged_gather per "
                         "layer and step and no paged_decode_attention")
    if not mla and run["paged_decode_attention"] != cfg.n_layers * runs:
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
        whole, _ = prefill_ms(model, params, cfg.vocab_size, 1024, 1024,
                              ranges=("moe_dispatch",), whole=True)
        chunked, _ = prefill_ms(model, params, cfg.vocab_size, 2048, 1024,
                                ranges=("moe_dispatch",))
        log(f"  = {whole:.3f} ms per 1,024-token whole prompt (the served path), "
            f"{chunked / 2:.3f} ms per 1,024-token chunked-prefill slice ({smi})")
        decode_breakdown(model, params, cfg.vocab_size, prompt=1024, max_len=2048,
                         eager=EAGER_STEP[arch])
        log("  the same step eager (cuda_graph=False), with the MoE dispatch as a range:")
        decode_breakdown(model, params, cfg.vocab_size, prompt=1024, max_len=2048,
                         ranges=("moe_dispatch",), cuda_graph=False)
    finally:
        undo()
    log(f"  peak device memory over the phase {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")
    return run


# ---------------------------------------------------------------------------
# phases 32 and 33: the vlm (llava-next-mistral-7b) and the audio family
# (whisper-large-v3)
# ---------------------------------------------------------------------------


def logits_close(label: str, got, want) -> float:
    """float32 logits of the card against the CPU's: within 2e-4 x max(1,
    |logits|) and the same argmax; returns the max abs error."""
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    bound_err = 2e-4 * max(1.0, float(want.abs().max()))
    if err > bound_err or not torch.equal(got.argmax(-1), want.argmax(-1)):
        raise SystemExit(f"chip_smoke: {label}: card logits {err:.3e} from the CPU's "
                         f"(bound {bound_err:.3e}) or another argmax")
    return err


def grown_cache(model, cache, batch: int, rows: int, device):
    """``model.cache_specs(batch, rows)`` zeros with ``cache``'s rows copied
    into the first of them: a prefill's cache, room for decode steps."""
    from repro_torch.models.common import tree_map

    full = tree_map(lambda sp: torch.zeros(sp.shape, dtype=sp.dtype, device=device),
                    model.cache_specs(batch, rows))
    tree_map(lambda f, c: f[:, :, :c.shape[2]].copy_(c), full, cache)
    return full


def multimodal_card_vs_cpu(smi) -> None:
    """Reduced llava-next-mistral-7b and whisper-large-v3 in float32, the
    same weights on the card and on the CPU: llava's text requests through
    the engine (paged and gather, whole and chunked prefill), its prefill
    over 16 image + 9 text tokens and 12 greedy ``decode_step``s; whisper's
    ``prefill(frames)`` and 16 greedy ``decode_step``s for 2 lanes.  Every
    logits within 2e-4 x max(1, |logits|) of the CPU's, every token equal."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.api import VISION_DIM
    from repro_torch.models.common import tree_map
    from repro_torch.serve import AdmissionConfig, CacheConfig, EngineConfig

    card_vs_cpu_tokens("llava-next-mistral-7b", [
        (f"text requests, prefill_chunk={chunk}, paged and gather", (5, 40, 17, 33, 9, 26),
         EngineConfig(batch_slots=3, max_len=96, cache=CacheConfig(page_size=PS),
                      admission=AdmissionConfig(prefill_chunk=chunk)), "gather")
        for chunk in (0, 16)], smi)
    rng = np.random.default_rng(32)
    for arch, b, s, new in (("llava-next-mistral-7b", 2, 9, 12), ("whisper-large-v3", 2, 4, 16)):
        cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
        model = build_model(cfg)
        cpu = model.init(torch.Generator().manual_seed(0), "cpu")
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s))).long()
        audio = cfg.family == "audio"
        extra = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder.n_ctx, cfg.d_model) if audio else
            (b, cfg.vision.n_image_tokens, VISION_DIM)).astype(np.float32))
        n = s if audio else cfg.vision.n_image_tokens + s
        got = {}
        for dev, params in (("cuda", tree_map(lambda t: t.to("cuda"), cpu)), ("cpu", cpu)):
            if audio:
                logits, cache = model.prefill(params, toks.to(dev), frames=extra.to(dev))
            else:
                logits, cache = model.prefill(params, toks.to(dev), extra_embeds=extra.to(dev))
            cache = grown_cache(model, cache, b, n + new, dev)
            steps, out = [logits], []
            for i in range(new):
                tok = steps[-1][:, -1].argmax(-1)[:, None]
                out.append(tok[:, 0].tolist())
                pos = n + i if audio else torch.full((b,), n + i, device=dev)
                logits, cache = model.decode_step(params, cache, tok, pos)
                steps.append(logits)
            got[dev] = (steps, out)
        err = max(logits_close(f"{arch} step {i}", c, p)
                  for i, (c, p) in enumerate(zip(got["cuda"][0], got["cpu"][0])))
        if got["cuda"][1] != got["cpu"][1]:
            raise SystemExit(f"chip_smoke: {arch}: card tokens {got['cuda'][1]} differ from "
                             f"the CPU's {got['cpu'][1]}")
        what = "frames, prefill" if audio else f"{cfg.vision.n_image_tokens} patches, prefill"
        log(f"  {arch} ({what} of {s} tokens + {new} greedy decode_steps, {b} lanes): card "
            f"tokens identical to CPU tokens; logits max abs err {err:.3e}")


def serve_llava(smi) -> dict:
    """llava-next-mistral-7b at published widths (32 layers, bf16, seeded
    random weights): (a) phase 4's mix of 16 text requests (128-512 prompt
    tokens, 32 new) through the engine, 8 lanes, max_len 1,024: every request
    finishes, one ``flash_attention`` launch per layer per prefill, one
    ``paged_decode_attention`` and one ``paged_write`` per layer per decode
    step; the decode step's ms and busy share; (b) 4 image requests, each
    2,880 patch embeddings + 64 text tokens through ``VLM.prefill`` (one
    flash launch per layer), then 32 greedy ``decode_step``s of the 4
    together: prefill ms with its device split, time to first token, ms per
    decode step.  Returns the launch counts of (a) and (b)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.api import VISION_DIM
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.serve import CacheConfig, EngineConfig

    cfg = get_arch("llava-next-mistral-7b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_items(params))
    log(f"  {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
        f"of {cfg.hd}, d_ff {cfg.d_ff}, projector {VISION_DIM} -> {cfg.d_model}; "
        f"{n_params / 1e9:.3f} B parameters ({torch.cuda.memory_allocated() / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    log("  (a) 16 text requests through the engine:")
    calls = count_calls(model, ("prefill",))
    ecfg = EngineConfig(batch_slots=8, max_len=1024, cache=CacheConfig(page_size=PS))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),)).astype(np.int32)
               for n in rng.integers(128, 513, size=16)]
    reqs, run, eng = serve_full_width(model, params, prompts, ecfg,
                                      SERVE_KERNELS + ("paged_write",), smi,
                                      on_reset=lambda: calls.update(prefill=0))
    runs = decode_runs(eng, "llava-next-mistral-7b")
    log(f"  {calls['prefill']} prefills, {runs - 1} decode steps (graph replays) + 1 warm-up; "
        f"flash_attention {run['flash_attention']} launches, paged_decode_attention "
        f"{run['paged_decode_attention']}, paged_write {run['paged_write']}")
    if run["flash_attention"] != cfg.n_layers * calls["prefill"]:
        raise SystemExit("chip_smoke: llava's prefill should launch flash once per layer")
    if run["paged_decode_attention"] != cfg.n_layers * runs \
            or run["paged_write"] != run["paged_decode_attention"]:
        raise SystemExit("chip_smoke: llava's decode step should launch paged_decode_attention "
                         "and paged_write once per layer")
    del eng
    decode_breakdown(model, params, cfg.vocab_size)

    k = LLAVA["requests"]
    n, new = LLAVA["image"] + LLAVA["text"], LLAVA["new"]
    log(f"  (b) {k} image requests ({LLAVA['image']} patches + {LLAVA['text']} text tokens) "
        f"through VLM.prefill, then {new} greedy decode_steps of the {k} together:")
    gen = torch.Generator(device="cuda").manual_seed(33)
    patches = torch.randn(k, LLAVA["image"], VISION_DIM, generator=gen,
                          device="cuda").to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (k, LLAVA["text"]), generator=gen, device="cuda")
    model.prefill(params, toks[:1], extra_embeds=patches[:1])        # first launches
    torch.cuda.synchronize()
    ops.reset_launches()
    cache = tree_map(lambda sp: torch.zeros(sp.shape, dtype=sp.dtype, device="cuda"),
                     model.cache_specs(k, n + new))
    first, ttft = [], []
    t_all = time.perf_counter()
    for i in range(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, c = model.prefill(params, toks[i:i + 1], extra_embeds=patches[i:i + 1])
        first.append(int(logits[0, -1].argmax()))                # the host reads the token
        ttft.append((time.perf_counter() - t0) * 1e3)
        if logits.shape != (1, 1, cfg.padded_vocab) or not torch.isfinite(logits).all():
            raise SystemExit(f"chip_smoke: bad llava image prefill logits {tuple(logits.shape)}")
        tree_map(lambda f, x: f[:, i:i + 1, :n].copy_(x), cache, c)
    tok = torch.tensor(first, device="cuda")[:, None]
    out = [first]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(new):
        logits, cache = model.decode_step(params, cache, tok,
                                          torch.full((k,), n + j, device="cuda"))
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok[:, 0].tolist())
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / new * 1e3
    image = dict(ops.LAUNCHES)
    wall = time.perf_counter() - t_all
    log(f"  time to first token per image request (prefill + the token's read) "
        f"{', '.join(f'{t:.2f}' for t in ttft)} ms; decode step of {k} lanes at "
        f"~{n + new // 2}-token contexts {step_ms:.3f} ms; {k * (new + 1)} tokens in "
        f"{wall:.2f} s ({smi})")
    log(f"  launches: flash_attention {image['flash_attention']} ({cfg.n_layers} per prefill), "
        f"paged_decode_attention {image['paged_decode_attention']} (decode_step reads its "
        "dense cache with the plain decode_attention, as the reference's XLA does)")
    if image["flash_attention"] != cfg.n_layers * k:
        raise SystemExit("chip_smoke: an image prefill should launch flash once per layer")
    if not all(0 <= t < cfg.vocab_size for row in out for t in row) \
            or not torch.isfinite(logits).all():
        raise SystemExit("chip_smoke: llava image decode gave a bad token or logits")
    pre = statistics.median(ttft)
    log_groups("image prefill", pre, *device_groups(
        lambda: model.prefill(params, toks[:1], extra_embeds=patches[:1]), 2))
    last = torch.full((k,), n + new - 1, device="cuda")
    log_groups("decode step", step_ms, *device_groups(
        lambda: model.decode_step(params, cache, tok, last), 3))
    for name, c in image.items():
        run[name] = run.get(name, 0) + c
    return run


def serve_whisper(smi) -> dict:
    """whisper-large-v3 at published widths (32 + 32 layers, bf16, seeded
    random weights): 8 requests at once, 1,500 frames and a 4-token prompt
    each, ``EncDecLM.prefill`` (the encoder's 32 flash launches, then the
    decoder's self- and cross-attention, 2 per layer) and 64 greedy
    ``decode_step``s: encoder ms, prefill ms, decode ms per step with its
    busy share, tok/s.  Returns this run's launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items

    cfg = get_arch("whisper-large-v3")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_items(params))
    log(f"  {cfg.encoder.n_layers} + {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, {cfg.encoder.n_ctx} frames; "
        f"{n_params / 1e9:.3f} B parameters ({torch.cuda.memory_allocated() / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    b, p, new = WHISPER["batch"], WHISPER["prompt"], WHISPER["new"]
    gen = torch.Generator(device="cuda").manual_seed(34)
    frames = torch.randn(b, cfg.encoder.n_ctx, cfg.d_model, generator=gen,
                         device="cuda").to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (b, p), generator=gen, device="cuda")
    model.prefill(params, toks, frames=frames)                     # first launches
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, toks, frames=frames)
    cache = grown_cache(model, cache, b, p + new, "cuda")
    tok = logits[:, -1].argmax(-1, keepdim=True)
    out = [tok[:, 0].tolist()]                                     # the host reads the tokens
    t_pre = time.perf_counter() - t0
    t1 = time.perf_counter()
    for j in range(new):
        logits, cache = model.decode_step(params, cache, tok, p + j)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok[:, 0].tolist())
    t_dec = time.perf_counter() - t1
    run = dict(ops.LAUNCHES)
    gen_tokens = b * (new + 1)
    log(f"  {b} requests: prefill (encoder + decoder over the prompt, cache grown for "
        f"decode) {t_pre * 1e3:.2f} ms, {new} decode steps {t_dec / new * 1e3:.3f} ms each; {gen_tokens} tokens in "
        f"{t_pre + t_dec:.2f} s = {gen_tokens / (t_pre + t_dec):.1f} tok/s end to end ({smi})")
    log(f"  launches: flash_attention {run['flash_attention']} (encoder {cfg.encoder.n_layers} "
        f"+ decoder self and cross {2 * cfg.n_layers})")
    if run["flash_attention"] != cfg.encoder.n_layers + 2 * cfg.n_layers:
        raise SystemExit("chip_smoke: whisper's prefill should launch flash once per encoder "
                         "layer and twice per decoder layer")
    if not all(0 <= t < cfg.vocab_size for row in out for t in row) \
            or not torch.isfinite(logits).all():
        raise SystemExit("chip_smoke: whisper decode gave a bad token or logits")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model.encode(params, frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    enc = statistics.median(times)
    log(f"  encoder alone ({b} x {cfg.encoder.n_ctx} frames): {enc:.2f} ms (median of 3)")
    with torch.no_grad():
        log_groups("encoder pass", enc, *device_groups(lambda: model.encode(params, frames), 2))
    last = p + new - 1
    log_groups("decode step", t_dec / new * 1e3, *device_groups(
        lambda: model.decode_step(params, cache, tok, last), 3))
    return run


# ---------------------------------------------------------------------------
# phases 24-26: the memory tiers (host tier, swap preemption, prefix sharing)
# ---------------------------------------------------------------------------


# the forced-preemption cell of tests/test_tiered_cache.py: 3 lanes on a
# 7-page pool of 4-token pages; 3 requests of 7 tokens, 12 new each
PRESSURE = dict(batch_slots=3, max_len=32, page_size=4, n_pages=7)
TIER_FAMILIES = ("qwen2.5-3b", "mamba2-130m", "recurrentgemma-9b", "deepseek-v3-671b")
# phase 25's device pool: 112 pages of 16 tokens (66.1 MB at full-width
# qwen2.5-3b) for 16 requests of 128-512 tokens + 64 new on 8 lanes; under
# inline admission the scheduling depends on lengths alone, and this pool
# makes at least 4 swap preemptions fire
PRESSURE_PAGES = 112


def index_host_pages(prefix) -> int:
    """Host pages the prefix index holds (nodes and terminals with a retired
    copy), by a walk of its trie."""
    held, stack = 0, [prefix.root]
    while stack:
        node = stack.pop()
        held += sum(t.host_page is not None for t in node.terminals.values())
        for child in node.children.values():
            held += child.host_page is not None
            stack.append(child)
    return held


def pages_back(eng, label: str) -> None:
    """Every device and host page not held by the prefix index is back in
    its free list, and the pool partition is sane."""
    cache = eng.cache
    held = len(cache.prefix.by_page) if cache.prefix is not None else 0
    host_held = index_host_pages(cache.prefix) if cache.prefix is not None else 0
    cache.check_invariant()
    ok = cache.allocator.n_free == cache.n_pages - held
    if cache.host is not None:
        ok = ok and cache.host.allocator.n_free == cache.host.n_pages - host_held
    if not ok:
        raise SystemExit(f"chip_smoke: {label}: pages did not come back (device "
                         f"{cache.allocator.n_free}/{cache.n_pages} free, {held} indexed)")


def serve_staged(model, params, ecfg, prompts, max_new):
    """``serve`` on the card under async admission, the decode loop started
    only once the admission thread has every request ready: all lanes then
    decode together from the first step, so a pool too small for them runs
    dry for sure however fast a step is."""
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(model, params, ecfg, device="cuda")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    deadline = time.monotonic() + 60
    while True:
        with eng._lock:
            ready = len(eng.sched.ready)
        if ready == len(reqs):
            break
        if eng.pipeline.error is not None or time.monotonic() > deadline:
            raise SystemExit(f"chip_smoke: the admission thread readied {ready} of "
                             f"{len(reqs)} requests") from eng.pipeline.error
        time.sleep(1e-3)
    done = eng.run()
    torch.cuda.synchronize()
    return reqs, done, eng


def tiers_card_vs_cpu(smi) -> dict[str, int]:
    """Phase 24: the reduced families in float32, card against CPU, on the
    forced-preemption cell (swap at swap_token_cost 0, inline and under async
    admission, recompute, the gather path) and on the prefix rounds of tests/test_prefix_cache.py with every
    index page retired to the host tier between rounds.  Returns the card
    runs' kernel launches."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serve import AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine

    launches = dict.fromkeys(KERNELS, 0)
    for arch in TIER_FAMILIES:
        cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
        model = build_model(cfg)
        params = {"cpu": model.init(torch.Generator().manual_seed(0), "cpu")}
        params["cuda"] = tree_map(lambda t: t.to("cuda"), params["cpu"])
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, cfg.vocab_size, size=(7,)).astype(np.int32)
                   for _ in range(3)]
        top = dict(batch_slots=PRESSURE["batch_slots"], max_len=PRESSURE["max_len"])
        pool = dict(page_size=PRESSURE["page_size"], n_pages=PRESSURE["n_pages"])
        cases = [("card swap", "cuda", dict(swap_token_cost=0.0)),
                 ("card swap, eager step", "cuda", dict(swap_token_cost=0.0)),
                 ("card swap, async", "cuda", dict(swap_token_cost=0.0)),
                 ("card swap, async, eager step", "cuda", dict(swap_token_cost=0.0)),
                 ("cpu swap", "cpu", dict(swap_token_cost=0.0)),
                 ("card recompute", "cuda", dict(preempt_policy="recompute")),
                 ("card swap, gather path", "cuda", dict(swap_token_cost=0.0,
                                                         decode_path="gather"))]
        got, tel = {}, {}
        for label, dev, knobs in cases:
            ops.reset_launches()
            eager = label.endswith("eager step")
            ecfg = EngineConfig(**top, cuda_graph=not eager, cache=CacheConfig(**pool, **knobs),
                                admission=AdmissionConfig(async_prefill=False))
            if "async" in label:
                # the admission thread stages the swapped-out lane back onto
                # the card while the decode loop steps (replays) the others
                reqs, done, eng = serve_staged(model, params[dev], dataclasses.replace(
                    ecfg, admission=AdmissionConfig(admission_inflight=len(prompts))),
                    prompts, 12)
            else:
                # inline admission: how often the pool runs dry must not hang
                # on how fast a decode step is against the admission thread
                reqs, done, eng = serve(model, params[dev], ecfg, prompts, 12, dev)
            if dev == "cuda" and not eager:
                decode_runs(eng, f"{arch} {label}")
            for k in launches:
                launches[k] += ops.LAUNCHES[k]
            if len(done) != len(prompts):
                raise SystemExit(f"chip_smoke: {arch} {label}: {len(done)} requests finished")
            got[label], tel[label] = [r.out_tokens for r in reqs], eng.telemetry()
            pages_back(eng, f"{arch} {label}")
        sw, host = tel["card swap"], tel["card swap"]["host_tier"]
        same = all(v == got["cpu swap"] for v in got.values())
        swap_ins = {k: tel[k]["host_tier"]["swap_ins"] for k in tel if "async" in k}
        log(f"  {arch}, 3 lanes on 7 pages of 4: card swap {sw['swap_preemptions']} swap "
            f"preemptions ({host['swap_ins']} swap-ins, {host['pages_out']} pages out, "
            f"{host['bytes_out']} B), recompute {tel['card recompute']['recompute_preemptions']}; "
            f"async admission (swap-ins staged by its thread): captured "
            f"{swap_ins['card swap, async']}, eager {swap_ins['card swap, async, eager step']} "
            f"swap-ins; tokens of card swap (inline and async, captured step and eager), "
            f"recompute and gather {'identical to' if same else 'DIFFER from'} the CPU's")
        if not same:
            for label, toks in got.items():
                log(f"    {label}: {toks}")
            raise SystemExit("chip_smoke: swap, recompute and gather tokens differ")
        if (sw["swap_preemptions"] <= 0 or sw["recompute_preemptions"] != 0
                or host["swap_ins"] <= 0 or min(swap_ins.values()) <= 0
                or tel["card recompute"]["recompute_preemptions"] <= 0):
            raise SystemExit(f"chip_smoke: {arch}: the pressure cell did not swap and recompute")
        # the prefix rounds: [a, b] twice, every index page retired to the
        # host tier before the replay
        rng = np.random.default_rng(5)
        a, b = [rng.integers(0, cfg.vocab_size, size=(10 + i,)).astype(np.int32)
                for i in range(2)]
        got, tel = {}, {}
        for label, dev, on in (("card prefix on", "cuda", True), ("card prefix off", "cuda", False),
                               ("cpu prefix on", "cpu", True)):
            eng = ServeEngine(model, params[dev], EngineConfig(
                batch_slots=2, max_len=64, cache=CacheConfig(
                    page_size=4, n_pages=24, host_pages=32, prefix_sharing=on)), device=dev)
            ops.reset_launches()
            out, uid = {}, 0
            for rnd in range(2):
                if rnd and on:
                    with eng._lock:
                        eng.cache.prefix_retire(eng.cache.n_pages)
                for p in (a, b):
                    eng.submit(Request(uid=uid, prompt=p, max_new_tokens=5))
                    uid += 1
                out.update({r.uid: r.out_tokens for r in eng.run()})
            if dev == "cuda":
                torch.cuda.synchronize()
                for k in launches:
                    launches[k] += ops.LAUNCHES[k]
            got[label], tel[label] = out, eng.telemetry()
            pages_back(eng, f"{arch} {label}")
        pr = tel["card prefix on"]["prefix"]
        same = all(v == got["cpu prefix on"] for v in got.values())
        log(f"  {arch}, prefix rounds with a host retire between: hits {pr['hits']}, retired "
            f"{pr['retired_pages']}, restored {pr['restored_pages']} pages; card on/off tokens "
            f"{'identical to' if same else 'DIFFER from'} the CPU's")
        if not same:
            raise SystemExit(f"chip_smoke: {arch}: prefix on/off tokens differ: {got}")
        has_seq = arch != "mamba2-130m"         # the ssm shares state snapshots, no pages
        if pr["hits"] < 2 or (has_seq and (pr["retired_pages"] <= 0
                                           or pr["restored_pages"] <= 0)):
            raise SystemExit(f"chip_smoke: {arch}: the prefix rounds did not hit, retire and "
                             "restore")
    log(f"  ({smi})")
    return launches


def link_ms(nbytes: int, to_host: bool) -> float:
    """Median ms of one pinned host<->device copy of ``nbytes`` (the rate the
    host link reaches on this machine for that size)."""
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    src, dst = (dev, host) if to_host else (host, dev)
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def probe_swaps(eng, ops) -> tuple[list, list]:
    """Time every swap-out batch and swap-in staging of ``eng`` (each between
    two synchronisations): ``(pages, bytes, ms, paged_gather launches)`` per
    swap-out, ``(pages, bytes, ms)`` per swap-in."""
    cache = eng.cache
    outs, ins = [], []
    swap_out_batch, stage_in = cache.swap_out_batch, cache.stage_in

    def timed_out(items):
        torch.cuda.synchronize()
        b0, g0 = cache.host.stats["bytes_out"], ops.LAUNCHES["paged_gather"]
        t0 = time.perf_counter()
        swap_out_batch(items)
        torch.cuda.synchronize()
        outs.append((sum(len(d) for _, d in items), cache.host.stats["bytes_out"] - b0,
                     (time.perf_counter() - t0) * 1e3, ops.LAUNCHES["paged_gather"] - g0))

    def timed_in(handle):
        torch.cuda.synchronize()
        b0 = cache.host.stats["bytes_in"]
        t0 = time.perf_counter()
        got = stage_in(handle)
        torch.cuda.synchronize()
        ins.append((len(handle.host_pages), cache.host.stats["bytes_in"] - b0,
                    (time.perf_counter() - t0) * 1e3))
        return got

    cache.swap_out_batch, cache.stage_in = timed_out, timed_in
    return outs, ins


def serve_under_pressure(model, params, prompts, smi):
    """Phase 25: full-width qwen2.5-3b, 8 lanes, max_len 1,024, 16-token
    pages, 16 requests of 128-512 tokens + 64 new, inline admission, three
    ways: unpressured, on ``PRESSURE_PAGES`` pages with swap preemption
    (default cost model, host tier 2x), and with recompute.  Returns the
    three runs' launches, and the
    swap run's tokens and wall seconds (phase 27 sanitizes that run)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine

    cfg = model.cfg
    max_new = 64
    runs = {"unpressured": {}, "swap": dict(n_pages=PRESSURE_PAGES),
            "recompute": dict(n_pages=PRESSURE_PAGES, preempt_policy="recompute")}
    launches = dict.fromkeys(KERNELS, 0)
    got, tel, probes = {}, {}, {}
    for label, cache in runs.items():
        eng = ServeEngine(model, params, EngineConfig(
            batch_slots=8, max_len=1024, cache=CacheConfig(page_size=PS, **cache),
            admission=AdmissionConfig(async_prefill=False)), device="cuda")
        if label == "swap":
            probes = probe_swaps(eng, ops)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
        ops.reset_launches()
        runs0 = eng.decode_graph.runs               # the warm-up, before the reset
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = dict(ops.LAUNCHES)
        for k in launches:
            launches[k] += run[k]
        t = tel[label] = eng.telemetry()
        got[label] = [r.out_tokens for r in reqs]
        n_tok = sum(len(r.out_tokens) for r in reqs)
        log(f"  {label}: {eng.cache.n_pages} pages; {len(done)}/{len(reqs)} requests, "
            f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tok/s; {t['steps']} steps, "
            f"prefill tokens {t['prefill_tokens']}; preemptions swap {t['swap_preemptions']}, "
            f"recompute {t['recompute_preemptions']}; decode idle fraction "
            f"{t['decode_idle_fraction']:.3f} ({smi})")
        if len(done) != len(reqs) or not all(len(r.out_tokens) == max_new for r in reqs):
            raise SystemExit(f"chip_smoke: {label}: not every request finished")
        if run["paged_decode_attention"] != cfg.n_layers * (decode_runs(eng, label) - runs0) \
                or run["paged_write"] != run["paged_decode_attention"]:
            raise SystemExit(f"chip_smoke: {label}: paged_decode_attention and paged_write "
                             "should launch once per layer per decode step")
        if label == "swap":
            swap_run, swap_wall = run, wall
        pages_back(eng, label)
    prompt_tokens = sum(len(p) for p in prompts)
    sw = tel["swap"]
    host = sw["host_tier"]
    outs, ins = probes
    log(f"  swap run: {sw['swap_preemptions']} swap preemptions in {len(outs)} swap-out "
        f"batches, {host['pages_out']} pages ({host['bytes_out'] / 1e6:.1f} MB) out, "
        f"{host['swap_ins']} swap-ins, {host['pages_in']} pages ({host['bytes_in'] / 1e6:.1f} "
        f"MB) in; paged_gather {swap_run['paged_gather']} launches")
    for kind, rows, to_host in (("swap-out", outs, True), ("swap-in", ins, False)):
        for i, row in enumerate(rows):
            pages, nbytes, ms = row[:3]
            ref_ms = link_ms(nbytes, to_host) if nbytes else float("nan")
            log(f"    {kind} {i}: {pages} pages, {nbytes / 1e6:.2f} MB in {ms:.3f} ms = "
                f"{nbytes / ms / 1e6:.2f} GB/s; a pinned {'device->host' if to_host else 'host->device'}"
                f" copy of the same size {ref_ms:.3f} ms = {nbytes / ref_ms / 1e6:.2f} GB/s"
                + (f"; paged_gather launches {row[3]}" if kind == "swap-out" else ""))
    log(f"  (the first swap-out also pins the host tier's buffers: "
        f"{2 * PRESSURE_PAGES} pages)")
    if sw["swap_preemptions"] < 4:
        raise SystemExit(f"chip_smoke: only {sw['swap_preemptions']} swap preemptions fired "
                         f"on {PRESSURE_PAGES} pages (at least 4 wanted)")
    if sw["prefill_tokens"] != prompt_tokens:
        raise SystemExit(f"chip_smoke: the swap run prefilled {sw['prefill_tokens']} tokens, "
                         f"not the prompts' {prompt_tokens}")
    if swap_run["paged_gather"] != sum(1 for row in outs if row[0]) or any(
            row[3] != (1 if row[0] else 0) for row in outs):
        raise SystemExit("chip_smoke: paged_gather should launch once per swap-out batch")
    for i, (a, b) in enumerate(zip(got["swap"], got["unpressured"])):
        if a != b:
            step = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            raise SystemExit(f"chip_smoke: FAULT: swap request {i} diverges from the "
                             f"unpressured run at token {step}")
    rec = tel["recompute"]
    same = sum(a == b for a, b in zip(got["recompute"], got["unpressured"]))
    log(f"  swap tokens identical to the unpressured run's for all {len(prompts)} requests; "
        f"recompute re-prefilled {rec['prefill_tokens'] - prompt_tokens} extra tokens in "
        f"{rec['recompute_preemptions']} preemptions, {same}/{len(prompts)} requests gave the "
        "unpressured tokens (bf16: a re-prefill rounds otherwise than decode)")
    # the decode step's device-busy share under pressure: a fourth swap run,
    # profiled over 5 steps once a lane has been swapped out and back
    eng = ServeEngine(model, params, EngineConfig(
        batch_slots=8, max_len=1024, cache=CacheConfig(page_size=PS, n_pages=PRESSURE_PAGES),
        admission=AdmissionConfig(async_prefill=False)), device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=max_new))
    while eng.load and eng.cache.host.stats["swap_ins"] < 1:
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"  decode step after a swap-in, {len(eng.sched.running)} lanes running: "
        f"{step_ms:.3f} ms wall (mean of 5)")
    log_groups("step", step_ms, *device_groups(eng.step, 5))
    eng.pipeline.shutdown()
    return launches, got["swap"], swap_wall


def serve_shared_prefix(model, params, smi) -> tuple[dict[str, int], list, list]:
    """Phase 26: full-width qwen2.5-3b, an unpressured pool, 256-token
    prefill chunks, async admission; 16 requests of one 512-token system
    prompt + 64-256 own tokens, 32 new each, with ``prefix_sharing`` off
    and on; then every index page retired to the host tier and 4 of the
    requests replayed.  Returns the runs' launches, the prompts and the
    single engine's tokens (phase 29 routes them)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine

    cfg = model.cfg
    rng = np.random.default_rng(26)
    system = rng.integers(0, cfg.vocab_size, size=(512,))
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, size=(int(n),))])
               .astype(np.int32) for n in rng.integers(64, 257, size=16)]
    launches = dict.fromkeys(KERNELS, 0)

    def drive(eng, batch):
        """Submit ``batch`` at once and step to the end: (tokens, mean time to
        first token at step granularity, tok/s)."""
        reqs = [Request(uid=i, prompt=p, max_new_tokens=32) for i, p in enumerate(batch)]
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        first = {}
        while eng.load:
            eng.step()
            now = time.perf_counter()
            for r in reqs:
                if r.out_tokens and r.uid not in first:
                    first[r.uid] = now - t0
        eng.pipeline.shutdown()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k in launches:
            launches[k] += ops.LAUNCHES[k]
        if not all(r.done and len(r.out_tokens) == 32 for r in reqs):
            raise SystemExit("chip_smoke: a shared-prefix request did not finish")
        n_tok = sum(len(r.out_tokens) for r in reqs)
        return ([r.out_tokens for r in reqs], statistics.mean(first.values()) * 1e3,
                n_tok / wall)

    got, tel = {}, {}
    for on in (False, True):
        eng = ServeEngine(model, params, EngineConfig(
            batch_slots=8, max_len=1024, cache=CacheConfig(page_size=PS, prefix_sharing=on),
            admission=AdmissionConfig(prefill_chunk=256)), device="cuda")
        toks, ttft, tps = drive(eng, prompts)
        got[on], tel[on] = toks, eng.telemetry()
        log(f"  prefix sharing {'on ' if on else 'off'}: {tps:.1f} tok/s, mean time to first "
            f"token {ttft:.1f} ms (read after each step), prefill tokens "
            f"{tel[on]['prefill_tokens']} ({smi})")
    pr = tel[True]["prefix"]
    saved = tel[False]["prefill_tokens"] - tel[True]["prefill_tokens"]
    log(f"  prefix on: hits {pr['hits']}, misses {pr['misses']}, hit tokens {pr['hit_tokens']} "
        f"(hit rate {pr['hit_rate']:.3f}), {saved} fewer prefill tokens, forks {pr['forks']}")
    if got[True] != got[False]:
        bad = [i for i, (a, b) in enumerate(zip(got[True], got[False])) if a != b]
        raise SystemExit(f"chip_smoke: prefix on/off tokens differ for requests {bad}")
    # the system prompt's 32 pages are full and no lane writes them; each
    # finished prefill shares its partly filled tail page with its index
    # terminal, so its lane forks that page at its first decode write
    tails = sum(1 for p in prompts if len(p) % PS)
    if pr["hits"] < 1 or saved != pr["hit_tokens"] or pr["forks"] != tails:
        raise SystemExit(f"chip_smoke: the shared prefix did not hit as it should ({tails} "
                         "tail pages to fork)")
    ops.reset_launches()
    t0 = time.perf_counter()
    with eng._lock:
        retired = eng.cache.prefix_retire(eng.cache.n_pages)
    ms = (time.perf_counter() - t0) * 1e3
    put = ops.LAUNCHES["paged_gather"]
    launches["paged_gather"] += put
    host = eng.telemetry()["host_tier"]
    log(f"  retired {retired} index pages to the host tier in {ms:.3f} ms "
        f"({host['bytes_out'] / 1e6:.1f} MB, paged_gather {put} launches; the first copy-out "
        "also pins the host tier's buffers)")
    replay, ttft, tps = drive(eng, prompts[:4])
    pr2 = eng.telemetry()["prefix"]
    log(f"  4 replays (full matches): restored {pr2['restored_pages']} pages, forks "
        f"{pr2['forks'] - pr['forks']} (their shared tail pages), mean time to first token "
        f"{ttft:.1f} ms, {tps:.1f} tok/s")
    if put < 1:
        raise SystemExit("chip_smoke: the retire read no page through paged_gather")
    if replay != got[True][:4] or pr2["restored_pages"] <= 0:
        raise SystemExit("chip_smoke: the host-restored replay differs or restored nothing")
    pages_back(eng, "prefix on, after the replay")
    return launches, prompts, got[True]


# ---------------------------------------------------------------------------
# phase 27: observability and request semantics
# ---------------------------------------------------------------------------


def served_tokens(model, params, prompts, max_new, generator=None, temperature=0.0, **knobs):
    """Serve ``prompts`` on a fresh full-width engine (8 lanes, max_len
    1,024, 16-token pages; ``knobs``: ``eos_id``, ``obs``, ``cache`` and
    ``admission``); (tokens, wall s, engine)."""
    from repro_torch.serve import CacheConfig, EngineConfig

    knobs.setdefault("cache", CacheConfig(page_size=PS))
    ecfg = EngineConfig(batch_slots=8, max_len=1024, **knobs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs, _, eng = serve(model, params, ecfg, prompts, max_new, "cuda", generator, temperature)
    wall = time.perf_counter() - t0
    if not all(r.done for r in reqs):
        raise SystemExit("chip_smoke: a request did not finish")
    return [r.out_tokens for r in reqs], wall, eng


def ranged_kernels(prof, range_name: str, kernel: str) -> tuple[int, int]:
    """(host ranges called ``range_name``, ``kernel`` launches whose device
    start lies inside a range's device-side span) of one profile.  By time,
    not by the profiler's op links: a kernel launched through ctypes has no
    torch op to link to."""
    host = [e for e in prof.events() if e.name == range_name
            and not str(getattr(e, "device_type", "")).endswith("CUDA")]
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name == range_name and str(getattr(e, "device_type", "")).endswith("CUDA")]
    inside = sum(1 for e in prof.events()
                 if kernel in e.name and str(getattr(e, "device_type", "")).endswith("CUDA")
                 and any(a <= e.time_range.start <= b for a, b in spans))
    return len(host), inside


def obs_and_semantics(model, params, prompts, greedy, swap_tokens, swap_wall,
                      smi) -> dict[str, int]:
    """Phase 27 on phase 4's model, requests (32 new tokens) and tokens
    (``greedy``): the tracer's cost, traced against untraced in turns; the
    sanitizer over phase 25's swap run (``swap_tokens`` in ``swap_wall``
    s); the ``decode.batch`` profiler ranges; sampling without and with a
    seeded generator, ``eos_id`` and ``admission_inflight``.  Returns the
    phase's launches."""
    from repro_torch.analysis import sanitizer
    from repro_torch.kernels import ops
    from repro_torch.obs.export import validate_lifecycles
    from repro_torch.serve import (
        AdmissionConfig, CacheConfig, EngineConfig, ObsConfig, Request, ServeEngine)

    t_phase = time.perf_counter()
    layers = model.cfg.n_layers
    ops.reset_launches()
    # 1. the tracer's cost: a traced and an untraced engine, warmed, then 3
    # runs each in turns (T U, U T, T U); per-mode medians, as the JAX
    # package's bench_obs_overhead takes them
    engines = {}
    for traced in (True, False):
        eng = ServeEngine(model, params, EngineConfig(
            batch_slots=8, max_len=1024, cache=CacheConfig(page_size=PS),
            obs=ObsConfig(trace=traced)), device="cuda")
        eng.submit(Request(uid=-1, prompt=prompts[0], max_new_tokens=2))
        eng.run()
        engines[traced] = eng
    tps = {True: [], False: []}
    toks = {}
    for rep, order in enumerate(((True, False), (False, True), (True, False))):
        for traced in order:
            eng = engines[traced]
            reqs = [Request(uid=100 * rep + i, prompt=p, max_new_tokens=32)
                    for i, p in enumerate(prompts)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tps[traced].append(sum(len(r.out_tokens) for r in reqs) / wall)
            got = [r.out_tokens for r in reqs]
            if got != greedy:
                raise SystemExit(f"chip_smoke: {'traced' if traced else 'untraced'} run {rep} "
                                 "gave other tokens than phase 4")
            toks[traced, rep] = got
    tracer = engines[True].tracer
    path = ROOT / "build" / "phase27_trace.json"
    path.parent.mkdir(exist_ok=True)
    hist = validate_lifecycles(engines[True].save_trace(str(path)), require_done=True)
    ratio = statistics.median(tps[True]) / statistics.median(tps[False])
    log(f"  tracer: traced {', '.join(f'{x:.1f}' for x in tps[True])} tok/s, untraced "
        f"{', '.join(f'{x:.1f}' for x in tps[False])} tok/s (in turns); traced / untraced "
        f"(medians) {ratio:.4f} against the JAX package's gate of 0.95 (bench_gate.py; "
        f"not a gate here) ({smi})")
    log(f"  tracer: {tracer.total} events recorded, dropped {tracer.dropped}, "
        f"{len(hist)} request lifecycles valid (the warm-up's and 3 x {len(prompts)}); "
        f"tokens identical traced, untraced and phase 4's")
    if tracer.dropped:
        raise SystemExit("chip_smoke: the tracer's ring wrapped")
    # 2. the sanitizer over phase 25's swap run (inline admission, 112 pages)
    sanitizer.enable()
    try:
        got, wall, eng = served_tokens(
            model, params, prompts, 64, cache=CacheConfig(page_size=PS, n_pages=PRESSURE_PAGES),
            admission=AdmissionConfig(async_prefill=False))
    finally:
        sanitizer.disable()
    tel = eng.telemetry()
    log(f"  sanitizer over phase 25's swap run: {wall:.2f} s against {swap_wall:.2f} s "
        f"unsanitized (phase 25), {tel['swap_preemptions']} swap preemptions, "
        f"{tel['host_tier']['swap_ins']} swap-ins, no SanitizerError ({smi})")
    if got != swap_tokens:
        raise SystemExit("chip_smoke: the sanitized swap run's tokens differ from phase 25's")
    if tel["swap_preemptions"] < 1:
        raise SystemExit("chip_smoke: the sanitized run swapped nothing")
    # 3. trace annotations under the profiler: decode.batch ranges around the
    # paged-decode kernels of 3 decode steps of 8 lanes
    eng = ServeEngine(model, params, EngineConfig(
        batch_slots=8, max_len=1024, cache=CacheConfig(page_size=PS),
        admission=AdmissionConfig(async_prefill=False),
        obs=ObsConfig(trace_annotations=True)), device="cuda")
    for i, p in enumerate(prompts[:8]):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=16))
    while len(eng.sched.running) < 8 or eng.sched.ready or eng.sched.admitting:
        eng.step()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):                   # a profile may come back without device records
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                eng.step()
            torch.cuda.synchronize()
        ranges, inside = ranged_kernels(prof, "decode.batch", "paged_decode_")
        if inside:
            break
    eng.run()
    log(f"  profiler: {ranges} decode.batch ranges over 3 decode steps holding {inside} "
        f"paged-decode kernels by device time ({layers} per step)")
    if ranges != 3 or inside != 3 * layers:
        raise SystemExit("chip_smoke: the decode.batch ranges do not hold each step's "
                         "paged-decode kernels")
    # 4. request semantics
    got, wall, _ = served_tokens(model, params, prompts, 32, temperature=0.8,
                                 admission=AdmissionConfig(admission_inflight=1))
    log(f"  temperature 0.8, no generator, admission_inflight 1: "
        f"{sum(a == b for a, b in zip(got, greedy))}/{len(prompts)} requests gave phase 4's "
        f"greedy tokens ({wall:.2f} s)")
    if got != greedy:
        raise SystemExit("chip_smoke: without a generator the engine did not decode greedily")
    got, wall, _ = served_tokens(model, params, prompts, 32,
                                 admission=AdmissionConfig(admission_inflight=3))
    log(f"  admission_inflight 3: {sum(a == b for a, b in zip(got, greedy))}/{len(prompts)} "
        f"requests gave phase 4's tokens ({wall:.2f} s)")
    if got != greedy:
        raise SystemExit("chip_smoke: admission_inflight 3 changed the tokens")
    # a seeded card generator, two runs each (inline admission: the draws'
    # order is fixed): at 0.8, and hot enough (T = 1e4, near uniform) that the
    # draws leave the greedy path of this random-weight model
    for temp in (0.8, 1e4):
        sampled = [served_tokens(model, params, prompts[:8], 16,
                                 torch.Generator(device="cuda").manual_seed(27), temp,
                                 admission=AdmissionConfig(async_prefill=False))[0]
                   for _ in range(2)]
        moved = sum(a != b for r, g in zip(sampled[0], greedy) for a, b in zip(r, g))
        log(f"  a seeded card generator at temperature {temp:g}, 8 requests: two runs "
            f"{'identical' if sampled[0] == sampled[1] else 'DIFFERENT'}; {moved} of {8 * 16} "
            "tokens differ from greedy; prefill tokens greedy: "
            f"{all(r[0] == g[0] for r, g in zip(sampled[0], greedy))}")
        if sampled[0] != sampled[1]:
            raise SystemExit("chip_smoke: one seed gave two token streams")
        if any(r[0] != g[0] for r, g in zip(sampled[0], greedy)):
            raise SystemExit("chip_smoke: a prefill token was sampled (it stays greedy)")
        if not all(0 <= t < model.cfg.padded_vocab for r in sampled[0] for t in r):
            raise SystemExit("chip_smoke: a sampled token lies outside the vocabulary")
    if moved == 0:
        raise SystemExit("chip_smoke: at temperature 1e4 no draw left the greedy path")
    # eos_id at prefill: of phase 4's tokens, the one a request produced first
    # at the latest step (this random model repeats its first token)
    k, i = max((k, i) for i, t in enumerate(greedy[:8]) for k in range(len(t))
               if t[k] not in t[:k])
    eos = greedy[i][k]
    want = [t[:t.index(eos) + 1] if eos in t else t for t in greedy[:8]]
    got, wall, _ = served_tokens(model, params, prompts[:8], 32, eos_id=eos)
    log(f"  eos_id = request {i}'s token at step {k} ({eos}), 8 requests: request {i} stopped "
        f"after {len(got[i])} tokens, {sum(len(t) < 32 for t in got)} stopped early; each "
        f"stops at its first such token of phase 4's: {got == want}")
    if got != want or len(got[i]) != k + 1:
        raise SystemExit("chip_smoke: eos_id did not stop the requests at phase 4's token")
    # eos_id mid-decode: one hot sampled request, then the same seed with its
    # first token first seen at a step >= 3 (and before the last) as the end token
    one = dict(admission=AdmissionConfig(async_prefill=False))
    (t,), _, _ = served_tokens(model, params, prompts[:1], 16,
                               torch.Generator(device="cuda").manual_seed(28), 1e4, **one)
    k = next(k for k in range(3, len(t) - 1) if t[k] not in t[:k])
    (got,), _, _ = served_tokens(model, params, prompts[:1], 16,
                                 torch.Generator(device="cuda").manual_seed(28), 1e4,
                                 eos_id=t[k], **one)
    log(f"  eos_id mid-decode: a sampled request's token at step {k} ({t[k]}) as the end "
        f"token: it stopped after {len(got)} tokens, the first {k + 1} of the free run's: "
        f"{got == t[:k + 1]}")
    if got != t[:k + 1]:
        raise SystemExit("chip_smoke: eos_id did not stop a decoding request at its token")
    run = dict(ops.LAUNCHES)
    log(f"  phase 27: {time.perf_counter() - t_phase:.1f} s; kernel launches "
        f"{ {n: v for n, v in run.items() if v} }")
    return run


# ---------------------------------------------------------------------------
# phase 28: the captured decode step against the eager one
# ---------------------------------------------------------------------------


def decode_spans_ms(tracer) -> list[float]:
    """The ``decode.batch`` spans of a tracer's ring, in ms (each holds one
    decode call and its host read)."""
    from repro_torch.obs.trace import PH_BEGIN, PH_END

    open_ts, spans = {}, []
    for e in tracer.events():
        if e["name"] != "decode.batch":
            continue
        if e["ph"] == PH_BEGIN:
            open_ts[e["tid"]] = e["ts"]
        elif e["ph"] == PH_END and e["tid"] in open_ts:
            spans.append((e["ts"] - open_ts.pop(e["tid"])) * 1e3)
    return spans


def step_profile(model, params, prompts, cuda_graph: bool, steps: int = 10):
    """A full-width engine (8 lanes, max_len 1,024, inline admission) with
    its 8 lanes decoding: (mean wall ms of ``steps`` synced decode steps,
    device-busy share in % and launches per step by kernel group from one
    profiled step, the engine); the share is None and the launches empty
    where three profiles recorded no device kernel."""
    from repro_torch.serve import AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine

    eng = ServeEngine(model, params, EngineConfig(
        batch_slots=8, max_len=1024, cuda_graph=cuda_graph, cache=CacheConfig(page_size=PS),
        admission=AdmissionConfig(async_prefill=False)), device="cuda")
    for i, p in enumerate(prompts[:8]):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=64))
    s = eng.sched
    while len(s.running) < 8 or s.waiting or s.admitting or s.ready:
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    busy, launches = None, {}
    for _ in range(3):                  # a profile may come back without device records
        groups, launches, _ = device_groups(eng.step, 1)
        if groups:
            busy = 100 * sum(groups.values()) / ms
            break
    return ms, busy, launches, eng


def captured_vs_eager(model, params, prompts, greedy, smi) -> dict[str, int]:
    """Phase 28 on phase 4's model and requests (32 new tokens) and tokens
    (``greedy``): a captured and an eager (``cuda_graph=False``) traced
    engine, 3 runs each in turns (C E, E C, C E): tokens equal to phase 4's
    request for request, tok/s medians and the tracer's ``decode.batch``
    spans; then the decode step of 8 lanes of each, in turns (C E E C):
    wall ms, and from one profiled step each the device-busy share and the
    kernels per step, and ``ops.LAUNCHES`` of n replays against n times the
    captured step's.  Returns the phase's launches."""
    from repro_torch.kernels import ops
    from repro_torch.serve import CacheConfig, EngineConfig, ObsConfig, Request, ServeEngine

    t_phase = time.perf_counter()
    ops.reset_launches()
    engines = {}
    for graph in (True, False):
        eng = ServeEngine(model, params, EngineConfig(
            batch_slots=8, max_len=1024, cuda_graph=graph, cache=CacheConfig(page_size=PS),
            obs=ObsConfig(trace=True)), device="cuda")
        eng.submit(Request(uid=-1, prompt=prompts[0], max_new_tokens=2))
        eng.run()
        engines[graph] = eng
    decode_runs(engines[True], "phase 28")
    if engines[False].decode_graph.graph is not None:
        raise SystemExit("chip_smoke: the eager engine captured a graph")
    tps = {True: [], False: []}
    for rep, order in enumerate(((True, False), (False, True), (True, False))):
        for graph in order:
            eng = engines[graph]
            reqs = [Request(uid=100 * rep + i, prompt=p, max_new_tokens=32)
                    for i, p in enumerate(prompts)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tps[graph].append(sum(len(r.out_tokens) for r in reqs) / wall)
            for i, (r, want) in enumerate(zip(reqs, greedy)):
                if r.out_tokens != want:
                    step = next(j for j, (x, y) in enumerate(zip(r.out_tokens, want)) if x != y)
                    raise SystemExit(f"chip_smoke: {'captured' if graph else 'eager'} run {rep}: "
                                     f"request {i} differs from phase 4's at token {step}")
    spans = {g: decode_spans_ms(engines[g].tracer) for g in engines}
    for g in (True, False):
        sp = spans[g]
        log(f"  {'captured' if g else 'eager   '}: {', '.join(f'{x:.1f}' for x in tps[g])} tok/s "
            f"end to end (median {statistics.median(tps[g]):.1f}); decode.batch spans "
            f"(tracer): {len(sp)}, median {statistics.median(sp):.3f} ms, p90 "
            f"{np.percentile(sp, 90):.3f} ms ({smi})")
    log(f"  tokens of all 6 runs identical to phase 4's, request for request; captured / "
        f"eager tok/s (medians) "
        f"{statistics.median(tps[True]) / statistics.median(tps[False]):.3f}")
    del engines
    gc.collect()
    prof = {True: [], False: []}
    for graph in (True, False, False, True):
        ms, busy, launches, eng = step_profile(model, params, prompts, graph)
        prof[graph].append((ms, busy, sum(launches.values())))
        if graph:
            # the profiled replay ran the port's kernels: one paged decode
            # and one paged_write launch per layer, as the capture counted
            want = {k: eng.decode_graph.launches.get(k, 0)
                    for k in ("paged_decode_attention", "paged_write")}
            got = {k: launches.get(k, 0) for k in want}
            retakes = 0
            while got != want and retakes < 2:
                # a profile now and then loses some of a replay's kernel
                # records (20 of 36 in one H100 run); one that never holds them
                # all still fails below
                retakes += 1
                _, launches, _ = device_groups(eng.step, 1)
                got = {k: launches.get(k, 0) for k in want}
            if retakes:
                log(f"  the replay's profile was taken {retakes + 1} times ({got} at the last)")
            if got != want or want["paged_write"] != model.cfg.n_layers \
                    or want["paged_decode_attention"] != model.cfg.n_layers:
                raise SystemExit(f"chip_smoke: a profiled replay ran {got} kernels of the "
                                 f"port, the capture counted {want} ({model.cfg.n_layers} "
                                 "layers each wanted)")
            log(f"  profiled replay: {got['paged_decode_attention']:g} paged_decode_attention "
                f"and {got['paged_write']:g} paged_write kernel records, as the capture counted")
            n = 5
            before = dict(ops.LAUNCHES)
            for _ in range(n):
                eng.decode_graph(eng.cache.pools)
            torch.cuda.synchronize()
            want = {k: n * v for k, v in eng.decode_graph.launches.items() if v}
            got = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
            if got != want or want.get("paged_decode_attention") != n * model.cfg.n_layers:
                raise SystemExit(f"chip_smoke: {n} replays counted {got}, expected {want}")
        eng.run()
    for g in (True, False):
        (m1, b1, k1), (m2, b2, k2) = prof[g]
        busy = ("not measured" if b1 is None or b2 is None
                else f"{b1:.1f} % / {b2:.1f} %")
        log(f"  decode step of 8 lanes, {'captured' if g else 'eager   '}: {m1:.3f} / {m2:.3f} ms "
            f"wall (in turns), device busy {busy}, {k1:g} / {k2:g} kernels per step "
            f"({smi})")
    ratio = sum(p[0] for p in prof[True]) / sum(p[0] for p in prof[False])
    log(f"  captured step / eager step (wall): {ratio:.3f}; {n} replays counted {n} x the "
        "captured step's launches")
    run = dict(ops.LAUNCHES)
    log(f"  phase 28: {time.perf_counter() - t_phase:.1f} s")
    return run


def chunked_captured_vs_eager(model, params, prompts, smi) -> dict[str, int]:
    """Phase 34 on phase 4's model and requests (32 new tokens), 256-token
    prefill chunks, async admission: a captured engine (each full chunk one
    replay of its slot's graph, each tail eager) and an eager one
    (``cuda_graph=False``), 3 runs each in turns (C E, E C, C E): tokens equal
    between the two and across runs, request for request; per run, the
    replays and eager tails the prompts' lengths call for and one
    flash_attention launch per layer per chunk (a replay counted as its
    captured launches); tok/s; then one 256-token chunk at offset 256 of each
    (``chunk_vs_eager``).  Returns the phase's launches."""
    from repro_torch.kernels import ops
    from repro_torch.serve import AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine

    t_phase = time.perf_counter()
    chunk, n_layers = 256, model.cfg.n_layers
    engines = {}
    for graph in (True, False):
        eng = ServeEngine(model, params, EngineConfig(
            batch_slots=8, max_len=1024, cuda_graph=graph, cache=CacheConfig(page_size=PS),
            admission=AdmissionConfig(prefill_chunk=chunk)), device="cuda")
        # warm-up: the longest prompt, so a full chunk replays too
        eng.submit(Request(uid=-1, prompt=max(prompts, key=len), max_new_tokens=2))
        eng.run()
        engines[graph] = eng
    extend_runs(engines[True], "phase 34")
    if any(g is not None for g in engines[False].prefill_slots.graphs):
        raise SystemExit("chip_smoke: the eager engine captured its extend")
    full = sum(len(p) // chunk for p in prompts)
    tails = sum(1 for p in prompts if len(p) % chunk)
    if engines[True].prefill_slots.launches.get("flash_attention") != n_layers:
        raise SystemExit("chip_smoke: the captured extend holds "
                         f"{engines[True].prefill_slots.launches} launches, expected "
                         f"{n_layers} flash_attention")
    run = dict.fromkeys(ops.LAUNCHES, 0)
    tps, toks = {True: [], False: []}, {}
    for rep, order in enumerate(((True, False), (False, True), (True, False))):
        for graph in order:
            eng = engines[graph]
            sl = eng.prefill_slots
            runs0, eager0 = sl.runs, sl.eager_runs
            reqs = [Request(uid=100 * rep + i, prompt=p, max_new_tokens=32)
                    for i, p in enumerate(prompts)]
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for k, n in ops.LAUNCHES.items():
                run[k] += n
            tps[graph].append(sum(len(r.out_tokens) for r in reqs) / wall)
            what = "captured" if graph else "eager"
            static, eager = sl.runs - runs0, sl.eager_runs - eager0
            if (static, eager) != (full, tails):
                raise SystemExit(f"chip_smoke: {what} run {rep}: {static} static chunks and "
                                 f"{eager} eager ones, expected {full} and {tails}")
            if ops.LAUNCHES["flash_attention"] != n_layers * (full + tails):
                raise SystemExit(f"chip_smoke: {what} run {rep}: "
                                 f"{ops.LAUNCHES['flash_attention']} flash_attention launches, "
                                 f"expected {n_layers} per chunk of {full + tails}")
            got = [r.out_tokens for r in reqs]
            if not all(len(t) == 32 for t in got):
                raise SystemExit(f"chip_smoke: {what} run {rep}: a request did not finish")
            first_diff(got, toks.setdefault(graph, got), f"phase 34 {what} run {rep}")
    first_diff(toks[True], toks[False], "phase 34 captured against eager")
    for g in (True, False):
        log(f"  {'captured' if g else 'eager   '}: {', '.join(f'{x:.1f}' for x in tps[g])} tok/s "
            f"end to end (median {statistics.median(tps[g]):.1f}) ({smi})")
    log(f"  {len(prompts)} requests, {full} full chunks (one replay each, captured) and {tails} "
        f"tails (eager) per run; flash_attention {n_layers} launches per chunk in every run; "
        f"tokens of all 6 runs identical, request for request; captured / eager tok/s "
        f"(medians) {statistics.median(tps[True]) / statistics.median(tps[False]):.3f}")
    chunk_vs_eager(model, params, model.cfg.vocab_size, chunk, chunk, 1024, smi,
                   engines=engines)
    for eng in engines.values():
        if eng.prefill_slots.in_use:
            raise SystemExit("chip_smoke: a prefill slot was not given back")
    del engines
    gc.collect()
    log(f"  phase 34: {time.perf_counter() - t_phase:.1f} s")
    return run


# ---------------------------------------------------------------------------
# phase 35: the kernel autotuner on the card
# ---------------------------------------------------------------------------


def ssd_unclipped(args):
    """The SSD cutout's shapes with phase 2's unclipped draws (x, B and C
    N(0, 1) x 0.5, dt after the softplus in [0.01, 0.5], a in [-1.5, -0.5]),
    so no chunk's seg spans 120 and the decay clip never engages: there the
    chunk does not change the function."""
    cfg, xh, bb, cc, dt, a_log, d_skip = args[:7]
    gen = torch.Generator(device="cuda").manual_seed(35)

    def rand(like):
        return torch.rand(like.shape, generator=gen, device="cuda")

    return (cfg, torch.randn_like(xh) * 0.5, torch.randn_like(bb) * 0.5,
            torch.randn_like(cc) * 0.5, torch.log(torch.expm1(rand(dt) * 0.49 + 0.01)),
            torch.log(rand(a_log) + 0.5), d_skip)


def ssd_chunks_against_plain() -> str:
    """Phase 35 (b): ``ssd_scan`` at mamba2-130m's served widths (H 24, P
    64, N 128; a 256-token slice with a carried state, bf16, phase 2's
    unclipped draws) at every chunk of ``ssd.chunked``'s space against its
    plain version at the same chunk: ``ssd_plan``'s cluster and rows at the
    small chunks.  Returns the log line's text."""
    from repro_torch.kernels import ops, ref

    h, p, n = SSM["h"], SSM["p"], SSM["n"]
    gen = torch.Generator(device="cuda").manual_seed(35)
    conv = (torch.randn(1, 256, h * p + 2 * n, generator=gen, device="cuda") * 0.5).to(
        torch.bfloat16)
    xh = conv[..., :h * p].reshape(1, 256, h, p)
    bb, cc = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    dt = torch.rand(1, 256, h, generator=gen, device="cuda") * 0.49 + 0.01
    a = -(torch.rand(h, generator=gen, device="cuda") + 0.5)
    st = torch.randn(1, h, p, n, generator=gen, device="cuda")
    parts = []
    for q in (16, 32, 64, 128, 256):
        (y, fin), (want_y, want_fin) = ops.ssd_scan(xh, bb, cc, dt, a, q, st), \
            ref.ssd_scan(xh, bb, cc, dt, a, q, st)
        err = max(check_close(f"ssd_scan chunk {q} y", y, want_y, torch.float32),
                  check_close(f"ssd_scan chunk {q} final state", fin, want_fin, torch.float32))
        parts.append(f"{q}: {err:.2e} ({ops.PATHS['ssd_scan']})")
    return "; ".join(parts)


def configs_against_default(name, args) -> str:
    """Phase 35 (b): every valid config of ``name``'s space against the
    default config on ``args``: bit-equal for ``lane_block``; ``chunk``
    within the float32 tolerance; ``expert_block`` bit-equal or, where it is
    not, within the float32 tolerance (a block of fewer experts is a
    cuBLAS product of a smaller batch, for which cuBLAS may pick another
    GEMM with another summation order).  Returns the log line's text."""
    from repro_torch.tune import enumerate_space, registry

    kern = registry.REGISTRY[name]
    with torch.no_grad():
        want = kern.fn(*args, **kern.defaults)
        parts = []
        for c in enumerate_space(kern.space):
            if kern.validate is not None and not kern.validate(c, *args):
                parts.append(f"{c} invalid")
                continue
            got = kern.fn(*args, **c)
            torch.cuda.synchronize()
            pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
            if all(torch.equal(g, w) for g, w in pairs):
                parts.append(f"{c} bit-equal")
                continue
            if "lane_block" in c:
                raise SystemExit(f"chip_smoke: {name} {c} is not bit-equal to the default")
            atol, rtol = TOL["torch.float32"]
            err = max(float((g.float() - w.float()).abs().max()) for g, w in pairs)
            if not all(bool(((g.float() - w.float()).abs() <= atol + rtol * w.float().abs()).all())
                       and bool(torch.isfinite(g).all()) for g, w in pairs):
                raise SystemExit(f"chip_smoke: {name} {c} is {err:.3e} from the default "
                                 f"(atol {atol:g}, rtol {rtol:g})")
            parts.append(f"{c} {err:.2e}" + (" (not bit-equal)" if "expert_block" in c else ""))
    return "; ".join(parts)


def tuner_on_card(smi) -> dict[str, int]:
    """Phase 35: the autotuner (``repro_torch.tune``) on the card, into a
    table of its own under ``chiprun_out/`` (never the committed one).
    (a) ``tune_kernel`` over the four canonical cutouts: full schema,
    winner <= default; (b) every valid config of each space against the
    default config (``lane_block`` bit-equal; ``chunk`` within the float32
    tolerance, the SSD on phase 2's unclipped draws at the cutout's shapes;
    ``expert_block`` bit-equal or within it), and ``ssd_scan`` at the served
    widths at every chunk against its plain version; (c) a full-width
    mamba2-130m prefill of its 256-token served slice under ``capture()``:
    its ``ssd.chunked`` cutout materialized on the card and tuned into the
    table, the prefill rerun under it with ``ssd_scan`` at the winner's
    chunk (``ops.PATHS``), its logits against the untuned prefill's
    (``no_tuning``): bit-equal at the default's chunk, else within the bf16
    tolerance where the decay clip does not engage (logged where it does);
    where the winner is the default's chunk, an entry of chunk 64 is run
    the same way; then the same model with ``a_log`` setting the per-token
    decays in Mamba-2's dt range, where no chunk engages the clip, held to
    the bf16 tolerance; (d) the host us of
    one resolve over 10,000 calls.  Returns the phase's launches."""
    import os

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items
    from repro_torch.tune import capture, cutouts, materialize, registry, table, tuner

    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "phase35_tuned.json"
    path.unlink(missing_ok=True)
    prev = os.environ.get(table.ENV_VAR)
    os.environ[table.ENV_VAR] = str(path)
    table.reload_table()
    run = dict.fromkeys(ops.LAUNCHES, 0)
    fields = ("params", "default_us", "winner_us", "ratio", "space_size", "pruned", "measured")

    def tune_into_table(name, args, sc):
        entry = tuner.tune_kernel(name, args, log=lambda m: log(f"    {m}"))
        if set(entry) != set(fields) or not entry["winner_us"] <= entry["default_us"]:
            raise SystemExit(f"chip_smoke: {name} entry {entry} lacks the schema or its "
                             "winner is slower than its default")
        tab = table.load_table()
        tab["entries"][table.entry_key(name, sc, "cuda")] = entry
        table.save_table(tab)
        log(f"  {name} [{sc}]: winner {entry['params']} {entry['winner_us']} us, default "
            f"{entry['default_us']} us (ratio {entry['ratio']}; space {entry['space_size']}, "
            f"pruned {entry['pruned']}, measured {entry['measured']}) ({smi})")
        return entry

    try:
        ops.reset_launches()
        built = {}
        t0 = time.perf_counter()
        for name in sorted(cutouts.CUTOUTS):
            args = built[name] = cutouts.build(name, device="cuda")
            tune_into_table(name, args, registry.REGISTRY[name].shape_class(*args))
        log(f"  (a) four canonical cutouts tuned in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for name, args in sorted(built.items()):
            if name == "ssd.chunked":
                fn = registry.REGISTRY[name].fn
                want, errs = fn(*args, chunk=None), []
                for c in registry.REGISTRY[name].space["chunk"]:
                    errs.append(f"{c}: {float((fn(*args, chunk=c)[0] - want[0]).abs().max()):.3e}")
                log(f"  (b) {name} (kernel form) on the canonical draws, which engage the decay "
                    "clip, where the chunk changes the function (as in the reference): y's max "
                    f"abs err against the default per chunk {', '.join(errs)}")
                args = ssd_unclipped(args)
            log(f"  (b) {name}: {configs_against_default(name, args)}")
        log(f"  (b) every valid config against the default in {time.perf_counter() - t0:.1f} s")
        for k, n in ops.LAUNCHES.items():
            run[k] += n

        t0 = time.perf_counter()
        log(f"  (b) ssd_scan at mamba2-130m's served widths, every chunk of the space against "
            f"its plain version at that chunk: {ssd_chunks_against_plain()}")
        cfg = get_arch("mamba2-130m")
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        toks = torch.as_tensor(np.random.default_rng(35).integers(0, cfg.vocab_size, size=(1, 256)),
                               device="cuda").long()
        default_q = min(cfg.ssm.chunk, 256)

        def prefill(tuned=True):
            """The prefill's last logits, ``ssd_scan``'s chunk (``ops.PATHS``) and the
            largest seg span of a default-sized chunk over its layers."""
            spans, real = [], ops.ssd_scan

            def spy(xh, b, c, dt, a, chunk, init_state=None):
                span = (dt * a).reshape(dt.shape[0], -1, default_q, dt.shape[2]).sum(2)
                spans.append(float(span.abs().max()))
                return real(xh, b, c, dt, a, chunk, init_state)

            ops.ssd_scan = spy
            try:
                with torch.no_grad(), contextlib.ExitStack() as stack:
                    if not tuned:
                        stack.enter_context(registry.no_tuning())
                    logits, _ = model.prefill(params, toks)
                torch.cuda.synchronize()
            finally:
                ops.ssd_scan = real
            if not torch.isfinite(logits).all():
                raise SystemExit("chip_smoke: a phase 35 prefill's logits are not finite")
            return logits, int(ops.PATHS["ssd_scan"].rsplit(", ", 1)[1].split("-")[0]), max(spans)

        def against_untuned(label, got, q, want, span):
            """Logits at chunk ``q`` against the untuned prefill's: bit-equal at the
            default's chunk.  Where no chunk of the default's size spans more than 120
            (the decay clip never engages), the same greedy token and max |diff| <= the
            bf16 rtol x max |logit|: another chunk sums in another order, and through 24
            bf16 layers of random weights a last-bit change in one layer grows past an
            elementwise atol + rtol x |logit| (logged).  Where a chunk spans more, the
            chunk changes the function (as in the reference) and the gap is logged."""
            if q == default_q:
                if not torch.equal(got, want):
                    raise SystemExit(f"chip_smoke: {label} at the default's chunk is not "
                                     "bit-equal to the untuned prefill")
                return "bit-equal to the untuned prefill's (the default's chunk)"
            g, w = got.float(), want.float()
            err = float((g - w).abs().max())
            if span <= 120:
                atol, rtol = TOL["torch.bfloat16"]
                rel = err / float(w.abs().max())
                inside = float(((g - w).abs() <= atol + rtol * w.abs()).float().mean())
                same = bool((g.argmax(-1) == w.argmax(-1)).all())
                if rel > rtol or not same:
                    raise SystemExit(f"chip_smoke: {label} at {q}-token chunks is {rel:.3e} "
                                     f"of max |logit| from the untuned prefill (bf16 rtol "
                                     f"{rtol:g}), same greedy token: {same}")
                return (f"{err:.3e} from the untuned prefill's, {rel:.3e} of max |logit| "
                        f"(held: <= {rtol:g}), the same greedy token; {100 * inside:.2f} % of "
                        f"the logits within atol {atol:g} + rtol {rtol:g} x |logit|")
            return (f"{err:.3e} from the untuned prefill's: the decay clip engages (a "
                    f"{default_q}-token chunk's seg spans more than 120), so the chunk changes "
                    "the function, as in the reference; not held")

        ops.reset_launches()
        with capture() as caps:
            before, q0, span = prefill(tuned=False)
            before_path = ops.PATHS["ssd_scan"]
            caps_untuned = list(caps)
            prefill()                                    # the table has no entry yet
        cuts = [c for c in caps if c.kernel == "ssd.chunked"]
        if len(caps_untuned) or len(cuts) != cfg.n_layers or len({c.shape_class for c in cuts}) != 1 \
                or ops.LAUNCHES["ssd_scan"] != 2 * cfg.n_layers or q0 != default_q:
            raise SystemExit(f"chip_smoke: the prefill captured {len(cuts)} ssd.chunked "
                             f"cutouts ({len(caps_untuned)} under no_tuning) and launched "
                             f"ssd_scan {ops.LAUNCHES['ssd_scan']} times, expected "
                             f"{cfg.n_layers} of one shape class per prefill")
        sc = cuts[0].shape_class
        log(f"  (c) full-width mamba2-130m prefill, 256 tokens (seeded random weights): "
            f"{len(cuts)} ssd.chunked cutouts [{sc}], ssd_scan: {before_path}; the largest seg "
            f"span of a {default_q}-token chunk {span:.1f}")
        cut_args = materialize(cuts[0], device="cuda")
        entry = tune_into_table("ssd.chunked", cut_args, sc)
        key = table.entry_key("ssd.chunked", sc, "cuda")
        want_q = min(entry["params"]["chunk"] or cfg.ssm.chunk, 256)
        after, q, _ = prefill()
        if registry.resolve_tuned("ssd.chunked", *cut_args) != entry["params"] or q != want_q:
            raise SystemExit(f"chip_smoke: the tuned prefill ran ssd_scan as "
                             f"{ops.PATHS['ssd_scan']}, expected {want_q}-token chunks")
        log(f"  (c) rerun under the table: ssd_scan {ops.PATHS['ssd_scan']}; logits "
            f"{against_untuned('the tuned prefill', after, q, before, span)}")
        # where the winner is the default's chunk, an entry of chunk 64 shows the table
        # driving the served path; either way the tuned entry is put back after (d)
        show = entry if q != default_q else dict(entry, params={"chunk": 64})
        tab = table.load_table()
        tab["entries"][key] = show
        table.save_table(tab)
        show_q = min(show["params"]["chunk"], 256)
        if q == default_q:
            forced, fq, _ = prefill()
            if fq != show_q:
                raise SystemExit(f"chip_smoke: an entry of chunk 64 ran ssd_scan as "
                                 f"{ops.PATHS['ssd_scan']}")
            log(f"  (c) under an entry of chunk 64: ssd_scan {ops.PATHS['ssd_scan']}; logits "
                f"{against_untuned('an entry of chunk 64', forced, fq, before, span)}")
        # the same model with the per-token decays where Mamba-2's dt init puts them:
        # neither package reads dt_bias, so a_log takes the scale (dt * |a| ~ 0.001-0.1
        # at dt ~ softplus(0)); no chunk then spans 120, and the chunk must not change
        # the function
        gen = torch.Generator(device="cuda").manual_seed(36)
        for leaf_path, leaf in tree_items(params):
            if leaf_path[-1] == "a_log":
                leaf.copy_(torch.rand(leaf.shape, generator=gen, device="cuda")
                           * math.log(100.0) + math.log(1.5e-3))
        base, _, span2 = prefill(tuned=False)
        got, gq, _ = prefill()
        if gq != show_q or span2 > 120:
            raise SystemExit(f"chip_smoke: with small decays the table ran {gq}-token "
                             f"chunks (expected {show_q}) and a chunk spans {span2:.1f}")
        log(f"  (c) with decays of Mamba-2's dt range (a_log; largest span {span2:.1f}): the "
            f"table's {gq}-token chunks against the untuned prefill: "
            f"{against_untuned('the prefill with small decays', got, gq, base, span2)}")
        tab["entries"][key] = entry
        table.save_table(tab)
        for k, n in ops.LAUNCHES.items():
            run[k] += n
        log(f"  (c) in {time.perf_counter() - t0:.1f} s")
        del model, params

        ops.reset_launches()
        for name, args in sorted(built.items()) + [("ssd.chunked (mamba2-130m)", cut_args)]:
            kname = name.split()[0]
            registry.resolve_tuned(kname, *args)
            t0 = time.perf_counter()
            for _ in range(10_000):
                registry.resolve_tuned(kname, *args)
            log(f"  (d) resolve {name}: {(time.perf_counter() - t0) * 1e2:.3f} us per call "
                "(host, mean of 10,000)")
    finally:
        if prev is None:
            os.environ.pop(table.ENV_VAR, None)
        else:
            os.environ[table.ENV_VAR] = prev
        table.reload_table()
    log(f"  phase 35: {time.perf_counter() - t_phase:.1f} s; the table: {path.name} under "
        "chiprun_out/")
    return run


# ---------------------------------------------------------------------------
# phase 36: the port's repro-lint on the card machine
# ---------------------------------------------------------------------------

# the modules whose functions phase 36 records inside a captured step
CAPTURE_MODULES = ("repro_torch.models", "repro_torch.kernels.ops", "repro_torch.serve.captured",
                   "repro_torch.train", "repro_torch.optim", "repro_torch.tune")
# phase 36's captured training steps: (arch, optimizer, microbatches, config
# fields replaced), reduced, float32, 2 steps each through Trainer
TRAIN_CLOSURE = [("qwen2.5-3b", "momentum", 2, {"remat": "full"}),
                 ("qwen2.5-3b", "adamw", 1, {}), ("mamba2-130m", "sgd", 1, {"remat": "full"}),
                 ("recurrentgemma-9b", "sgd", 1, {"n_layers": 5}),
                 ("qwen3-moe-235b-a22b", "sgd", 1, {}), ("deepseek-v3-671b", "momentum", 1, {}),
                 ("llava-next-mistral-7b", "sgd", 1, {}),
                 ("whisper-large-v3", "sgd", 1, {"remat": "full"})]

SEEDED_STEP = """import torch

from repro_torch.analysis.ownership import captured_step


@captured_step
def step(x, w):
    y = torch.tanh(x * w)
{read}    return y * 2 + 1
"""

# phase 36 (c) in a process of its own: after a failed capture the caching
# allocator kept its cached blocks (48.5 GiB reserved and unallocated by phase
# 19, whose 4 GiB allocation then failed), as if the capture were still open
SEEDED_CAPTURE = """import importlib.util
import json
import sys

import torch

from repro_torch.capture import capturing


def load(path):
    spec = importlib.util.spec_from_file_location(path.rsplit("/", 1)[-1][:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.step


bad, good = (load(p) for p in sys.argv[1:3])
gen = torch.Generator(device="cuda").manual_seed(36)
x = torch.randn(64, 1024, device="cuda", generator=gen)
w = torch.randn(64, 1024, device="cuda", generator=gen)
side = torch.cuda.Stream()


def capture(step):
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(x, w)                              # warm-up, as the engine's
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with capturing(graph, side):
        out = step(x, w)
    return graph, out


graph, out = capture(good)
x.copy_(torch.randn(x.shape, device="cuda", generator=gen))
graph.replay()
equal = torch.equal(out, good(x, w))
try:
    capture(bad)
    raised = None
except RuntimeError as e:
    while e.__context__ is not None:            # the read's own error, not the capture's end
        e = e.__context__
    raised = str(e).strip().splitlines()[0]
print(json.dumps({"equal": equal, "raised": raised}))
"""


def entered_in_step(cls, pkg: Path, seen: set):
    """``cls._capture`` with ``sys.setprofile`` on while the step it captures
    runs (its warm-up and its capture), adding each function of
    ``CAPTURE_MODULES`` entered there to ``seen`` as (path in the package,
    qualname of the enclosing function).  Returns the original."""
    import os

    dirs = tuple(str(pkg.joinpath(*m.split(".")[1:])) + os.sep for m in CAPTURE_MODULES)
    files = {d[:-1] + ".py" for d in dirs}
    orig = cls._capture

    def prof(frame, event, arg):
        name = frame.f_code.co_filename
        if event == "call" and (name.startswith(dirs) or name in files):
            seen.add((Path(name).relative_to(pkg).as_posix(),
                      frame.f_code.co_qualname.split(".<locals>")[0]))

    def _capture(self, *args):
        step = self._step

        def traced(*a, **k):
            sys.setprofile(prof)
            try:
                return step(*a, **k)
            finally:
                sys.setprofile(None)

        self._step = traced
        try:
            return orig(self, *args)
        finally:
            self._step = step

    cls._capture = _capture
    return orig


def train_closure_on_card(pkg: Path, static: set) -> None:
    """Phase 36 (b) for training: each ``TRAIN_CLOSURE`` case trains 2 steps
    through ``Trainer`` on the card (a warm-up, the capture and one replay)
    while ``entered_in_step`` records the functions of ``CAPTURE_MODULES``
    that ``CapturedTrainStep``'s warm-up and capture enter on this thread
    (the backward's recompute, on autograd's device thread, is not seen
    here: ``tests/test_torch_lint.py`` follows it on the CPU); every one
    lies in ``static`` and each case's graph holds one stream_gd launch
    where its optimizer has one."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.train.captured import CapturedTrainStep
    from repro_torch.train.trainer import Trainer, TrainerConfig

    seen: set = set()
    orig = entered_in_step(CapturedTrainStep, pkg, seen)
    try:
        for arch, opt, n_micro, over in TRAIN_CLOSURE:
            cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **over)
            tr = Trainer(build_model(cfg), SyntheticLMData(cfg, batch=2, seq=16, device="cuda"),
                         TrainerConfig(total_steps=2, optimizer=opt, lr=1e-3,
                                       n_microbatches=n_micro, log_every=100), device="cuda")
            state = tr.run(tr.init_state(0))
            g = next(iter(tr.captured._graphs.values()))
            want = {} if opt == "adamw" else {"stream_gd": 1}
            if (tr.captured.graphs, tr.captured.replays, g.launches) != (1, 1, want) \
                    or not all(np.isfinite(state.losses)):
                raise SystemExit(f"chip_smoke: {arch}'s captured training step: "
                                 f"{tr.captured.graphs} graph(s), {tr.captured.replays} replays, "
                                 f"launches {g.launches}, losses {state.losses}")
            del tr, state, g
    finally:
        CapturedTrainStep._capture = orig
    gc.collect()
    roots = {("train/train_step.py", "TrainStep.__call__"), ("train/train_step.py",
                                                           "value_and_grad")}
    roots |= {("optim/optimizer.py", opt) for _, opt, _, _ in TRAIN_CLOSURE}
    if not roots <= seen:
        raise SystemExit(f"chip_smoke: the training captures never entered {sorted(roots - seen)}")
    missing = sorted(seen - static)
    if missing:
        raise SystemExit(f"chip_smoke: the card entered functions outside capture-safety's "
                         f"closure while capturing a training step: {missing}")
    log(f"  (b) training: {len(TRAIN_CLOSURE)} reduced models' captured steps ("
        f"{', '.join(f'{a} {o}' for a, o, _, _ in TRAIN_CLOSURE)}) entered {len(seen)} "
        "functions on this thread, every one in the closure")


def release_lingering_engines() -> None:
    """Drop the weights, pools and graphs of every ``ServeEngine`` still
    alive once phase 9 is done with its model (no serving engine is in use
    then).  One full-width qwen2.5-3b engine of phases 4-9 outlives its
    phase: its only referrers ``gc`` sees are its own cycle (its admission
    pipeline, its decode lambda's closure), so something outside Python
    holds it (not found; ``PERF.md`` §7), with 5.75 GiB of weights and its
    pools, which the training phases' graphs need (phase 23 captured with
    0.3 GiB to spare beside it)."""
    from repro_torch.serve import ServeEngine

    gc.collect()
    before = torch.cuda.memory_allocated()
    engines = [o for o in gc.get_objects() if isinstance(o, ServeEngine)]
    for e in engines:
        e.params = e.cache = e.decode_graph = e.prefill_slots = None
    n = len(engines)
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {n} serving engine(s) outlived their phases; dropping their weights, pools and "
        f"graphs freed {(before - torch.cuda.memory_allocated()) / 2**30:.2f} GiB "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated)")


def lint_on_card(model, params, src: Path, smi) -> dict[str, int]:
    """Phase 36 on phase 4's model: (a) ``python -m repro_torch.analysis.lint``
    over the checkout's package exits 0 on this machine's Python; (b) the
    functions entered inside the steps one ``CapturedDecode`` and one
    ``CapturedExtend`` capture (a full-width engine with 256-token chunks
    and one prefill slot) all lie in ``capture_safety``'s closure, and the
    captures hold paged_decode_attention and paged_write once per layer and
    flash_attention once per layer in its device-offset form
    (``ops._offset_pair`` entered); (c) a seeded ``@captured_step`` with
    an ``.item()`` is flagged ``graph-host-read`` by ``lint_paths`` and its
    capture raises, the same step without the read is not flagged, captures
    and replays equal to its eager run (both captured in a child process:
    ``SEEDED_CAPTURE``).  Returns the phase's launches (the captures'
    warm-up runs)."""
    import os
    import tempfile

    from repro_torch.analysis.lint import lint_paths, load_files
    from repro_torch.analysis.rules import ALL_RULE_IDS, capture_safety
    from repro_torch.kernels import ops
    from repro_torch.serve import AdmissionConfig, CacheConfig, EngineConfig, ServeEngine, captured

    t_phase = time.perf_counter()
    src = src.resolve()
    pkg = src / "repro_torch"
    # (a) the CLI, as a user runs it
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint"], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(src)), capture_output=True,
                          text=True, timeout=120)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke: repro-lint exited {proc.returncode}:\n{proc.stdout}"
                         f"{proc.stderr}")
    log(f"  (a) python -m repro_torch.analysis.lint: exit 0, {len(ALL_RULE_IDS)} rules, "
        f"{proc.stdout.strip().splitlines()[-1]!r}, {wall:.2f} s wall (the process's start "
        f"included) ({smi})")
    t0 = time.perf_counter()
    files, errors = load_files([pkg], root=pkg)
    if errors:
        raise SystemExit(f"chip_smoke: repro-lint could not read {errors}")
    static = capture_safety.closure(files)
    log(f"  capture-safety's closure: {len(static)} functions "
        f"({time.perf_counter() - t0:.3f} s in this process)")

    # (b) what the card enters while it captures, against the closure
    seen = {"decode": set(), "extend": set()}
    origs = {cls: entered_in_step(cls, pkg, seen[key]) for cls, key in
             ((captured.CapturedDecode, "decode"), (captured.CapturedExtend, "extend"))}
    ops.reset_launches()
    try:
        eng = ServeEngine(model, params, EngineConfig(
            batch_slots=8, max_len=1024, cache=CacheConfig(page_size=PS),
            admission=AdmissionConfig(prefill_chunk=256, admission_inflight=1)), device="cuda")
        torch.cuda.synchronize()
    finally:
        for cls, orig in origs.items():
            cls._capture = orig
    run = dict(ops.LAUNCHES)
    n_layers = model.cfg.n_layers
    dec, ext = eng.decode_graph, eng.prefill_slots
    if dec.graph is None or ext is None or ext.graphs != [ext.graphs[0]] \
            or ext.graphs[0] is None:
        raise SystemExit("chip_smoke: phase 36's engine did not capture one decode step and "
                         "one prefill slot")
    want = {"paged_decode_attention": n_layers, "paged_write": n_layers}
    if {k: dec.launches.get(k) for k in want} != want \
            or ext.launches.get("flash_attention") != n_layers:
        raise SystemExit(f"chip_smoke: the captures hold {dec.launches} and {ext.launches}")
    roots = {"decode": ("models/transformer.py", "DecoderLM.decode_step_paged"),
             "extend": ("models/transformer.py", "DecoderLM.extend_step")}
    for key, got in seen.items():
        if roots[key] not in got:
            raise SystemExit(f"chip_smoke: the {key} capture never entered {roots[key]}")
    if ("kernels/ops.py", "_offset_pair") not in seen["extend"]:
        raise SystemExit("chip_smoke: the captured extend did not take flash_attention's "
                         "device-offset form")
    missing = sorted((seen["decode"] | seen["extend"]) - static)
    if missing:
        raise SystemExit(f"chip_smoke: the card entered functions outside capture-safety's "
                         f"closure while capturing: {missing}")
    log(f"  (b) the decode capture entered {len(seen['decode'])} functions, the extend "
        f"capture {len(seen['extend'])} ({len(seen['decode'] | seen['extend'])} in all), every "
        f"one in the closure; captured launches: decode {dec.launches}, extend {ext.launches}")
    del eng, dec, ext
    gc.collect()
    train_closure_on_card(pkg, static)

    # (c) the rule and the card agree on a seeded host read
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths = []
        for name, read in (("seeded_bad", "    y = y + y.abs().max().item()\n"),
                           ("seeded_good", "")):
            paths.append(tmp / f"{name}.py")
            paths[-1].write_text(SEEDED_STEP.format(read=read))
        findings, errors = lint_paths([tmp], baseline=None, root=tmp)
        got = sorted((f.rule, f.path, f.func) for f in findings)
        if errors or got != [("graph-host-read", "seeded_bad.py", "step")]:
            raise SystemExit(f"chip_smoke: repro-lint on the seeded steps gave {got} {errors}")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", SEEDED_CAPTURE, *map(str, paths)],
                              cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(src)),
                              capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke: the seeded captures failed:\n{proc.stdout}{proc.stderr}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    if res["raised"] is None:
        raise SystemExit("chip_smoke: the step with an .item() captured without an error")
    if not res["equal"]:
        raise SystemExit("chip_smoke: the seeded step's replay differs from its eager run")
    log(f"  (c) .item() in a @captured_step: flagged graph-host-read; its capture raised "
        f"({res['raised']!r}); without it: not flagged, captured, the replay on new inputs "
        f"bit-equal to the eager run (a process of its own, {time.perf_counter() - t0:.1f} s)")
    log(f"  phase 36: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return run


# ---------------------------------------------------------------------------
# phases 29-31: routing, migration and cube processes
# ---------------------------------------------------------------------------


def routed_run(router, prompts, max_new: int = 32, waves=None) -> tuple[list, list, float]:
    """Submit ``prompts`` (uids 0..n-1; ``waves``: the index splits at which
    the router runs dry before the next submissions) and run: (cube of each
    request, its tokens, wall seconds)."""
    from repro_torch.serve import Request

    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    cubes = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lo = 0
    for hi in list(waves or ()) + [len(reqs)]:
        cubes += [router.submit(r) for r in reqs[lo:hi]]
        router.run()
        lo = hi
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(r.done and len(r.out_tokens) == max_new for r in reqs):
        raise SystemExit("chip_smoke: a routed request did not finish")
    return cubes, [r.out_tokens for r in reqs], wall


def first_diff(got, want, label: str) -> None:
    """Fail with the first request and token where ``got`` leaves ``want``."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            step = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            raise SystemExit(f"chip_smoke: {label}: request {i} differs at token {step}")
    if len(got) != len(want):
        raise SystemExit(f"chip_smoke: {label}: {len(got)} requests, {len(want)} wanted")


def route_full_width(model, params, prompts, greedy, shared, shared_tokens,
                     smi) -> dict[str, int]:
    """Phase 29 on phase 4's model: two in-process cubes (``CubeRouter``) on
    the one card over one parameter set, each engine with its own pools and
    captured step.  Phase 4's 16 requests under ``hash`` and
    ``least_loaded``, against a single engine in turns (S H L L H S): tokens
    equal to phase 4's, request for request, routed counts and tok/s; the
    merged trace of the traced ``least_loaded`` router.  Phase 26's
    shared-prompt requests under ``prefix_affinity`` with prefix sharing (the
    first request alone, then the other 15): phase 26's tokens, and the 15
    land on the cube that holds the prompt.  ``DenseSlotEngine`` on phase 4's
    requests (the share of phase 4's tokens it gives: its shared-position
    step is exact only for prompts of one length), and reduced float32, card
    against CPU, on prompts of one length: dense tokens = paged tokens.
    Returns the phase's launches."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serve import (
        AdmissionConfig, CacheConfig, CubeRouter, DenseSlotEngine, EngineConfig, ObsConfig,
        Request, ServeEngine)

    t_phase = time.perf_counter()
    launches = dict.fromkeys(KERNELS, 0)
    ecfg = EngineConfig(batch_slots=8, max_len=1024, cache=CacheConfig(page_size=PS))
    single = ServeEngine(model, params, ecfg, device="cuda")
    routers = {"hash": CubeRouter(model, params, ecfg, n_cubes=2, policy="hash", device="cuda"),
               "least_loaded": CubeRouter(model, params, dataclasses.replace(
                   ecfg, obs=ObsConfig(trace=True)), n_cubes=2, device="cuda")}
    for name, r in routers.items():
        e0, e1 = r.engines
        if not (e0.params is e1.params is params) or e0.decode_graph.graph is None \
                or e1.decode_graph.graph is None:
            raise SystemExit(f"chip_smoke: {name}: the cubes do not share the parameters or "
                             "did not capture their steps")
    tps = {k: [] for k in ("single", *routers)}
    for order in (("single", "hash", "least_loaded"), ("least_loaded", "hash", "single")):
        for name in order:
            ops.reset_launches()
            if name == "single":
                sreqs = [Request(uid=i, prompt=p, max_new_tokens=32) for i, p in enumerate(prompts)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for r in sreqs:
                    single.submit(r)
                single.run()
                torch.cuda.synchronize()
                wall, toks, cubes = time.perf_counter() - t0, [r.out_tokens for r in sreqs], None
            else:
                cubes, toks, wall = routed_run(routers[name], prompts)
            for k in launches:
                launches[k] += ops.LAUNCHES[k]
            first_diff(toks, greedy, f"{name} routing")
            tps[name].append(sum(len(t) for t in toks) / wall)
            if cubes is not None:
                routers[name].last_cubes = cubes
    for name in routers:
        r = routers[name]
        log(f"  {name}: routed {r.routed} over two cubes (last run's cubes "
            f"{''.join(map(str, r.last_cubes))}); {', '.join(f'{x:.1f}' for x in tps[name])} "
            f"tok/s against the single engine's {', '.join(f'{x:.1f}' for x in tps['single'])} "
            f"in turns ({smi})")
        if sorted(set(r.last_cubes)) != [0, 1]:
            raise SystemExit(f"chip_smoke: {name} left a cube without work")
    log("  tokens of both policies' runs identical to phase 4's, request for request")
    path = ROOT / "build" / "router_trace.json"
    path.parent.mkdir(exist_ok=True)
    trace = routers["least_loaded"].save_trace(str(path))
    procs = sorted(e["args"]["name"] for e in trace["traceEvents"]
                   if e["ph"] == "M" and e["name"] == "process_name")
    n_dispatch = sum(1 for e in trace["traceEvents"] if e["name"] == "router.dispatch")
    log(f"  least_loaded merged trace: {len(trace['traceEvents'])} events over processes "
        f"{procs}, {n_dispatch} router.dispatch instants")
    if procs != ["pod0", "pod1"] or n_dispatch != sum(routers["least_loaded"].routed):
        raise SystemExit("chip_smoke: the merged trace lacks a cube or a dispatch")
    del routers, single
    gc.collect()

    # prefix_affinity on phase 26's requests (256-token chunks, async admission)
    pcfg = EngineConfig(batch_slots=8, max_len=1024,
                        cache=CacheConfig(page_size=PS, prefix_sharing=True),
                        admission=AdmissionConfig(prefill_chunk=256))
    router = CubeRouter(model, params, pcfg, n_cubes=2, policy="prefix_affinity", device="cuda")
    ops.reset_launches()
    cubes, toks, wall = routed_run(router, shared, waves=[1])
    for k in launches:
        launches[k] += ops.LAUNCHES[k]
    first_diff(toks, shared_tokens, "prefix_affinity routing")
    tel = router.telemetry()
    home = f"pod{cubes[0]}"
    log(f"  prefix_affinity on phase 26's 16 shared-prompt requests (the first alone, then "
        f"15): cubes {''.join(map(str, cubes))}, {home} prefix hits {tel[home]['prefix']['hits']}"
        f", {sum(len(t) for t in toks) / wall:.1f} tok/s; tokens identical to phase 26's")
    if cubes[1:] != [cubes[0]] * 15 or tel[home]["prefix"]["hits"] < 15:
        raise SystemExit("chip_smoke: prefix_affinity did not send the shared prompt's "
                         "requests to the cube that holds it")
    del router
    gc.collect()

    # the dense reference engine at full width, then reduced card against CPU
    dense = DenseSlotEngine(model, params, ecfg, device="cuda")
    dreqs = [Request(uid=i, prompt=p, max_new_tokens=32) for i, p in enumerate(prompts)]
    for r in dreqs:
        dense.submit(r)
    ops.reset_launches()
    t0 = time.perf_counter()
    dense.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k in launches:
        launches[k] += ops.LAUNCHES[k]
    same = sum(a == b for r, g in zip(dreqs, greedy) for a, b in zip(r.out_tokens, g))
    log(f"  DenseSlotEngine on phase 4's requests (bf16, 8 slots x 1,024): "
        f"{sum(len(r.out_tokens) for r in dreqs) / wall:.1f} tok/s; {same}/{32 * len(dreqs)} "
        f"tokens equal to phase 4's, {sum(r.out_tokens == g for r, g in zip(dreqs, greedy))}/"
        f"{len(dreqs)} requests whole (ragged prompts step at the shared maximum position)")
    if not all(r.done and len(r.out_tokens) == 32 for r in dreqs):
        raise SystemExit("chip_smoke: a dense-engine request did not finish")
    del dense
    rmodel = build_model(dataclasses.replace(get_arch("qwen2.5-3b").reduced(), dtype="float32"))
    rparams = rmodel.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(29)
    rprompts = [rng.integers(0, rmodel.cfg.vocab_size, size=(8,)).astype(np.int32)
                for _ in range(5)]
    rcfg = EngineConfig(batch_slots=2, max_len=64)
    got = {}
    for dev, p in (("cpu", rparams), ("cuda", tree_map(lambda t: t.cuda(), rparams))):
        for cls in (DenseSlotEngine, ServeEngine):
            eng = cls(rmodel, p, rcfg, device=dev)
            rq = [Request(uid=i, prompt=x, max_new_tokens=10) for i, x in enumerate(rprompts)]
            for r in rq:
                eng.submit(r)
            eng.run()
            got[dev, cls.__name__] = [r.out_tokens for r in rq]
    if len({json.dumps(v) for v in got.values()}) != 1:
        raise SystemExit(f"chip_smoke: reduced dense/paged tokens differ: {got}")
    log("  reduced qwen2.5-3b, float32, 5 prompts of 8 tokens: dense = paged tokens, card = CPU")
    log(f"  phase 29: {time.perf_counter() - t_phase:.1f} s")
    return launches


def migrate_full_width(model, params, prompts, greedy, smi) -> dict[str, int]:
    """Phase 30 on phase 4's model and requests (32 new tokens, inline
    admission, ``swap_token_cost=0``): engine A takes the 16 requests, and
    after 6 steps every running request is ``export_request``ed, packed
    (``pack_payload``), pickled, unpacked and landed on engine B by
    ``migrate_put``/``migrate_signal``; then the same through
    ``checkpoint_request`` → ``shadow_put``/``shadow_signal`` of every
    in-flight request, A dropped, ``adopt_shadow`` on B.  Tokens equal phase
    4's, request for request; payload bytes and the export, wire, put and
    restore ms per request; B's pools keep their storage.  Returns the
    phase's launches."""
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_items
    from repro_torch.serve import AdmissionConfig, CacheConfig, EngineConfig, Request, ServeEngine
    from repro_torch.serve.cube_proc import pack_payload, unpack_payload

    t_phase = time.perf_counter()
    launches = dict.fromkeys(KERNELS, 0)
    cap = ops.paged_gather_table_cache()          # table entries one gather launch takes
    ecfg = EngineConfig(batch_slots=8, max_len=1024,
                        cache=CacheConfig(page_size=PS, swap_token_cost=0.0),
                        admission=AdmissionConfig(async_prefill=False))

    def ptrs(eng):
        return [t.data_ptr() for _, t in tree_items(eng.cache.pools)]

    def drain(eng):
        while eng.load or eng.pending_migrations():
            eng.step()
        return {r.uid: r.out_tokens for r in eng.completed}

    def started():
        eng = ServeEngine(model, params, ecfg, device="cuda")
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
        for _ in range(6):
            eng.step()
        return eng

    def wire(payload) -> tuple[dict, int, float]:
        t0 = time.perf_counter()
        blob = pickle.dumps(pack_payload(payload), protocol=pickle.HIGHEST_PROTOCOL)
        back = unpack_payload(pickle.loads(blob))
        return back, len(blob), (time.perf_counter() - t0) * 1e3

    for mode in ("migrate", "shadow"):
        ops.reset_launches()
        a, b = started(), ServeEngine(model, params, ecfg, device="cuda")
        before = ptrs(b)
        running = sorted(st.req.uid for st in a.sched.running.values())
        ms = {"read": [], "wire": [], "put": []}
        nbytes, moved, unread, want_gathers = [], [], [], 0
        gathers = ops.LAUNCHES["paged_gather"]
        for uid in (running if mode == "migrate" else a.inflight_uids()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload = (a.export_request(uid) if mode == "migrate"
                       else a.checkpoint_request(uid))
            ms["read"].append((time.perf_counter() - t0) * 1e3)
            if payload is None:          # mid-admission: no checkpoint to take
                unread.append(uid)
                continue
            moved.append(uid)
            if payload["kind"] == "pages":
                want_gathers += -(-payload["n_pages"] // cap)
            payload, n, wire_ms = wire(payload)
            nbytes.append(n)
            ms["wire"].append(wire_ms)
            t0 = time.perf_counter()
            if mode == "migrate":
                kind = b.migrate_put(uid, payload)
                b.migrate_signal(uid)
            else:
                kind = b.shadow_put(uid, payload)
                b.shadow_signal(uid)
            ms["put"].append((time.perf_counter() - t0) * 1e3)
            if kind != ("pages" if uid in running else "fresh"):
                raise SystemExit(f"chip_smoke: {mode}: request {uid} landed as {kind}")
        gathers = ops.LAUNCHES["paged_gather"] - gathers
        got = {}
        if mode == "shadow":
            del a                        # the cube dies: its shadows are adopted on B, and
            gc.collect()                 # requests without one resubmitted, as the router does
            for uid in moved:
                if not b.adopt_shadow(uid):
                    raise SystemExit(f"chip_smoke: shadow of request {uid} not adopted")
            for uid in unread:
                b.submit(Request(uid=uid, prompt=prompts[uid], max_new_tokens=32))
        else:
            got = drain(a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.step()                         # polls, restores every landed request, one decode
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        got.update(drain(b))
        for k in launches:
            launches[k] += ops.LAUNCHES[k]
        first_diff([got[i] for i in range(len(prompts))], greedy, f"{mode} run")
        if ptrs(b) != before:
            raise SystemExit(f"chip_smoke: {mode}: B's pools were reallocated")
        tel = b.telemetry()
        pages = [n for n, uid in zip(nbytes, moved) if uid in running]
        log(f"  {mode}: {len(moved)} requests ({len(running)} running, pages; "
            f"{len(unread)} mid-admission resubmitted), payloads "
            f"{min(pages) / 1e6:.2f}-{max(pages) / 1e6:.2f} MB pickled; per request "
            f"{'export' if mode == 'migrate' else 'checkpoint'} "
            f"{statistics.median(ms['read']):.2f} ms, wire (pack + pickle + unpack) "
            f"{statistics.median(ms['wire']):.2f} ms, put + signal "
            f"{statistics.median(ms['put']):.2f} ms (medians); paged_gather {gathers} launches "
            f"for the reads; B's first step after them (polls, restores "
            f"{tel['host_tier']['swap_ins']} requests, decodes) {first_ms:.1f} ms ({smi})")
        log(f"    B: migrate {tel['migrations']}; tokens identical to phase 4's, pools kept")
        if gathers != want_gathers:
            raise SystemExit(f"chip_smoke: {mode}: {gathers} paged_gather launches for the "
                             f"reads of {len(running)} running requests ({want_gathers} wanted)")
        del b
        gc.collect()
    log(f"  phase 30: {time.perf_counter() - t_phase:.1f} s")
    return launches


def cube_processes_on_card(smi) -> dict[str, int]:
    """Phase 31: ``CubeProcRouter`` with 2 worker processes on the card, each
    building reduced qwen2.5-3b as the JAX package's worker does (the
    reduced config, seed 0), every one on the same card.  Against a card
    engine built the same way in this process: 6 requests served; 6 more with
    ``drain_cube(0)`` right after their submission; 6 more with worker 0
    SIGKILLed after 3 more step reports (recovery_s, adopted and
    resubmitted uids logged).  Each worker counts its own launches from
    after its engine's build and ships them up with its telemetry; every
    worker must have launched paged_decode_attention, flash_attention and
    paged_write, and the workers together paged_gather (their checkpoints
    and the drain's export).  Returns the workers' launches: worker 0's up
    to its last telemetry before the kill, worker 1's to the end (the
    comparison engine in this process counts nothing)."""
    from repro_torch.configs import get_arch
    from repro_torch.serve import AdmissionConfig, CacheConfig, CubeProcRouter, EngineConfig, Request
    from repro_torch.serve.cube_proc import build_cube_engine

    t_phase = time.perf_counter()
    ecfg = EngineConfig(batch_slots=2, max_len=64,
                        cache=CacheConfig(page_size=4, n_pages=32, swap_token_cost=0.0),
                        admission=AdmissionConfig(async_prefill=False))
    cfg = get_arch("qwen2.5-3b").reduced()
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),)).astype(np.int32)
               for n in rng.integers(5, 20, size=18)]
    eng = build_cube_engine("qwen2.5-3b", ecfg, "cuda")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=24) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    want = {r.uid: r.out_tokens for r in reqs}
    del eng
    gc.collect()
    t0 = time.perf_counter()
    with CubeProcRouter("qwen2.5-3b", ecfg, n_cubes=2, checkpoint_every=2, device="cuda",
                        startup_timeout=240.0) as router:
        log(f"  2 workers up in {time.perf_counter() - t0:.1f} s (each its own CUDA context "
            "and captured step)")

        def batch(lo, during=None):
            for r in [Request(uid=i, prompt=prompts[i], max_new_tokens=24)
                      for i in range(lo, lo + 6)]:
                router.submit(r)
            extra = during() if during is not None else None
            t1 = time.perf_counter()
            done = router.run(timeout=120.0)
            got = {r.uid: r.out_tokens for r in done}
            if got != {u: want[u] for u in range(lo, lo + 6)}:
                raise SystemExit(f"chip_smoke: cube processes, requests {lo}-{lo + 5}: tokens "
                                 "differ from the single card engine's")
            return extra, time.perf_counter() - t1

        _, wall = batch(0)
        log(f"  6 requests over 2 workers: routed {router.routed}, tokens identical to the "
            f"single card engine's ({wall:.2f} s)")
        moved, wall = batch(6, lambda: router.drain_cube(0))
        log(f"  drain_cube(0) right after 6 more submissions moved {moved} to cube 1; tokens "
            f"identical ({wall:.2f} s)")
        worker = {c: tel["launches"] for c, tel in
                  ((c, router.telemetry()[f"pod{c}"]) for c in (0, 1))}
        for c, got in worker.items():
            log(f"  worker {c}'s launches so far: " + ", ".join(
                f"{k} {got[k]}" for k in KERNELS if got[k]))
            missing = [k for k in ("paged_decode_attention", "flash_attention", "paged_write")
                       if not got[k]]
            if missing:
                raise SystemExit(f"chip_smoke: cube worker {c} launched no {missing}")
        if not worker[0]["paged_gather"] + worker[1]["paged_gather"]:
            raise SystemExit("chip_smoke: no cube worker launched paged_gather (checkpoints, "
                             "drain export)")
        victim, base = 0, router.detector._count.get(0, 0)

        def chaos():
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                if router.detector._count.get(victim, 0) >= base + 3:
                    router.kill_cube(victim)
                    return
                time.sleep(0.002)

        killer = threading.Thread(target=chaos, daemon=True)
        _, wall = batch(12, killer.start)
        killer.join(timeout=10.0)
        deaths = [e for e in router.recovery_log if e["event"] == "cube_dead"]
        if len(deaths) != 1 or router.procs[victim].alive():
            raise SystemExit("chip_smoke: the killed worker was not recovered from")
        ev = deaths[0]
        if set(ev["adopted"]) | set(ev["resubmitted"]) != set(ev["stranded"]):
            raise SystemExit("chip_smoke: a stranded request was neither adopted nor resubmitted")
        tel = router.telemetry()
        log(f"  worker 0 SIGKILLed after 3 more step reports: stranded {ev['stranded']}, adopted "
            f"{ev['adopted']} (shadow checkpoints), resubmitted {ev['resubmitted']}, recovery_s "
            f"{ev['recovery_s']:.4f}; tokens identical ({wall:.2f} s); survivor's migrations "
            f"{tel['pod1']['migrations']} ({smi})")
        survivor = tel["pod1"]["launches"]
        if not all(survivor[k] > worker[1][k] for k in ("paged_decode_attention",
                                                         "flash_attention", "paged_write")):
            raise SystemExit("chip_smoke: the surviving worker launched no kernel while it "
                             "recovered the killed worker's requests")
        log("  worker 1's launches at the end: " + ", ".join(
            f"{k} {survivor[k]}" for k in KERNELS if survivor[k]))
    log(f"  phase 31: {time.perf_counter() - t_phase:.1f} s")
    return {k: worker[0][k] + survivor[k] for k in KERNELS}


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


def train_batches(cfg, seq: int, n: int = 4) -> list[dict]:
    """``n`` batches of 4 rows (numpy): tokens and targets from one seeded
    stream; for the vlm and the audio family also the synthetic stream's
    patches or frames of the same step, as ``SyntheticLMData`` makes them."""
    from repro_torch.data.pipeline import SyntheticLMData

    rng = np.random.default_rng(10)
    out = []
    for i in range(n):
        toks = rng.integers(0, cfg.vocab_size, size=(4, seq + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if cfg.family in ("vlm", "audio"):
            extra = SyntheticLMData(cfg, batch=4, seq=seq, device="cpu")._make(i)
            b.update({k: v for k, v in extra.items() if k in ("patches", "frames")})
        out.append(b)
    return out


def train_card_vs_cpu(arch: str, seq: int, **over) -> int:
    """Reduced ``arch`` in float32 (``over`` replaces config fields): 4
    steps of each optimizer with 1 and 2 microbatches from the same weights
    and batches (``train_batches``) on the card, through the captured
    training step (``CapturedTrainStep``: a warm-up step, then 3 replays of
    its graph), and on the CPU (the same step on its static buffers);
    losses and grad norms within 1e-4 relative at every step, parameters
    within 1e-4 (atol = rtol).  For the moe family a third run, eager on
    the card (``capture=False``: the recorder reads the router's
    probabilities back, which no capture may), gives the captured run's
    losses bit for bit, and its aux loss per step (the mean over its
    microbatches' forwards) is held within 1e-4 relative to the CPU's,
    logged on both sides, with the routing's expert choices compared call
    for call (``routing_flips``).  Returns the captured runs' ``stream_gd``
    launches."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.optim import get_optimizer
    from repro_torch.train.captured import CapturedTrainStep
    from repro_torch.train.train_step import make_train_step

    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("chip_smoke: TF32 matmuls are on; float32 would not be float32")
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **over)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    total = 0
    batches = train_batches(cfg, seq)
    moe = cfg.family == "moe"
    runs_of = ("cpu", "cuda", "eager") if moe else ("cpu", "cuda")
    for opt in ("sgd", "momentum", "adamw"):
        for n_micro in (1, 2):
            runs = {}
            for run in runs_of:
                dev = "cpu" if run == "cpu" else "cuda"
                o = get_optimizer(opt, **LR[opt])
                p = tree_map(lambda t, d=dev: t.to(d, copy=True), params)
                state = o.init(p)
                step = CapturedTrainStep(make_train_step(model, o, n_microbatches=n_micro), p,
                                         state, torch.device(dev), capture=run == "cuda")
                record = moe and run != "cuda"
                if record:
                    auxes, gates, undo = record_routing(model)
                ops.reset_launches()
                metrics = []
                try:
                    for b in batches:
                        p, state, mt = step(p, state,
                                            {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
                        metrics.append((float(mt["loss"]), float(mt["grad_norm"])))
                finally:
                    if record:
                        undo()
                aux = (np.array([float(a) for a in auxes]).reshape(len(batches), n_micro)
                       .mean(1) if record else None)
                runs[run] = (np.array(metrics), p, ops.LAUNCHES["stream_gd"], aux,
                             gates if record else None, step)
            (cm, cp, _, caux, cgates, _), (gm, gp, launches, _, _, gstep) = (runs["cpu"],
                                                                            runs["cuda"])
            rel = float(np.max(np.abs(gm - cm) / np.abs(cm)))
            perr = max(float(((a.cpu() - b).abs() / (1e-4 + 1e-4 * b.abs())).max())
                       for (_, a), (_, b) in zip(tree_items(gp), tree_items(cp)))
            log(f"  {opt}, {n_micro} microbatch(es): losses {['%.5f' % x for x in gm[:, 0]]}, "
                f"max rel diff of loss/grad norm {rel:.2e}, params at {perr:.3f} of the "
                f"1e-4 tolerance; {launches} stream_gd launches on the card (captured: "
                f"{gstep.replays} replays)")
            if rel > 1e-4 or perr > 1.0 or not np.isfinite(gm).all():
                raise SystemExit(f"chip_smoke: {opt} training on the card differs from the CPU")
            if gstep.graphs != 1 or gstep.replays != len(batches) - 1:
                raise SystemExit(f"chip_smoke: the card's training step made {gstep.graphs} "
                                 f"graph(s) and {gstep.replays} replays")
            if moe:
                em, _, _, gaux, ggates, _ = runs["eager"]
                if not np.array_equal(em, gm):
                    raise SystemExit(f"chip_smoke: {opt}: the captured step's losses "
                                     f"{gm[:, 0].tolist()} differ from the eager step's "
                                     f"{em[:, 0].tolist()}")
                aux_rel = float(np.max(np.abs(gaux - caux) / np.abs(caux)))
                flips = routing_flips(cgates, ggates, cfg.experts_per_token)
                log(f"    captured losses and grad norms = eager (card) bit for bit; aux loss "
                    f"per step: card {['%.7f' % x for x in gaux]}, CPU "
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
    steps under build/, the captured step): a crash injected at step 6
    restores step 4 and resumes to step 12 with the clean run's final loss;
    the restored state (new tensors) gets a captured step of its own."""
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
        out[label] = (*tr.run_with_restarts(0), tr.builds, tr.captured.replays)
    shutil.rmtree(root, ignore_errors=True)
    (fs, fr, fb, fp), (cs, cr, cb, cp) = out["faulty"], out["clean"]
    log(f"  Trainer with a crash at step 6: {fr} restart(s), step {fs.step}, last loss "
        f"{fs.losses[-1]:.6f}, {fb} captured steps built ({fp} replays on the restored state); "
        f"clean run: step {cs.step}, last loss {cs.losses[-1]:.6f}, {cb} built ({cp} replays)")
    if (fr, fs.step, cr, cs.step) != (1, 12, 0, 12) or \
            abs(fs.losses[-1] - cs.losses[-1]) > 1e-4 * abs(cs.losses[-1]):
        raise SystemExit("chip_smoke: crash -> restore -> resume did not reproduce the clean run")
    if (fb, fp, cb, cp) != (2, 7, 1, 11):
        raise SystemExit("chip_smoke: the restart did not capture a step of its own")


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
    """One more step of the Trainer ``tr`` under the profiler, eager
    (``cuda_graph=False``, so that its ``record_function`` ranges split it;
    the captured step is dropped first, and its graph's memory with it): its
    wall ms (profiler on) and ``profile_split``'s split."""
    tr.tcfg.total_steps = state.step + 1
    tr.tcfg.cuda_graph = False
    tr.captured = None
    gc.collect()
    torch.cuda.empty_cache()
    split = profile_split(lambda: tr.run(state), ranges)
    return state.step_s[-1] * 1e3, split


def log_split(wall_ms, split, step_ms, bytes_update, n_params, two_pass=False) -> None:
    """Print a profiled eager step: its device time beside the unprofiled
    step's wall ``step_ms``, forward+backward, the update against its bound
    (``bytes_update`` at 3.35 TB/s) and the rest."""
    busy = split["busy"]
    bound_update = bytes_update / HBM_BYTES_PER_S * 1e3
    fb = busy - split["update"] - split["accumulate"]
    log(f"  profiled step (eager, so that its ranges split it): {wall_ms:.1f} ms wall "
        f"(profiler on), device busy {busy:.1f} ms over {split['launches']} launches; the "
        f"unprofiled step {step_ms:.1f} ms wall")
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
    cap = tr.captured
    log(f"  stream_gd launches {launches} = {launches / steps:g} per step; captured step: "
        f"{cap.graphs} graph, capture {cap.capture_s:.2f} s, {cap.replays} replays")
    if state.step != steps or not all(np.isfinite(state.losses)):
        raise SystemExit(f"chip_smoke: full-width {arch} training gave a non-finite loss")
    if launches != steps or (cap.graphs, cap.replays) != (1, steps - 1):
        raise SystemExit(f"chip_smoke: {launches} stream_gd launches, {cap.graphs} graph(s), "
                         f"{cap.replays} replays in {steps} steps")
    del cap
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
    before = torch.cuda.memory_allocated()
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
        f"(training_bytes) {need / 1e9:.1f} GB; {before / 2**30:.2f} GiB allocated before the "
        "weights")
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
    cap = tr.captured
    log(f"  stream_gd launches {launches} = {launches / steps:g} per step; captured step: "
        f"{cap.graphs} graph, capture {cap.capture_s:.2f} s, {cap.replays} replays; "
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved at the peak")
    if state.step != steps or not all(np.isfinite(state.losses)):
        raise SystemExit(f"chip_smoke: {arch} training gave a non-finite loss")
    if launches != steps or (cap.graphs, cap.replays) != (1, steps - 1):
        raise SystemExit(f"chip_smoke: {launches} stream_gd launches, {cap.graphs} graph(s), "
                         f"{cap.replays} replays in {steps} steps")
    # where the memory peaks: one more batch's forward, then its backward,
    # eager, with the graph and its memory pool dropped first
    del cap
    tr.captured = None
    gc.collect()
    torch.cuda.empty_cache()
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


@contextlib.contextmanager
def expandable_segments():
    """The caching allocator's expandable segments for the block (phases 22
    and 23): with fixed segments deepseek-v3's captured step reserved 77.20
    GiB alone and 78.20 beside 1 GiB held, of the ~78.2 the card leaves
    PyTorch; with expandable segments 72.97 beside 1.5 GiB held (a CUDA
    graph's pool cannot take the general pool's cached blocks)."""
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    log("  (expandable segments on for this phase)")
    try:
        yield
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


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
    from repro_torch.train.captured import CapturedTrainStep

    steps = 6
    gc.collect()
    torch.cuda.empty_cache()
    layers = zoo.vgg16()
    exe = ConvNetExecutor(layers, impl="xla")
    opt = ex.make_optimizer("momentum")
    params = exe.init(torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
    state = opt.init(params)
    cuda = torch.device("cuda")
    step = CapturedTrainStep(ex.make_step(exe, opt), params, state, cuda, capture=True)
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
        batches.append({"x": torch.from_numpy(x).to("cuda", torch.bfloat16),
                        "y": torch.from_numpy(y).to("cuda")})
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
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, b)
        losses.append(float(metrics["loss"]))        # waits for the step
        step_s.append(time.perf_counter() - t0)
    launches = ops.LAUNCHES["stream_gd"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = statistics.median(step_s[1:]) * 1e3
    log(f"  losses {['%.4f' % x for x in losses]}")
    log(f"  step {step_ms:.2f} ms (median of steps 2-{steps}; first step "
        f"{step_s[0] * 1e3:.1f} ms) = {CNN_TRAIN_BATCH / step_ms * 1e3:.1f} trained images/s, "
        f"peak device memory {peak:.2f} GiB, {held:.2f} GiB of it held before the steps; "
        f"stream_gd launches {launches} = {launches / steps:g} per step ({smi}); captured "
        f"step: {step.graphs} graph, capture {step.capture_s:.2f} s, {step.replays} replays")
    if not all(np.isfinite(losses)):
        raise SystemExit("chip_smoke: full-width VGG16 training gave a non-finite loss")
    if launches != steps or (step.graphs, step.replays) != (1, steps - 1):
        raise SystemExit(f"chip_smoke: {launches} stream_gd launches, {step.graphs} graph(s), "
                         f"{step.replays} replays in {steps} steps")
    # the profiled step runs eagerly on static buffers of its own
    del step
    eager = CapturedTrainStep(ex.make_step(exe, opt), params, state, cuda, capture=False)
    t0 = time.perf_counter()
    split = profile_split(lambda: eager(params, state, batches[0]))
    wall_ms = (time.perf_counter() - t0) * 1e3
    log_split(wall_ms, split, step_ms, update_bytes(leaves), n_params)

    n = 16
    kexe = ConvNetExecutor(layers)                    # impl="kernel"
    x16 = batches[-1]["x"][:n]
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
    del params, state, batches, data, eager
    torch.cuda.empty_cache()
    return {"stream_gd": launches, **run}


# ---------------------------------------------------------------------------
# phases 37 and 38: the captured training step
# ---------------------------------------------------------------------------

# captured, eager, eager, captured: host-bound steps move 1.4-1.8x between
# calls, so the two modes are compared in turns within one
TRAIN_TURNS = (True, False, False, True)


def params_digest(tree) -> list[int]:
    """Per leaf, the sum of its elements' bit patterns as integers: equal
    for two runs that agree bit for bit (a fingerprint, where two full-width
    trees do not fit on the card together)."""
    from repro_torch.models.common import tree_items

    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return [int(t.detach().view(ints[t.element_size()]).sum(dtype=torch.int64))
            for _, t in tree_items(tree)]


def profiled_step(fn) -> tuple[float, float]:
    """(device-busy ms, kernel launches) of one call of ``fn`` from the
    profiler, its ``record_function`` ranges left out (an eager step's
    ``train_step.*`` ranges show as device spans over their kernels), taken
    again up to three times where a profile comes back without device
    records; (0, 0) where all three did."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        busy, n = 0.0, 0
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA") \
                    and not e.key.startswith(("train_step.", "ProfilerStep")):
                busy += e.self_device_time_total / 1e3
                n += e.count
        if busy:
            return busy, n
    return 0.0, 0


def training_turns(label: str, setup, steps: int, smi) -> int:
    """``TRAIN_TURNS``' runs of ``setup(cuda_graph)`` -> (step, captured,
    params, stream_gd launches per step), where ``step()`` makes one training
    step and returns its loss as a float and ``captured()`` is the
    ``CapturedTrainStep`` it goes through: each run from the same seeded
    weights over the same batches, ``steps`` steps, then, in the first run of
    each mode, one more step under the profiler (device-busy ms and
    launches).  Logs per run the losses, the step's wall ms (median of steps
    2-N), the first step's (with the warm-up and the capture), the capture's
    seconds, the stream_gd launches and peak device memory (allocated by the
    run, and reserved); fails unless every run's losses and final weights
    (``params_digest``) equal the first run's bit for bit, with one
    stream_gd launch per step where the optimizer has one.  Returns the
    stream_gd launches of the compared steps."""
    from repro_torch.kernels import ops

    runs = []
    for cuda_graph in TRAIN_TURNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        step, captured, params, gd_per_step = setup(cuda_graph)
        ops.reset_launches()
        losses, wall = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step())
            wall.append(time.perf_counter() - t0)
        gd = ops.LAUNCHES["stream_gd"]
        cap = captured()
        r = dict(graph=cuda_graph, losses=losses, digest=params_digest(params),
                 step_ms=statistics.median(wall[1:]) * 1e3, first_ms=wall[0] * 1e3,
                 capture_s=cap.capture_s, graphs=cap.graphs, replays=cap.replays, stream_gd=gd,
                 peak=(torch.cuda.max_memory_allocated() - held) / 2**30,
                 reserved=torch.cuda.max_memory_reserved() / 2**30, busy=None, launches=None,
                 profiled=not any(o["graph"] == cuda_graph for o in runs))
        if r["profiled"]:
            busy, n = profiled_step(step)
            if busy:
                r["busy"], r["launches"] = 100 * busy / r["step_ms"], n
        runs.append(r)
        del step, captured, params, cap
        if gd != gd_per_step * steps:
            raise SystemExit(f"chip_smoke: {label}: {gd} stream_gd launches in {steps} steps")
        if cuda_graph and (r["graphs"], r["replays"]) != (1, steps - 1):
            raise SystemExit(f"chip_smoke: {label}: the captured run made {r['graphs']} graph(s) "
                             f"and {r['replays']} replays")
    for i, r in enumerate(runs):
        mode = "captured" if r["graph"] else "eager"
        busy = (f"busy {r['busy']:.1f} % over {r['launches']:.0f} launches (a profiled step)"
                if r["busy"] is not None else "busy not measured (no device records)"
                if r["profiled"] else "not profiled")
        cap = f", capture {r['capture_s']:.2f} s" if r["graph"] else ""
        log(f"    run {i + 1}, {mode}: losses {['%.6f' % x for x in r['losses']]}; step "
            f"{r['step_ms']:.2f} ms (median of steps 2-{steps}; first {r['first_ms']:.1f} ms"
            f"{cap}); {busy}; {r['stream_gd']} stream_gd launches; peak {r['peak']:.2f} GiB "
            f"allocated by the run, {r['reserved']:.2f} GiB reserved")
    same = [r["losses"] == runs[0]["losses"] for r in runs]
    weights = [r["digest"] == runs[0]["digest"] for r in runs]
    cap = statistics.mean(r["step_ms"] for r in runs if r["graph"])
    eag = statistics.mean(r["step_ms"] for r in runs if not r["graph"])
    log(f"    {label}: losses bit-equal to run 1's {same}, final weights {weights}; step "
        f"captured {cap:.2f} ms, eager {eag:.2f} ms (eager / captured {eag / cap:.2f}) ({smi})")
    if not all(same) or not all(weights):
        raise SystemExit(f"chip_smoke: {label}: the runs differ (captured, eager, eager, "
                         f"captured: losses {same}, weights {weights})")
    return sum(r["stream_gd"] for r in runs)


def trainer_setup(model, cfg, optimizer: str, lr: float, batch: int, seq: int, n_micro: int):
    """``training_turns``' setup for a ``Trainer`` on the card: weights from
    seed 0, ``SyntheticLMData`` from seed 0, one ``Trainer.run`` per step."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def setup(cuda_graph):
        data = SyntheticLMData(cfg, batch=batch, seq=seq, device="cuda")
        tr = Trainer(model, data, TrainerConfig(
            total_steps=0, optimizer=optimizer, lr=lr, n_microbatches=n_micro,
            log_every=10**9, cuda_graph=cuda_graph), device="cuda")
        state = tr.init_state(0)

        def step():
            tr.tcfg.total_steps = state.step + 1
            tr.run(state)
            return state.losses[-1]

        return step, lambda: tr.captured, state.params, 0 if optimizer == "adamw" else 1

    return setup


def training_captured_vs_eager(ex, smi) -> int:
    """Phase 37: the captured training step against the eager one
    (``cuda_graph=False``), ``TRAIN_TURNS``' runs from the same weights over
    the same batches (``training_turns``): reduced qwen2.5-3b in float32
    (sgd, momentum, adamw; 1 and 2 microbatches; 4 steps a run), full-width
    qwen2.5-3b (momentum, 8 x 1,024 in 4 microbatches, as phase 11) and
    full-width mamba2-130m (momentum, 16 x 1,024 in 8 microbatches, as phase
    14), 3 steps a run, each through ``Trainer``, and full-width VGG16
    through the ConvNet example's step (momentum, batch 32, as phase 13; 4
    steps).  Returns the stream_gd launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core import zoo
    from repro_torch.core.convnet import ConvNetExecutor
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.models import build_model
    from repro_torch.train.captured import CapturedTrainStep

    total = 0
    cfg = dataclasses.replace(get_arch("qwen2.5-3b").reduced(), dtype="float32")
    model = build_model(cfg)
    for opt in ("sgd", "momentum", "adamw"):
        for n_micro in (1, 2):
            log(f"  reduced qwen2.5-3b in float32, {opt}, {n_micro} microbatch(es) of 4 x 32 "
                f"tokens:")
            total += training_turns(
                f"reduced qwen2.5-3b, {opt}, {n_micro} microbatch(es)",
                trainer_setup(model, cfg, opt, LR[opt].get("lr", 3e-4), 4, 32, n_micro), 4, smi)
    for arch, batch in (("qwen2.5-3b", 8), ("mamba2-130m", 16)):
        cfg = get_arch(arch)
        log(f"  full-width {arch} (bf16, momentum, {batch} x 1,024 tokens in "
            f"{cfg.train_microbatches} microbatches, remat {cfg.remat}):")
        total += training_turns(
            f"full-width {arch}",
            trainer_setup(build_model(cfg), cfg, "momentum", 1e-4, batch, 1024,
                          cfg.train_microbatches), 3, smi)
    exe = ConvNetExecutor(zoo.vgg16(), impl="xla")
    data = SyntheticImageData(px=224, channels=3, classes=1000, batch=CNN_TRAIN_BATCH)
    batches = []
    for _ in range(5):
        x, y = data.next()
        batches.append({"x": torch.from_numpy(x).to("cuda", torch.bfloat16),
                        "y": torch.from_numpy(y).to("cuda")})

    def vgg_setup(cuda_graph):
        opt = ex.make_optimizer("momentum")
        params = exe.init(torch.Generator(device="cuda").manual_seed(0), "cuda", torch.bfloat16)
        state = opt.init(params)
        step = CapturedTrainStep(ex.make_step(exe, opt), params, state, torch.device("cuda"),
                                 capture=cuda_graph)
        feed = iter(batches)

        def one():
            return float(step(params, state, next(feed))[2]["loss"])

        return one, lambda: step, params, 1

    log(f"  full-width VGG16 (224 x 224, bf16, float32 momentum, batch {CNN_TRAIN_BATCH}, "
        "impl='xla', the ConvNet example's step):")
    total += training_turns("full-width VGG16", vgg_setup, 4, smi)
    del batches
    return total


# phase 38: whisper-large-v3 at full depth; llava-next-mistral-7b cut in
# depth for the phase's time (under sgd its 7.3 B parameters' weights and
# gradients alone, ~29 GB, would fit)
AUDIO_TRAIN = dict(batch=4, seq=448)
VLM_TRAIN = dict(over=dict(n_layers=8), batch=2, seq=512)


def train_families_full_width(smi) -> int:
    """Phase 38's published widths, 6 captured sgd steps each:
    whisper-large-v3 through the launcher (``--full``: bf16, remat full,
    ``AUDIO_TRAIN``'s rows of 1,500 frames and 448 tokens in
    ``train_microbatches`` microbatches) and llava-next-mistral-7b cut to
    ``VLM_TRAIN``'s depth through ``Trainer`` (rows of 2,880 patches and 512
    tokens, 1 microbatch): every loss finite, one ``stream_gd`` launch per
    step, one graph replayed from step 2; losses, step ms (median of steps
    2-6), the first step's (the warm-up and the capture), a replay's
    device-busy share and launches, peak memory.  Returns the stream_gd
    launches."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.train import training_bytes
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_items
    from repro_torch.train.trainer import Trainer, TrainerConfig

    steps, total = 6, 0
    for arch in ("whisper-large-v3", "llava-next-mistral-7b"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        if arch == "whisper-large-v3":
            tr, state, _ = train_main(
                ["--arch", arch, "--full", "--optimizer", "sgd", "--steps", str(steps),
                 "--batch", str(AUDIO_TRAIN["batch"]), "--seq", str(AUDIO_TRAIN["seq"]),
                 "--lr", "1e-4"])
            cfg, cut = tr.model.cfg, "none: full depth"
            rows = (f"{AUDIO_TRAIN['batch']} rows of {cfg.encoder.n_ctx} frames + "
                    f"{AUDIO_TRAIN['seq']} tokens")
        else:
            full = get_arch(arch)
            cfg = dataclasses.replace(full, **VLM_TRAIN["over"])
            cut = ", ".join(f"{k}: {getattr(full, k)} -> {v}" for k, v in VLM_TRAIN["over"].items())
            rows = (f"{VLM_TRAIN['batch']} rows of {cfg.vision.n_image_tokens} patches + "
                    f"{VLM_TRAIN['seq']} tokens")
            data = SyntheticLMData(cfg, batch=VLM_TRAIN["batch"], seq=VLM_TRAIN["seq"],
                                   device="cuda")
            tr = Trainer(build_model(cfg), data, TrainerConfig(
                total_steps=steps, optimizer="sgd", lr=1e-4, log_every=100), device="cuda")
            state = tr.run(tr.init_state(0))
        torch.cuda.synchronize()
        launches = ops.LAUNCHES["stream_gd"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        reserved = torch.cuda.max_memory_reserved() / 2**30
        cap = tr.captured
        graphs, replays = cap.graphs, cap.replays
        n_params = sum(t.numel() for _, t in tree_items(state.params))
        step_ms = statistics.median(state.step_s[1:]) * 1e3
        need = training_bytes(tr.model, "sgd", tr.tcfg.n_microbatches)
        log(f"  {arch}: reduced = {{{cut}}}; {cfg.n_layers} layers"
            + (f" + {cfg.encoder.n_layers} encoder layers" if cfg.encoder else "")
            + f", d_model {cfg.d_model}, vocab {cfg.vocab_size}, remat {cfg.remat}; "
            f"{n_params / 1e9:.3f} B parameters; sgd, {rows} in {tr.tcfg.n_microbatches} "
            f"microbatch(es); training_bytes {need / 1e9:.1f} GB")
        log(f"    losses {['%.4f' % x for x in state.losses]}")

        def one_more():
            tr.tcfg.total_steps = state.step + 1
            tr.run(state)

        busy, n = profiled_step(one_more)
        share = (f"a replay: device busy {busy:.1f} ms = {100 * busy / step_ms:.1f} % of the "
                 f"step, {n:.0f} launches" if busy else "busy not measured (no device records)")
        log(f"    step {step_ms:.1f} ms (median of steps 2-{steps}; first step "
            f"{state.step_s[0] * 1e3:.1f} ms with the warm-up and the capture, "
            f"{cap.capture_s:.2f} s), {graphs} graph, {replays} replays; {share}; peak device "
            f"memory {peak:.2f} GiB allocated, {reserved:.2f} GiB reserved; stream_gd "
            f"launches {launches} ({smi})")
        if state.step < steps or not all(np.isfinite(state.losses)):
            raise SystemExit(f"chip_smoke: {arch} training gave a non-finite loss")
        if (launches, graphs, replays) != (steps, 1, steps - 1):
            raise SystemExit(f"chip_smoke: {arch}: {launches} stream_gd launches, {graphs} "
                             f"graph(s), {replays} replays in {steps} steps")
        total += launches
        del tr, state, cap
        gc.collect()
        torch.cuda.empty_cache()
    return total


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
               ("qwen3-moe served", QM["h"], QM["hkv"], PAGED_SERVED_MOE, 2048 // PS, False),
               ("llava served", LLAVA["h"], LLAVA["hkv"], PAGED_SERVED_LLAVA, 1024 // PS, False)]


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
    use_roofline()
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
    log("  the captured chunked prefill's flash calls, q_offset and kv_len read on the card "
        "(K/V over the whole slot) against the host-offset form and SDPA:")
    for label, shape in FLASH_OFFSET.items():
        flash_offset_case(label, **shape)
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
    log(f"  the vlm and audio families: whisper-large-v3's non-causal encoder ({WHISPER['n_ctx']} "
        f"x {WHISPER['n_ctx']}) and cross-attention ({WHISPER['prompt']} queries over the "
        f"frames), H = Hkv = {WHISPER['h']}, D = {WHISPER['d']}, {WHISPER['batch']} requests; "
        f"llava-next-mistral-7b's image + text prefill ({LLAVA['image'] + LLAVA['text']} causal "
        f"tokens, H {LLAVA['h']} over Hkv {LLAVA['hkv']}, D = {D}) and its paged decode (rep "
        f"{LLAVA['h'] // LLAVA['hkv']}) at its served contexts:")
    for dtype in (torch.float32, torch.bfloat16):
        timed = dtype == torch.bfloat16
        for label in ("whisper encoder", "whisper cross", "llava prefill"):
            row = flash_case(dtype, label, timed=timed, turns=True, **FLASH_SERVED[label])
            if row:                 # logged, not in the JSON line
                log_row(row)
            if row and label in FLASH_D64_BEFORE:
                ev, dev, host, sdpa_ev, sdpa_dev = FLASH_D64_BEFORE[label]
                log(f"    before, on mma.sync 64x64: event {ev:.4f}, device "
                    f"{dev:.4f}, host {host:.4f} ms against SDPA's {sdpa_ev:.4f} / "
                    f"{sdpa_dev:.4f}; now {ops.PATHS['flash_attention']}: device "
                    f"{row['device_ms']:.4f} ms = {dev / row['device_ms']:.2f}x faster, "
                    f"{row['device_ms'] / row['library_device_ms']:.3f} of SDPA's device time")
        row = paged_case(dtype, timed, LLAVA["h"], LLAVA["hkv"], "llava served",
                         lens=PAGED_SERVED_LLAVA, slots=1024 // PS, holes=False, floor=floor)
        if row:
            log_row(row)
    log("  bf16 head dim 64, each design's contract (wgmma + TMA above 16 query rows per KV "
        "head, the split-key cluster at or below):")
    for label, case in FLASH_D64.items():
        flash_case(torch.bfloat16, f"D 64 {label}", timed=False, d=64, **case)
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
    log("  paged_write, one launch per call (the decode step's drop-mode write, beyond the "
        "TPU set), full-width qwen2.5-3b pools, 8 lanes:")
    for dtype in (torch.float32, torch.bfloat16):
        for label, layers, n_pools in WRITE_CASES:
            row = paged_write_case(dtype, dtype == torch.bfloat16, label, layers, n_pools)
            if row:
                log_row(row)
                rows.setdefault("paged_write", row)      # the JSON line keeps one layer's
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
    reqs, run, eng = serve_full_width(model, params, qwen_prompts, ecfg,
                                      SERVE_KERNELS + ("paged_write",), smi)
    launches = {k: run[k] for k in SERVE_KERNELS + ("paged_write",)}
    runs = decode_runs(eng, "phase 4")
    log(f"  {runs - 1} decode steps (graph replays) + 1 warm-up, paged_decode_attention "
        f"{run['paged_decode_attention']} launches, paged_write {run['paged_write']} "
        f"({cfg.n_layers} layers)")
    if run["paged_decode_attention"] != cfg.n_layers * runs \
            or run["paged_write"] != run["paged_decode_attention"]:
        raise SystemExit("chip_smoke: paged_decode_attention and paged_write should launch "
                         "once per layer per decode step")
    paged_tokens = [r.out_tokens for r in reqs]
    # the engine's first token agrees with a direct prefill, whose logits are finite
    logits, _ = model.prefill(params, torch.as_tensor(qwen_prompts[0],
                                                      device="cuda")[None].long())
    if logits.shape != (1, 1, cfg.padded_vocab) or not torch.isfinite(logits).all():
        raise SystemExit(f"chip_smoke: bad prefill logits {tuple(logits.shape)}")
    if int(logits[0, -1].argmax()) != reqs[0].out_tokens[0]:
        raise SystemExit("chip_smoke: engine's first token differs from a direct prefill")
    log("  prefill logits finite, shape (1, 1, V); first token matches the engine")
    decode_breakdown(model, params, cfg.vocab_size, eager=EAGER_STEP["qwen2.5-3b"])

    # -- phases 25 and 26 (on phase 4's model) ------------------------------------
    log(f"== phase 25: full-width qwen2.5-3b under page pressure ({PRESSURE_PAGES} pages of "
        f"{PS}), unpressured, swap and recompute")
    run, swap_tokens, swap_wall = serve_under_pressure(model, params, qwen_prompts, smi)
    for name, n in run.items():
        launches[name] = launches.get(name, 0) + n      # every kernel's key from here
    log("== phase 26: full-width qwen2.5-3b prefix sharing (a 512-token system prompt, "
        "256-token chunks, async admission)")
    run, shared_prompts, shared_tokens = serve_shared_prefix(model, params, smi)
    for name, n in run.items():
        launches[name] += n
    log("== phase 27: full-width qwen2.5-3b observability and request semantics (tracer "
        "cost, the sanitizer under page pressure, profiler ranges, sampling, eos_id, "
        "admission_inflight)")
    for name, n in obs_and_semantics(model, params, qwen_prompts, paged_tokens, swap_tokens,
                                     swap_wall, smi).items():
        launches[name] += n
    log("== phase 28: full-width qwen2.5-3b, the captured decode step against the eager one "
        "(cuda_graph=False)")
    for name, n in captured_vs_eager(model, params, qwen_prompts, paged_tokens, smi).items():
        launches[name] += n
    log("== phase 29: full-width qwen2.5-3b routed over two in-process cubes (CubeRouter: "
        "hash, least_loaded, prefix_affinity) and the dense reference engine")
    for name, n in route_full_width(model, params, qwen_prompts, paged_tokens, shared_prompts,
                                    shared_tokens, smi).items():
        launches[name] += n
    log("== phase 30: full-width qwen2.5-3b migration between engines (export_request -> "
        "migrate_put/signal; checkpoint_request -> shadow_put/signal -> adopt_shadow)")
    for name, n in migrate_full_width(model, params, qwen_prompts, paged_tokens, smi).items():
        launches[name] += n
    log("== phase 34: full-width qwen2.5-3b chunked prefill (256-token chunks, async "
        "admission), the captured extend against the eager one (cuda_graph=False)")
    for name, n in chunked_captured_vs_eager(model, params, qwen_prompts, smi).items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    log("== phase 35: the kernel autotuner on the card (repro_torch.tune: four canonical "
        "cutouts, every config against the default, a tuned full-width mamba2-130m prefill)")
    for name, n in tuner_on_card(smi).items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    log("== phase 36: the port's repro-lint on this machine, its capture closure against the "
        "functions the card enters while capturing, a seeded host read")
    for name, n in lint_on_card(model, params, args.src, smi).items():
        launches[name] += n
    # phase 4's engine holds the weights and its pools (~7 GiB): the training
    # phases' graphs need that room (phase 23 captures within 2 GiB of the card)
    del model, params, eng, reqs, logits
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 5 ----------------------------------------------------------------
    log("== phase 5: narrow VGG16 (channels / 16, 32 px) in float32, card against CPU")
    vgg16_card_vs_cpu(narrow_convnet(zoo.vgg16(), channel_div=16, input_px=32), 8, 32)

    # -- phase 6 ----------------------------------------------------------------
    log(f"== phase 6: full-width VGG16 (224 x 224, batch {CNN_BATCH}, bf16, random weights) "
        "on the card")
    for name, n in vgg16_forward(smi).items():
        launches[name] += n
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
    reqs, run, eng = serve_full_width(model, params, prompts, ecfg, ("ssd_scan",), smi)
    launches["ssd_scan"] += run["ssd_scan"]
    slices, tails = extend_runs(eng, "mamba2-130m")
    log(f"  {decode_runs(eng, 'mamba2-130m') - 1} decode steps (graph replays) + 1 warm-up; "
        f"{slices - 1} full prefill chunks (graph replays) + 1 warm-up, {tails} tails (eager)")
    if run["ssd_scan"] != cfg.n_layers * (slices + tails):
        raise SystemExit(f"chip_smoke: {run['ssd_scan']} ssd_scan launches, expected one per "
                         "layer per prefill chunk (a replay counts its captured launches)")
    cache = tree_map(lambda sp: torch.zeros(sp.shape, dtype=sp.dtype, device="cuda"),
                     model.cache_specs(1, len(prompts[0])))
    toks = torch.as_tensor(prompts[0], device="cuda")[None].long()
    for i in range(0, toks.shape[1], SSM["chunk"]):
        logits, cache = model.extend_step(params, cache, toks[:, i:i + SSM["chunk"]], i,
                                          last_only=True)
    if logits.shape != (1, 1, cfg.padded_vocab) or not torch.isfinite(logits).all():
        raise SystemExit(f"chip_smoke: bad mamba2 prefill logits {tuple(logits.shape)}")
    if int(logits[0, -1].argmax()) != reqs[0].out_tokens[0]:
        raise SystemExit("chip_smoke: mamba2 engine's first token differs from a direct "
                         "chunked prefill")
    log("  chunked-prefill logits finite; first token matches the engine")
    prefill_ms(model, params, cfg.vocab_size, 512, SSM["chunk"], group="ssd_scan")
    log("  (eager, every slice's logits); the engine's chunk, captured against the same "
        "static-buffer step run eagerly:")
    chunk_vs_eager(model, params, cfg.vocab_size, SSM["chunk"], SSM["chunk"], 1024, smi)
    decode_breakdown(model, params, cfg.vocab_size, prefill_chunk=SSM["chunk"],
                     eager=EAGER_STEP["mamba2-130m"])
    log("  (the decode step runs no port kernel: ssm_decode is plain torch, as the "
        "JAX package leaves it to XLA; it is one graph replay)")
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
    reqs, run, eng = serve_full_width(model, params, qwen_prompts, ecfg,
                                      ("paged_gather", "paged_write"), smi)
    runs = decode_runs(eng, "gather path")
    for name in ("paged_gather", "paged_write"):    # phases 25 and 26 counted before
        launches[name] += run[name]
    log(f"  {runs - 1} decode steps (graph replays) + 1 warm-up, paged_gather "
        f"{run['paged_gather']} launches, paged_write {run['paged_write']}")
    if run["paged_gather"] != runs or run["paged_write"] != runs:
        raise SystemExit("chip_smoke: the gather path should launch one paged_gather and one "
                         "paged_write per decode step (every seq leaf in one launch)")
    same = sum(r.out_tokens == t for r, t in zip(reqs, paged_tokens))
    log(f"  {same}/{len(reqs)} requests gave the paged path's tokens (bf16: the plain "
        "decode attention rounds otherwise than the paged kernel)")
    paged_ms = decode_breakdown(model, params, cfg.vocab_size, profile=False)
    gather_ms = decode_breakdown(model, params, cfg.vocab_size, decode_path="gather")
    log(f"  decode step, same call: paged {paged_ms:.3f} ms, gather {gather_ms:.3f} ms "
        f"({gather_ms / paged_ms:.2f}x)")
    del model, params
    release_lingering_engines()

    # -- phase 10 ---------------------------------------------------------------
    log("== phase 10: reduced qwen2.5-3b training in float32, card against CPU")
    train_card_vs_cpu("qwen2.5-3b", 32)
    train_fault_on_card()

    # -- phase 11 ---------------------------------------------------------------
    log("== phase 11: full-width qwen2.5-3b training (bf16, random weights, momentum) "
        "on the card")
    n, tr, state = train_full_width(smi, "qwen2.5-3b", 8, 1024, "1e-4")
    launches["stream_gd"] += n
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
    for name in ("flash_attention", "paged_gather", "paged_write"):
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
        for name in ("flash_attention", "paged_gather", "paged_decode_attention",
                     "paged_write"):
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
        with expandable_segments():
            n, flash = train_moe_full_width(smi, arch)
        launches["stream_gd"] += n
        launches["flash_attention"] += flash

    # -- phase 24 -------------------------------------------------------------------
    log("== phase 24: the memory tiers, reduced qwen2.5-3b, mamba2-130m, recurrentgemma-9b "
        "and deepseek-v3-671b in float32, card against CPU")
    for name, n in tiers_card_vs_cpu(smi).items():
        launches[name] += n

    # -- phases 32 and 33 -------------------------------------------------------------
    log("== phase 32: reduced llava-next-mistral-7b and whisper-large-v3 in float32, card "
        "against CPU")
    multimodal_card_vs_cpu(smi)
    log("== phase 33: llava-next-mistral-7b at published widths (bf16, random weights) on the "
        "card")
    for name, n in serve_llava(smi).items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    log("== phase 33: whisper-large-v3 at published widths (bf16, random weights) on the card")
    for name, n in serve_whisper(smi).items():
        launches[name] += n
    gc.collect()
    torch.cuda.empty_cache()

    # -- phases 37 and 38 -------------------------------------------------------------
    log("== phase 37: the captured training step against the eager one (cuda_graph=False), in "
        "turns: reduced qwen2.5-3b, full-width qwen2.5-3b, mamba2-130m and VGG16")
    launches["stream_gd"] += training_captured_vs_eager(ex, smi)
    gc.collect()
    torch.cuda.empty_cache()
    log("== phase 38: llava-next-mistral-7b and whisper-large-v3 training: reduced in float32, "
        "card against CPU; published widths (llava cut in depth), captured")
    for arch, seq in (("llava-next-mistral-7b", 32), ("whisper-large-v3", 32)):
        log(f"  reduced {arch} in float32, card against CPU ({seq} tokens a row):")
        launches["stream_gd"] += train_card_vs_cpu(arch, seq)
    launches["stream_gd"] += train_families_full_width(smi)

    # -- phase 31 -------------------------------------------------------------------
    log("== phase 31: cube worker processes on the card (CubeProcRouter, 2 workers, reduced "
        "qwen2.5-3b), a drain and a killed worker")
    for name, n in cube_processes_on_card(smi).items():
        launches[name] += n

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
