// Blocked causal GQA attention (flash attention forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (function at :87, `pl.pallas_call` at
// :115, body `_attn_kernel` at :23), reached from `ops.flash_attention` in
// src/repro/kernels/ops.py.
//
// What it computes: q (B, H, Sq, D) against k, v (B, Hkv, Sk, D); head h
// reads KV head h / (H / Hkv).  Key kpos is visible to query row i when
// kpos < kv_len, and, when asked, qpos >= kpos (causal) and
// qpos - kpos < window, where qpos = i + q_offset.  Softmax is online with
// float accumulation; a row with no visible key writes zeros.  causal,
// window, q_offset and kv_len are run-time arguments, so chunked prefill
// (a nonzero offset against a capacity-length cache) runs the same binary;
// q_offset and kv_len may instead come from an int32 pair on the device,
// read at kernel entry, so that one launch captured in a CUDA graph serves
// every chunk offset.
// q, k and v are read through strides (the model's (B, S, H, D)
// projections go in as (B, H, S, D) views) and the output is written
// through strides into the (B, Sq, H, D) storage the wrapper allocates.
//
// What bounds it on the H100 (3.35 TB/s, 989 dense bf16 Tflop/s): a prompt
// reads q, k, v once and writes the output once and does 4 * H * D flops
// per visible (q, k) pair.  At the served shapes in bf16:
//   qwen2.5-3b prefill, 512 tokens, H 16 over Hkv 2, D 128:  bytes, 1.41 us
//     (the flops, 1.09 us, are close);
//   qwen3-moe prompt, 1,024 tokens, H 64 over Hkv 4, D 128: operations,
//     17.2 GFLOP = 17.4 us;
//   deepseek-v3 MLA prompt, 1,024 tokens, H = Hkv = 128, D 192 (V zero-
//     padded to 192): bytes, 201 MB = 60 us (the flops 52 us);
//   recurrentgemma-9b prompt, 3,072 tokens, H 16 over Hkv 1, D 256, window
//     2,048: operations, 68.7 GFLOP = 69.5 us; its 1,024-token chunk at
//     offset 2,048 against kv_len 3,072: operations, about 35 us;
//   whisper-large-v3's encoder, 8 x 1,500 frames, H = Hkv = 20, D 64,
//     non-causal: operations, 92.2 GFLOP = 93.2 us; at D 64 a score costs
//     as many special-function-unit cycles (its 2^x) as tensor-core cycles
//     (its 256 flops), so the softmax has to overlap the products;
//   whisper's cross-attention, its 4-token prompt over the 1,500 frames:
//     bytes, K and V 61.4 MB = 18.4 us, on only 160 (batch, head) pairs.
// So the served shapes need the tensor cores at their full rate, and K/V
// loads that overlap them.
//
// Four designs, chosen by dtype, head_dim and the query rows per KV head
// (`ops.flash_path` holds the table; `ops.PATHS["flash_attention"]` names
// the one a card call took):
//
// wgmma + TMA (bf16 at head dims 64, 128, 192, 256 with more than 16 query
// rows per KV head at 64).  One block of a producer warpgroup and two
// consumer warpgroups per 128 query rows of one head (three per 192 at
// D 64, where O and S leave room for a third).  The grid runs the
// heaviest q tiles (the last, under a causal mask) first, and the query
// heads of one KV head next to each other, so the rep heads that read the
// same K/V tiles run together and share them in L2.  One producer thread
// loads the block's Q (once) and its K and V tiles by TMA, through 4-D
// tensor maps over the strided (D, S, H, B) views with the 128-byte
// swizzle, into a ring of 2-3 stages with a full barrier each for K and for
// V and an empty barrier the consumers release; the map's position extent
// is min(Sk, kv_len), so rows past kv_len, Sk or Sq come back zero-filled
// (no copy pads them) and only the mask sees them.  With the device pair the
// extent is Sk: rows between kv_len and Sk are read as they lie, and the
// mask gives them P = 0 exactly, so finite values there change nothing.  Two consumer
// warpgroups own 64 query rows each: S = Q K^T is one warpgroup product
// (wgmma m64nBNk16, Q and K both from swizzled shared memory, K read
// K-major), the online softmax runs on S in registers (exp2, the scale
// folded in), P is rounded to bf16 in registers and O += P V is a second
// warpgroup product with P as the register A operand and V read as a
// transposed (N-major) B operand, O (64 x D float) staying in registers.
// Registers: at D 256 O takes 128 a thread, S 32 and P 16, so the keys per
// tile are 64 (128 at D 128 and 64) and setmaxnreg moves registers from the
// producer warpgroup (40) to the consumers (232; at D 64 32 to 160, for
// three consumers).  Shared memory: Q (BM x D) and the ring, 160 KB at D 128
// (2 stages of 128 keys), 192 KB at D 192 (3 of 64) and D 256 (2 of 64),
// 120 KB at D 64 (3 of 128).  At D 64 the design differs in three ways:
// S of tile k + 1 is issued beside O += P V of tile k, so one tile's
// softmax runs while the tensor cores work (the wait for P V is guarded by a
// predicate on the row sums, so the assembler cannot hoist it into the
// softmax); 2^x is ex2.approx alone; and the grid runs a head's q tiles
// next to each other, so the 8 blocks that read one head's K/V tiles run
// together and find them in L2.  k tiles that the causal mask or the
// window hides from the whole block are never loaded; a warpgroup whose
// own rows see none of a loaded tile skips its products but still waits
// for the tile and releases it, so the ring's phases never fall behind;
// only the tiles on the diagonal, past kv_len or on the window's edge are
// masked element by element.  The tensor maps are encoded on the host by
// `cuTensorMapEncodeTiled` and kept in a small cache keyed by (pointer,
// shape, strides, box), so a call whose operands the caching allocator
// placed where an earlier call's were pays a lookup, not an encode.
//
// mma.sync, keys split over a cluster (bf16 at head dim 64 with at most 16
// query rows per KV head: whisper's cross-attention and its decoder's
// prompt).  The Sq * rep rows of a (batch, KV head) pair fill one 16-row
// mma.sync tile (query r % Sq of head r / Sq), so the work is K/V's bytes
// and the 160 pairs of whisper's call are too few to stream them from one
// block each.  C blocks, one thread-block cluster (`ops.flash_split_plan`:
// at least two blocks per SM), split the 16-key tiles that some row of the
// pair can see; each of a block's 4 warps streams every fourth tile of the
// block's share through its own 3-stage cp.async ring (rows past the share,
// kv_len or Sk are not read: the copy zero-fills them), S and O += P V on
// mma.sync m16n8k16, and keeps its (m, l, acc); the warps merge in shared
// memory, then the blocks through distributed shared memory in rank order
// (the bits do not depend on timing; a block that saw no key weighs 0), each
// writing D / C columns of the pair's rows.  One launch, no scratch.
//
// mma.sync (bf16 at the reduced head dims 32, 48): one block per 64
// query rows of one head, 4 warps of 16 rows; K/V tiles of 64 keys staged
// by all threads; S and O += P V on mma.sync m16n8k16 with Q's fragments
// and O in registers and P fed back from S's fragments.
//
// CUDA cores (float32, every head dim): the same loop in float math from
// shared memory; float32 is the card-against-CPU check type, not a serving
// type.

#include <cooperative_groups.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "gemm.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kKeys = 32;      // keys per tile: one per lane of a warp

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int rep, sq, sk;
  long long q_sb, q_sh, q_ss;  // strides in elements: batch, head, position
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window, q_offset, kv_len;  // window <= 0: no window
  float scale;
  // when set, an int32 pair on the device {q_offset, kv_len} read at kernel
  // entry in place of the two arguments (a captured chunked prefill replays
  // the same launch at every offset)
  const int* offsets;
};

// (q_offset, kv_len) of this launch: the arguments, or the device pair
struct Offsets {
  int q_offset, kv_len;
};

__device__ __forceinline__ Offsets offsets_of(const FlashArgs& a) {
  if (a.offsets == nullptr) return {a.q_offset, a.kv_len};
  return {a.offsets[0], max(0, a.offsets[1])};
}

template <int D>
__host__ __device__ constexpr int q_tile() { return D <= 128 ? 64 : 32; }

// Threads per output row in the P @ V step: the largest power of two that
// divides D, at most a block (D = 48 gives 16 threads of 3 columns each,
// D = 192 gives 64).
template <int D>
__host__ __device__ constexpr int pv_cols() {
  int t = rt::kThreads;
  while (D % t) t /= 2;
  return t;
}

template <int D>
constexpr size_t flash_smem_bytes() {
  constexpr int DP = D + 4, BQ = q_tile<D>();
  return sizeof(float) * (BQ * DP + 2 * kKeys * DP + BQ * kKeys + BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(rt::kThreads) flash_attn_fwd(const FlashArgs a) {
  using namespace rt;
  constexpr int BQ = q_tile<D>();
  constexpr int DP = D + 4;
  constexpr int RPW = BQ / kWarps;             // score rows per warp
  constexpr int TD = pv_cols<D>();             // output columns per row group
  constexpr int RG = kThreads / TD;            // row groups in the P @ V step
  constexpr int COLS = D / TD;
  constexpr int PV_ROWS = BQ / RG;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);    // BQ x DP, pre-scaled
  float* k_s = q_s + BQ * DP;                      // kKeys x DP
  float* v_s = k_s + kKeys * DP;                   // kKeys x DP
  float* p_s = v_s + kKeys * DP;                   // BQ x kKeys
  float* r_s = p_s + BQ * kKeys;                   // BQ: alpha per tile, l at the end

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, g = h / a.rep;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + g * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + g * a.v_sh;
  const int q_rows = min(BQ, a.sq - q0);
  const Offsets off = offsets_of(a);
  const int kv_end = min(a.sk, off.kv_len);

  stage_rows<T, D, BQ, DP>(
      q_s, [&](int t) -> const T* { return t < q_rows ? qb + (q0 + t) * a.q_ss : nullptr; },
      a.scale);

  // k tiles wholly hidden by the causal or window mask are skipped
  int k_hi = kv_end;
  if (a.causal) k_hi = min(k_hi, q0 + q_rows + off.q_offset);
  int k_lo = 0;
  if (a.window > 0) k_lo = max(0, q0 + off.q_offset - a.window + 1) / kKeys * kKeys;

  float m[RPW], l[RPW], acc[PV_ROWS][COLS];
#pragma unroll
  for (int n = 0; n < RPW; ++n) {
    m[n] = -INFINITY;
    l[n] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < PV_ROWS; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;
  const int dc = tid % TD, ir = tid / TD;

  for (int k0 = k_lo; k0 < k_hi; k0 += kKeys) {
    stage_rows<T, D, kKeys, DP>(
        k_s, [&](int t) -> const T* { return k0 + t < kv_end ? kb + (k0 + t) * a.k_ss : nullptr; },
        1.f);
    stage_rows<T, D, kKeys, DP>(
        v_s, [&](int t) -> const T* { return k0 + t < kv_end ? vb + (k0 + t) * a.v_ss : nullptr; },
        1.f);
    __syncthreads();

    // scores: lane j holds key k0 + j; warp w holds rows w, w + 4, ...
    float s[RPW];
#pragma unroll
    for (int n = 0; n < RPW; ++n) s[n] = 0.f;
    const float* kr = k_s + lane * DP;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int n = 0; n < RPW; ++n) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (warp + kWarps * n) * DP + d);
        s[n] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, s[n]))));
      }
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int n = 0; n < RPW; ++n) {
      const int i = warp + kWarps * n;
      const int qpos = q0 + i + off.q_offset;
      bool ok = kpos < kv_end && i < q_rows;
      if (a.causal) ok = ok && qpos >= kpos;
      if (a.window > 0) ok = ok && qpos - kpos < a.window;
      float alpha;
      p_s[i * kKeys + lane] = online_softmax(ok ? s[n] : -INFINITY, m[n], l[n], alpha);
      if (lane == 0) r_s[i] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P @ V
#pragma unroll
    for (int r = 0; r < PV_ROWS; ++r) {
      const float alpha = r_s[ir + r * RG];
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] *= alpha;
    }
#pragma unroll 2
    for (int t = 0; t < kKeys; t += 4) {
      float vv[COLS][4];
#pragma unroll
      for (int c = 0; c < COLS; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u) vv[c][u] = v_s[(t + u) * DP + dc + c * TD];
#pragma unroll
      for (int r = 0; r < PV_ROWS; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(p_s + (ir + r * RG) * kKeys + t);
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          acc[r][c] = fmaf(p.x, vv[c][0], fmaf(p.y, vv[c][1],
                      fmaf(p.z, vv[c][2], fmaf(p.w, vv[c][3], acc[r][c]))));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < RPW; ++n)
    if (lane == 0) r_s[warp + kWarps * n] = l[n];
  __syncthreads();
  T* ob = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < PV_ROWS; ++r) {
    const int i = ir + r * RG;
    if (i < q_rows) {
      const float inv = 1.f / fmaxf(r_s[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < COLS; ++c) store(ob + (q0 + i) * a.o_ss + dc + c * TD, acc[r][c] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at the reduced head dims (32, 48): mma.sync m16n8k16, f32 accumulate
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;   // q rows per block: 16 per warp
constexpr int kMmaKeys = 64;   // keys per tile

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats as bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Copies ROWS rows of D bf16 into shared memory (row pitch PITCH) as they are;
// row_ptr(r) == nullptr stores zeros.  All loads are issued before any store.
template <int D, int ROWS, int PITCH, typename RowPtr>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, RowPtr row_ptr) {
  constexpr int VPR = D / 8;
  constexpr int ITER = ROWS * VPR / rt::kThreads;
  static_assert(ROWS * VPR % rt::kThreads == 0, "tile must split evenly over the block");
  uint4 v[ITER];
#pragma unroll
  for (int u = 0; u < ITER; ++u) {
    const int i = threadIdx.x + u * rt::kThreads;
    const __nv_bfloat16* src = row_ptr(i / VPR);
    v[u] = src != nullptr ? *reinterpret_cast<const uint4*>(src + (i % VPR) * 8)
                          : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < ITER; ++u) {
    const int i = threadIdx.x + u * rt::kThreads;
    *reinterpret_cast<uint4*>(dst + (i / VPR) * PITCH + (i % VPR) * 8) = v[u];
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kMmaRows + 2 * kMmaKeys) * (D + 8);
}

// Warp w owns q rows 16w .. 16w+15 of the block's tile.  In the mma register
// layouts, lane = 4g + t holds rows g and g + 8 and columns 2t, 2t + 1 (+ 8):
// the score fragment S = Q K^T is reused as the A operand of P @ V without
// leaving registers (P rounded to bf16, as FlashAttention-2 does).
template <int D>
__global__ void __launch_bounds__(rt::kThreads) flash_attn_mma(const FlashArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int PITCH = D + 8;                 // bf16; 32-bit fragment loads stay conflict-free
  constexpr int KD = D / 16, ND = D / 8, NJ = kMmaKeys / 8;
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);  // kMmaRows x PITCH
  bf16* k_s = q_s + kMmaRows * PITCH;          // kMmaKeys x PITCH
  bf16* v_s = k_s + kMmaKeys * PITCH;          // kMmaKeys x PITCH

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y, b = blockIdx.z, hg = h / a.rep;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + hg * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + hg * a.v_sh;
  const int q_rows = min(kMmaRows, a.sq - q0);
  const Offsets off = offsets_of(a);
  const int kv_end = min(a.sk, off.kv_len);

  stage_bf16<D, kMmaRows, PITCH>(
      q_s, [&](int r) -> const bf16* { return r < q_rows ? qb + (q0 + r) * a.q_ss : nullptr; });
  __syncthreads();
  const int r0 = warp * 16 + g;                // this lane's rows: r0 and r0 + 8
  // Q's fragments stay in registers for the whole k loop
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const bf16* p = q_s + r0 * PITCH + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * PITCH);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * PITCH + 8);
  }

  int k_hi = kv_end;
  if (a.causal) k_hi = min(k_hi, q0 + q_rows + off.q_offset);
  int k_lo = 0;
  if (a.window > 0) k_lo = max(0, q0 + off.q_offset - a.window + 1) / kMmaKeys * kMmaKeys;

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const bool row_ok[2] = {r0 < q_rows, r0 + 8 < q_rows};
  const int qpos[2] = {q0 + r0 + off.q_offset, q0 + r0 + 8 + off.q_offset};

  for (int k0 = k_lo; k0 < k_hi; k0 += kMmaKeys) {
    __syncthreads();                           // the previous tile's reads are done
    stage_bf16<D, kMmaKeys, PITCH>(
        k_s, [&](int r) -> const bf16* { return k0 + r < kv_end ? kb + (k0 + r) * a.k_ss : nullptr; });
    stage_bf16<D, kMmaKeys, PITCH>(
        v_s, [&](int r) -> const bf16* { return k0 + r < kv_end ? vb + (k0 + r) * a.v_ss : nullptr; });
    __syncthreads();

    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const bf16* p = k_s + (j * 8 + g) * PITCH + kk * 16 + 2 * t;
        mma_16816(s[j], qa[kk], ld32(p), ld32(p + 8));
      }
    }

    // scale, mask, and the online-softmax update of rows r0 (i = 0), r0 + 8 (i = 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, kpos = k0 + j * 8 + 2 * t + (e % 2);
        bool ok = row_ok[i] && kpos < kv_end;
        if (a.causal) ok = ok && qpos[i] >= kpos;
        if (a.window > 0) ok = ok && qpos[i] - kpos < a.window;
        s[j][e] = ok ? s[j][e] * a.scale : -INFINITY;
        mx[i] = fmaxf(mx[i], s[j][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        s[j][e] = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m[i]);
        sum[i] += s[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];   // this lane's columns
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P @ V: P's score fragments become the A operand directly
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* p = v_s + (kk * 16 + 2 * t) * PITCH + n * 8 + g;
        mma_16816(o[n], pa, pack(p[0], p[PITCH]), pack(p[8 * PITCH], p[9 * PITCH]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  bf16* ob = static_cast<bf16*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    bf16* orow = ob + (q0 + r0 + 8 * i) * a.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 at the served head dims (128, 192, 256): wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BOX = 64;          // bf16 columns per 128-byte swizzled box

// Per head dim: keys per tile, ring stages, consumer warpgroups (64 query
// rows each), the registers setmaxnreg leaves the producer warpgroup and
// gives each consumer (the sum over the block's threads stays within the
// SM's 65,536), whether a consumer overlaps one tile's softmax with the next
// tile's products (and takes 2^x from ex2.approx alone), and whether the
// grid runs a head's q tiles next to each other (they read the same K/V
// tiles, which then stay in L2; else the query heads of a KV head are
// neighbours and a head's q tiles a whole grid row apart).
template <int D>
struct Cfg;
template <>
struct Cfg<64> {
  static constexpr int BN = 128, STAGES = 3, NWG = 3, REGS_P = 32, REGS_C = 160;
  static constexpr bool OVERLAP = true, TILES_TOGETHER = true;
};
template <>
struct Cfg<128> {
  static constexpr int BN = 128, STAGES = 2, NWG = 2, REGS_P = 40, REGS_C = 232;
  static constexpr bool OVERLAP = false, TILES_TOGETHER = false;
};
template <>
struct Cfg<192> {
  static constexpr int BN = 64, STAGES = 3, NWG = 2, REGS_P = 40, REGS_C = 232;
  static constexpr bool OVERLAP = false, TILES_TOGETHER = false;
};
template <>
struct Cfg<256> {
  static constexpr int BN = 64, STAGES = 2, NWG = 2, REGS_P = 40, REGS_C = 232;
  static constexpr bool OVERLAP = false, TILES_TOGETHER = false;
};

// Shared memory, every tile based at a multiple of 1024 bytes: each
// warpgroup's 64 Q rows, then the ring's K tiles, then its V tiles.  A tile
// of R rows is D / 64 boxes of R rows x 128 bytes.
template <int D>
struct Lay {
  static constexpr int BN = Cfg<D>::BN, STAGES = Cfg<D>::STAGES, NWG = Cfg<D>::NWG;
  static constexpr int DB = D / BOX;
  static constexpr int BM = 64 * NWG;              // q rows per block
  static constexpr int THREADS = 128 * (NWG + 1);  // the producer warpgroup, then the consumers
  static constexpr int Q_BOX = 64 * 128, Q_WG = DB * Q_BOX;
  static constexpr int KV_BOX = BN * 128, KV = DB * KV_BOX;
  static constexpr int K_OFF = NWG * Q_WG, V_OFF = K_OFF + STAGES * KV;
  static constexpr size_t SMEM = V_OFF + STAGES * KV + 1024;   // + alignment to 1024
  static_assert(128 * (Cfg<D>::REGS_P + NWG * Cfg<D>::REGS_C) <= 65536,
                "setmaxnreg hands out more registers than the SM has");
};

// The coordinate of a head or batch index in a tensor map: 1, or 0 where
// the view broadcasts that dim (stride 0) and the map holds one slice.
struct Coords {
  int qh, qb, kh, kb, vh, vb;
};

// d (64 x N, float) = (acc ? d : 0) + A (64 x 16, K-major, shared memory) @
// B (16 x N), B read from shared memory as N rows of K (K-major): S = Q K^T.
template <int N>
struct SS;
// d (64 x N, float) += A (64 x 16, registers) @ B (16 x N, N-major in shared
// memory, the transpose flag): O += P V.
template <int N>
struct RS;

template <>
struct SS<64> {
  static constexpr int R = 32;
  __device__ __forceinline__ static void mma(float (&d)[R], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct SS<128> {
  static constexpr int R = 64;
  __device__ __forceinline__ static void mma(float (&d)[R], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct RS<64> {
  static constexpr int R = 32;
  __device__ __forceinline__ static void mma(float (&d)[R], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct RS<128> {
  static constexpr int R = 64;
  __device__ __forceinline__ static void mma(float (&d)[R], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct RS<192> {
  static constexpr int R = 96;
  __device__ __forceinline__ static void mma(float (&d)[R], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct RS<256> {
  static constexpr int R = 128;
  __device__ __forceinline__ static void mma(float (&d)[R], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
        "%125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
          "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
          "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
          "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
          "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
          "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};


template <int R>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

}  // namespace wg

// 2^x: exp2f, or (FAST) the special-function unit's ex2.approx alone, which
// flushes subnormal results to zero where exp2f scales around them
template <bool FAST>
__device__ __forceinline__ float exp2_of(float x) {
  if constexpr (FAST) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
  } else {
    return exp2f(x);
  }
}

// wgmma.wait_group 0 that the assembler cannot move above the work that
// computes `l` (the row sums, which every exponential of a softmax feeds):
// it is guarded by a predicate on l's bits that always holds (no float
// result has all 32 bits set).  Unguarded, the assembler hoists the wait
// into the softmax it should overlap.
__device__ __forceinline__ void wgmma_wait0_after(const float (&l)[2]) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 t;\n"
      "and.b32 t, %0, %1;\n"
      "setp.ne.b32 p, t, -1;\n"
      "@p wgmma.wait_group.sync.aligned 0;\n"
      "}\n" ::"r"(__float_as_uint(l[0])), "r"(__float_as_uint(l[1]))
      : "memory");
}

// Accumulator layout of a warpgroup's 64 x N product: thread 32 w + 4 g + t
// holds d[4 j + 2 i + e] = row 16 w + g + 8 i, column 8 j + 2 t + e, which is
// also the layout of the A operand from registers (per 16-column k step),
// so S's fragments become P's without leaving registers.
template <int D>
__global__ void __launch_bounds__(wg::Lay<D>::THREADS, 1)
    flash_attn_wgmma(const FlashArgs a, const wg::Coords c,
                     const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap) {
  using L = wg::Lay<D>;
  using Cf = wg::Cfg<D>;
  using Smm = wg::SS<L::BN>;
  using Pvm = wg::RS<D>;
  constexpr int BN = L::BN, ST = L::STAGES, BM = L::BM, NWG = L::NWG;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[ST], v_full[ST], empty[ST];
  const uint32_t base = (hop::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;

  // heaviest q tiles first; a head's q tiles fastest, or its KV head's
  // query heads fastest
  const int h = Cf::TILES_TOGETHER ? blockIdx.y : blockIdx.x;
  const int b = Cf::TILES_TOGETHER ? blockIdx.z : blockIdx.y, hg = h / a.rep;
  const int q0 = Cf::TILES_TOGETHER ? (gridDim.x - 1 - blockIdx.x) * BM
                                    : (gridDim.z - 1 - blockIdx.z) * BM;
  const int rows = min(BM, a.sq - q0);
  const Offsets off = offsets_of(a);
  const int q_offset = off.q_offset;
  const int kv_end = min(a.sk, off.kv_len);
  // k tiles the causal mask or the window hides from every row of the block
  int k_hi = kv_end;
  if (a.causal) k_hi = min(k_hi, q0 + rows + q_offset);
  int k_lo = 0;
  if (a.window > 0) k_lo = max(0, q0 + q_offset - a.window + 1) / BN * BN;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  if (tid == 0) {
    hop::mbar_init(hop::smem_u32(&q_full), 1);
    for (int s = 0; s < ST; ++s) {
      hop::mbar_init(hop::smem_u32(&k_full[s]), 1);    // the producer's arrival + bytes
      hop::mbar_init(hop::smem_u32(&v_full[s]), 1);
      hop::mbar_init(hop::smem_u32(&empty[s]), 4 * NWG);   // one per consumer warp
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread issues every load ----
    hop::regs_dec<Cf::REGS_P>();
    if (tid == 0 && n_tiles > 0) {
      const uint32_t qb = hop::smem_u32(&q_full);
      hop::mbar_arrive_tx(qb, NWG * L::Q_WG);
#pragma unroll
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int j = 0; j < L::DB; ++j)
          hop::tma_load_4d(base + w * L::Q_WG + j * L::Q_BOX, &qmap, qb, j * wg::BOX,
                           q0 + 64 * w, h * c.qh, b * c.qb);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST, k0 = k_lo + t * BN;
        hop::mbar_wait(hop::smem_u32(&empty[s]), ((t / ST) & 1) ^ 1);
        const uint32_t kb = hop::smem_u32(&k_full[s]), vb = hop::smem_u32(&v_full[s]);
        hop::mbar_arrive_tx(kb, L::KV);
#pragma unroll
        for (int j = 0; j < L::DB; ++j)
          hop::tma_load_4d(base + L::K_OFF + s * L::KV + j * L::KV_BOX, &kmap, kb, j * wg::BOX,
                           k0, hg * c.kh, b * c.kb);
        hop::mbar_arrive_tx(vb, L::KV);
#pragma unroll
        for (int j = 0; j < L::DB; ++j)
          hop::tma_load_4d(base + L::V_OFF + s * L::KV + j * L::KV_BOX, &vmap, vb, j * wg::BOX,
                           k0, hg * c.vh, b * c.vb);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns rows q0 + 64 w .. q0 + 64 w + 63 ----
  hop::regs_inc<Cf::REGS_C>();
  const int w = tid / 128 - 1, warp = tid % 128 / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int qw = q0 + 64 * w, rows_w = min(64, a.sq - qw);
  // the keys this warpgroup's rows can see, within the block's range
  int hi_w = rows_w > 0 ? kv_end : 0;
  if (a.causal) hi_w = min(hi_w, qw + rows_w + q_offset);
  const int lo_w = a.window > 0 ? qw + q_offset - a.window + 1 : 0;
  const int qpos0 = qw + warp * 16 + g + q_offset;        // rows qpos0 and qpos0 + 8
  const float sl2 = a.scale * 1.4426950408889634f;        // scores in log2 units
  const uint32_t qs = base + w * L::Q_WG;
  auto stage = [&](int it) { return it % ST; };
  auto phase = [&](int it) { return static_cast<uint32_t>((it / ST) & 1); };
  auto k_tile = [&](int it) { return base + L::K_OFF + stage(it) * L::KV; };
  auto v_tile = [&](int it) { return base + L::V_OFF + stage(it) * L::KV; };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[stage(it)]));
  };

  float o[Pvm::R];
#pragma unroll
  for (int i = 0; i < Pvm::R; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (n_tiles > 0) hop::mbar_wait(hop::smem_u32(&q_full), 0);

  // S = Q K^T of the tile whose K lies at ks (issued, not waited for); a
  // k step's operands lie a constant offset past the tile's descriptors
  const uint64_t qd = hop::sw128_desc(qs, 16, 1024);
  auto s_product = [&](float (&sc)[Smm::R], uint32_t ks) {
    const uint64_t kd = hop::sw128_desc(ks, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;                  // k16 = 32 bytes of a row
      Smm::mma(sc, qd + (((kk / 4) * L::Q_BOX + col) >> 4),
               kd + (((kk / 4) * L::KV_BOX + col) >> 4), kk > 0);
    }
  };
  // O += P V of the tile whose V lies at vs (issued, not waited for)
  auto pv_product = [&](const uint32_t (&pa)[BN / 16][4], uint32_t vs) {
    const uint64_t vd = hop::sw128_desc(vs, L::KV_BOX, 1024);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) Pvm::mma(o, pa[kk], vd + ((kk * 16 * 128) >> 4));
  };
  // Masks the scores of the tile at k0 where it crosses the diagonal,
  // kv_len or the window's edge, and folds them into the rows' running max
  // m and sum l: sc becomes P, alpha the factor that rescales O.
  auto softmax = [&](float (&sc)[Smm::R], int k0, float (&alpha)[2]) {
    const bool edge = k0 + BN > kv_end || (a.causal && k0 + BN - 1 > qw + q_offset) ||
                      (a.window > 0 && k0 < lo_w + rows_w - 1);
    if (edge) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1), qpos = qpos0 + 8 * (e >> 1);
          const bool ok = (kpos < kv_end) & (!a.causal | (qpos >= kpos)) &
                          (a.window <= 0 | (qpos - kpos < a.window));
          sc[4 * j + e] = ok ? sc[4 * j + e] : -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    float mu[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * sl2);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;        // a row with nothing visible yet
      alpha[i] = exp2_of<Cf::OVERLAP>(m[i] - mu[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_of<Cf::OVERLAP>(fmaf(sc[4 * j + e], sl2, -mu[e >> 1]));
        sc[4 * j + e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];   // this thread's columns
  };
  auto pack_p = [&](uint32_t (&pa)[BN / 16][4], const float (&sc)[Smm::R]) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };
  auto rescale_o = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
  };

  if constexpr (Cf::OVERLAP) {
    // S of tile it is issued beside O += P V of tile it - 1, so the softmax
    // of one tile runs while the tensor cores work on the other's products.
    // Every tile of the block's range is computed (the mask hides what this
    // warpgroup's rows do not see); a warpgroup past Sq only waits and
    // releases, so the ring's phases never fall behind.
    if (n_tiles > 0 && rows_w > 0) {
      float sc[Smm::R], alpha[2];
      uint32_t pa[BN / 16][4];
      hop::mbar_wait(hop::smem_u32(&k_full[0]), 0);
      hop::fence_regs(sc);
      hop::wgmma_fence();
      s_product(sc, k_tile(0));
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
      softmax(sc, k_lo, alpha);                          // O is still 0: no rescale
      pack_p(pa, sc);
      for (int it = 1; it < n_tiles; ++it) {
        hop::mbar_wait(hop::smem_u32(&k_full[stage(it)]), phase(it));
        hop::mbar_wait(hop::smem_u32(&v_full[stage(it - 1)]), phase(it - 1));
        hop::fence_regs(sc);
        wg::fence_u32(pa);
        hop::fence_regs(o);
        hop::wgmma_fence();
        s_product(sc, k_tile(it));
        hop::wgmma_commit();
        pv_product(pa, v_tile(it - 1));
        hop::wgmma_commit();
        hop::wgmma_wait<1>();                            // S of tile it is in
        hop::fence_regs(sc);
        softmax(sc, k_lo + it * BN, alpha);
        wgmma_wait0_after(l);                            // P V of tile it - 1 is in
        hop::fence_regs(o);
        wg::fence_u32(pa);
        release(it - 1);
        pack_p(pa, sc);
        rescale_o(alpha);
      }
      const int last = n_tiles - 1;
      hop::mbar_wait(hop::smem_u32(&v_full[stage(last)]), phase(last));
      wg::fence_u32(pa);
      hop::fence_regs(o);
      hop::wgmma_fence();
      pv_product(pa, v_tile(last));
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(o);
      wg::fence_u32(pa);
      release(last);
    } else {
      for (int it = 0; it < n_tiles; ++it) {
        hop::mbar_wait(hop::smem_u32(&k_full[stage(it)]), phase(it));
        hop::mbar_wait(hop::smem_u32(&v_full[stage(it)]), phase(it));
        release(it);
      }
    }
  } else {
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = k_lo + it * BN;
      // every warpgroup waits for every tile, seen or not, so that its release
      // of the stage below never runs a phase ahead of the producer
      hop::mbar_wait(hop::smem_u32(&k_full[stage(it)]), phase(it));
      if (k0 < hi_w && k0 + BN > lo_w) {
        float sc[Smm::R], alpha[2];
        hop::fence_regs(sc);
        hop::wgmma_fence();
        s_product(sc, k_tile(it));
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(sc);
        softmax(sc, k0, alpha);
        rescale_o(alpha);
        uint32_t pa[BN / 16][4];
        pack_p(pa, sc);
        hop::mbar_wait(hop::smem_u32(&v_full[stage(it)]), phase(it));
        wg::fence_u32(pa);
        hop::fence_regs(o);
        hop::wgmma_fence();
        pv_product(pa, v_tile(it));
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(o);
        wg::fence_u32(pa);
      } else {
        hop::mbar_wait(hop::smem_u32(&v_full[stage(it)]), phase(it));
      }
      release(it);
    }
  }

  // O / l, rows past Sq not stored; a row that saw no key has l = 0 and O = 0
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = qw + warp * 16 + g + 8 * i - q0;
    if (r >= rows) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    __nv_bfloat16* orow = ob + static_cast<long long>(q0 + r) * a.o_ss + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 at D 64 with few query rows (Sq * rep <= 16): keys split over a cluster
// ---------------------------------------------------------------------------

namespace fs {

using bf16 = __nv_bfloat16;
constexpr int kRows = 16;          // query rows of a (batch, KV head) pair: mma's M
constexpr int kTile = 16;          // keys per warp tile, the unit of the split
constexpr int kStages = 3;         // a warp's ring: two tiles in flight, one computed
constexpr int kMaxCluster = 8;     // the portable cluster size

template <int D>
struct Lay {
  static constexpr int PITCH = D + 8;                   // bf16 a row: 16 bytes of padding
  static constexpr int TILE = 2 * kTile * PITCH;        // a stage: K rows, then V rows
  static constexpr int WARP_RING = kStages * TILE;      // bf16 per warp
  static constexpr int STATE = 2 * kRows + kRows * D;   // floats: m, l (base 2), then acc
  static constexpr int SCRATCH = 2 * kMaxCluster * kRows + kRows;
  static constexpr size_t BYTES = sizeof(bf16) * (kRows * PITCH + rt::kWarps * WARP_RING);
  // after the loop a warp's ring holds its state; warp 0's also the block's,
  // warp 1's the merge scratch
  static_assert(sizeof(float) * (2 * STATE + SCRATCH) <= sizeof(bf16) * WARP_RING,
                "a warp's ring holds two states");
};

}  // namespace fs

// Block s of the C blocks of (batch b, KV head hg) takes its share of the
// 16-key tiles that some row of the pair can see; warp w of it takes tiles
// w, w + 4, ... through its own cp.async ring.  Row r of the 16-row tile is
// query r % Sq of head hg * rep + r / Sq.  In the mma layouts lane 4g + t
// holds rows g and g + 8 and columns 2t, 2t + 1 of each 8-wide block; S's
// fragment becomes P's A operand without leaving registers.
template <int D>
__global__ void __launch_bounds__(rt::kThreads) flash_split_mma(const FlashArgs a) {
  using bf16 = __nv_bfloat16;
  using L = fs::Lay<D>;
  constexpr int PITCH = L::PITCH, CPR = D / 8, KD = D / 16, ND = D / 8;
  constexpr int kRows = fs::kRows, kTile = fs::kTile, kStages = fs::kStages;
  constexpr int kWarps = rt::kWarps, kThreads = rt::kThreads;
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  bf16* ring = q_s + kRows * PITCH;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int s = blockIdx.x, nsplit = gridDim.x, hg = blockIdx.y, b = blockIdx.z;
  const int nrows = a.sq * a.rep;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb;
  auto q_row = [&](int r) {
    return qb + (hg * a.rep + r / a.sq) * a.q_sh + static_cast<long long>(r % a.sq) * a.q_ss;
  };
  for (int i = tid; i < kRows * CPR; i += kThreads) {
    const int r = i / CPR, col = i % CPR;
    gemm::cp_async16(q_s + r * PITCH + col * 8, r < nrows ? q_row(r) + col * 8 : qb, r < nrows);
  }
  gemm::cp_async_commit();

  // the keys some row of the pair may see, in 16-key tiles split over the cluster
  const Offsets off = offsets_of(a);
  const int kv_end = min(a.sk, off.kv_len);
  int hi = kv_end;
  if (a.causal) hi = min(hi, off.q_offset + a.sq);
  const int lo = a.window > 0 ? max(0, off.q_offset - a.window + 1) / kTile * kTile : 0;
  const int tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  const int per = (tiles + nsplit - 1) / nsplit;
  const int t0 = min(s * per, tiles), t1 = min(t0 + per, tiles);
  const int r_lo = lo + t0 * kTile, r_hi = min(lo + t1 * kTile, hi);   // this block's keys
  const bool row_ok[2] = {g < nrows, g + 8 < nrows};
  const int qpos[2] = {off.q_offset + g % a.sq, off.q_offset + (g + 8) % a.sq};
  const float sl2 = a.scale * 1.4426950408889634f;        // scores in log2 units

  gemm::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    gemm::ldmatrix_x4(qa[kk], q_s + (lane % 16) * PITCH + kk * 16 + (lane / 16) * 8);

  const int ntiles = r_hi > r_lo ? (r_hi - r_lo + kTile - 1) / kTile : 0;
  const int mine = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps : 0;
  bf16* wring = ring + warp * L::WARP_RING;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + hg * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + hg * a.v_sh;
  auto tile_pos = [&](int i) { return r_lo + (warp + kWarps * i) * kTile; };
  // keys past the block's range are not read: the copy stores zeros
  auto issue = [&](int i) {
    const int p0 = tile_pos(i);
    bf16* ks = wring + (i % kStages) * L::TILE;
    bf16* vs = ks + kTile * PITCH;
#pragma unroll
    for (int j = 0; j < kTile * CPR / 32; ++j) {
      const int e = lane + 32 * j, r = e / CPR, col = e % CPR;
      const bool ok = p0 + r < r_hi;
      const long long row = ok ? p0 + r : 0;
      gemm::cp_async16(ks + r * PITCH + col * 8, kb + row * a.k_ss + col * 8, ok);
      gemm::cp_async16(vs + r * PITCH + col * 8, vb + row * a.v_ss + col * 8, ok);
    }
  };

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine) issue(i);
    gemm::cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    if (i + kStages - 1 < mine) issue(i + kStages - 1);
    gemm::cp_async_commit();
    gemm::cp_async_wait<kStages - 1>();        // tile i has landed (this lane's copies)
    __syncwarp();                              // ... and every lane's
    const bf16* ks = wring + (i % kStages) * L::TILE;
    const bf16* vs = ks + kTile * PITCH;
    const int p0 = tile_pos(i);

    // S = Q K^T: n-tile 0 holds keys 0-7, n-tile 1 keys 8-15
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t kf[4];
      gemm::ldmatrix_x4(kf, ks + ((lane & 7) + ((lane >> 4) << 3)) * PITCH + kk * 16 +
                                ((lane >> 3) & 1) * 8);
      gemm::mma_16816(sc[0], qa[kk], kf[0], kf[1]);
      gemm::mma_16816(sc[1], qa[kk], kf[2], kf[3]);
    }

    // mask, then the online softmax of rows g (h = 0) and g + 8 (h = 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, kpos = p0 + j * 8 + 2 * t + (e & 1);
        bool ok = row_ok[h] && kpos < r_hi;
        if (a.causal) ok = ok && qpos[h] >= kpos;
        if (a.window > 0) ok = ok && qpos[h] - kpos < a.window;
        sc[j][e] = ok ? sc[j][e] * sl2 : -INFINITY;
        mx[h] = fmaxf(mx[h], sc[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = m[h] == -INFINITY ? 0.f : exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = sc[j][e] == -INFINITY ? 0.f : exp2f(sc[j][e] - m[e / 2]);
        sum[e / 2] += sc[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];   // this lane's columns
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, V's B fragments by ldmatrix.trans (keys are its k dim)
    const uint32_t pa[4] = {pack(sc[0][0], sc[0][1]), pack(sc[0][2], sc[0][3]),
                            pack(sc[1][0], sc[1][1]), pack(sc[1][2], sc[1][3])};
#pragma unroll
    for (int n = 0; n < ND; n += 2) {
      uint32_t vf[4];
      gemm::ldmatrix_x4_trans(vf, vs + (lane % 16) * PITCH + n * 8 + (lane / 16) * 8);
      gemm::mma_16816(o[n], pa, vf[0], vf[1]);
      gemm::mma_16816(o[n + 1], pa, vf[2], vf[3]);
    }
    __syncwarp();                              // the stage is free for tile i + 3
  }
  gemm::cp_async_wait<0>();
  __syncwarp();

  // this warp's state into its own ring: rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* part = reinterpret_cast<float*>(wring);
  if (t == 0) {
    part[g] = m[0];
    part[g + 8] = m[1];
    part[kRows + g] = l[0];
    part[kRows + g + 8] = l[1];
  }
  float* pacc = part + 2 * kRows;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<float2*>(pacc + g * D + n * 8 + 2 * t) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(pacc + (g + 8) * D + n * 8 + 2 * t) =
        make_float2(o[n][2], o[n][3]);
  }
  __syncthreads();

  // the block's state (in warp 0's ring, after its part): the warps' merged
  // in a fixed order; their weights go through the merge scratch (in warp
  // 1's ring, after its part)
  auto part_of = [&](int w) { return reinterpret_cast<const float*>(ring + w * L::WARP_RING); };
  float* state = reinterpret_cast<float*>(ring) + L::STATE;
  float* scratch = reinterpret_cast<float*>(ring + L::WARP_RING) + L::STATE;
  if (tid < kRows) {
    float mx = -INFINITY, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part_of(w)[tid]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = part_of(w)[tid];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      scratch[w * kRows + tid] = wt;
      den = fmaf(wt, part_of(w)[kRows + tid], den);
    }
    state[tid] = mx;
    state[kRows + tid] = den;
  }
  __syncthreads();
  for (int i = tid; i < nrows * D; i += kThreads) {
    const int r = i / D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      acc = fmaf(scratch[w * kRows + r], part_of(w)[2 * kRows + i], acc);
    state[2 * kRows + i] = acc;
  }

  // the cluster's merge through distributed shared memory, in rank order:
  // block s writes columns [s D / C, (s + 1) D / C) of every row; a block
  // that saw no key has m = -inf and weight 0
  cg::cluster_group cluster = cg::this_cluster();
  float* wgt = scratch;                      // m of each block, then its weight
  float* lsum = scratch + fs::kMaxCluster * kRows;
  float* inv = lsum + fs::kMaxCluster * kRows;
  cluster.sync();                            // every block's state is written
  for (int i = tid; i < nsplit * kRows; i += kThreads) {
    const float* remote = cluster.map_shared_rank(state, i / kRows);
    wgt[i] = remote[i % kRows];
    lsum[i] = remote[kRows + i % kRows];
  }
  __syncthreads();
  if (tid < kRows) {
    float mx = -INFINITY;
    for (int k = 0; k < nsplit; ++k) mx = fmaxf(mx, wgt[k * kRows + tid]);
    float den = 0.f;
    for (int k = 0; k < nsplit; ++k) {
      const float mk = wgt[k * kRows + tid];
      const float wk = mk == -INFINITY ? 0.f : exp2f(mk - mx);
      wgt[k * kRows + tid] = wk;
      den = fmaf(wk, lsum[k * kRows + tid], den);
    }
    inv[tid] = den > 0.f ? 1.f / den : 0.f;
  }
  __syncthreads();
  bf16* ob = static_cast<bf16*>(a.out) + b * a.o_sb;
  const int cols = D / nsplit, c0 = s * cols;
  for (int i = tid; i < nrows * cols; i += kThreads) {
    const int r = i / cols, col = c0 + i % cols;
    float num = 0.f;
    for (int k = 0; k < nsplit; ++k) {
      const float wk = wgt[k * kRows + r];
      if (wk != 0.f) num = fmaf(wk, cluster.map_shared_rank(state, k)[2 * kRows + r * D + col], num);
    }
    ob[(hg * a.rep + r / a.sq) * a.o_sh + static_cast<long long>(r % a.sq) * a.o_ss + col] =
        __float2bfloat16(num * inv[r]);
  }
  cluster.sync();                            // no block leaves while its state is read
}

template <typename T, int D>
cudaError_t launch(const FlashArgs& a, int batch, int heads, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<D>();
  cudaError_t err = rt::allow_smem(flash_attn_fwd<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + q_tile<D>() - 1) / q_tile<D>(), heads, batch);
  flash_attn_fwd<T, D><<<grid, rt::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const FlashArgs& a, int batch, int heads, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = rt::allow_smem(flash_attn_mma<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kMmaRows - 1) / kMmaRows, heads, batch);
  flash_attn_mma<D><<<grid, rt::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- tensor maps: encoded once, kept by (pointer, shape, strides, box) ----

struct MapKey {
  const void* base;
  long long ss, sh, sb;
  int d, rows, heads, batch, box_rows, pad;
};

struct MapEntry {
  MapKey key;
  CUtensorMap map;
  int hm, bm;
  bool used;
};

constexpr int kMapSlots = 64;
std::mutex map_mu;
MapEntry map_cache[kMapSlots];

// x (B, heads, rows, D) with element strides sb, sh, ss and unit stride
// along D, as the 4-D map (D, rows, heads, B) with boxes of 64 columns x
// box_rows rows.  A head or batch dim that the view broadcasts (stride 0)
// becomes a dim of 1 read at coordinate 0 (*hm, *bm = 0; else 1); the stride
// of a dim of 1 is never used and is set to a packed one.  Returns a CUresult
// (0 = success).
int encode_rows(CUtensorMap* map, int* hm, int* bm, const void* base, int d, int rows,
                int heads, int batch, long long ss, long long sh, long long sb, int box_rows) {
  MapKey key;
  std::memset(&key, 0, sizeof key);
  key.base = base;
  key.ss = ss;
  key.sh = sh;
  key.sb = sb;
  key.d = d;
  key.rows = rows;
  key.heads = heads;
  key.batch = batch;
  key.box_rows = box_rows;
  uint64_t hash = 1469598103934665603ull;          // FNV-1a over the key's bytes
  const unsigned char* p = reinterpret_cast<const unsigned char*>(&key);
  for (size_t i = 0; i < sizeof key; ++i) hash = (hash ^ p[i]) * 1099511628211ull;
  MapEntry& slot = map_cache[hash % kMapSlots];
  std::lock_guard<std::mutex> lock(map_mu);
  if (slot.used && std::memcmp(&slot.key, &key, sizeof key) == 0) {
    *map = slot.map;
    *hm = slot.hm;
    *bm = slot.bm;
    return 0;
  }
  if (rows > 1 && ss == 0) return CUDA_ERROR_INVALID_VALUE;
  const uint64_t row_bytes = static_cast<uint64_t>(d) * 2;
  const uint64_t s_rows = rows > 1 ? static_cast<uint64_t>(ss) * 2 : row_bytes;
  const bool h_on = heads > 1 && sh != 0, b_on = batch > 1 && sb != 0;
  const uint64_t s_heads = h_on ? static_cast<uint64_t>(sh) * 2 : s_rows * rows;
  const uint64_t s_batch = b_on ? static_cast<uint64_t>(sb) * 2 : s_heads * (h_on ? heads : 1);
  const uint64_t dims[4] = {static_cast<uint64_t>(d), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(h_on ? heads : 1),
                            static_cast<uint64_t>(b_on ? batch : 1)};
  const uint64_t strides[3] = {s_rows, s_heads, s_batch};
  const uint32_t box[4] = {static_cast<uint32_t>(wg::BOX), static_cast<uint32_t>(box_rows), 1, 1};
  const int res = hop::encode_bf16(map, base, 4, dims, strides, box);
  if (res != 0) return res;
  *hm = h_on;
  *bm = b_on;
  slot.key = key;
  slot.map = *map;
  slot.hm = *hm;
  slot.bm = *bm;
  slot.used = true;
  return 0;
}

template <int D>
cudaError_t launch_wgmma(const FlashArgs& a, int batch, int heads, cudaStream_t stream) {
  using L = wg::Lay<D>;
  // the K/V maps span the rows a key may come from: min(Sk, kv_len), or with
  // the device pair all Sk rows (the slot's capacity), whose rows past the
  // device kv_len the kernel masks inside the boundary tile
  const int kv_end = a.offsets != nullptr ? a.sk : (a.sk < a.kv_len ? a.sk : a.kv_len);
  CUtensorMap qmap, kmap, vmap;
  std::memset(&kmap, 0, sizeof kmap);
  std::memset(&vmap, 0, sizeof vmap);
  wg::Coords c{0, 0, 0, 0, 0, 0};
  if (encode_rows(&qmap, &c.qh, &c.qb, a.q, D, a.sq, heads, batch, a.q_ss, a.q_sh, a.q_sb,
                  64) != 0)
    return cudaErrorNotSupported;
  // with no key to read (kv_len 0) no block loads K or V: the maps stay empty
  if (kv_end > 0 &&
      (encode_rows(&kmap, &c.kh, &c.kb, a.k, D, kv_end, heads / a.rep, batch, a.k_ss, a.k_sh,
                   a.k_sb, L::BN) != 0 ||
       encode_rows(&vmap, &c.vh, &c.vb, a.v, D, kv_end, heads / a.rep, batch, a.v_ss, a.v_sh,
                   a.v_sb, L::BN) != 0))
    return cudaErrorNotSupported;
  cudaError_t err = rt::allow_smem(flash_attn_wgmma<D>, L::SMEM);
  if (err != cudaSuccess) return err;
  const int q_tiles = (a.sq + L::BM - 1) / L::BM;
  if (q_tiles > 65535 || batch > 65535 || heads > 65535) return cudaErrorInvalidValue;
  const dim3 grid = wg::Cfg<D>::TILES_TOGETHER ? dim3(q_tiles, heads, batch)
                                               : dim3(heads, batch, q_tiles);
  flash_attn_wgmma<D><<<grid, L::THREADS, L::SMEM, stream>>>(a, c, qmap, kmap, vmap);
  return cudaGetLastError();
}

// grid (cluster, Hkv, B), the `cluster` blocks of a pair one thread-block
// cluster
template <int D>
cudaError_t launch_split(const FlashArgs& a, int batch, int heads, int cluster,
                         cudaStream_t stream) {
  constexpr size_t smem = fs::Lay<D>::BYTES;
  if (a.sq * a.rep > fs::kRows || cluster < 1 || cluster > fs::kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || heads / a.rep > 65535 || batch > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = rt::allow_smem(flash_split_mma<D>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, heads / a.rep, batch);
  cfg.blockDim = dim3(rt::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_split_mma<D>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// design: 0 = CUDA cores (float32), 1 = mma.sync (bf16 head_dim 32, 48),
// 2 = wgmma + TMA (bf16 head_dim 64, 128, 192, 256), 3 = keys split over a
// cluster of `cluster` blocks (bf16 head_dim 64, Sq * rep <= 16);
// `ops.flash_path` picks it
cudaError_t dispatch(int dtype, int design, int cluster, int head_dim, const FlashArgs& a,
                     int batch, int heads, cudaStream_t s) {
  if (dtype == 0 && design == 0) {
    switch (head_dim) {
      case 32: return launch<float, 32>(a, batch, heads, s);
      case 48: return launch<float, 48>(a, batch, heads, s);
      case 64: return launch<float, 64>(a, batch, heads, s);
      case 128: return launch<float, 128>(a, batch, heads, s);
      case 192: return launch<float, 192>(a, batch, heads, s);
      case 256: return launch<float, 256>(a, batch, heads, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1 && design == 1) {
    switch (head_dim) {
      case 32: return launch_mma<32>(a, batch, heads, s);
      case 48: return launch_mma<48>(a, batch, heads, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1 && design == 2) {
    switch (head_dim) {
      case 64: return launch_wgmma<64>(a, batch, heads, s);
      case 128: return launch_wgmma<128>(a, batch, heads, s);
      case 192: return launch_wgmma<192>(a, batch, heads, s);
      case 256: return launch_wgmma<256>(a, batch, heads, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1 && design == 3 && head_dim == 64)
    return launch_split<64>(a, batch, heads, cluster, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; design and cluster as `dispatch` reads
// them (cluster: blocks per (batch, KV head) pair of design 3, else unread).
// `offsets`: nullptr, or an int32 pair {q_offset, kv_len} on the device that
// the kernel reads in place of the two ints (the K/V maps then span all Sk
// rows, so rows past kv_len must hold finite values: they are read and
// weighted by exactly 0).  Returns cudaGetLastError() after the launch (0 =
// launched).  Launches on `stream`, allocates nothing and does not
// synchronise.
extern "C" int flash_attention_launch(
    int dtype, int design, int cluster, int head_dim, const void* q, const void* k, const void* v,
    void* out, int batch, int heads, int rep, int sq, int sk,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, int q_offset, int kv_len,
    float scale, const int* offsets, void* stream) {
  if (batch <= 0 || heads <= 0 || rep <= 0 || heads % rep != 0 || sq <= 0 || sk <= 0)
    return cudaErrorInvalidValue;
  const FlashArgs a{q, k, v, out, rep, sq, sk,
                    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                    causal, window, q_offset, kv_len, scale, offsets};
  return static_cast<int>(
      dispatch(dtype, design, cluster, head_dim, a, batch, heads,
               static_cast<cudaStream_t>(stream)));
}
