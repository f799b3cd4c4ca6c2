// Blocked causal GQA attention (flash attention forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_attn_kernel`, reached from
// `ops.flash_attention` in src/repro/kernels/ops.py).
//
// What it computes: q (B, H, Sq, D) against k, v (B, Hkv, Sk, D); head h
// reads KV head h / (H / Hkv).  Key kpos is visible to query row i when
// kpos < kv_len, and, when asked, qpos >= kpos (causal) and
// qpos - kpos < window, where qpos = i + q_offset.  Softmax is online with
// float accumulation; a row with no visible key writes zeros.  causal,
// window, q_offset and kv_len are run-time arguments, so chunked prefill
// (a nonzero offset against a capacity-length cache) runs the same binary.
//
// What bounds it on the H100: bytes for short prompts, operations for long
// ones.  A causal prefill of S tokens reads q and k, v once and writes the
// output once, (2 * H + 2 * Hkv) * D * S * itemsize bytes, and does
// 4 * H * D flops per visible (q, k) pair, about 2 * H * D * S^2.  At the
// qwen2.5-3b widths in bf16 the two meet near S = 660 (3.35 TB/s against
// 989 dense Tflop/s): a 512-token prefill is bytes-bound (1.41 us of bytes
// against 1.09 us of flops), longer prefills are operations-bound.  Both
// are microseconds at these lengths, so launch latency and occupancy, not
// either roofline, set the measured time.
//
// What the design does about that: one block per (batch, head, 64-row q
// tile) keeps its q tile on chip and streams K/V tiles through shared
// memory, so K/V are read once per q tile instead of once per row.  bf16
// with head_dim <= 128 (the serving path) runs both contractions on the
// tensor cores with mma.sync m16n8k16 (f32 accumulation): each warp owns 16
// q rows, keeps its Q fragments and its output in registers, and feeds the
// score fragments back as the A operand of P @ V (P rounded to bf16, as
// FlashAttention-2 does); MLA's head_dim 192 (and the reduced model's 48)
// takes the same variant, its Q fragments re-read from shared memory per
// k tile.  float32 and head_dim 256 run a CUDA-core variant
// of the same loop (float math from shared memory) — float32 is the
// end-to-end check against the CPU, not a serving type.  Both skip k tiles
// that the causal or window mask hides entirely, mask the ragged Sq and Sk
// edges instead of padding them, and read q, k and v through strides, so
// the model's (B, S, H, D) projections go in without a transposing copy.
// Not yet used: wgmma and TMA, the next factor of speed.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

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
};

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
  const int kv_end = min(a.sk, a.kv_len);

  stage_rows<T, D, BQ, DP>(
      q_s, [&](int t) -> const T* { return t < q_rows ? qb + (q0 + t) * a.q_ss : nullptr; },
      a.scale);

  // k tiles wholly hidden by the causal or window mask are skipped
  int k_hi = kv_end;
  if (a.causal) k_hi = min(k_hi, q0 + q_rows + a.q_offset);
  int k_lo = 0;
  if (a.window > 0) k_lo = max(0, q0 + a.q_offset - a.window + 1) / kKeys * kKeys;

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
      const int qpos = q0 + i + a.q_offset;
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
// bf16 on the tensor cores (head_dim <= 192): mma.sync m16n8k16, f32 accumulate
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
  const int kv_end = min(a.sk, a.kv_len);

  stage_bf16<D, kMmaRows, PITCH>(
      q_s, [&](int r) -> const bf16* { return r < q_rows ? qb + (q0 + r) * a.q_ss : nullptr; });
  __syncthreads();
  const int r0 = warp * 16 + g;                // this lane's rows: r0 and r0 + 8
  auto q_frag = [&](int kk, uint32_t (&f)[4]) {
    const bf16* p = q_s + r0 * PITCH + kk * 16 + 2 * t;
    f[0] = ld32(p);
    f[1] = ld32(p + 8 * PITCH);
    f[2] = ld32(p + 8);
    f[3] = ld32(p + 8 * PITCH + 8);
  };
  // Up to D = 128 the Q fragments stay in registers for the whole k loop.
  // Wider heads (MLA's 192) would hold 4 * D / 16 more registers beside
  // the 16 x D output, so they read Q's fragments from shared memory
  // again for every k tile instead of spilling.
  constexpr bool kQInRegs = D <= 128;
  uint32_t qa[kQInRegs ? KD : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) q_frag(kk, qa[kk]);
  }

  int k_hi = kv_end;
  if (a.causal) k_hi = min(k_hi, q0 + q_rows + a.q_offset);
  int k_lo = 0;
  if (a.window > 0) k_lo = max(0, q0 + a.q_offset - a.window + 1) / kMmaKeys * kMmaKeys;

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const bool row_ok[2] = {r0 < q_rows, r0 + 8 < q_rows};
  const int qpos[2] = {q0 + r0 + a.q_offset, q0 + r0 + 8 + a.q_offset};

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
      uint32_t qf[4];
      if constexpr (kQInRegs) {
        qf[0] = qa[kk][0];
        qf[1] = qa[kk][1];
        qf[2] = qa[kk][2];
        qf[3] = qa[kk][3];
      } else {
        q_frag(kk, qf);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const bf16* p = k_s + (j * 8 + g) * PITCH + kk * 16 + 2 * t;
        mma_16816(s[j], qf, ld32(p), ld32(p + 8));
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

// float32 and head_dim 256 run on the CUDA cores; bf16 up to 192 on the
// tensor cores (48 and 192 are MLA's heads: qk_nope + qk_rope of the
// reduced and the published deepseek-v3)
template <typename T>
cudaError_t dispatch(int head_dim, const FlashArgs& a, int batch, int heads, cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    switch (head_dim) {
      case 32: return launch_mma<32>(a, batch, heads, s);
      case 48: return launch_mma<48>(a, batch, heads, s);
      case 64: return launch_mma<64>(a, batch, heads, s);
      case 128: return launch_mma<128>(a, batch, heads, s);
      case 192: return launch_mma<192>(a, batch, heads, s);
      case 256: return launch<T, 256>(a, batch, heads, s);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (head_dim) {
      case 32: return launch<T, 32>(a, batch, heads, s);
      case 48: return launch<T, 48>(a, batch, heads, s);
      case 64: return launch<T, 64>(a, batch, heads, s);
      case 128: return launch<T, 128>(a, batch, heads, s);
      case 192: return launch<T, 192>(a, batch, heads, s);
      case 256: return launch<T, 256>(a, batch, heads, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).  Launches on `stream`, allocates nothing and does
// not synchronise.
extern "C" int flash_attention_launch(
    int dtype, int head_dim, const void* q, const void* k, const void* v, void* out,
    int batch, int heads, int rep, int sq, int sk,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, int q_offset, int kv_len,
    float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || rep <= 0 || heads % rep != 0 || sq <= 0 || sk <= 0)
    return cudaErrorInvalidValue;
  const FlashArgs a{q, k, v, out, rep, sq, sk,
                    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                    causal, window, q_offset, kv_len, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? dispatch<float>(head_dim, a, batch, heads, s)
                    : dtype == 1 ? dispatch<__nv_bfloat16>(head_dim, a, batch, heads, s)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
