// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_decode_attention` in
// src/repro/kernels/paged_attn.py (body `_paged_attn_kernel`, reached from
// `ops.paged_attention` in src/repro/kernels/ops.py).
//
// What it computes: one decode query per lane.  For lane b and KV head g, the
// rep = H / Hkv query rows of that group attend over the pages named by
// block_table[b, :], where table slot p holds positions p*PS .. p*PS+PS-1.
// Positions >= lengths[b] and slots holding -1 are masked.  Softmax is online
// with float accumulation; a lane whose length is 0 writes zeros.
//
// What bounds it on the H100: device memory.  A step reads each live token's
// K and V row once (B * L * Hkv * D * 2 * itemsize bytes) and does 4 flops
// per element read, far below the ~295 flop/byte the tensor cores need.
//
// What the design does about that:
//  * It reads the pools in place, in the serving cache's public layout
//    (n_pages, PS, Hkv, D), through the strides it is given.  The TPU
//    wrapper transposed both pools to (Hkv, n_pages, PS, D) and padded D on
//    every call; on this card that would copy every layer's whole pool on
//    every decode step.
//  * A block serves one (lane, KV head) and holds all rep query rows of the
//    group, so the rows sharing a KV head read it once.
//  * A decode batch has few (lane, KV head) pairs (16 for 8 lanes of
//    qwen2.5-3b) against 132 SMs, so each pair's pages are split across
//    `splits` blocks (grid B x Hkv x splits).  Each block writes its rows'
//    partial (acc, max, sum) and a second small kernel merges the splits —
//    the flash-decoding split that the TPU's sequential grid did not need.
//  * A block copies its slice of the block table to shared memory first (the
//    TPU kernel got the table by scalar prefetch), then stages 32 tokens of
//    K and V at a time in one pass of 16-byte loads, any page size.
//  * The math is float on the CUDA cores: per token it is 2 * rep * D flops,
//    too little to feed tensor cores.

#include "common.cuh"

namespace {

constexpr int kChunk = 32;     // tokens staged per step: one per lane of a warp
constexpr int kMaxRep = 16;    // query rows per KV head

struct PagedArgs {
  const void* q;               // (B, Hkv * rep, D) contiguous
  const void* k_pool;          // (n_pages, PS, Hkv, D), last dim contiguous
  const void* v_pool;          //   same strides as k_pool
  const int* block_table;      // (B, P) contiguous, -1 = unallocated
  const int* lengths;          // (B,)
  void* out;                   // (B, Hkv * rep, D) contiguous
  float* part;                 // splits > 1: (B, Hkv, splits, rep, D + 2) partials
  int rep, page_size, pages_per_lane, split_pages;
  long long sp, so, sh;        // pool strides in elements: page, offset, head
  float scale;
};

template <int D>
size_t paged_smem_bytes(int split_pages) {
  constexpr int DP = D + 4;
  return sizeof(float) * (kMaxRep * DP + 2 * kChunk * DP + kMaxRep * kChunk + kMaxRep) +
         sizeof(int) * split_pages;
}

template <typename T, int D>
__global__ void __launch_bounds__(rt::kThreads) paged_decode_attn(const PagedArgs a) {
  using namespace rt;
  constexpr int DP = D + 4;                    // row pitch: float4 reads stay conflict-free
  constexpr int RPW = kMaxRep / kWarps;        // softmax rows per warp
  constexpr int TD = D < kThreads ? D : kThreads;
  constexpr int RG = kThreads / TD;            // row groups in the P @ V step
  constexpr int COLS = D / TD;
  constexpr int PV_ROWS = kMaxRep / RG;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);    // kMaxRep x DP, pre-scaled
  float* k_s = q_s + kMaxRep * DP;                 // kChunk x DP
  float* v_s = k_s + kChunk * DP;                  // kChunk x DP
  float* p_s = v_s + kChunk * DP;                  // kMaxRep x kChunk
  float* r_s = p_s + kMaxRep * kChunk;             // kMaxRep: alpha per chunk, l at the end
  int* bt_s = reinterpret_cast<int*>(r_s + kMaxRep);   // this split's table slice

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x, g = blockIdx.y, hkv = gridDim.y, split = blockIdx.z;
  const int rep = a.rep, ps = a.page_size;
  const long long row0 = (static_cast<long long>(b) * hkv + g) * rep;  // first q row
  const T* qb = static_cast<const T*>(a.q) + row0 * D;
  const T* kp = static_cast<const T*>(a.k_pool) + g * a.sh;
  const T* vp = static_cast<const T*>(a.v_pool) + g * a.sh;
  const int* bt = a.block_table + static_cast<long long>(b) * a.pages_per_lane;
  const int p0 = split * a.split_pages;
  const int p1 = min(p0 + a.split_pages, a.pages_per_lane);
  const int t_hi = min(max(0, a.lengths[b]), p1 * ps);   // this split's tokens: [p0*ps, t_hi)

  for (int i = tid; i < a.split_pages; i += kThreads) bt_s[i] = p0 + i < p1 ? bt[p0 + i] : -1;
  stage_rows<T, D, kMaxRep, DP>(
      q_s, [&](int r) -> const T* { return r < rep ? qb + r * D : nullptr; }, a.scale);
  __syncthreads();

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

  // element offset of position pos's row in a pool, or -1 when masked
  auto row_off = [&](int pos) -> long long {
    if (pos >= t_hi) return -1;
    const int page = bt_s[pos / ps - p0];
    return page < 0 ? -1 : page * a.sp + (pos % ps) * a.so;
  };

  for (int c0 = p0 * ps; c0 < t_hi; c0 += kChunk) {
    stage_pair<T, D, kChunk, DP>(k_s, v_s, kp, vp, [&](int t) { return row_off(c0 + t); });
    __syncthreads();

    // scores: lane j holds token c0 + j; warp w holds rows w, w + 4, ...
    float s[RPW];
#pragma unroll
    for (int n = 0; n < RPW; ++n) s[n] = 0.f;
    const float* kr = k_s + lane * DP;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int n = 0; n < RPW; ++n) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (warp + kWarps * n) * DP + d);
        s[n] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, s[n]))));
      }
    }
    const bool valid = row_off(c0 + lane) >= 0;
#pragma unroll
    for (int n = 0; n < RPW; ++n) {
      const int r = warp + kWarps * n;
      if (r < rep) {                           // warp-uniform
        float alpha;
        p_s[r * kChunk + lane] = online_softmax(valid ? s[n] : -INFINITY, m[n], l[n], alpha);
        if (lane == 0) r_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V
#pragma unroll
    for (int r = 0; r < PV_ROWS; ++r) {
      const int i = ir + r * RG;
      if (i < rep) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] *= r_s[i];
      }
    }
#pragma unroll 2
    for (int t = 0; t < kChunk; t += 4) {
      float vv[COLS][4];
#pragma unroll
      for (int c = 0; c < COLS; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u) vv[c][u] = v_s[(t + u) * DP + dc + c * TD];
#pragma unroll
      for (int r = 0; r < PV_ROWS; ++r) {
        const int i = ir + r * RG;
        if (i < rep) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + i * kChunk + t);
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            acc[r][c] = fmaf(p.x, vv[c][0], fmaf(p.y, vv[c][1],
                        fmaf(p.z, vv[c][2], fmaf(p.w, vv[c][3], acc[r][c]))));
        }
      }
    }
    __syncthreads();
  }

  if (gridDim.z > 1) {
    // partials of this split: acc (rep x D), then max and sum per row
    float* part = a.part + ((static_cast<long long>(b) * hkv + g) * gridDim.z + split) *
                               (static_cast<long long>(rep) * (D + 2));
#pragma unroll
    for (int n = 0; n < RPW; ++n) {
      const int r = warp + kWarps * n;
      if (r < rep && lane == 0) {
        part[rep * D + r] = m[n];
        part[rep * D + rep + r] = l[n];
      }
    }
#pragma unroll
    for (int r = 0; r < PV_ROWS; ++r) {
      const int i = ir + r * RG;
      if (i < rep) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) part[i * D + dc + c * TD] = acc[r][c];
      }
    }
    return;
  }
#pragma unroll
  for (int n = 0; n < RPW; ++n) {
    const int r = warp + kWarps * n;
    if (r < rep && lane == 0) r_s[r] = l[n];
  }
  __syncthreads();
  T* ob = static_cast<T*>(a.out) + row0 * D;
#pragma unroll
  for (int r = 0; r < PV_ROWS; ++r) {
    const int i = ir + r * RG;
    if (i < rep) {
      const float inv = 1.f / fmaxf(r_s[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < COLS; ++c) store(ob + i * D + dc + c * TD, acc[r][c] * inv);
    }
  }
}

// Merges the splits' partials of one query row (block (lane, KV head, row)):
// rescale each split's accumulator and sum by exp(max_split - max_all).
template <typename T>
__global__ void __launch_bounds__(rt::kThreads) paged_combine(const float* part, T* out,
                                                              int splits, int d) {
  const int b = blockIdx.x, g = blockIdx.y, r = blockIdx.z;
  const int hkv = gridDim.y, rep = gridDim.z;
  const long long pair = static_cast<long long>(b) * hkv + g;
  const long long stride = static_cast<long long>(rep) * (d + 2);
  const float* base = part + pair * splits * stride;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, base[s * stride + rep * d + r]);
  T* orow = out + (pair * rep + r) * d;
  for (int c = threadIdx.x; c < d; c += rt::kThreads) {
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < splits; ++s) {
        const float* ps = base + s * stride;
        const float ms = ps[rep * d + r];
        const float w = ms == -INFINITY ? 0.f : expf(ms - mx);
        num = fmaf(ps[r * d + c], w, num);
        den = fmaf(ps[rep * d + rep + r], w, den);
      }
    }
    rt::store(orow + c, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const PagedArgs& a, int batch, int hkv, int splits, cudaStream_t stream) {
  const size_t smem = paged_smem_bytes<D>(a.split_pages);
  cudaError_t err = rt::allow_smem(paged_decode_attn<T, D>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_attn<T, D><<<dim3(batch, hkv, splits), rt::kThreads, smem, stream>>>(a);
  if (splits > 1) {
    paged_combine<T><<<dim3(batch, hkv, a.rep), rt::kThreads, 0, stream>>>(
        a.part, static_cast<T*>(a.out), splits, D);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int head_dim, const PagedArgs& a, int batch, int hkv, int splits,
                     cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch<T, 32>(a, batch, hkv, splits, s);
    case 64: return launch<T, 64>(a, batch, hkv, splits, s);
    case 128: return launch<T, 128>(a, batch, hkv, splits, s);
    case 256: return launch<T, 256>(a, batch, hkv, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `splits` blocks share each (lane, KV
// head), each over `split_pages` table slots; with splits > 1, `part` is
// float scratch of B * Hkv * splits * rep * (D + 2).  Returns
// cudaGetLastError() after the launches (0 = launched).  Launches on
// `stream`, allocates nothing and does not synchronise.
extern "C" int paged_decode_attention_launch(
    int dtype, int head_dim, const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* lengths, void* out, void* part, int batch, int hkv,
    int rep, int page_size, int pages_per_lane, int splits, int split_pages, long long sp,
    long long so, long long sh, float scale, void* stream) {
  if (batch <= 0 || hkv <= 0 || rep <= 0 || rep > kMaxRep || page_size <= 0 ||
      splits <= 0 || split_pages <= 0 || (splits > 1 && part == nullptr) ||
      static_cast<long long>(splits) * split_pages < pages_per_lane)
    return cudaErrorInvalidValue;
  const PagedArgs a{q, k_pool, v_pool, static_cast<const int*>(block_table),
                    static_cast<const int*>(lengths), out, static_cast<float*>(part), rep,
                    page_size, pages_per_lane, split_pages, sp, so, sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? dispatch<float>(head_dim, a, batch, hkv, splits, s)
                    : dtype == 1 ? dispatch<__nv_bfloat16>(head_dim, a, batch, hkv, splits, s)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
