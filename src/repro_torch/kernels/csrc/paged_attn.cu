// Paged decode attention for Hopper (sm_90a): one launch per call.
//
// Replaces the Pallas TPU kernel `paged_decode_attention` in
// src/repro/kernels/paged_attn.py:130 (`pl.pallas_call` at :167, body
// `_paged_attn_kernel` at :74), reached from `ops.paged_attention`.
//
// What it computes: one decode query per lane.  For lane b and KV head g, the
// rep = H / Hkv query rows of that group attend over the pages named by
// block_table[b, :], where table slot p holds positions p*PS .. p*PS+PS-1.
// Positions >= lengths[b] and slots holding -1 (holes too) are masked.
// Softmax is online with float m, l and accumulator; a lane with nothing
// visible writes zeros.  The pools are read in place, in the serving cache's
// layout (n_pages, PS, Hkv, D), through the strides they have.
//
// What bounds it on the H100: device memory.  A call reads each live token's
// K and V row once (tokens * Hkv * D * 2 * itemsize bytes) and does 4 flops
// per element read, far below the ~295 flop/byte the tensor cores need.  At
// the served shapes that is 4.3 MB (qwen2.5-3b: 8 lanes at ~524 tokens, Hkv
// 2) and 17 MB (qwen3-moe: 8 lanes at ~1,036 tokens, Hkv 4): 1.3 and 5.1 us
// at 3.35 TB/s.  That is the order of the fixed cost of one launch: an
// empty kernel takes 0.9 us of device time on the H100 (`chip_smoke.py`
// phase 2), above the 0.84 us bound of its 8-lane qwen2.5-3b case.  So what
// counts is that a call is one launch, that every block it starts has
// work, that a block's loads are in flight together, and that the work
// around the loads (staging, merging, barriers) is short; `chip_smoke.py`
// times each paged row with every lane empty too, which is that work
// alone.
//
// What the design does about that:
//  * One launch.  The C blocks that split one (lane, KV head) pair form a
//    thread-block cluster (grid C x Hkv x B, cluster C x 1 x 1).  Each block
//    leaves its (m, l, acc) in its own shared memory; after a cluster
//    barrier every block reads all C states through distributed shared
//    memory and writes a D / C slice of the merged rows.  No global scratch,
//    no atomics, no second kernel, and no state kept between calls, so a
//    call can be captured in a CUDA graph.  C comes from the host's plan
//    (`ops.paged_plan`): a function of the SM count, B, Hkv and the table's
//    slots, capped by what `cudaOccupancyMaxActiveClusters` says fits.
//    Clusters fit at every served shape, so the fallback the design left
//    open (the last block of a pair merges through a ticket in global
//    memory) is not built.
//  * The split is by length, on the device.  Block s of a pair takes the
//    16-key tiles [s*T, (s+1)*T) of the lane's ceil(len / 16), T = ceil of
//    that over C, so every block of a live lane has work and the host never
//    reads the lengths.  A block with no tiles still joins both cluster
//    barriers; the merge gives a state with m = -inf weight 0 without
//    forming exp(-inf - -inf).
//  * K and V come through an asynchronous ring.  A block first copies its
//    slice of the block table to shared memory (the TPU kernel got the
//    table by scalar prefetch), then streams 16-byte cp.async copies of the
//    rows of its tiles into a ring of 3 stages: two tiles are in flight
//    while one is computed.  A row of a -1 slot or past the length is not
//    read (the copy zero-fills it) and is masked in the scores.  bf16 stays
//    bf16 in shared memory; rows are padded by 16 bytes, so ldmatrix reads
//    them without bank conflicts.
//  * bf16 math runs on the tensor cores, mma.sync m16n8k16 with float
//    accumulators.  The rep query rows are the 16-row M operand (rep 16
//    fills it; smaller reps are padded with zero rows that are never
//    stored).  Each of the 4 warps owns every fourth tile of the block and
//    its own ring, so warps never wait for each other inside the loop:
//    S = Q K^T over D, the online softmax in registers, then P (rounded to
//    bf16, as flash does) times V read by ldmatrix.trans.  The warps'
//    states merge in shared memory before the cluster merge.  wgmma is not
//    used: its 64-row minimum would leave >= 75 % of every product empty.
//  * float32, the card-against-CPU check type, keeps the CUDA cores: a
//    32-key tile shared by the block through the same kind of ring, lane j
//    scoring key j, and the same one-launch cluster merge.
//  * Softmax runs in base 2 (scores pre-multiplied by scale * log2 e).

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "gemm.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = rt::kThreads;     // 4 warps
constexpr int kWarps = rt::kWarps;
constexpr int kRows = 16;                  // query rows per pair: MAX_REP, mma's M
constexpr int kTile = 16;                  // keys per warp tile (mma's K in P V); the split unit
constexpr int kStages = 3;                 // ring depth: two tiles in flight, one computed
constexpr int kF32Keys = 32;               // keys per block tile on the float path
constexpr int kMaxCluster = 16;            // 8 is portable; 16 needs the non-portable opt-in
constexpr float kLog2e = 1.4426950408889634f;

// two floats as bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

struct PagedArgs {
  const void* q;               // (B, Hkv * rep, D) contiguous
  const void* k_pool;          // (n_pages, PS, Hkv, D), last dim contiguous
  const void* v_pool;          //   same strides as k_pool
  const int* block_table;      // (B, P) contiguous, -1 = unallocated
  const int* lengths;          // (B,)
  void* out;                   // (B, Hkv * rep, D) contiguous
  int rep, page_size, pages_per_lane;
  long long sp, so, sh;        // pool strides in elements: page, offset, head
  float scale_log2;            // scale * log2(e)
};

// The positions [lo, hi) and table slots [slot_lo, slot_lo + nslots) of
// block `s` of the `c` blocks that split lane b.
struct Range {
  int lo, hi, slot_lo, nslots;
};

__device__ __forceinline__ Range split_range(const PagedArgs& a, int b, int s, int c) {
  const int len = min(max(a.lengths[b], 0), a.pages_per_lane * a.page_size);
  const int tiles = (len + kTile - 1) / kTile;
  const int per = (tiles + c - 1) / c;
  const int t0 = min(s * per, tiles), t1 = min(t0 + per, tiles);
  Range r;
  r.lo = t0 * kTile;
  r.hi = max(r.lo, min(t1 * kTile, len));
  r.slot_lo = r.lo / a.page_size;
  r.nslots = r.hi > r.lo ? (r.hi - 1) / a.page_size - r.slot_lo + 1 : 0;
  return r;
}

// The most table slots any block's range can span with `c` blocks a pair.
inline int slice_slots(int pages, int page_size, int c) {
  const long long tiles = (static_cast<long long>(pages) * page_size + kTile - 1) / kTile;
  const long long per = (tiles + c - 1) / c;
  return static_cast<int>(std::min<long long>(pages, per * kTile / page_size + 2));
}

// Element offset of position pos's row in a pool (head offset excluded), or
// -1 when it is masked: past the range, or on a -1 slot.
__device__ __forceinline__ long long row_offset(const PagedArgs& a, const int* bt_s,
                                                const Range& r, int pos) {
  if (pos < r.lo || pos >= r.hi) return -1;
  const int page = bt_s[pos / a.page_size - r.slot_lo];
  return page < 0 ? -1 : page * a.sp + (pos % a.page_size) * a.so;
}

// Q's rows (zeros past rep) into shared memory by async copies, then the
// block's table slice; returns once both have landed, block-wide.
template <typename T, int D, int PITCH>
__device__ __forceinline__ void stage_q_and_table(T* q_s, int* bt_s, const T* qb, const int* bt,
                                                  const Range& r, int rep) {
  constexpr int CPR = D * static_cast<int>(sizeof(T)) / 16;   // 16-byte chunks per row
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));       // elements per chunk
  for (int i = threadIdx.x; i < kRows * CPR; i += kThreads) {
    const int row = i / CPR, c = i % CPR;
    gemm::cp_async16(q_s + row * PITCH + c * EPC, row < rep ? qb + row * D + c * EPC : qb,
                     row < rep);
  }
  gemm::cp_async_commit();
  for (int i = threadIdx.x; i < r.nslots; i += kThreads) bt_s[i] = bt[r.slot_lo + i];
  gemm::cp_async_wait<0>();
  __syncthreads();
}

// A pair's state in shared memory, all float: m[kRows], l[kRows] (base 2),
// then acc[kRows][D], not yet divided by l.
template <int D>
constexpr int kState = 2 * kRows + kRows * D;
// the cluster merge's own scratch: weights [kMaxCluster][kRows], sums
// [kMaxCluster][kRows], 1 / denominator [kRows]
constexpr int kScratch = 2 * kMaxCluster * kRows + kRows;

// Merges the C states of the cluster's blocks: block s writes columns
// [s * D / C, (s + 1) * D / C) of the pair's rep output rows.  Every thread
// of every block calls it.
template <typename T, int D>
__device__ __forceinline__ void cluster_merge(float* state, float* scratch, T* out, int rep) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int s = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  float* w = scratch;                        // m of each block, then its weight
  float* lsum = scratch + kMaxCluster * kRows;
  float* inv = lsum + kMaxCluster * kRows;
  cluster.sync();                            // every block's state is written
  for (int i = tid; i < c * kRows; i += kThreads) {
    const float* remote = cluster.map_shared_rank(state, i / kRows);
    w[i] = remote[i % kRows];
    lsum[i] = remote[kRows + i % kRows];
  }
  __syncthreads();
  if (tid < kRows) {
    float mx = -INFINITY;
    for (int k = 0; k < c; ++k) mx = fmaxf(mx, w[k * kRows + tid]);
    float den = 0.f;
    for (int k = 0; k < c; ++k) {
      const float m = w[k * kRows + tid];
      const float wk = m == -INFINITY ? 0.f : exp2f(m - mx);
      w[k * kRows + tid] = wk;
      den = fmaf(wk, lsum[k * kRows + tid], den);
    }
    inv[tid] = den > 0.f ? 1.f / den : 0.f;
  }
  __syncthreads();
  const int cols = D / c, c0 = s * cols;
  for (int i = tid; i < rep * cols; i += kThreads) {
    const int r = i / cols, col = c0 + i % cols;
    float num = 0.f;
    for (int k = 0; k < c; ++k) {
      const float wk = w[k * kRows + r];
      if (wk != 0.f) num = fmaf(wk, cluster.map_shared_rank(state, k)[2 * kRows + r * D + col], num);
    }
    rt::store(out + r * D + col, num * inv[r]);
  }
  cluster.sync();                            // no block leaves while its state is read
}

// ---------------------------------------------------------------------------
// bf16: mma.sync, one ring per warp
// ---------------------------------------------------------------------------

template <int D>
struct MmaLayout {
  static constexpr int PITCH = D + 8;                    // bf16 a row: 16 bytes of padding
  static constexpr int TILE = 2 * kTile * PITCH;         // a stage: K rows, then V rows
  static constexpr int WARP_RING = kStages * TILE;       // bf16 per warp
  static constexpr size_t BYTES = sizeof(bf16) * (kRows * PITCH + kWarps * WARP_RING);
  // after the loop a warp's ring holds its state; warp 0's also the
  // block's, warp 1's the merge scratch
  static_assert(sizeof(float) * (2 * kState<D> + kScratch) <= sizeof(bf16) * WARP_RING,
                "a warp's ring holds two states");
};

// Warp w owns tiles w, w + 4, ... of the block's range.  In the mma layouts
// lane 4g + t holds rows g and g + 8 and columns 2t, 2t + 1 of each 8-wide
// block; S's fragment becomes P's A operand without leaving registers.
template <int D>
__global__ void __launch_bounds__(kThreads) paged_decode_mma(const PagedArgs a) {
  using L = MmaLayout<D>;
  constexpr int PITCH = L::PITCH, CPR = D / 8, KD = D / 16, ND = D / 8;
  constexpr bool Q_IN_REGS = D <= 128;        // at 256, O's 128 floats leave no room for Q
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  bf16* ring = q_s + kRows * PITCH;
  int* bt_s = reinterpret_cast<int*>(ring + kWarps * L::WARP_RING);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int rep = a.rep;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + kvh) * rep;
  const bf16* kp = static_cast<const bf16*>(a.k_pool) + kvh * a.sh;
  const bf16* vp = static_cast<const bf16*>(a.v_pool) + kvh * a.sh;
  const Range rg = split_range(a, b, s, gridDim.x);
  stage_q_and_table<bf16, D, PITCH>(q_s, bt_s, static_cast<const bf16*>(a.q) + row0 * D,
                                    a.block_table + static_cast<long long>(b) * a.pages_per_lane,
                                    rg, rep);

  uint32_t qa[Q_IN_REGS ? KD : 1][4];
  auto q_frag = [&](int kk, uint32_t(&f)[4]) {
    gemm::ldmatrix_x4(f, q_s + (lane % 16) * PITCH + kk * 16 + (lane / 16) * 8);
  };
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) q_frag(kk, qa[kk]);
  }

  const int ntiles = (rg.hi - rg.lo + kTile - 1) / kTile;
  const int mine = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps : 0;
  bf16* wring = ring + warp * L::WARP_RING;
  auto tile_pos = [&](int i) { return rg.lo + (warp + kWarps * i) * kTile; };
  // lane j < 16: the pool offset of key j of the tile at p0, or -1
  auto key_off = [&](int p0) -> long long {
    return lane < kTile ? row_offset(a, bt_s, rg, p0 + lane) : -1;
  };
  auto issue = [&](int i) {
    const long long off = key_off(tile_pos(i));
    bf16* ks = wring + (i % kStages) * L::TILE;
    bf16* vs = ks + kTile * PITCH;
#pragma unroll
    for (int j = 0; j < kTile * CPR / 32; ++j) {
      const int e = lane + 32 * j, r = e / CPR, c = e % CPR;
      const long long o = __shfl_sync(0xffffffffu, off, r);
      gemm::cp_async16(ks + r * PITCH + c * 8, o >= 0 ? kp + o + c * 8 : kp, o >= 0);
      gemm::cp_async16(vs + r * PITCH + c * 8, o >= 0 ? vp + o + c * 8 : vp, o >= 0);
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
    const unsigned valid = __ballot_sync(0xffffffffu, key_off(tile_pos(i)) >= 0);

    // S = Q K^T: n-tile 0 holds keys 0-7, n-tile 1 keys 8-15
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qf[4], kf[4];
      if constexpr (Q_IN_REGS) {
        qf[0] = qa[kk][0];
        qf[1] = qa[kk][1];
        qf[2] = qa[kk][2];
        qf[3] = qa[kk][3];
      } else {
        q_frag(kk, qf);
      }
      gemm::ldmatrix_x4(kf, ks + ((lane & 7) + ((lane >> 4) << 3)) * PITCH + kk * 16 +
                                ((lane >> 3) & 1) * 8);
      gemm::mma_16816(sc[0], qf, kf[0], kf[1]);
      gemm::mma_16816(sc[1], qf, kf[2], kf[3]);
    }

    // mask, then the online softmax of rows g (h = 0) and g + 8 (h = 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t + (e & 1);
        sc[j][e] = (valid >> key) & 1u ? sc[j][e] * a.scale_log2 : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], sc[j][e]);
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
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
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

  // the block's state (in warp 0's ring, after its part): the warps' merged;
  // their weights go through the merge scratch (in warp 1's ring)
  auto part_of = [&](int w) { return reinterpret_cast<const float*>(ring + w * L::WARP_RING); };
  float* state = reinterpret_cast<float*>(ring) + kState<D>;
  float* scratch = reinterpret_cast<float*>(ring + L::WARP_RING) + kState<D>;
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
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      acc = fmaf(scratch[w * kRows + r], part_of(w)[2 * kRows + i], acc);
    state[2 * kRows + i] = acc;
  }
  cluster_merge<bf16, D>(state, scratch, static_cast<bf16*>(a.out) + row0 * D, rep);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, one ring shared by the block
// ---------------------------------------------------------------------------

template <int D>
struct FmaLayout {
  static constexpr int DP = D + 4;                       // float4 reads stay conflict-free
  static constexpr int TILE = 2 * kF32Keys * DP;         // a stage: K rows, then V rows
  static constexpr size_t BYTES =
      sizeof(float) * (kRows * DP + kRows * kF32Keys + kRows + kStages * TILE);
  static_assert(kState<D> + kScratch <= kStages * TILE, "the ring holds the state");
};

// the online-softmax update of one row in base 2 (one score per lane)
__device__ __forceinline__ float online_softmax2(float s, float& m, float& l, float& alpha) {
  const float m_new = fmaxf(m, rt::warp_max(s));
  const float p = s == -INFINITY ? 0.f : exp2f(s - m_new);
  alpha = m == -INFINITY ? 0.f : exp2f(m - m_new);
  l = l * alpha + rt::warp_sum(p);
  m = m_new;
  return p;
}

template <int D>
__global__ void __launch_bounds__(kThreads) paged_decode_fma(const PagedArgs a) {
  using L = FmaLayout<D>;
  constexpr int DP = L::DP, CPR = D / 4;
  constexpr int RPW = kRows / kWarps;          // softmax rows per warp
  constexpr int TD = D < kThreads ? D : kThreads;
  constexpr int RG = kThreads / TD;            // row groups in the P V step
  constexpr int COLS = D / TD;
  constexpr int PV_ROWS = kRows / RG;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);    // kRows x DP
  float* p_s = q_s + kRows * DP;                   // kRows x kF32Keys
  float* r_s = p_s + kRows * kF32Keys;             // kRows: alpha of the tile
  float* ring = r_s + kRows;                       // kStages x TILE
  int* bt_s = reinterpret_cast<int*>(ring + kStages * L::TILE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int rep = a.rep;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + kvh) * rep;
  const float* kp = static_cast<const float*>(a.k_pool) + kvh * a.sh;
  const float* vp = static_cast<const float*>(a.v_pool) + kvh * a.sh;
  const Range rg = split_range(a, b, s, gridDim.x);
  stage_q_and_table<float, D, DP>(q_s, bt_s, static_cast<const float*>(a.q) + row0 * D,
                                  a.block_table + static_cast<long long>(b) * a.pages_per_lane,
                                  rg, rep);

  auto issue = [&](int i) {
    const int c0 = rg.lo + i * kF32Keys;
    float* ks = ring + (i % kStages) * L::TILE;
    for (int e = tid; e < 2 * kF32Keys * CPR; e += kThreads) {
      const int half = e / (kF32Keys * CPR), w = e % (kF32Keys * CPR);
      const int r = w / CPR, c = w % CPR;
      const long long off = row_offset(a, bt_s, rg, c0 + r);
      const float* src = half ? vp : kp;
      gemm::cp_async16(ks + half * kF32Keys * DP + r * DP + c * 4,
                       off >= 0 ? src + off + c * 4 : src, off >= 0);
    }
  };

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

  const int ntiles = (rg.hi - rg.lo + kF32Keys - 1) / kF32Keys;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles) issue(i);
    gemm::cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    if (i + kStages - 1 < ntiles) issue(i + kStages - 1);
    gemm::cp_async_commit();
    gemm::cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* k_s = ring + (i % kStages) * L::TILE;
    const float* v_s = k_s + kF32Keys * DP;
    const int c0 = rg.lo + i * kF32Keys;

    // scores: lane j holds key c0 + j; warp w holds rows w, w + 4, ...
    float sc[RPW];
#pragma unroll
    for (int n = 0; n < RPW; ++n) sc[n] = 0.f;
    const float* kr = k_s + lane * DP;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int n = 0; n < RPW; ++n) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (warp + kWarps * n) * DP + d);
        sc[n] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, sc[n]))));
      }
    }
    const bool valid = row_offset(a, bt_s, rg, c0 + lane) >= 0;
#pragma unroll
    for (int n = 0; n < RPW; ++n) {
      const int r = warp + kWarps * n;
      if (r < rep) {                           // warp-uniform
        float alpha;
        p_s[r * kF32Keys + lane] =
            online_softmax2(valid ? sc[n] * a.scale_log2 : -INFINITY, m[n], l[n], alpha);
        if (lane == 0) r_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int r = 0; r < PV_ROWS; ++r) {
      const int row = ir + r * RG;
      if (row < rep) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] *= r_s[row];
      }
    }
#pragma unroll 2
    for (int k = 0; k < kF32Keys; k += 4) {
      float vv[COLS][4];
#pragma unroll
      for (int c = 0; c < COLS; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u) vv[c][u] = v_s[(k + u) * DP + dc + c * TD];
#pragma unroll
      for (int r = 0; r < PV_ROWS; ++r) {
        const int row = ir + r * RG;
        if (row < rep) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + row * kF32Keys + k);
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            acc[r][c] = fmaf(p.x, vv[c][0], fmaf(p.y, vv[c][1],
                        fmaf(p.z, vv[c][2], fmaf(p.w, vv[c][3], acc[r][c]))));
        }
      }
    }
    __syncthreads();                           // the stage is free for tile i + 3
  }
  gemm::cp_async_wait<0>();
  __syncthreads();

  // the block's state at the ring's start (rows past rep keep m = -inf, l = 0)
  float* state = ring;
#pragma unroll
  for (int n = 0; n < RPW; ++n) {
    if (lane == 0) {
      state[warp + kWarps * n] = m[n];
      state[kRows + warp + kWarps * n] = l[n];
    }
  }
#pragma unroll
  for (int r = 0; r < PV_ROWS; ++r) {
    const int row = ir + r * RG;
    if (row < rep) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) state[2 * kRows + row * D + dc + c * TD] = acc[r][c];
    }
  }
  cluster_merge<float, D>(state, ring + kState<D>, static_cast<float*>(a.out) + row0 * D, rep);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using KernelFn = void (*)(PagedArgs);

template <typename T, int D>
KernelFn kernel_of() {
  if constexpr (std::is_same_v<T, bf16>) {
    return paged_decode_mma<D>;
  } else {
    return paged_decode_fma<D>;
  }
}

template <typename T, int D>
size_t smem_bytes(int slice) {
  const size_t base = std::is_same_v<T, bf16> ? MmaLayout<D>::BYTES : FmaLayout<D>::BYTES;
  return base + sizeof(int) * slice;
}

// Allows the kernel `smem` bytes of dynamic shared memory and clusters of
// 16; each instantiation sets its attributes again only when it needs more.
template <typename T, int D>
cudaError_t configure(size_t smem) {
  static size_t allowed = 0;
  if (smem <= allowed) return cudaSuccess;
  const KernelFn k = kernel_of<T, D>();
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

template <typename T, int D>
cudaError_t launch(const PagedArgs& a, int batch, int hkv, int cluster, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(slice_slots(a.pages_per_lane, a.page_size, cluster));
  cudaError_t err = configure<T, D>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, hkv, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel_of<T, D>(), a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The largest cluster (16, 8, ..., 1) that the card can hold at least once.
template <typename T, int D>
int max_cluster(int pages, int page_size) {
  for (int c = kMaxCluster; c > 1; c /= 2) {
    const size_t smem = smem_bytes<T, D>(slice_slots(pages, page_size, c));
    if (configure<T, D>(smem) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c, 1, 1);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel_of<T, D>(), &cfg) == cudaSuccess && n > 0)
      return c;
    cudaGetLastError();
  }
  return 1;
}

// f(T* tag, integral_constant<int, D>) for the kernel of `dtype` and
// `head_dim`; f(nullptr, 0) when there is none.
template <typename F>
auto by_type_and_dim(int dtype, int head_dim, F f) {
  switch (dtype * 1000 + head_dim) {
    case 32: return f(static_cast<float*>(nullptr), std::integral_constant<int, 32>{});
    case 64: return f(static_cast<float*>(nullptr), std::integral_constant<int, 64>{});
    case 128: return f(static_cast<float*>(nullptr), std::integral_constant<int, 128>{});
    case 256: return f(static_cast<float*>(nullptr), std::integral_constant<int, 256>{});
    case 1032: return f(static_cast<bf16*>(nullptr), std::integral_constant<int, 32>{});
    case 1064: return f(static_cast<bf16*>(nullptr), std::integral_constant<int, 64>{});
    case 1128: return f(static_cast<bf16*>(nullptr), std::integral_constant<int, 128>{});
    case 1256: return f(static_cast<bf16*>(nullptr), std::integral_constant<int, 256>{});
    default: return f(nullptr, std::integral_constant<int, 0>{});
  }
}

__global__ void empty_kernel() {}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `cluster` blocks (1, 2, 4, 8 or 16, at
// most paged_decode_attention_max_cluster's answer) split each (lane, KV
// head) pair and merge in a thread-block cluster.  Returns the launch's
// error code (0 = launched).  Launches on `stream`, allocates nothing and
// does not synchronise.
extern "C" int paged_decode_attention_launch(
    int dtype, int head_dim, const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* lengths, void* out, int batch, int hkv, int rep,
    int page_size, int pages_per_lane, int cluster, long long sp, long long so, long long sh,
    float scale, void* stream) {
  if (batch <= 0 || batch > 65535 || hkv <= 0 || hkv > 65535 || rep <= 0 || rep > kRows ||
      page_size <= 0 || pages_per_lane <= 0 || cluster <= 0 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0)
    return cudaErrorInvalidValue;
  const PagedArgs a{q, k_pool, v_pool, static_cast<const int*>(block_table),
                    static_cast<const int*>(lengths), out, rep, page_size, pages_per_lane,
                    sp, so, sh, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = by_type_and_dim(dtype, head_dim, [&](auto t, auto d) {
    using T = std::remove_pointer_t<decltype(t)>;
    if constexpr (std::is_same_v<T, std::nullptr_t>) {
      return cudaErrorInvalidValue;
    } else {
      return launch<T, decltype(d)::value>(a, batch, hkv, cluster, s);
    }
  });
  return static_cast<int>(err);
}

// The largest cluster the card fits for this type, head dim and table (0 for
// a type or head dim without a kernel).
extern "C" int paged_decode_attention_max_cluster(int dtype, int head_dim, int pages_per_lane,
                                                  int page_size) {
  if (pages_per_lane <= 0 || page_size <= 0) return 0;
  return by_type_and_dim(dtype, head_dim, [&](auto t, auto d) {
    using T = std::remove_pointer_t<decltype(t)>;
    if constexpr (std::is_same_v<T, std::nullptr_t>) {
      return 0;
    } else {
      return max_cluster<T, decltype(d)::value>(pages_per_lane, page_size);
    }
  });
}

// One launch of a kernel that does nothing: the device time no launch goes
// under, which `chip_smoke.py` logs beside the paged rows' bounds.
extern "C" int paged_decode_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
