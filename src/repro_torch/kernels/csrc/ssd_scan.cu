// Mamba-2 SSD chunked scan for Hopper (sm_90a): one launch per call.
//
// Replaces the Pallas TPU kernel `ssd_scan` in src/repro/kernels/ssd_scan.py:89
// (`pl.pallas_call` at :106, body `_ssd_kernel` at :27), reached from
// `ops.ssd_scan`.  In the port it is the card path of
// `models/ssm.py:ssd_chunked`, so every mamba2 prefill (a whole prompt, or
// each slice of a chunked prefill) runs it once per layer.
//
// What it computes, in float32 whatever the input type: over chunks of Q
// tokens (a short last chunk is masked), with seg the running sum of dt*a
// inside the chunk, mid = (seg[0] + seg[L-1]) / 2,
//   y[i]  = e_out[i] * sum_{j<=i} (C_i . B_j) * dt_j * e_in[j] * x_j
//         + exp(seg[i]) * C_i . S
//   S'    = exp(seg[L-1]) * S + sum_j exp(seg[L-1] - seg[j]) * dt_j * x_j (x) B_j
// with e_out = exp(clip(seg - mid, +-60)) and e_in = exp(clip(mid - seg,
// +-60)), the clipped decay factorization of ssd_chunked (it differs from
// exp(seg_i - seg_j) where a chunk's seg spans more than 120, and the kernel
// keeps it).  S (P x N per head) starts from the given initial state (zeros
// for a null pointer); the final one is written out.  No D-skip.
//
// The bound at the served shapes (mamba2-130m: H 24, P 64, N 128, Q 256).
// A 256-token chunk at batch 1 with a carried state moves 4.1 MB (x, B and
// C read once in bf16, dt, y and the state read and written in float32):
// 1.2 us at 3.35 TB/s.  Its products are 0.31 GFLOP (the causal half of the
// head-free C.B^T, the causal y product, C.S and the state update).  The
// bf16 design issues them as bf16 mma.sync, the float32 operands split in
// bf16 terms (below: 3, 3 and 2), so 0.81 GFLOP of tensor-core work: 0.8 us
// at 989 TFLOP/s.  In float32 on the CUDA cores they are 4.6 us at 67
// TFLOP/s.  So a chunk is bound by neither: what costs is the chain of
// dependent steps inside it (scan, products, hand-over of the state), and
// the card has to be filled at batch 1.
//
// What the design does, against the five causes that held the first port
// of this kernel (one block per 16 columns of P, float FMAs) to 4 % of its
// float32 bound:
//  1. C.B^T once per block, not per 16 columns of P.  The grid is
//     (R, H, B): the R blocks of one (batch row, head) form a thread-block
//     cluster (R = 4 at the served shapes, 96 blocks at batch 1).  A block
//     owns up to four 16-row tiles of every chunk, tiles r, r + R, r + 2R
//     and r + 3R (early and late rows, so every block has the same causal
//     work), and all of P: it computes the C.B^T of its rows once, for the
//     head and every column of P.  In bf16 two warps share a 16-row tile,
//     one half of every 64-token tile's columns each (C.B^T and y), and the
//     two warps on one tensor core hold halves of a heavy and a light tile.
//     The state update is split across the cluster: the P x N state is cut
//     in strips (16 x 16 in bf16, 16 x 32 in float32), one per warp of the
//     cluster, each kept in that warp's registers in float32 from chunk to
//     chunk.  After a chunk every warp writes its strip (its bf16 terms)
//     into its block's copy of the state and into the same place of every
//     other block's (distributed shared memory, 16 bytes a store); the copy
//     is double buffered, so one cluster barrier per chunk boundary orders
//     the hand-over, waited on only before the next chunk's C.S (a call of
//     one chunk has none).  No global scratch: a call allocates nothing but
//     y and the final state.
//  2. bf16 products on the tensor cores (mma.sync m16n8k16, float32
//     accumulators).  B, C and x are exact bf16 values, so C.B^T is exact
//     products summed in float32.  Three operands are float32; each is split
//     into a sum of bf16 terms (v = bf16(v) + bf16(rest) + ...), every term
//     multiplied with an exact partner: the decay-weighted scores
//     (C.B^T * dt * e_in, against x) and the state S (against C) in three
//     terms, the update's dt * exp(seg_last - seg) * x (against B) in two.
//     K terms leave at most 2^-(9K - 1) of each value.  Two terms of the
//     scores or of S (2^-17) still reach 0.77 and 0.45 of the card check's
//     1e-4 where many tokens carry the same weight (a chunk where the clip
//     engages; slow decay with a carried state), and the card's own
//     accumulation pushed the first over it; three put both at the level
//     of exact products (0.25 and 0.03); one rounding alone misses by
//     90-540 times.  tests/test_torch_ssm.py emulates these at the phase-2
//     shapes.  The state itself stays float32 in registers; only the copy
//     that C.S reads is split, so no split error accumulates over chunks.
//     float32 inputs (the card-against-CPU type) take the same
//     decomposition with float32 FMAs on the CUDA cores, 4 warps a block.
//  3. A parallel decay scan: each thread sums up to 4 consecutive dt*a, a
//     warp-shuffle scan and one pass over the warp totals, in double, so
//     seg is exact before its one rounding to float32.  (Where the decay
//     clip engages, at |seg| ~ 300, the clipped weights of whole runs of
//     tokens hang on seg to a few ulp: a float32 scan in any order misses
//     the card check, and the plain version evaluated in float32, with its
//     serial cumsum on the card, is itself 3.2 times the tolerance from the
//     exact result; the check holds such chunks to the plain version
//     evaluated in float64, which the kernel meets at 0.68 of it.)
//  4. Operands stay narrow and are loaded once, ahead of their use.  B and
//     x tiles of 64 tokens run through a ring of three (bf16) or two
//     (float32) stages across chunk boundaries, the C rows of a chunk are
//     loaded at the end of the one before, each chunk's dt a chunk ahead,
//     and the initial state (32 KB) only lands for the first C.S.  At the
//     served shapes in bf16 the tiles are TMA boxes of 64 rows x 128 bytes
//     in the 128-byte swizzle (which ldmatrix reads without bank
//     conflicts), each on an mbarrier, and the initial state one 1-D bulk
//     copy: per-row copies (cp.async or bulk) held an SM to ~10 bytes a
//     cycle, which bounded the j-loop.  Other shapes take 16-byte cp.async
//     copies into rows padded by 16 bytes, and element loads where rows are
//     not 16-byte aligned.
//  5. Host issue: the wrapper passes the raw stream handle and caches its
//     launch plan per shape, the library its tensor maps per tensor; the
//     shared-memory attribute is set once per kernel instantiation; nothing
//     is read back from the card.
//
// What remains (`chip_smoke.py` phase 2, H100): the device time is 12-15x
// the bytes bound at the served shapes.  A 256-token chunk's critical path is
// its j-loop (~12K cycles: two warps a tensor core leave the dependent
// chains of C.B^T, split and products exposed), the initial state's
// conversion into bf16 terms (~4K) and C.S with y (~3.5K).

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

using bf16 = __nv_bfloat16;
constexpr int kRowsMax = 64;                  // rows of a chunk per block: 4 tiles of 16
constexpr int kJ = 64;                        // tokens per staged B / x tile
constexpr int kMaxCluster = 8;
constexpr int kMaxChunk = kMaxCluster * kRowsMax;
// bf16 terms of each float32 operand of the tensor-core products
constexpr int kScoreTerms = 3;                // scores * dt * e_in, against x
constexpr int kStateTerms = 3;                // the state copy, against C
constexpr int kUpdateTerms = 2;               // dt * exp(seg_last - seg) * x, against B

// What differs by type.  bf16: two warps share each 16-row tile (one half
// of every B / x tile's 64 columns each, the same tensor core), state
// strips of 16 x 16, a ring of three tiles.  float32 (twice the bytes a
// tile): one warp a tile, strips of 16 x 32, two stages.
template <typename T>
struct Cfg {
  static constexpr bool kMma = sizeof(T) == 2;
  static constexpr int kHalves = kMma ? 2 : 1;        // warps per 16-row tile
  static constexpr int kThreads = 128 * kHalves;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kStages = kMma ? 3 : 2;
  static constexpr int kStrip = kMma ? 2 : 4;         // n8 tiles of a state strip
  static constexpr int kPer = kMaxChunk / kThreads;   // scan values per thread
  static constexpr int kTerms = kMma ? kStateTerms : 1;
};

// state strips of a P x N state: 16 rows of P by 8 * kStrip columns
template <typename T>
__host__ __device__ constexpr int strips(int P, int N) {
  return (P + 15) / 16 * (((N + 15) / 16 * 2 + Cfg<T>::kStrip - 1) / Cfg<T>::kStrip);
}

struct SsdArgs {
  const void* x;
  const void* b;
  const void* c;
  const float* dt;
  const float* a;
  const float* init;
  float* y;
  float* fin;
  int S, H, P, N, Q, rows;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr size_t align128(size_t v) { return (v + 127) / 128 * 128; }
__host__ __device__ constexpr size_t align1024(size_t v) { return (v + 1023) / 1024 * 1024; }

// Element offset of (row, col) in a staged tile of C, B or x (col a
// multiple of 8): rows at `pitch` (padded by 16 bytes, so ldmatrix hits
// every bank once), or, SWZ, as TMA writes them with the 128-byte swizzle:
// 64-column halves of 64 rows x 128 bytes, 16-byte chunk c of row r at
// chunk c ^ (r % 8).
template <bool SWZ>
__device__ __forceinline__ int toff(int row, int col, int pitch) {
  if constexpr (SWZ) {
    return (col >> 6) * (kJ * 64) + row * 64 + ((((col >> 3) & 7) ^ (row & 7)) << 3);
  } else {
    return row * pitch + col;
  }
}

// Shared memory of a block, byte offsets.  Rows of C and B (N padded to
// np, a multiple of 16), of x (P padded to pp) and of the state copy
// (pp rows of np) carry 16 bytes of padding.  B and x tiles sit in a ring
// of kStages.  The state copy is double buffered (chunk c's C.S reads
// buffer c % 2 while the state after chunk c is written into the other);
// in bf16 a buffer holds kStateTerms arrays, the state's bf16 terms.
// bf16 adds the halves' exchange of partial y, float32 a per-warp tile of
// scores.
template <typename T>
struct Layout {
  int np, pp, cpitch, xpitch, qpad, sbuf;
  size_t cs, bs, xs, st, sc, arr, scan, bytes;
  __host__ __device__ Layout(int N, int P, int Q, bool swz) {
    using C = Cfg<T>;
    constexpr int pad = 16 / static_cast<int>(sizeof(T));
    np = round_up(N, 16);
    pp = round_up(P, 16);
    cpitch = swz ? np : np + pad;             // the swizzled tiles need no padding
    xpitch = swz ? pp : pp + pad;
    qpad = round_up(Q, kJ);
    sbuf = C::kTerms * pp * (np + pad);       // the state copy keeps its padding
    size_t o = 0;
    cs = o;
    o += align1024(sizeof(T) * kRowsMax * cpitch);
    bs = o;
    o += align1024(sizeof(T) * C::kStages * kJ * cpitch);
    xs = o;
    o += align1024(sizeof(T) * C::kStages * kJ * xpitch);
    st = o;
    o += align128(sizeof(T) * 2 * sbuf);
    sc = o;
    o += align128(sizeof(float) * (C::kMma ? C::kWarps * 16 * pp / 2 : C::kWarps * 16 * (kJ + 4)));
    arr = o;
    o += align128(sizeof(float) * 5 * qpad);
    scan = o;                                 // the scan's warp totals, then
    o += 128;                                 // (TMA) the ring's, C's and the
    bytes = o + 1024;                         // initial state's mbarriers; slack
                                              // to align the base to 1024
  }
};

// Rows [0, rows) of a tile whose row k starts at src + k * rstride, columns
// [0, n) and zeros to npad; rows at or past `lim` are zeros.  VEC: 16-byte
// async copies (n a multiple of the 16-byte vector, rows 16-byte aligned;
// `base` is a mapped address the zero-fill copies name), each thread on
// one column of 16 bytes and every (threads / chunks per row)-th row where
// that divides; else element loads.
template <typename T, bool VEC, int THREADS>
__device__ __forceinline__ void stage(T* dst, int pitch, const T* src, const T* base,
                                      long long rstride, int rows, int lim, int n, int npad) {
  if constexpr (VEC) {
    constexpr int E = 16 / static_cast<int>(sizeof(T));
    const int cpr = npad / E;
    if (THREADS % cpr == 0) {
      const int step = THREADS / cpr, col = (threadIdx.x % cpr) * E;
      const bool in = col < n;
#pragma unroll 4
      for (int r = threadIdx.x / cpr; r < rows; r += step) {
        const bool ok = in && r < lim;
        gemm::cp_async16(dst + r * pitch + col, ok ? src + r * rstride + col : base, ok);
      }
    } else {
      for (int i = threadIdx.x; i < rows * cpr; i += THREADS) {
        const int r = i / cpr, col = (i - r * cpr) * E;
        const bool ok = r < lim && col < n;
        gemm::cp_async16(dst + r * pitch + col, ok ? src + r * rstride + col : base, ok);
      }
    }
  } else {
    const int total = rows * npad;
    for (int i = threadIdx.x; i < total; i += THREADS) {
      const int r = i / npad, col = i - r * npad;
      dst[r * pitch + col] = r < lim && col < n ? src[r * rstride + col] : T(0.f);
    }
  }
}

// (v0, v1) = sum_k out[k], K bf16 pairs (lower column in the lower half):
// each term is the bf16 rounding of what the ones before it leave (the
// subtractions are exact), so K terms leave a relative error of at most
// 2^-(9K - 1).
template <int K>
__device__ __forceinline__ void split(float v0, float v1, uint32_t (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
    out[k] = *reinterpret_cast<const uint32_t*>(&b);
    const float2 f = __bfloat1622float2(b);
    v0 -= f.x;
    v1 -= f.y;
  }
}

// the K terms of four float pairs, as K fragments of an mma operand
template <int K>
__device__ __forceinline__ void split_frag(const float (&v)[8], uint32_t (&frag)[K][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t terms[K];
    split<K>(v[2 * r], v[2 * r + 1], terms);
#pragma unroll
    for (int k = 0; k < K; ++k) frag[k][r] = terms[k];
  }
}

// mma.sync m16n8k16 bf16 -> float32 as a plain register operation, so the
// compiler may interleave independent products
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// strip += (w * x)^T . B over the 64 tokens of one staged tile, on the
// tensor cores: the strip is 16 rows of P (from 16 mt) by CNT n8 tiles
// (from nt0); w * x is split in kUpdateTerms bf16 terms.
template <int CNT, bool SWZ, int S>
__device__ __forceinline__ void update_mma(float (&st)[S][4], const bf16* Xt, int xp,
                                           const bf16* Bt, int cp, const float* w_st, int j0,
                                           int lim, int mt, int nt0, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (16 * m >= lim) break;
    uint32_t xr[4], bf[CNT / 2][4];
    // x^T of rows 16 mt .. + 15 as an A fragment: (p g, j 2t), (p g + 8, j 2t),
    // (p g, j 2t + 8), (p g + 8, j 2t + 8), each a pair of tokens
    gemm::ldmatrix_x4_trans(xr, Xt + toff<SWZ>(16 * m + (lane & 7) + ((lane >> 4) << 3),
                                                16 * mt + ((lane >> 3) & 1) * 8, xp));
#pragma unroll
    for (int q = 0; q < CNT / 2; ++q)
      gemm::ldmatrix_x4_trans(bf[q], Bt + toff<SWZ>(16 * m + (lane & 15),
                                                    8 * (nt0 + 2 * q) + (lane >> 4) * 8, cp));
    const int j = j0 + 16 * m + 2 * t;
    const float2 w01 = *reinterpret_cast<const float2*>(w_st + j);
    const float2 w89 = *reinterpret_cast<const float2*>(w_st + j + 8);
    const float2 f0 = unpack(xr[0]), f1 = unpack(xr[1]), f2 = unpack(xr[2]), f3 = unpack(xr[3]);
    const float v[8] = {f0.x * w01.x, f0.y * w01.y, f1.x * w01.x, f1.y * w01.y,
                        f2.x * w89.x, f2.y * w89.y, f3.x * w89.x, f3.y * w89.y};
    uint32_t af[kUpdateTerms][4];
    split_frag<kUpdateTerms>(v, af);
#pragma unroll
    for (int k = 0; k < kUpdateTerms; ++k)
#pragma unroll
      for (int q = 0; q < CNT / 2; ++q) {
        mma(st[2 * q], af[k], bf[q][0], bf[q][1]);
        mma(st[2 * q + 1], af[k], bf[q][2], bf[q][3]);
      }
  }
}

// Writes this warp's state strip (16 rows of P from 16 mt by cnt n8 tiles
// from nt0; in bf16 its K terms, each pp * cp further) into buffer `Sn` of
// its own block, then copies it into the same place in every other block of
// the cluster, 16 bytes a store.  The caller keeps the buffer out of every
// block's reads until a cluster barrier arrived at after this.
template <typename T, int K, int S>
__device__ __forceinline__ void hand_over(T* Sn, const float (&st)[S][4], int mt, int nt0,
                                          int cnt, int cp, int pp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    if (q < cnt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int off = (16 * mt + g + 8 * hh) * cp + 8 * (nt0 + q) + 2 * t;
        if constexpr (std::is_same_v<T, bf16>) {
          uint32_t terms[K];
          split<K>(st[q][2 * hh], st[q][2 * hh + 1], terms);
#pragma unroll
          for (int k = 0; k < K; ++k) *reinterpret_cast<uint32_t*>(Sn + k * pp * cp + off) = terms[k];
        } else {
          *reinterpret_cast<float2*>(Sn + off) = make_float2(st[q][2 * hh], st[q][2 * hh + 1]);
        }
      }
    }
  }
  __syncwarp();
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank()), R = static_cast<int>(cluster.num_blocks());
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  const int cpr = 8 * cnt / E;                   // 16-byte chunks in a strip row
  for (int i = lane; i < K * 16 * cpr; i += 32) {
    const int k = i / (16 * cpr), rr = (i / cpr) % 16, c = i % cpr;
    const int off = k * pp * cp + (16 * mt + rr) * cp + 8 * nt0 + c * E;
    const uint4 v = *reinterpret_cast<const uint4*>(Sn + off);
    for (int o = 1; o < R; ++o) {
      const int dst = r + o < R ? r + o : r + o - R;
      *reinterpret_cast<uint4*>(cluster.map_shared_rank(Sn, dst) + off) = v;
    }
  }
}

// The whole kernel; T = bf16 runs the products on mma.sync, float on the
// CUDA cores.  Warp w of block r owns chunk rows r * rows + 16 (w % 4) ...
// + 15 (bf16: with warp w ^ 4, each on one half of every tile's columns)
// and state strip kWarps r + w.  Fragment layout (that of an m16n8
// accumulator, also used by the float32 path): lane 4 g + t holds rows g
// and g + 8, columns 2 t and 2 t + 1 of each 16 x 8 tile.
template <typename T, int PP, bool VEC, bool TMA>
__device__ __forceinline__ void ssd_body(const SsdArgs& a, const CUtensorMap* bmap,
                                         const CUtensorMap* cmap, const CUtensorMap* xmap) {
  using C = Cfg<T>;
  constexpr bool kMma = C::kMma;
  constexpr int kThreads = C::kThreads, kWarps = C::kWarps, NS = C::kStages;
  constexpr int kStrip = C::kStrip, kTerms = C::kTerms, kHalves = C::kHalves;
  constexpr int PT = PP / 8;                  // n8 tiles over P
  constexpr int PH = PT / kHalves;            // of them, this warp's in y
  // TMA's 128-byte swizzle wants its tiles at multiples of 1024 bytes
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (hop::smem_u32(smem_raw) & 1023u)) & 1023u);
  const Layout<T> L(a.N, a.P, a.Q, TMA);
  const int np = L.np, cp = L.cpitch, xp = L.xpitch, sbuf = L.sbuf;
  const int spitch = np + 16 / static_cast<int>(sizeof(T));   // the state copy's rows
  T* Cs = reinterpret_cast<T*>(smem + L.cs);
  T* Bs = reinterpret_cast<T*>(smem + L.bs);
  T* Xs = reinterpret_cast<T*>(smem + L.xs);
  // the state copies: buffer b at Ss + b * sbuf, term k of it PP * spitch further
  T* Ss = reinterpret_cast<T*>(smem + L.st);
  float* w_in = reinterpret_cast<float*>(smem + L.arr);   // dt * e_in
  float* e_out = w_in + L.qpad;
  float* dfs = e_out + L.qpad;                // exp(seg)
  float* w_st = dfs + L.qpad;                 // dt * exp(seg_last - seg)
  float* seg = w_st + L.qpad;
  double* wsum = reinterpret_cast<double*>(smem + L.scan);

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  // this warp's 16-row tile slot mw (the block's tiles of a chunk are
  // r, r + R, r + 2R, ...: heavy and light ones in every block) and its
  // half of the columns.  In bf16 the two warps on a tensor core (w and
  // w + 4) hold halves of tile slots w and 3 - w, a heavy and a light one.
  const int hf = warp / 4, mw = hf == 0 ? warp : 7 - warp;
  const int r = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, bi = blockIdx.z;
  const int P = a.P, N = a.N, S = a.S, H = a.H;
  const T* xg = static_cast<const T*>(a.x);
  const T* bg = static_cast<const T*>(a.b);
  const T* cgl = static_cast<const T*>(a.c);
  const T* xb = xg + bi * a.x_sb + static_cast<long long>(h) * P;
  const T* bb = bg + bi * a.b_sb;
  const T* cb = cgl + bi * a.c_sb;
  const long long soff = (static_cast<long long>(bi) * H + h) * P * N;

  // this warp's state strip: 16 rows of P from 16 mt, n8 tiles nt0 .. nt0 + cnt
  const int ntiles = np / 8, spm = (ntiles + kStrip - 1) / kStrip;
  const int strip = r * kWarps + warp;
  const bool owns = strip < (PP / 16) * spm;
  const int mt = owns ? strip / spm : 0;
  const int nt0 = owns ? (strip % spm) * kStrip : 0;
  const int cnt = owns ? min(kStrip, ntiles - nt0) : 0;     // even: np is a multiple of 16

  const int R = static_cast<int>(cluster.num_blocks());
  const int tr = a.rows;                      // this block's rows of a chunk: tr / 16 tiles
  const int i0 = 16 * (r + R * mw);           // this warp's first row
  const bool warp_rows = 16 * mw < tr;
  const float ah = a.a[h];
  const int nc = (S + a.Q - 1) / a.Q;
  const bool has_init = a.init != nullptr;

  // The tiles of all chunks form one sequence, tile g in ring slot g % NS.
  // TMA: one thread loads a tile's B and x boxes (64 rows, zeros past S),
  // completing on the slot's mbarrier, and the C tile's on its own.  Else
  // each is one group of async copies (an empty group past the last keeps
  // the count), and C tiles and the initial state are groups of their own.
  const int jtiles = (a.Q + kJ - 1) / kJ;     // tiles of a whole chunk
  const int total_tiles = (nc - 1) * jtiles + (S - (nc - 1) * a.Q + kJ - 1) / kJ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.scan + 64);   // ring, C, initial state
  if constexpr (TMA) {
    if (tid == 0) {
      for (int k = 0; k < NS + 2; ++k) hop::mbar_init(hop::smem_u32(bars + k), 1);
      hop::mbar_init_fence();
    } else if (tid < 4) {
      const CUtensorMap* map = tid == 1 ? bmap : tid == 2 ? cmap : xmap;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
    }
    __syncthreads();
  }
  uint32_t cphase = 0;                        // the C tile's mbarrier parity
  auto issue_tile = [&](int gt) {
    if (gt < total_tiles) {
      const int ci = min(gt / jtiles, nc - 1), jt = gt - ci * jtiles;
      const int s0 = ci * a.Q, lim = min(a.Q, S - s0) - jt * kJ, slot = gt % NS;
      const int row = s0 + jt * kJ;
      if constexpr (TMA) {
        // lanes of warp 0: lane 0 arms the slot, lanes 0 .. np / 64 - 1 load
        // B's halves and the next one x's box
        if (warp == 0) {
          const uint32_t bar = hop::smem_u32(bars + slot);
          if (lane == 0) hop::mbar_arrive_tx(bar, static_cast<uint32_t>(kJ * (np + PP) * sizeof(T)));
          if (lane < np / 64)
            hop::tma_load_3d(hop::smem_u32(Bs + slot * kJ * cp + lane * kJ * 64), bmap, bar,
                             64 * lane, row, bi);
          else if (lane == np / 64)
            hop::tma_load_4d(hop::smem_u32(Xs + slot * kJ * xp), xmap, bar, 0, h, row, bi);
        }
      } else {
        stage<T, VEC, kThreads>(Bs + slot * kJ * cp, cp, bb + row * a.b_ss, bg, a.b_ss, kJ, lim,
                                N, np);
        stage<T, VEC, kThreads>(Xs + slot * kJ * xp, xp, xb + row * a.x_ss, xg, a.x_ss, kJ, lim,
                                P, PP);
      }
    }
    gemm::cp_async_commit();
  };
  // the C rows of this block's tiles, tile slot k at rows 16 k of Cs
  auto issue_c = [&](int ci) {
    const int s0 = ci * a.Q, Lc = min(a.Q, S - s0);
    if (16 * r < Lc) {
      if constexpr (TMA) {
        // lane k * (np / 64) + hc of warp 0 loads tile slot k's half hc
        if (warp == 0) {
          const uint32_t bar = hop::smem_u32(bars + NS);
          if (lane == 0) hop::mbar_arrive_tx(bar, static_cast<uint32_t>(tr * np * sizeof(T)));
          const int k = lane / (np / 64), hc = lane % (np / 64);
          if (k < tr / 16)
            hop::tma_load_3d(hop::smem_u32(Cs + hc * kJ * 64 + 16 * k * 64), cmap, bar, 64 * hc,
                             s0 + 16 * (r + R * k), bi);
        }
      } else {
        for (int k = 0; k < tr / 16; ++k) {
          const int row = 16 * (r + R * k);
          stage<T, VEC, kThreads>(Cs + 16 * k * cp, cp, cb + (s0 + row) * a.c_ss, cgl, a.c_ss, 16,
                                  Lc - row, N, np);
        }
      }
    }
    gemm::cp_async_commit();
  };
  // each chunk's dt * a, loaded a chunk ahead (the first now): thread tid
  // takes tokens tid * per ... + per - 1 of the chunk
  float dv[C::kPer];
  auto load_dt = [&](int ci) {
    const int s0 = ci * a.Q, Lc = min(a.Q, S - s0), per = (Lc + kThreads - 1) / kThreads;
    const float* dtp = a.dt + (static_cast<long long>(bi) * S + s0) * H + h;
#pragma unroll
    for (int k = 0; k < C::kPer; ++k) {
      const int i = tid * per + k;
      dv[k] = k < per && i < Lc ? dtp[static_cast<long long>(i) * H] : 0.f;
    }
  };
  load_dt(0);
  // the first chunk's C tile and first tile; after its scan the initial
  // state (float32 P x N, into buffer 1 of the state copy, unused until
  // the first hand-over; it is needed only after the first j-loop) and
  // tiles 1 .. NS - 2
  issue_c(0);
  issue_tile(0);
  T* stage_init = Ss + sbuf;
  const float* init_f = reinterpret_cast<const float*>(stage_init);
  const bool init_bulk = has_init && reinterpret_cast<uintptr_t>(a.init + soff) % 16 == 0;
  // Cluster barriers order the hand-overs of the state between chunks; a
  // call of one chunk has none.  The first barrier is waited on before the
  // first hand-over: every block runs by then, and has read its staged
  // initial state (it arrives after that; without one, now).  The first
  // chunk's C.S reads only this block's own buffer 0.
  if (!has_init && nc > 1) cluster_arrive();

  float st[kStrip][4];
#pragma unroll
  for (int q = 0; q < kStrip; ++q) st[q][0] = st[q][1] = st[q][2] = st[q][3] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const int s0 = ci * a.Q, Lc = min(a.Q, S - s0);
    const int njt = (Lc + kJ - 1) / kJ;
    const bool c_here = 16 * r < Lc;          // a row of this block in the chunk

    // seg: each thread sums up to kPer consecutive dt * a (float32
    // products), then a scan over the thread totals (warp shuffles, then the
    // warp totals).  The sums are in double, where every partial sum of
    // these float32 terms is exact, so seg is the exact prefix rounded once
    // to float32 whatever the order: what the plain version's cumsum gives
    // on the CPU (torch accumulates a float32 cumsum in double there).
    const int per = (Lc + kThreads - 1) / kThreads;
    double sv[C::kPer], run = 0.0;
#pragma unroll
    for (int k = 0; k < C::kPer; ++k) {
      const float v = dv[k] * ah;
      run += static_cast<double>(v);
      sv[k] = run;
    }
    double inc = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    double off = inc - run;
    for (int w = 0; w < warp; ++w) off += wsum[w];
#pragma unroll
    for (int k = 0; k < C::kPer; ++k) {
      const int i = tid * per + k;
      if (k < per && i < Lc) seg[i] = static_cast<float>(off + sv[k]);
    }
    __syncthreads();
    const float last = seg[Lc - 1], mid = 0.5f * (seg[0] + last);
#pragma unroll
    for (int k = 0; k < C::kPer; ++k) {
      const int i = tid * per + k;
      if (k < per && i < Lc) {
        const float sg = seg[i];
        e_out[i] = expf(fminf(fmaxf(sg - mid, -60.f), 60.f));
        w_in[i] = dv[k] * expf(fminf(fmaxf(mid - sg, -60.f), 60.f));
        dfs[i] = expf(sg);
        w_st[i] = dv[k] * expf(last - sg);
      }
    }
    for (int i = Lc + tid; i < round_up(Lc, kJ); i += kThreads) {
      e_out[i] = w_in[i] = dfs[i] = w_st[i] = 0.f;
    }
    const float decay = expf(last);
#pragma unroll
    for (int q = 0; q < kStrip; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[q][e] *= decay;
    if (ci + 1 < nc) load_dt(ci + 1);
    if (ci == 0) {
      if (has_init) {
        const float* src = a.init + soff;
        if (TMA && init_bulk) {
          if (tid == 0) {
            const uint32_t bar = hop::smem_u32(bars + NS + 1);
            hop::mbar_arrive_tx(bar, static_cast<uint32_t>(P * N * sizeof(float)));
            hop::bulk_load(hop::smem_u32(stage_init), src, static_cast<uint32_t>(P * N * sizeof(float)),
                           bar);
          }
        } else if (init_bulk) {
          for (int i = tid; i < P * N / 4; i += kThreads)
            gemm::cp_async16(stage_init + i * (16 / sizeof(T)), src + 4 * i, true);
        } else {
          float* dst = reinterpret_cast<float*>(stage_init);
          for (int i = tid; i < P * N; i += kThreads) dst[i] = src[i];
        }
        gemm::cp_async_commit();
      }
      for (int gt = 1; gt + 1 < NS; ++gt) issue_tile(gt);
    }

    float yd[PT][4];
#pragma unroll
    for (int q = 0; q < PT; ++q) yd[q][0] = yd[q][1] = yd[q][2] = yd[q][3] = 0.f;
    const bool rows_here = warp_rows && i0 < Lc;
    const int ia = i0 + g, ib = ia + 8;

    for (int jt = 0; jt < njt; ++jt) {
      const int gt = ci * jtiles + jt, slot = gt % NS;
      // tile gt (and, first, the C tile) has landed once at most the groups
      // issued after it are in flight: NS - 2 tiles; at a chunk's first
      // tile, the C tile came last (the first chunk: C, tile 0, then the
      // initial state and tiles 1 .. NS - 2)
      if constexpr (TMA) {
        if (jt == 0 && c_here) {
          hop::mbar_wait(hop::smem_u32(bars + NS), cphase);
          cphase ^= 1;
        }
        hop::mbar_wait(hop::smem_u32(bars + slot), (gt / NS) & 1);
      } else if (jt > 0) {
        gemm::cp_async_wait<NS - 2>();
      } else if (ci > 0) {
        gemm::cp_async_wait<0>();
      } else if (has_init) {
        gemm::cp_async_wait<NS - 1>();
      } else {
        gemm::cp_async_wait<NS - 2>();
      }
      __syncthreads();
      // every warp is done with tile gt - 1, whose slot takes tile gt + NS - 1
      issue_tile(gt + NS - 1);
      const int j0 = jt * kJ;
      const int jh = j0 + (kJ / kHalves) * hf;          // this warp's columns
      const T* Bt = Bs + slot * kJ * cp;
      const T* Xt = Xs + slot * kJ * xp;

      if (rows_here && jh <= i0 + 15) {
        // scores = C . B^T of this warp's 16 rows and its columns of the tile
        constexpr int SN = 8 / kHalves;                 // n8 tiles of them
        float sc[SN][4];
#pragma unroll
        for (int q = 0; q < SN; ++q) sc[q][0] = sc[q][1] = sc[q][2] = sc[q][3] = 0.f;
        if constexpr (kMma) {
          for (int kk = 0; kk < np; kk += 16) {
            uint32_t af[4], bf[SN / 2][4];
            gemm::ldmatrix_x4(af, Cs + toff<TMA>(16 * mw + (lane & 15), kk + (lane >> 4) * 8, cp));
#pragma unroll
            for (int q = 0; q < SN / 2; ++q)
              gemm::ldmatrix_x4(bf[q], Bt + toff<TMA>((jh - j0) + 16 * q + (lane & 7) +
                                                          ((lane >> 4) << 3),
                                                      kk + ((lane >> 3) & 1) * 8, cp));
#pragma unroll
            for (int q = 0; q < SN / 2; ++q) {
              mma(sc[2 * q], af, bf[q][0], bf[q][1]);
              mma(sc[2 * q + 1], af, bf[q][2], bf[q][3]);
            }
          }
        } else {
          const T* crow = Cs + (16 * mw) * cp;
          const T* brow = Bt + (jh - j0) * cp;
          for (int k = 0; k < np; k += 4) {
            const float4 c0 = *reinterpret_cast<const float4*>(crow + g * cp + k);
            const float4 c1 = *reinterpret_cast<const float4*>(crow + (g + 8) * cp + k);
#pragma unroll
            for (int q = 0; q < SN; ++q) {
              if (jh + 8 * q <= i0 + 15) {
                const float4 b0 = *reinterpret_cast<const float4*>(brow + (8 * q + 2 * t) * cp + k);
                const float4 b1 =
                    *reinterpret_cast<const float4*>(brow + (8 * q + 2 * t + 1) * cp + k);
                sc[q][0] = dot4(c0, b0, sc[q][0]);
                sc[q][1] = dot4(c0, b1, sc[q][1]);
                sc[q][2] = dot4(c1, b0, sc[q][2]);
                sc[q][3] = dot4(c1, b1, sc[q][3]);
              }
            }
          }
        }
        // times dt * e_in of the column, causal mask; then y += scores . x
#pragma unroll
        for (int q = 0; q < SN; ++q) {
          const int j = jh + 8 * q + 2 * t;
          const float2 w = *reinterpret_cast<const float2*>(w_in + j);
          sc[q][0] = j <= ia ? sc[q][0] * w.x : 0.f;
          sc[q][1] = j + 1 <= ia ? sc[q][1] * w.y : 0.f;
          sc[q][2] = j <= ib ? sc[q][2] * w.x : 0.f;
          sc[q][3] = j + 1 <= ib ? sc[q][3] * w.y : 0.f;
        }
        if constexpr (kMma) {
#pragma unroll
          for (int m = 0; m < SN / 2; ++m) {
            // the A fragment of k-step m is the accumulator pair 2m, 2m + 1
            // (columns past the diagonal are zeros)
            uint32_t bf[PT / 2][4];
#pragma unroll
            for (int q = 0; q < PT / 2; ++q)
              gemm::ldmatrix_x4_trans(bf[q], Xt + toff<TMA>((jh - j0) + 16 * m + (lane & 15),
                                                            16 * q + (lane >> 4) * 8, xp));
            const float v[8] = {sc[2 * m][0],     sc[2 * m][1],     sc[2 * m][2],
                                sc[2 * m][3],     sc[2 * m + 1][0], sc[2 * m + 1][1],
                                sc[2 * m + 1][2], sc[2 * m + 1][3]};
            uint32_t af[kScoreTerms][4];
            split_frag<kScoreTerms>(v, af);
#pragma unroll
            for (int k = 0; k < kScoreTerms; ++k)
#pragma unroll
              for (int q = 0; q < PT / 2; ++q) {
                mma(yd[2 * q], af[k], bf[q][0], bf[q][1]);
                mma(yd[2 * q + 1], af[k], bf[q][2], bf[q][3]);
              }
          }
        } else {
          float* scw = reinterpret_cast<float*>(smem + L.sc) + warp * 16 * (kJ + 4);
#pragma unroll
          for (int q = 0; q < SN; ++q) {
            if (j0 + 8 * q <= i0 + 15) {
              *reinterpret_cast<float2*>(scw + g * (kJ + 4) + 8 * q + 2 * t) =
                  make_float2(sc[q][0], sc[q][1]);
              *reinterpret_cast<float2*>(scw + (g + 8) * (kJ + 4) + 8 * q + 2 * t) =
                  make_float2(sc[q][2], sc[q][3]);
            }
          }
          __syncwarp();
          const int jn = min(kJ, i0 + 16 - j0);
          for (int j = 0; j < jn; ++j) {
            const float sa = scw[g * (kJ + 4) + j], sb = scw[(g + 8) * (kJ + 4) + j];
#pragma unroll
            for (int q = 0; q < PT; ++q) {
              const float2 xv = *reinterpret_cast<const float2*>(Xt + j * xp + 8 * q + 2 * t);
              yd[q][0] = fmaf(sa, xv.x, yd[q][0]);
              yd[q][1] = fmaf(sa, xv.y, yd[q][1]);
              yd[q][2] = fmaf(sb, xv.x, yd[q][2]);
              yd[q][3] = fmaf(sb, xv.y, yd[q][3]);
            }
          }
          __syncwarp();
        }
      }

      if (owns) {
        // strip += (dt * exp(seg_last - seg) * x)^T . B over the tile's tokens
        if constexpr (kMma) {
          update_mma<kStrip, TMA>(st, Xt, xp, Bt, cp, w_st, j0, Lc - j0, mt, nt0, lane);
        } else {
          const int jn = min(kJ, Lc - j0);
          for (int j = 0; j < jn; ++j) {
            const float w = w_st[j0 + j];
            const float wa = Xt[j * xp + 16 * mt + g] * w, wb = Xt[j * xp + 16 * mt + g + 8] * w;
#pragma unroll
            for (int q = 0; q < kStrip; ++q) {
              if (q < cnt) {
                const float2 bv =
                    *reinterpret_cast<const float2*>(Bt + j * cp + 8 * (nt0 + q) + 2 * t);
                st[q][0] = fmaf(wa, bv.x, st[q][0]);
                st[q][1] = fmaf(wa, bv.y, st[q][1]);
                st[q][2] = fmaf(wb, bv.x, st[q][2]);
                st[q][3] = fmaf(wb, bv.y, st[q][3]);
              }
            }
          }
        }
      }
    }

    if (ci == 0 && has_init) {
      if (TMA && init_bulk) {
        hop::mbar_wait(hop::smem_u32(bars + NS + 1), 0);
      } else {
        gemm::cp_async_wait<0>();
      }
      __syncthreads();
      // the initial state, staged as float32 P x N in buffer 1: its terms
      // into buffer 0 for this chunk's C.S, 4 columns a thread at a time,
      // and decay * it into the strips (S' = decay * S + the chunk's sum);
      // then this block is done with buffer 1, which the first hand-over
      // overwrites
      const int q4 = np / 4;                               // 4-column groups of a row
      for (int i = tid; i < PP * q4; i += kThreads) {
        const int p = i / q4, n = 4 * (i - p * q4);
        const bool in = p < P && n < N;                    // then n + 3 < N too
        const float4 v = in ? *reinterpret_cast<const float4*>(init_f + p * N + n)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (kMma) {
          uint32_t t01[kTerms], t23[kTerms];
          split<kTerms>(v.x, v.y, t01);
          split<kTerms>(v.z, v.w, t23);
#pragma unroll
          for (int k = 0; k < kTerms; ++k)
            *reinterpret_cast<uint2*>(Ss + k * PP * spitch + p * spitch + n) = make_uint2(t01[k], t23[k]);
        } else {
          *reinterpret_cast<float4*>(Ss + p * spitch + n) = v;
        }
      }
#pragma unroll
      for (int q = 0; q < kStrip; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 16 * mt + g + 8 * (e >> 1), n = 8 * (nt0 + q) + 2 * t + (e & 1);
          if (q < cnt && p < P && n < N) st[q][e] = fmaf(decay, init_f[p * N + n], st[q][e]);
        }
      __syncthreads();
      if (nc > 1) cluster_arrive();
    }

    // the state before this chunk is complete in buffer ci % 2 once the
    // previous hand-over's barrier is passed (the barrier's phase ends with
    // arrivals made after the last chunk, so it orders nothing within this
    // one); the first chunk's buffer 0 is this block's own
    if (ci > 0) cluster_wait();
    const T* Sprev = Ss + (ci & 1) * sbuf;

    // y = e_out * (the causal product) + exp(seg) * C . S, S the state
    // before this chunk (zero in the first chunk of a call without one).
    // bf16: the two halves of a tile's columns each hold part of the
    // causal product for all of P; each finishes half of P.  HF is the
    // half as a constant, so that no register array is indexed at run time.
    float* red = reinterpret_cast<float*>(smem + L.sc);
    auto share = [&](auto half) {             // the other half's part, for it
      constexpr int HF = decltype(half)::value;
#pragma unroll
      for (int q = 0; q < PH; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((warp * PH + q) * 4 + e) * 32 + lane] = yd[(1 - HF) * PH + q][e];
    };
    auto finish = [&](auto half) {
      constexpr int HF = decltype(half)::value, Q0 = HF * PH;   // this warp's n8 tiles of P
      if constexpr (kHalves > 1) {
        const int other = 7 - warp;           // the other half of the tile
#pragma unroll
        for (int q = 0; q < PH; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) yd[Q0 + q][e] += red[((other * PH + q) * 4 + e) * 32 + lane];
      }
      float cs[PH][4];
#pragma unroll
      for (int q = 0; q < PH; ++q) cs[q][0] = cs[q][1] = cs[q][2] = cs[q][3] = 0.f;
      if (ci > 0 || has_init) {
        if constexpr (kMma) {
          // pairs of n8 tiles of P by ldmatrix x4 (at PP 16 a warp takes
          // one tile of its pair)
          constexpr int NPAIR = (PH + 1) / 2;
          for (int kk = 0; kk < np; kk += 16) {
            uint32_t af[4];
            gemm::ldmatrix_x4(af, Cs + toff<TMA>(16 * mw + (lane & 15), kk + (lane >> 4) * 8, cp));
            const int off = ((lane & 7) + ((lane >> 4) << 3)) * spitch + kk + ((lane >> 3) & 1) * 8;
#pragma unroll
            for (int k = 0; k < kStateTerms; ++k) {
              uint32_t bf[NPAIR][4];
#pragma unroll
              for (int q = 0; q < NPAIR; ++q)
                gemm::ldmatrix_x4(bf[q], Sprev + k * PP * spitch + 16 * (Q0 / 2 + q) * spitch + off);
#pragma unroll
              for (int q = 0; q < PH; ++q) {
                const int pr = (Q0 + q) / 2 - Q0 / 2, hi = 2 * ((Q0 + q) % 2);
                mma(cs[q], af, bf[pr][hi], bf[pr][hi + 1]);
              }
            }
          }
        } else {
          const T* crow = Cs + (16 * mw) * cp;
          for (int k = 0; k < np; k += 4) {
            const float4 c0 = *reinterpret_cast<const float4*>(crow + g * cp + k);
            const float4 c1 = *reinterpret_cast<const float4*>(crow + (g + 8) * cp + k);
#pragma unroll
            for (int q = 0; q < PH; ++q) {
              const float4 v0 =
                  *reinterpret_cast<const float4*>(Sprev + (8 * (Q0 + q) + 2 * t) * spitch + k);
              const float4 v1 =
                  *reinterpret_cast<const float4*>(Sprev + (8 * (Q0 + q) + 2 * t + 1) * spitch + k);
              cs[q][0] = dot4(c0, v0, cs[q][0]);
              cs[q][1] = dot4(c0, v1, cs[q][1]);
              cs[q][2] = dot4(c1, v0, cs[q][2]);
              cs[q][3] = dot4(c1, v1, cs[q][3]);
            }
          }
        }
      }
      const float oa = e_out[ia], ob = e_out[ib], da = dfs[ia], db = dfs[ib];
      float* ya = a.y + ((static_cast<long long>(bi) * S + s0 + ia) * H + h) * P;
      float* yb = ya + 8LL * H * P;
#pragma unroll
      for (int q = 0; q < PH; ++q) {
        const int p = 8 * (Q0 + q) + 2 * t;
        const float* d = yd[Q0 + q];
        const float v0 = oa * d[0] + da * cs[q][0], v1 = oa * d[1] + da * cs[q][1];
        const float v2 = ob * d[2] + db * cs[q][2], v3 = ob * d[3] + db * cs[q][3];
        if (p + 1 < P && (P & 1) == 0) {
          if (ia < Lc) *reinterpret_cast<float2*>(ya + p) = make_float2(v0, v1);
          if (ib < Lc) *reinterpret_cast<float2*>(yb + p) = make_float2(v2, v3);
        } else if (p < P) {
          if (ia < Lc) ya[p] = v0;
          if (ib < Lc) yb[p] = v2;
          if (p + 1 < P && ia < Lc) ya[p + 1] = v1;
          if (p + 1 < P && ib < Lc) yb[p + 1] = v3;
        }
      }
    };
    if constexpr (kHalves > 1) {
      if (rows_here) {
        if (hf == 0) {
          share(std::integral_constant<int, 0>{});
        } else {
          share(std::integral_constant<int, 1>{});
        }
      }
      __syncthreads();
    }
    if (rows_here) {
      if (hf == 0) {
        finish(std::integral_constant<int, 0>{});
      } else if constexpr (kHalves > 1) {
        finish(std::integral_constant<int, 1>{});
      }
    }

    if (ci + 1 < nc) {
      // every warp is done with this chunk's C tile: the next one may come
      __syncthreads();
      issue_c(ci + 1);
      // hand the state over into buffer (ci + 1) % 2, last read by the C.S
      // of chunk ci - 1, which every block finished before the barrier
      // waited on above (after the first chunk: the first barrier, waited
      // on here); the barrier arrived at here is waited on before the next
      // C.S
      if (ci == 0) cluster_wait();
      if (owns)
        hand_over<T, kTerms>(Ss + ((ci + 1) & 1) * sbuf, st, mt, nt0, cnt, spitch, PP, lane);
      cluster_arrive();
    }
  }

  if (owns) {
#pragma unroll
    for (int q = 0; q < kStrip; ++q) {
      if (q < cnt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = 16 * mt + g + 8 * hh, n = 8 * (nt0 + q) + 2 * t;
          if (p < P && n < N)
            *reinterpret_cast<float2*>(a.fin + soff + p * N + n) =
                make_float2(st[q][2 * hh], st[q][2 * hh + 1]);
        }
      }
    }
  }
}

template <bool VEC, int PP, bool TMA>
__global__ void __launch_bounds__(Cfg<bf16>::kThreads, 1)
    ssd_scan_mma(const SsdArgs a, const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap xmap) {
  ssd_body<bf16, PP, VEC, TMA>(a, &bmap, &cmap, &xmap);
}

template <bool VEC, int PP>
__global__ void __launch_bounds__(Cfg<float>::kThreads, 1)
    ssd_scan_fma(const SsdArgs a, const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap xmap) {
  ssd_body<float, PP, VEC, false>(a, &bmap, &cmap, &xmap);
}

using KernelFn = void (*)(SsdArgs, CUtensorMap, CUtensorMap, CUtensorMap);

template <typename T, bool VEC, int PP, bool TMA>
KernelFn kernel_of() {
  if constexpr (std::is_same_v<T, bf16>) {
    return ssd_scan_mma<VEC, PP, TMA>;
  } else {
    return ssd_scan_fma<VEC, PP>;
  }
}

// Allows the kernel `smem` bytes of dynamic shared memory; each
// instantiation sets the attribute again only when it needs more.
template <typename T, bool VEC, int PP, bool TMA = false>
cudaError_t launch(const SsdArgs& a, int batch, int cluster, cudaStream_t stream,
                   const CUtensorMap* maps = nullptr) {
  const size_t smem = Layout<T>(a.N, a.P, a.Q, TMA).bytes;
  if (smem > 232448) return cudaErrorInvalidValue;
  static size_t allowed = 0;
  if (smem > allowed) {
    const cudaError_t err = rt::allow_smem(kernel_of<T, VEC, PP, TMA>(), smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, a.H, batch);
  cfg.blockDim = dim3(Cfg<T>::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const CUtensorMap none = {};
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel_of<T, VEC, PP, TMA>(), a, maps ? maps[0] : none,
                         maps ? maps[1] : none, maps ? maps[2] : none);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The TMA design's tensor maps (bf16, 128-byte swizzle): B and C as
// (N, S, batch) in boxes of 64 columns x 64 rows (C: 16 rows), x as
// (P, H, S, batch) in boxes of 64 x 1 head x 64 rows.  Taken where P is 64, N a multiple of 64
// and every tile of 64 tokens lies inside one chunk (or past the end of S,
// which the maps fill with zeros); the rows are 16-byte aligned (VEC).
bool tma_design(const SsdArgs& a) {
  return a.P == 64 && a.N % 64 == 0 && (a.Q % kJ == 0 || a.S <= a.Q);
}

// The maps of recent calls, by their tensors' addresses, shapes and
// strides (the caching allocator hands a layer the same buffers call after
// call, so most calls find theirs here).
struct MapKey {
  const void *b, *c, *x;
  long long b_sb, b_ss, c_sb, c_ss, x_sb, x_ss;
  int S, H, P, N, batch;
};

struct MapEntry {
  MapKey key;
  CUtensorMap maps[3];
  bool used;
};

constexpr int kMapSlots = 64;
std::mutex map_mu;
MapEntry map_cache[kMapSlots];

int encode_maps(const SsdArgs& a, int batch, CUtensorMap* maps);

int cached_maps(const SsdArgs& a, int batch, CUtensorMap* maps) {
  MapKey key;
  std::memset(&key, 0, sizeof key);
  key.b = a.b;
  key.c = a.c;
  key.x = a.x;
  key.b_sb = a.b_sb;
  key.b_ss = a.b_ss;
  key.c_sb = a.c_sb;
  key.c_ss = a.c_ss;
  key.x_sb = a.x_sb;
  key.x_ss = a.x_ss;
  key.S = a.S;
  key.H = a.H;
  key.P = a.P;
  key.N = a.N;
  key.batch = batch;
  uint64_t hash = 1469598103934665603ull;          // FNV-1a over the key's bytes
  const unsigned char* p = reinterpret_cast<const unsigned char*>(&key);
  for (size_t i = 0; i < sizeof key; ++i) hash = (hash ^ p[i]) * 1099511628211ull;
  MapEntry& slot = map_cache[hash % kMapSlots];
  std::lock_guard<std::mutex> lock(map_mu);
  if (slot.used && std::memcmp(&slot.key, &key, sizeof key) == 0) {
    std::memcpy(maps, slot.maps, sizeof slot.maps);
    return 0;
  }
  const int res = encode_maps(a, batch, maps);
  if (res != 0) return res;
  slot.key = key;
  std::memcpy(slot.maps, maps, sizeof slot.maps);
  slot.used = true;
  return 0;
}

int encode_maps(const SsdArgs& a, int batch, CUtensorMap* maps) {
  constexpr uint64_t E = sizeof(bf16);
  const uint32_t box3[3] = {64, static_cast<uint32_t>(kJ), 1};
  const uint64_t dims3[3] = {static_cast<uint64_t>(a.N), static_cast<uint64_t>(a.S),
                             static_cast<uint64_t>(batch)};
  const uint64_t bstr[2] = {a.b_ss * E, a.b_sb * E}, cstr[2] = {a.c_ss * E, a.c_sb * E};
  const uint64_t xdims[4] = {static_cast<uint64_t>(a.P), static_cast<uint64_t>(a.H),
                             static_cast<uint64_t>(a.S), static_cast<uint64_t>(batch)};
  const uint64_t xstr[3] = {a.P * E, a.x_ss * E, a.x_sb * E};
  const uint32_t xbox[4] = {64, 1, static_cast<uint32_t>(kJ), 1};
  const uint32_t cbox[3] = {64, 16, 1};       // a block's C rows come in tiles of 16
  int res = hop::encode_bf16(&maps[0], a.b, 3, dims3, bstr, box3);
  if (res == 0) res = hop::encode_bf16(&maps[1], a.c, 3, dims3, cstr, cbox);
  if (res == 0) res = hop::encode_bf16(&maps[2], a.x, 4, xdims, xstr, xbox);
  return res;
}

template <typename T>
cudaError_t by_width(const SsdArgs& a, int batch, int cluster, bool vec, cudaStream_t s) {
  if (strips<T>(a.P, a.N) > Cfg<T>::kWarps * cluster) return cudaErrorInvalidValue;
  if constexpr (std::is_same_v<T, bf16>) {
    if (vec && tma_design(a)) {
      CUtensorMap maps[3];
      if (cached_maps(a, batch, maps) != 0) return cudaErrorInvalidValue;
      return launch<T, true, 64, true>(a, batch, cluster, s, maps);
    }
  }
  const int pp = round_up(a.P, 16);
  if (pp == 16)
    return vec ? launch<T, true, 16>(a, batch, cluster, s) : launch<T, false, 16>(a, batch, cluster, s);
  if (pp == 32)
    return vec ? launch<T, true, 32>(a, batch, cluster, s) : launch<T, false, 32>(a, batch, cluster, s);
  if (pp == 64)
    return vec ? launch<T, true, 64>(a, batch, cluster, s) : launch<T, false, 64>(a, batch, cluster, s);
  return cudaErrorInvalidValue;
}

// x, B and C are copied with 16-byte async copies (or, at the served
// shapes in bf16, TMA boxes) where their rows allow it (the model's views
// of one conv output do), else element by element.
template <typename T>
bool vectorizable(const SsdArgs& a) {
  constexpr long long E = 16 / sizeof(T);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.b) |
                         reinterpret_cast<uintptr_t>(a.c);
  return ptrs % 16 == 0 && a.N % E == 0 && a.P % E == 0 && a.x_sb % E == 0 && a.x_ss % E == 0 &&
         a.b_sb % E == 0 && a.b_ss % E == 0 && a.c_sb % E == 0 && a.c_ss % E == 0;
}

}  // namespace

// dtype: 0 = float32 (the CUDA cores), 1 = bfloat16 (mma.sync) for x, b
// and c.  x is (B, S, H, P) with H and P contiguous (strides x_sb, x_ss, P,
// 1 in elements); b and c are (B, S, N) with N contiguous; dt (B, S, H) and
// a (H,) are contiguous float32; init (B, H, P, N) float32 or null (zeros).
// y (B, S, H, P) and fin (B, H, P, N) are contiguous float32.  Q is the
// chunk (a short last chunk is masked).  The plan (`ops.ssd_plan`): grid
// (cluster, H, B), `cluster` (1, 2, 4 or 8) blocks of `rows` rows of a chunk
// each (a multiple of 16, at most 64, cluster * rows >= Q), and at most one
// state strip per warp of the cluster (bf16: 8 warps a block, strips of
// 16 x 16; float32: 4 warps, 16 x 32).  N must be a multiple of 4 and P at
// most 64.  Returns cudaGetLastError() after the launch (0 = launched);
// launches on `stream`, allocates nothing, does not synchronise.
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* b, const void* c,
                               const float* dt, const float* a, const float* init, float* y,
                               float* fin, int B, int S, int H, int P, int N, int Q, int cluster,
                               int rows, long long x_sb, long long x_ss, long long b_sb,
                               long long b_ss, long long c_sb, long long c_ss, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > 64 || N <= 0 || N % 4 != 0 || Q <= 0 ||
      Q > kMaxChunk || H > 65535 || B > 65535 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || rows <= 0 || rows % 16 != 0 || rows > kRowsMax ||
      cluster * rows < Q)
    return cudaErrorInvalidValue;
  const SsdArgs args{x, b, c, dt, a, init, y, fin, S, H, P, N, Q, rows,
                     x_sb, x_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = by_width<float>(args, B, cluster, vectorizable<float>(args), s);
  if (dtype == 1) err = by_width<bf16>(args, B, cluster, vectorizable<bf16>(args), s);
  return static_cast<int>(err);
}
