// Tiled matrix product (M, K) @ (K, N) with float accumulation for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `tiled_matmul` in
// src/repro/kernels/tiled_matmul.py (body `_mm_kernel`, reached from
// `ops.tiled_matmul` in src/repro/kernels/ops.py).  The port's ConvNet
// executor runs its fc layers through it (the JAX executor uses einsum).
//
// What it computes: out = x @ y, row-major, float accumulation, output in
// x's type.
//
// What bounds it on the H100: at VGG16's fc layers (M = batch = 16) the
// bytes of the weight y.  fc6 reads 25088 x 4096 bf16 = 205.5 MB, about 61 us
// at 3.35 TB/s, against 3.3 GFLOP (3 us of tensor-core time); fc7 reads
// 33.6 MB and fc8 8.2 MB.
//
// Two designs, chosen by shape (the wrapper logs which one ran):
//
// Weight stream (bf16, M <= 16, 16-byte aligned rows: the fc layers at
// batch 16).  Each block owns a 16 x 128 output tile and an equal share of
// K; the grid is about one block per SM (N tiles x K splits).  One
// producer thread streams the block's k-slices by TMA through a 6-stage
// ring of mbarriers: each stage holds 128 k-rows of the weight (two 16 KB
// boxes of 64 columns, 128-byte swizzle) and the matching 16 x 128 slice of
// x (two 2 KB boxes; rows past M and columns past K zero-filled), 36 KB a
// stage and 216 KB in flight per SM, with no __syncthreads() per slice.
// x comes through the ring with the weight rather than sitting in shared
// memory for the whole K range: at fc6 that range (16 x 6272 bf16) alone
// would take 196 KB beside the ring.  Four consumer warps own 32 columns
// each and multiply with mma.sync m16n8k16 (the 16-row tile fits it
// exactly; wgmma's 64-row minimum buys nothing at 3.3 GFLOP), fragments by
// ldmatrix from the swizzled tiles, and hand each stage back through its
// empty barrier.  fc6 streams 205.5 MB of weight in 49 slices per block.
//
// Tiles (float32, larger M, unaligned rows): each block owns a 64 x 128
// output tile and walks K in 64-byte slices (32 bf16 or 16 float32)
// through a 3-stage cp.async ring in shared memory; bf16 multiplies on the
// tensor cores (mma.sync m16n8k16, f32 accumulators, fragments by
// ldmatrix, each warp 64 x 32 of the tile) and skips 16-row sub-tiles past
// M; float32 runs on the CUDA cores, not TF32.  Ragged M, N and K are
// masked, not padded: when K and N are multiples of 16 bytes of elements
// the copies are 16-byte cp.async with zero fill, otherwise element by
// element.
//
// Both split K over blocks when the output tiles alone leave SMs idle:
// each block writes its float partial to a workspace, and the last block
// of a tile to arrive (a counter per tile) sums the partials in split
// order, which keeps the result deterministic, writes the tile and resets
// the counter to zero, all in one launch: the wrapper keeps one zeroed
// counter buffer per device and stream and launches nothing else.

#include <climits>

#include "common.cuh"
#include "gemm.cuh"
#include "hopper.cuh"

namespace {

using gemm::bf16;

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int STAGES = 3;

struct MatmulArgs {
  const void* x;            // (m, k) contiguous
  const void* y;            // (k, n) contiguous
  void* out;                // (m, n) contiguous
  float* ws;                // (splits, m, n) partials when splits > 1
  int* counters;            // one per output tile, zero before the launch
  int m, n, k, splits, steps_per_split;
};

template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int BK = 32;
  using Tile = gemm::MmaTile<BM, BN, BK, 1, 4>;
};
template <>
struct Cfg<float> {
  static constexpr int BK = 16;
  using Tile = gemm::SimtTile<BM, BN, BK, 8, 8>;
};

template <typename T>
struct Layout {
  static constexpr int BK = Cfg<T>::BK;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int AP = BK + VEC, BP = BN + VEC;
  static constexpr int A_ELEMS = BM * AP, STAGE = BM * AP + BK * BP;
  static constexpr size_t SMEM = sizeof(T) * STAGES * STAGE;
  static_assert(BK * sizeof(T) == 64, "one k slice is four 16-byte copies per row");
};

template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(gemm::kThreads) matmul_tiled(const MatmulArgs a) {
  using L = Layout<T>;
  constexpr int BK = L::BK, VEC = L::VEC, AP = L::AP, BP = L::BP;
  extern __shared__ float4 smem4[];
  __shared__ int last_block;
  T* smem = reinterpret_cast<T*>(smem4);
  const T* x = static_cast<const T*>(a.x);
  const T* y = static_cast<const T*>(a.y);

  const int n_tiles = (a.n + BN - 1) / BN;
  const int tile_id = blockIdx.x;
  const int m0 = tile_id / n_tiles * BM, n0 = tile_id % n_tiles * BN;
  const int total = (a.k + BK - 1) / BK;
  const int ks0 = blockIdx.y * a.steps_per_split;
  const int nk = max(0, min(total, ks0 + a.steps_per_split) - ks0);
  const int tid = threadIdx.x;

  auto load = [&](int stage, int ks) {
    T* As = smem + stage * L::STAGE;
    T* Bs = As + L::A_ELEMS;
    const int kb = ks * BK;
    constexpr int A_SEGS = BM * BK / VEC / gemm::kThreads;
#pragma unroll
    for (int j = 0; j < A_SEGS; ++j) {
      const int idx = tid + j * gemm::kThreads, r = idx / (BK / VEC), sg = idx % (BK / VEC);
      const int row = m0 + r, kc = kb + sg * VEC;
      T* dst = As + r * AP + sg * VEC;
      if constexpr (ALIGNED) {
        const bool ok = row < a.m && kc < a.k;
        gemm::cp_async16(dst, ok ? x + static_cast<long long>(row) * a.k + kc : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          dst[e] = row < a.m && kc + e < a.k ? x[static_cast<long long>(row) * a.k + kc + e]
                                             : gemm::from_float<T>(0.f);
      }
    }
    constexpr int SEGS = BN / VEC;
    constexpr int B_SEGS = BK * SEGS / gemm::kThreads;
#pragma unroll
    for (int j = 0; j < B_SEGS; ++j) {
      const int idx = tid + j * gemm::kThreads, kr = idx / SEGS, cs = idx % SEGS;
      const int kk = kb + kr, col = n0 + cs * VEC;
      T* dst = Bs + kr * BP + cs * VEC;
      if constexpr (ALIGNED) {
        const bool ok = kk < a.k && col < a.n;
        gemm::cp_async16(dst, ok ? y + static_cast<long long>(kk) * a.n + col : y, ok);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          dst[e] = kk < a.k && col + e < a.n ? y[static_cast<long long>(kk) * a.n + col + e]
                                             : gemm::from_float<T>(0.f);
      }
    }
  };

  typename Cfg<T>::Tile tile;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, ks0 + s);
    gemm::cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    gemm::cp_async_wait<STAGES - 2>();
    __syncthreads();                 // slice i landed; slice i - 1 is consumed
    const int next = i + STAGES - 1;
    if (next < nk) load(next % STAGES, ks0 + next);
    gemm::cp_async_commit();
    const T* As = smem + (i % STAGES) * L::STAGE;
    tile.template step<AP, BP>(As, As + L::A_ELEMS, a.m - m0);
  }

  const int rows = a.m - m0, cols = a.n - n0;
  if (a.splits == 1) {
    T* out = static_cast<T*>(a.out) + static_cast<long long>(m0) * a.n + n0;
    tile.for_each_pair([&](int r, int c, float v0, float v1) {
      gemm::store_pair(out, a.n, rows, cols, r, c, v0, v1);
    });
    return;
  }

  // split K: publish this block's partial, and let the tile's last block sum them
  float* part = a.ws + (static_cast<long long>(blockIdx.y) * a.m + m0) * a.n + n0;
  tile.for_each_pair([&](int r, int c, float v0, float v1) {
    gemm::store_pair(part, a.n, rows, cols, r, c, v0, v1);
  });
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(a.counters + tile_id, 1) == a.splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  T* out = static_cast<T*>(a.out);
  const int tr = min(rows, BM), tc = min(cols, BN);
  for (int idx = tid; idx < tr * tc; idx += gemm::kThreads) {
    const int r = idx / tc, c = idx % tc;
    const long long off = static_cast<long long>(m0 + r) * a.n + n0 + c;
    float s = 0.f;
    for (int sp = 0; sp < a.splits; ++sp)
      s += __ldcg(a.ws + static_cast<long long>(sp) * a.m * a.n + off);
    out[off] = gemm::from_float<T>(s);
  }
  if (tid == 0) a.counters[tile_id] = 0;
}

template <typename T, bool ALIGNED>
cudaError_t launch(const MatmulArgs& a, cudaStream_t stream) {
  constexpr size_t smem = Layout<T>::SMEM;
  cudaError_t err = rt::allow_smem(matmul_tiled<T, ALIGNED>, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((a.m + BM - 1) / BM) * ((a.n + BN - 1) / BN);
  if (tiles > INT_MAX || a.splits > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), a.splits);
  matmul_tiled<T, ALIGNED><<<grid, gemm::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool aligned, MatmulArgs a, cudaStream_t s) {
  const int total = (a.k + Layout<T>::BK - 1) / Layout<T>::BK;
  a.steps_per_split = (total + a.splits - 1) / a.splits;
  return aligned ? launch<T, true>(a, s) : launch<T, false>(a, s);
}


// ---- weight stream (bf16, M <= 16) ---------------------------------------------

namespace wst {
constexpr int BM = 16;                  // x rows: one m16n8k16 tile
constexpr int BN = 128;                 // output columns per block: 4 warps x 32
constexpr int BK = 128;                 // k-rows per slice
constexpr int STAGES = 6;
constexpr int CONSUMERS = 128;          // four consumer warps, then one producer warp
constexpr int Y_BOX = 64 * BK * 2;      // 16 KB: 64 columns x 128 k-rows
constexpr int X_BOX = 64 * BM * 2;      // 2 KB: 64 k-columns x 16 rows
constexpr int STAGE = 2 * Y_BOX + 2 * X_BOX;
constexpr size_t SMEM = STAGES * STAGE + 1024;
}  // namespace wst

__global__ void __launch_bounds__(wst::CONSUMERS + 32, 1)
    matmul_tiled_stream(const MatmulArgs a, const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap ymap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[wst::STAGES], empty[wst::STAGES];
  __shared__ int last_block;
  const uint32_t base = (hop::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < wst::STAGES; ++s) {
      hop::mbar_init(hop::smem_u32(&full[s]), 1);                // the producer's arrival
      hop::mbar_init(hop::smem_u32(&empty[s]), wst::CONSUMERS / 32);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  const int n0 = blockIdx.x * wst::BN;
  const int total = (a.k + wst::BK - 1) / wst::BK;
  const int ks0 = blockIdx.y * a.steps_per_split;
  const int nk = max(0, min(total, ks0 + a.steps_per_split) - ks0);

  if (tid >= wst::CONSUMERS) {
    // ---- producer: one thread keeps the ring full ----
    if (tid == wst::CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < nk; ++i) {
        const int kb = (ks0 + i) * wst::BK;
        const uint32_t fb = hop::smem_u32(&full[stage]);
        hop::mbar_wait(hop::smem_u32(&empty[stage]), phase ^ 1);
        const uint32_t st = base + stage * wst::STAGE;
        hop::mbar_arrive_tx(fb, wst::STAGE);
        hop::tma_load_2d(st, &ymap, fb, n0, kb);
        hop::tma_load_2d(st + wst::Y_BOX, &ymap, fb, n0 + 64, kb);
        hop::tma_load_2d(st + 2 * wst::Y_BOX, &xmap, fb, kb, 0);
        hop::tma_load_2d(st + 2 * wst::Y_BOX + wst::X_BOX, &xmap, fb, kb + 64, 0);
        if (++stage == wst::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warp w owns columns 32 w .. 32 w + 31 of the tile ----
  const int warp = tid / 32, lane = tid % 32;
  const int ybox = warp / 2, ychunk = (warp % 2) * 4;   // its 64-column box, first chunk
  float acc[4][4] = {};
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < nk; ++i) {
    hop::mbar_wait(hop::smem_u32(&full[stage]), phase);
    const uint32_t ys = base + stage * wst::STAGE + ybox * wst::Y_BOX;
    const uint32_t xs = base + stage * wst::STAGE + 2 * wst::Y_BOX;
#pragma unroll
    for (int kk = 0; kk < wst::BK / 16; ++kk) {
      uint32_t af[4], b[4][2];
      // A: rows lane % 16, k chunk 2 kk + lane / 16 (of the slice's 16)
      const int ac = (kk % 4) * 2 + lane / 16;
      hop::ldsm_x4(af, xs + (kk / 4) * wst::X_BOX + hop::swz(lane % 16, ac));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        const int krow = kk * 16 + lane % 16;
        hop::ldsm_x4_t(r, ys + hop::swz(krow, ychunk + 2 * p + lane / 16));
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) gemm::mma_16816(acc[j], af, b[j][0], b[j][1]);
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[stage]));
    if (++stage == wst::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // lane 4g + t holds rows g, g + 8 and columns 2t, 2t + 1 of each n8 tile j
  const int g = lane / 4, c = warp * 32 + 2 * (lane % 4);
  const int cols = a.n - n0;
  auto each = [&](auto f) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f(g, c + 8 * j, acc[j][0], acc[j][1]);
      f(g + 8, c + 8 * j, acc[j][2], acc[j][3]);
    }
  };
  if (a.splits == 1) {
    bf16* out = static_cast<bf16*>(a.out) + n0;
    each([&](int r, int cc, float v0, float v1) {
      gemm::store_pair(out, a.n, a.m, cols, r, cc, v0, v1);
    });
    return;
  }
  // split K: publish this block's partial; the tile's last block sums them
  float* part = a.ws + static_cast<long long>(blockIdx.y) * a.m * a.n + n0;
  each([&](int r, int cc, float v0, float v1) {
    gemm::store_pair(part, a.n, a.m, cols, r, cc, v0, v1);
  });
  __threadfence();
  asm volatile("bar.sync 1, %0;\n" ::"n"(wst::CONSUMERS) : "memory");
  if (tid == 0) last_block = atomicAdd(a.counters + blockIdx.x, 1) == a.splits - 1;
  asm volatile("bar.sync 1, %0;\n" ::"n"(wst::CONSUMERS) : "memory");
  if (!last_block) return;
  __threadfence();
  // Sum the partials in split order.  N is a multiple of 8 on this path, so
  // each thread takes whole 16-byte groups of 4 columns, Q of them, and
  // keeps 4 splits' loads in flight at a time.
  constexpr int G = wst::BN / 4, Q = wst::BM * G / wst::CONSUMERS;
  const long long plane = static_cast<long long>(a.m) * a.n;
  float4 sum[Q];
  long long off[Q];
  bool live[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int idx = tid + q * wst::CONSUMERS, r = idx / G, cc = idx % G * 4;
    live[q] = r < a.m && cc < cols;
    off[q] = live[q] ? static_cast<long long>(r) * a.n + n0 + cc : 0;
    sum[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  auto add = [&](int sp, int q) {
    if (!live[q]) return;
    const float4 v = __ldcg(reinterpret_cast<const float4*>(a.ws + sp * plane + off[q]));
    sum[q].x += v.x;
    sum[q].y += v.y;
    sum[q].z += v.z;
    sum[q].w += v.w;
  };
  int sp = 0;
  for (; sp + 4 <= a.splits; sp += 4) {
    float4 v[4][Q];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < Q; ++q)
        v[u][q] = live[q] ? __ldcg(reinterpret_cast<const float4*>(a.ws + (sp + u) * plane +
                                                                   off[q]))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        sum[q].x += v[u][q].x;
        sum[q].y += v[u][q].y;
        sum[q].z += v[u][q].z;
        sum[q].w += v[u][q].w;
      }
  }
  for (; sp < a.splits; ++sp)
#pragma unroll
    for (int q = 0; q < Q; ++q) add(sp, q);
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (!live[q]) continue;
    __nv_bfloat162 lo = __floats2bfloat162_rn(sum[q].x, sum[q].y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(sum[q].z, sum[q].w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + off[q]) = packed;
  }
  if (tid == 0) a.counters[blockIdx.x] = 0;
}

cudaError_t launch_stream(const MatmulArgs& a, cudaStream_t stream) {
  CUtensorMap xmap, ymap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(a.k), static_cast<uint64_t>(a.m)};
  const uint64_t xstr[1] = {static_cast<uint64_t>(a.k) * 2};
  const uint32_t xbox[2] = {64, wst::BM};
  const uint64_t ydims[2] = {static_cast<uint64_t>(a.n), static_cast<uint64_t>(a.k)};
  const uint64_t ystr[1] = {static_cast<uint64_t>(a.n) * 2};
  const uint32_t ybox[2] = {64, wst::BK};
  if (hop::encode_bf16(&xmap, a.x, 2, xdims, xstr, xbox) != 0 ||
      hop::encode_bf16(&ymap, a.y, 2, ydims, ystr, ybox) != 0)
    return cudaErrorNotSupported;
  cudaError_t err = rt::allow_smem(matmul_tiled_stream, wst::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + wst::BN - 1) / wst::BN, a.splits);
  matmul_tiled_stream<<<grid, wst::CONSUMERS + 32, wst::SMEM, stream>>>(a, xmap, ymap);
  return cudaGetLastError();
}

bool use_stream(int dtype, int aligned, int m) { return dtype == 1 && aligned && m <= wst::BM; }

}  // namespace

// The design a call takes: 0 = 64 x 128 tiles, 1 = the weight stream.
extern "C" int tiled_matmul_path(int dtype, int aligned, int m) {
  return use_stream(dtype, aligned, m) ? 1 : 0;
}

// The number of blocks K is split over for an (m, k) @ (k, n) product on a
// card with `sms` multiprocessors.  Weight stream: about one block per SM;
// tiles: about two, each with at least 8 slices of K.  Writes the number of
// output tiles (the counters a split launch needs) to *tiles.
extern "C" int tiled_matmul_plan(int dtype, int aligned, int m, int n, int k, int sms,
                                 int* tiles) {
  if (use_stream(dtype, aligned, m)) {
    const int t = (n + wst::BN - 1) / wst::BN;
    *tiles = t;
    const int steps = (k + wst::BK - 1) / wst::BK;
    const int want = sms / t;
    const int splits = want < steps ? want : steps;
    return splits > 1 ? splits : 1;
  }
  const long long t = static_cast<long long>((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  *tiles = static_cast<int>(t < INT_MAX ? t : INT_MAX);
  const int bk = dtype == 0 ? Layout<float>::BK : Layout<bf16>::BK;
  const long long steps = (k + bk - 1) / bk;
  const long long want = (2LL * sms + t - 1) / t;
  const long long splits = want < steps / 8 ? want : steps / 8;
  return static_cast<int>(splits > 1 ? splits : 1);
}

// dtype: 0 = float32, 1 = bfloat16.  aligned: 1 when k and n are multiples
// of 16 bytes of elements and x, y are 16-byte aligned.  splits comes from
// tiled_matmul_plan; ws holds splits * m * n floats and counters one int
// per output tile, zero before the launch and zero again after it, when
// splits > 1.  Returns cudaGetLastError() after the launch (0 = launched);
// launches on `stream`, allocates nothing, does not synchronise.
extern "C" int tiled_matmul_launch(int dtype, int aligned, const void* x, const void* y,
                                   void* out, float* ws, int* counters, int m, int n, int k,
                                   int splits, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || splits <= 0 || splits > 65535 ||
      (splits > 1 && (!ws || !counters)))
    return cudaErrorInvalidValue;
  MatmulArgs a{x, y, out, ws, counters, m, n, k, splits, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_stream(dtype, aligned, m)) {
    a.steps_per_split = ((k + wst::BK - 1) / wst::BK + splits - 1) / splits;
    return static_cast<int>(launch_stream(a, s));
  }
  cudaError_t err = dtype == 0   ? dispatch<float>(aligned != 0, a, s)
                    : dtype == 1 ? dispatch<bf16>(aligned != 0, a, s)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
