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
// What the design does about that: each block owns a 64 x 128 output tile
// and walks K in 64-byte slices (32 bf16 or 16 float32) through a 3-stage
// cp.async ring in shared memory, so the weight streams while the previous
// slice multiplies.  bf16 multiplies on the tensor cores (mma.sync m16n8k16,
// f32 accumulators, fragments by ldmatrix, each warp 64 x 32 of the tile)
// and skips 16-row sub-tiles past M (a batch of 16 uses one of four);
// float32 runs on the CUDA cores, not TF32.  128-wide N tiles give fc6 only
// 32 tiles for 132 SMs, so K is split over blocks (`tiled_matmul_plan` picks
// about two blocks per SM): each block writes its float partial to a workspace,
// and the last block of a tile to arrive (a counter per tile) sums the
// partials in split order, which keeps the result deterministic, and writes
// the tile, all in one launch.  Ragged M, N and K are masked, not padded:
// when K and N are multiples of 16 bytes of elements the copies are 16-byte
// cp.async with zero fill, otherwise element by element.
// Not yet used: wgmma and TMA.

#include <climits>

#include "common.cuh"
#include "gemm.cuh"

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

}  // namespace

// The number of blocks K is split over for an (m, k) @ (k, n) product on a
// card with `sms` multiprocessors: about two blocks per SM, each with at
// least 8 slices of K.  Writes the number of 64 x 128 output tiles (the
// counters a split launch needs) to *tiles.
extern "C" int tiled_matmul_plan(int dtype, int m, int n, int k, int sms, int* tiles) {
  const long long t = static_cast<long long>((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  *tiles = static_cast<int>(t < INT_MAX ? t : INT_MAX);
  const int bk = dtype == 0 ? Layout<float>::BK : Layout<bf16>::BK;
  const long long steps = (k + bk - 1) / bk;
  const long long want = (2LL * sms + t - 1) / t;
  const long long splits = want < steps / 8 ? want : steps / 8;
  return static_cast<int>(splits > 1 ? splits : 1);
}

// dtype: 0 = float32, 1 = bfloat16.  aligned: 1 when k and n are multiples
// of 16 bytes of elements and x, y are 16-byte aligned.  ws holds
// splits * m * n floats and counters one zeroed int per 64 x 128 output
// tile when splits > 1.  Returns cudaGetLastError() after the launch (0 =
// launched); launches on `stream`, allocates nothing, does not synchronise.
extern "C" int tiled_matmul_launch(int dtype, int aligned, const void* x, const void* y,
                                   void* out, float* ws, int* counters, int m, int n, int k,
                                   int splits, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || splits <= 0 || (splits > 1 && (!ws || !counters)))
    return cudaErrorInvalidValue;
  const MatmulArgs a{x, y, out, ws, counters, m, n, k, splits, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? dispatch<float>(aligned != 0, a, s)
                    : dtype == 1 ? dispatch<bf16>(aligned != 0, a, s)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
