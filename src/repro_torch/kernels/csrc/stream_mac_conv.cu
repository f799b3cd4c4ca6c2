// Strided, zero-padded NHWC x HWIO convolution as an implicit GEMM for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `stream_mac_conv` in
// src/repro/kernels/stream_mac_conv.py (body `_conv_kernel`, reached from
// `ops.stream_mac_conv` in src/repro/kernels/ops.py), which runs every conv
// layer of `ConvNetExecutor(impl="pallas")`.
//
// What it computes: out[n, oy, ox, co] = sum over taps (dy, dx) and input
// channels ci of x[n, oy*sy - py + dy, ox*sx - px + dx, ci] * w[dy, dx, ci, co],
// with taps that fall in the padding reading zero; float accumulation, the
// output written once in x's type.  As a GEMM: M = N*YO*WO output pixels,
// N = Co, K = KH*KW*Ci.
//
// What bounds it on the H100: operations, for most VGG16 layers in bf16 at
// batch 16.  conv3_x (56x56, 256 -> 256) does 59.2 GFLOP, 60 us at 989
// TFLOP/s, against 16 us of bytes; conv1_2 (224x224, 64 -> 64) sits at the
// crossover, about 61 us of bytes against 60 us of operations.
//
// What the design does about that: each block owns 128 output pixels x 64
// output channels and walks K in 64-byte slices (one tap, 32 bf16 or 16
// float32 channels).  The gathered input rows and the weight slice go
// through a 3-stage cp.async ring in shared memory, so the next slices load
// while this one multiplies; the input is read in place (no im2col copy and
// no padded copy: taps in the padding and pixels past the edge are
// zero-filled copies that read nothing).  bf16 multiplies on the tensor
// cores (mma.sync m16n8k16, f32 accumulators, fragments by ldmatrix; each
// warp owns 64 x 32 of the tile); float32 runs on the CUDA cores, not TF32,
// so the card-versus-CPU check holds at 1e-4.  Stride and padding are
// run-time arguments.  Ragged pixel and Co edges are masked.  The loads are
// 16 bytes wide, so Ci and the weight's row pitch must be multiples of 8:
// the wrapper (kernels/ops.py) zero-pads Ci to 8 on x and w (VGG16's and
// AlexNet's conv1 have Ci = 3) and Co to 8 on w only; the output keeps Co.
// Not yet used: wgmma and TMA, the next factor of speed.

#include <climits>

#include "common.cuh"
#include "gemm.cuh"

namespace {

using gemm::bf16;

constexpr int BM = 128;     // output pixels per block
constexpr int BN = 64;      // output channels per block
constexpr int STAGES = 3;

struct ConvArgs {
  const void* x;            // (n, h, wd, ci) contiguous, ci % 8 == 0
  const void* w;            // (kh, kw, ci, ldw) contiguous, ldw % 8 == 0, ldw >= co
  void* out;                // (n, yo, wo, co) contiguous
  int n, h, wd, ci, kh, kw, co, ldw, yo, wo, sy, sx, py, px;
  int m;                    // n * yo * wo
};

template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int BK = 32;
  using Tile = gemm::MmaTile<BM, BN, BK, 2, 2>;
};
template <>
struct Cfg<float> {
  static constexpr int BK = 16;
  using Tile = gemm::SimtTile<BM, BN, BK, 8, 8>;
};

template <typename T>
struct Layout {
  static constexpr int BK = Cfg<T>::BK;
  static constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte copy
  static constexpr int AP = BK + VEC;            // 80-byte rows: ldmatrix conflict-free
  static constexpr int BP = BN + VEC;
  static constexpr int A_ELEMS = BM * AP, STAGE = BM * AP + BK * BP;
  static constexpr size_t SMEM = sizeof(T) * STAGES * STAGE;
  static_assert(BK * sizeof(T) == 64, "one k slice is four 16-byte copies per pixel");
};

template <typename T>
__global__ void __launch_bounds__(gemm::kThreads) conv_igemm(const ConvArgs a) {
  using L = Layout<T>;
  constexpr int BK = L::BK, VEC = L::VEC, AP = L::AP, BP = L::BP;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);

  const int n_tiles = (a.co + BN - 1) / BN;
  const int m0 = blockIdx.x / n_tiles * BM, n0 = blockIdx.x % n_tiles * BN;
  const int tid = threadIdx.x;

  // Input rows: thread tid copies 16-byte segment tid % 4 of tile rows
  // tid / 4 + 32 i.  A row past the last pixel gets iy0 far below zero, so
  // every tap reads as padding.
  const int seg = tid % 4;
  int iy0[4], ix0[4];
  long long img[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tid / 4 + 32 * i;
    if (m < a.m) {
      const int per_img = a.yo * a.wo;
      const int b = m / per_img, rem = m - b * per_img, oy = rem / a.wo, ox = rem - oy * a.wo;
      img[i] = static_cast<long long>(b) * a.h * a.wd * a.ci;
      iy0[i] = oy * a.sy - a.py;
      ix0[i] = ox * a.sx - a.px;
    } else {
      img[i] = 0;
      iy0[i] = INT_MIN / 2;
      ix0[i] = 0;
    }
  }

  const int chunks = (a.ci + BK - 1) / BK;
  const int nk = a.kh * a.kw * chunks;

  auto load = [&](int stage, int ks) {
    T* As = smem + stage * L::STAGE;
    T* Bs = As + L::A_ELEMS;
    const int tap = ks / chunks, c0 = (ks - tap * chunks) * BK;
    const int dy = tap / a.kw, dx = tap - dy * a.kw;
    const int c = c0 + seg * VEC;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = iy0[i] + dy, ix = ix0[i] + dx;
      const bool ok = c < a.ci && iy >= 0 && iy < a.h && ix >= 0 && ix < a.wd;
      const T* src = ok ? x + img[i] + (static_cast<long long>(iy) * a.wd + ix) * a.ci + c : x;
      gemm::cp_async16(As + (tid / 4 + 32 * i) * AP + seg * VEC, src, ok);
    }
    constexpr int SEGS = BN / VEC;                 // 16-byte segments per weight row
    constexpr int PER_THREAD = BK * SEGS / gemm::kThreads;
    static_assert(BK * SEGS % gemm::kThreads == 0, "weight slice splits evenly");
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int idx = tid + j * gemm::kThreads, kr = idx / SEGS, cs = idx % SEGS;
      const int k = c0 + kr, col = n0 + cs * VEC;
      const bool ok = k < a.ci && col < a.ldw;
      const T* src = ok ? w + (static_cast<long long>(tap) * a.ci + k) * a.ldw + col : w;
      gemm::cp_async16(Bs + kr * BP + cs * VEC, src, ok);
    }
  };

  typename Cfg<T>::Tile tile;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    gemm::cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    gemm::cp_async_wait<STAGES - 2>();
    __syncthreads();                 // slice ks landed; slice ks - 1 is consumed
    const int next = ks + STAGES - 1;
    if (next < nk) load(next % STAGES, next);
    gemm::cp_async_commit();
    const T* As = smem + (ks % STAGES) * L::STAGE;
    tile.template step<AP, BP>(As, As + L::A_ELEMS, a.m - m0);
  }

  T* out = static_cast<T*>(a.out) + static_cast<long long>(m0) * a.co + n0;
  const int rows = a.m - m0, cols = a.co - n0;
  tile.for_each_pair([&](int r, int c, float v0, float v1) {
    gemm::store_pair(out, a.co, rows, cols, r, c, v0, v1);
  });
}

template <typename T>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  constexpr size_t smem = Layout<T>::SMEM;
  cudaError_t err = rt::allow_smem(conv_igemm<T>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((a.m + BM - 1) / BM) * ((a.co + BN - 1) / BN);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  conv_igemm<T><<<static_cast<unsigned>(blocks), gemm::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).  Launches on `stream`, allocates nothing and does
// not synchronise.
extern "C" int stream_mac_conv_launch(int dtype, const void* x, const void* w, void* out, int n,
                                      int h, int wd, int ci, int kh, int kw, int co, int ldw,
                                      int sy, int sx, int py, int px, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || ci <= 0 || ci % 8 || kh <= 0 || kw <= 0 || co <= 0 ||
      ldw < co || ldw % 8 || sy <= 0 || sx <= 0 || py < 0 || px < 0)
    return cudaErrorInvalidValue;
  const int yo = (h + 2 * py - kh) / sy + 1, wo = (wd + 2 * px - kw) / sx + 1;
  if (h + 2 * py < kh || wd + 2 * px < kw) return cudaErrorInvalidValue;
  const long long m = static_cast<long long>(n) * yo * wo;
  if (m > INT_MAX) return cudaErrorInvalidValue;
  const ConvArgs a{x, w, out, n, h, wd, ci, kh, kw, co, ldw, yo, wo, sy, sx, py, px,
                   static_cast<int>(m)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? launch<float>(a, s)
                    : dtype == 1 ? launch<bf16>(a, s)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
