// VALID max-pooling of an NHWC tensor for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `stream_maxpool` in
// src/repro/kernels/stream_maxpool.py (body `_maxpool_kernel`, reached from
// `ops.stream_maxpool` in src/repro/kernels/ops.py).  The JAX executor pools
// with `lax.reduce_window`; the port's executor runs this kernel for every
// pool layer that is not the global average, padding with -inf first where
// the layer pads.
//
// What it computes: out[n, oy, ox, c] = max over dy < kh, dx < kw of
// x[n, oy*sy + dy, ox*sx + dx, c], VALID (no padding), in x's type; NaN
// propagates as torch.maximum does.  The max is exact, so the result is
// bit-equal to the plain version's.
//
// What bounds it on the H100: bytes.  It does one comparison per element
// read; VGG16's pool1 at batch 16 in bf16 reads 102.8 MB and writes 25.7 MB,
// about 38 us at 3.35 TB/s.
//
// What the design does about that: one thread per 16 bytes of channels of
// one output pixel (8 bf16 or 4 float32), neighbouring threads on
// neighbouring channels, so every load and store is a full 16-byte access
// and a warp reads 512 contiguous bytes per tap.  With a 2x2 window and
// stride 2 each input element is read once; overlapping windows (3x3,
// stride 2) re-read rows that the L2 still holds.  A channel count that is
// not a multiple of the vector, or an unaligned pointer, takes the same
// kernel with one element per thread.

#include <climits>

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kBlock = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kBlock)
    maxpool_valid(const T* __restrict__ x, T* __restrict__ out, int h, int wd, int c, int kh,
                  int kw, int sy, int sx, int yo, int wo, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= total) return;
  const int groups = c / V;
  const int g = static_cast<int>(idx % groups);
  long long p = idx / groups;
  const int ox = static_cast<int>(p % wo);
  p /= wo;
  const int oy = static_cast<int>(p % yo);
  const long long b = p / yo;
  const T* src = x + ((b * h + static_cast<long long>(oy) * sy) * wd +
                      static_cast<long long>(ox) * sx) * c + g * V;
  Vec<T, V> best = *reinterpret_cast<const Vec<T, V>*>(src);
  for (int dy = 0; dy < kh; ++dy) {
    for (int dx = 0; dx < kw; ++dx) {
      const Vec<T, V> v =
          *reinterpret_cast<const Vec<T, V>*>(src + (static_cast<long long>(dy) * wd + dx) * c);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = gemm::to_float(v.v[e]);
        if (f > gemm::to_float(best.v[e]) || f != f) best.v[e] = v.v[e];
      }
    }
  }
  *reinterpret_cast<Vec<T, V>*>(out + idx * V) = best;
}

template <typename T, int V>
cudaError_t launch(const void* x, void* out, int n, int h, int wd, int c, int kh, int kw, int sy,
                   int sx, cudaStream_t stream) {
  const int yo = (h - kh) / sy + 1, wo = (wd - kw) / sx + 1;
  const long long total = static_cast<long long>(n) * yo * wo * (c / V);
  const long long blocks = (total + kBlock - 1) / kBlock;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  maxpool_valid<T, V><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), h, wd, c, kh, kw, sy, sx, yo, wo, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool vec, const void* x, void* out, int n, int h, int wd, int c, int kh,
                     int kw, int sy, int sx, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec) return launch<T, V>(x, out, n, h, wd, c, kh, kw, sy, sx, s);
  return launch<T, 1>(x, out, n, h, wd, c, kh, kw, sy, sx, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when c is a multiple of 16
// bytes of elements and both pointers are 16-byte aligned.  x and out are
// contiguous NHWC.  Returns cudaGetLastError() after the launch (0 =
// launched); launches on `stream`, allocates nothing, does not synchronise.
extern "C" int stream_maxpool_launch(int dtype, int vec, const void* x, void* out, int n, int h,
                                     int wd, int c, int kh, int kw, int sy, int sx,
                                     void* stream) {
  if (n <= 0 || c <= 0 || kh <= 0 || kw <= 0 || sy <= 0 || sx <= 0 || h < kh || wd < kw)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0   ? dispatch<float>(vec != 0, x, out, n, h, wd, c, kh, kw, sy, sx, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(vec != 0, x, out, n, h, wd, c, kh, kw, sy, sx, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
