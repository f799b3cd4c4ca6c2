// Helpers shared by the attention kernels: 16-byte loads widened to float,
// warp reductions, row staging into shared memory, and the online-softmax
// update of one row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace rt {

constexpr int kThreads = 128;               // every kernel runs 4 warps
constexpr int kWarps = kThreads / 32;

// 16 bytes of T, widened to float.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copies ROWS rows of D elements into shared memory as float (row pitch DP
// floats, times `mul`).  row_ptr(t) gives row t's address, or nullptr for a
// masked row, which is stored as zeros.  Each thread issues up to four
// 16-byte loads before it stores any of them, so the block keeps
// 4 x 128 x 16 bytes in flight.
template <typename T, int D, int ROWS, int DP, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* dst, RowPtr row_ptr, float mul) {
  constexpr int N = Pack<T>::N;
  constexpr int VPR = D / N;                       // vectors per row
  constexpr int TOTAL = ROWS * VPR;
  constexpr int ITER = (TOTAL + kThreads - 1) / kThreads;
  constexpr int BATCH = ITER < 4 ? ITER : 4;
  static_assert(D % N == 0 && DP % 4 == 0, "rows must split into 16-byte vectors");
  for (int it0 = 0; it0 < ITER; it0 += BATCH) {
    float vals[BATCH][N];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = threadIdx.x + (it0 + u) * kThreads;
      const T* src = i < TOTAL ? row_ptr(i / VPR) : nullptr;
      if (src != nullptr) {
        Pack<T>::load(src + (i % VPR) * N, vals[u]);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) vals[u][j] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = threadIdx.x + (it0 + u) * kThreads;
      if (i < TOTAL) {
        float4* d = reinterpret_cast<float4*>(dst + (i / VPR) * DP + (i % VPR) * N);
#pragma unroll
        for (int j = 0; j < N / 4; ++j) {
          d[j] = make_float4(vals[u][4 * j] * mul, vals[u][4 * j + 1] * mul,
                             vals[u][4 * j + 2] * mul, vals[u][4 * j + 3] * mul);
        }
      }
    }
  }
}

// Stages ROWS rows of two tensors that share a layout (K and V) in one pass:
// row_off(t) gives row t's element offset into both, or -1 for a masked
// row (zeros).  Up to eight 16-byte loads per thread are in flight before
// the first store.
template <typename T, int D, int ROWS, int DP, typename RowOff>
__device__ __forceinline__ void stage_pair(float* a_dst, float* b_dst, const T* a, const T* b,
                                           RowOff row_off) {
  constexpr int N = Pack<T>::N;
  constexpr int VPR = D / N;
  constexpr int HALF = ROWS * VPR;
  constexpr int TOTAL = 2 * HALF;
  constexpr int ITER = (TOTAL + kThreads - 1) / kThreads;
  constexpr int BATCH = ITER < 8 ? ITER : 8;
  static_assert(D % N == 0 && DP % 4 == 0, "rows must split into 16-byte vectors");
  for (int it0 = 0; it0 < ITER; it0 += BATCH) {
    float vals[BATCH][N];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = threadIdx.x + (it0 + u) * kThreads;
      const int j = i % HALF;
      const long long off = i < TOTAL ? row_off(j / VPR) : -1;
      if (off >= 0) {
        Pack<T>::load((i < HALF ? a : b) + off + (j % VPR) * N, vals[u]);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) vals[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = threadIdx.x + (it0 + u) * kThreads;
      if (i < TOTAL) {
        const int j = i % HALF;
        float4* d = reinterpret_cast<float4*>((i < HALF ? a_dst : b_dst) + (j / VPR) * DP +
                                              (j % VPR) * N);
#pragma unroll
        for (int e = 0; e < N / 4; ++e)
          d[e] = make_float4(vals[u][4 * e], vals[u][4 * e + 1], vals[u][4 * e + 2],
                             vals[u][4 * e + 3]);
      }
    }
  }
}

// Folds one tile of a row's scores (one per lane of the warp, -inf where
// masked) into the running max m and sum l.  Returns this lane's
// probability; `alpha` is the factor that rescales the row's accumulator.
// A row with nothing unmasked yet keeps m = -inf, l = 0 and probabilities 0.
__device__ __forceinline__ float online_softmax(float s, float& m, float& l, float& alpha) {
  const float m_new = fmaxf(m, warp_max(s));
  const float p = s == -INFINITY ? 0.f : expf(s - m_new);
  alpha = m == -INFINITY ? 0.f : expf(m - m_new);
  l = l * alpha + warp_sum(p);
  m = m_new;
  return p;
}

// Dynamic shared memory above 48 KB must be allowed per kernel before launch.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
