// Pieces shared by the implicit-GEMM convolution and the tiled matmul:
// 16-byte cp.async copies into shared memory, the product of one staged
// k-slice into a block's accumulator tile (bf16 on the tensor cores with
// mma.sync m16n8k16, float32 on the CUDA cores), and masked output stores.
//
// Both tiles take A staged as [BM][AP] (k contiguous) and B staged as
// [BK][BP] (n contiguous), run on 4 warps (128 threads) and hand their
// accumulators out as pairs of neighbouring columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gemm {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes from global to shared memory without blocking; when
// !valid it reads nothing and stores zeros (src must still be a mapped
// address: callers pass the tensor's base then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

// Writes the pair (r, c), (r, c + 1) of a rows x cols row-major matrix with
// row pitch ld, dropping what falls outside it; one vector store when the
// pair is whole and aligned.
template <typename T>
__device__ __forceinline__ void store_pair(T* out, long long ld, int rows, int cols, int r, int c,
                                           float v0, float v1) {
  if (r >= rows || c >= cols) return;
  T* p = out + r * ld + c;
  if (c + 1 < cols && (reinterpret_cast<uintptr_t>(p) % (2 * sizeof(T))) == 0) {
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    } else {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    }
    return;
  }
  *p = from_float<T>(v0);
  if (c + 1 < cols) p[1] = from_float<T>(v1);
}

// bf16 block tile on the tensor cores.  The 4 warps sit WARPS_M x WARPS_N
// over the BM x BN tile; each owns (BM / WARPS_M) x (BN / WARPS_N) float
// accumulators.  Fragments come from shared memory by ldmatrix (B
// transposed, since it is staged n-contiguous).  In the accumulator layout
// lane 4g + t holds rows g and g + 8 and columns 2t, 2t + 1 of each 16 x 8
// sub-tile.
template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
struct MmaTile {
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static_assert(WARPS_M * WARPS_N == kThreads / 32, "four warps");
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "whole mma tiles");

  float acc[MI][NI][4];
  int wm, wn, lane;

  __device__ __forceinline__ MmaTile() {
    const int warp = threadIdx.x / 32;
    wm = warp / WARPS_N * WM;
    wn = warp % WARPS_N * WN;
    lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }

  // acc += A[:, 0:BK] @ B[0:BK, :].  16-row sub-tiles at or past rows_live
  // hold no data and are skipped (the condition is the same for the whole
  // warp, as mma.sync needs).
  template <int AP, int BP>
  __device__ __forceinline__ void step(const bf16* As, const bf16* Bs, int rows_live) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t b[NI][2];
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Bs + (kk + lane % 16) * BP + wn + j * 8 + (lane / 16) * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if (wm + i * 16 < rows_live) {
          uint32_t a[4];
          ldmatrix_x4(a, As + (wm + i * 16 + lane % 16) * AP + kk + (lane / 16) * 8);
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_16816(acc[i][j], a, b[j][0], b[j][1]);
        }
      }
    }
  }

  // f(row, col, v(row, col), v(row, col + 1)) for every accumulator pair
  template <typename F>
  __device__ __forceinline__ void for_each_pair(F f) const {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int r = wm + i * 16 + g, c = wn + j * 8 + 2 * t;
        f(r, c, acc[i][j][0], acc[i][j][1]);
        f(r + 8, c, acc[i][j][2], acc[i][j][3]);
      }
  }
};

// float32 block tile on the CUDA cores (no TF32): the 128 threads sit
// (BM / TM) x (BN / TN) over the tile; thread (ty, tx) owns rows
// ty + i * (BM / TM) and column pairs 2 tx + 2 p (BN / TN).
template <int BM, int BN, int BK, int TM, int TN>
struct SimtTile {
  static constexpr int TY = BM / TM, TX = BN / TN;
  static_assert(TY * TX == kThreads && TN % 2 == 0, "128 threads, column pairs");

  float acc[TM][TN];
  int ty, tx;

  __device__ __forceinline__ SimtTile() {
    ty = threadIdx.x / TX;
    tx = threadIdx.x % TX;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  template <int AP, int BP>
  __device__ __forceinline__ void step(const float* As, const float* Bs, int /*rows_live*/) {
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[TM];
      float2 b[TN / 2];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty + i * TY) * AP + k];
#pragma unroll
      for (int p = 0; p < TN / 2; ++p)
        b[p] = *reinterpret_cast<const float2*>(Bs + k * BP + 2 * tx + 2 * p * TX);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int p = 0; p < TN / 2; ++p) {
          acc[i][2 * p] = fmaf(a[i], b[p].x, acc[i][2 * p]);
          acc[i][2 * p + 1] = fmaf(a[i], b[p].y, acc[i][2 * p + 1]);
        }
    }
  }

  template <typename F>
  __device__ __forceinline__ void for_each_pair(F f) const {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int p = 0; p < TN / 2; ++p)
        f(ty + i * TY, 2 * tx + 2 * p * TX, acc[i][2 * p], acc[i][2 * p + 1]);
  }
};

}  // namespace gemm
