// The paper's Eq. 1 weight update, W = sum_j C_j * W^(j), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `stream_gd` in src/repro/kernels/stream_gd.py
// (body `_gd_kernel`, wrapper `ops.stream_gd` in src/repro/kernels/ops.py).
// In the port it is the whole of the `sgd` and `momentum` updates
// (src/repro_torch/optim/optimizer.py): one launch per parameter leaf for
// sgd, w <- [1 - lr*wd, -lr] . (w, g), and two for momentum,
// m <- [beta, 1] . (m, g) then w <- [1 - lr*wd, -lr] . (w, m).
//
// What it computes: for every element i < M, acc = C_0 * x_0[i], then
// acc = acc + C_j * x_j[i] for j = 1 .. J-1 in stream order, all in float32
// with separate multiplies and adds (__fmul_rn / __fadd_rn, never an FMA),
// rounded once to the output type.  That is the plain version's arithmetic
// (separate torch ops), so the two are bit-equal.  Each stream has its own
// type (float32 or bfloat16): a momentum step mixes a bf16 weight with an
// f32 moment, which one stacked (J, M) array cannot hold.  The output may
// alias any input: a thread reads all of its elements before it writes
// them, so the update runs in place.
//
// What bounds it on the H100: bytes.  Each element reads J values and
// writes one, and does 2J - 1 flops: about 0.1 flop per byte, far below
// the card's ~20 float32 flops per byte.  A full-width qwen2.5-3b momentum
// step moves 18 bytes per parameter (m: f32 + bf16 read, f32 written; w:
// bf16 + f32 read, bf16 written), 55.6 GB, 16.6 ms at 3.35 TB/s.
//
// What the design does about that: a grid-stride loop in which a thread
// takes 8 consecutive elements per stream, as one 16-byte load of bf16 or
// two of float32, where every pointer is 16-byte aligned; everything else,
// and the tail past the last multiple of 8, goes element by element.
// Eight 256-thread blocks per SM keep ~100 KB of loads in flight per SM.
// One launch updates one leaf; a multi-tensor launch over all leaves is
// left for later.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxStreams = 8;
constexpr int kBlock = 256;
constexpr int kVec = 8;             // elements per thread per step of the vector loop

struct Streams {
  const void* in[kMaxStreams];
  float c[kMaxStreams];
  int bf16[kMaxStreams];            // 1: bfloat16, 0: float32
};

__device__ __forceinline__ void load_vec(const void* base, bool bf16, long long i, float* v) {
  if (bf16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
    const float4 a = p[0];
    const float4 b = p[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
}

__device__ __forceinline__ void store_vec(void* base, bool bf16, long long i, const float* v) {
  if (bf16) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + i) = raw;
  } else {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(base) + i);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ float load_one(const void* base, bool bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i])
              : static_cast<const float*>(base)[i];
}

__device__ __forceinline__ void store_one(void* base, bool bf16, long long i, float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(base)[i] = v;
}

// J streams; VEC: every pointer is 16-byte aligned, so the first
// floor(M / 8) * 8 elements go through 16-byte accesses.
template <int J, bool VEC>
__global__ void __launch_bounds__(kBlock)
    stream_gd_update(const Streams s, void* out, int out_bf16, long long m) {
  const long long tid = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * kBlock;
  long long done = 0;
  if (VEC) {
    const long long units = m / kVec;
    for (long long u = tid; u < units; u += nthreads) {
      const long long i = u * kVec;
      float x[J][kVec];
#pragma unroll
      for (int j = 0; j < J; ++j) load_vec(s.in[j], s.bf16[j], i, x[j]);
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        acc[e] = __fmul_rn(s.c[0], x[0][e]);
#pragma unroll
        for (int j = 1; j < J; ++j) acc[e] = __fadd_rn(acc[e], __fmul_rn(s.c[j], x[j][e]));
      }
      store_vec(out, out_bf16, i, acc);
    }
    done = units * kVec;
  }
  for (long long i = done + tid; i < m; i += nthreads) {
    float x[J];
#pragma unroll
    for (int j = 0; j < J; ++j) x[j] = load_one(s.in[j], s.bf16[j], i);
    float acc = __fmul_rn(s.c[0], x[0]);
#pragma unroll
    for (int j = 1; j < J; ++j) acc = __fadd_rn(acc, __fmul_rn(s.c[j], x[j]));
    store_one(out, out_bf16, i, acc);
  }
}

template <int J>
cudaError_t launch(const Streams& s, void* out, int out_bf16, long long m, bool vec, int sms,
                   cudaStream_t stream) {
  const long long work = vec ? m / kVec + m % kVec : m;
  const long long want = (work + kBlock - 1) / kBlock;
  const long long cap = static_cast<long long>(sms) * 8;
  const unsigned blocks = static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
  if (vec)
    stream_gd_update<J, true><<<blocks, kBlock, 0, stream>>>(s, out, out_bf16, m);
  else
    stream_gd_update<J, false><<<blocks, kBlock, 0, stream>>>(s, out, out_bf16, m);
  return cudaGetLastError();
}

}  // namespace

// j streams (1 <= j <= 8) of m elements each: in[k] points at stream k,
// in_bf16[k] is 1 for bfloat16 and 0 for float32, c[k] its float32
// coefficient; out (out_bf16 likewise) may alias any stream.  All are
// contiguous.  sms: the card's SM count (sizes the grid).  Returns
// cudaGetLastError() after the launch (0 = launched); launches on `stream`,
// allocates nothing, does not synchronise.
extern "C" int stream_gd_launch(int j, const void* const* in, const int* in_bf16,
                                const float* c, void* out, int out_bf16, long long m, int sms,
                                void* stream) {
  if (j < 1 || j > kMaxStreams || m <= 0 || sms <= 0 || out == nullptr)
    return cudaErrorInvalidValue;
  Streams s = {};
  uintptr_t align = reinterpret_cast<uintptr_t>(out);
  for (int k = 0; k < j; ++k) {
    if (in[k] == nullptr) return cudaErrorInvalidValue;
    s.in[k] = in[k];
    s.c[k] = c[k];
    s.bf16[k] = in_bf16[k] != 0;
    align |= reinterpret_cast<uintptr_t>(in[k]);
  }
  const bool vec = align % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ob = out_bf16 != 0;
  switch (j) {
    case 1: return static_cast<int>(launch<1>(s, out, ob, m, vec, sms, st));
    case 2: return static_cast<int>(launch<2>(s, out, ob, m, vec, sms, st));
    case 3: return static_cast<int>(launch<3>(s, out, ob, m, vec, sms, st));
    case 4: return static_cast<int>(launch<4>(s, out, ob, m, vec, sms, st));
    case 5: return static_cast<int>(launch<5>(s, out, ob, m, vec, sms, st));
    case 6: return static_cast<int>(launch<6>(s, out, ob, m, vec, sms, st));
    case 7: return static_cast<int>(launch<7>(s, out, ob, m, vec, sms, st));
    default: return static_cast<int>(launch<8>(s, out, ob, m, vec, sms, st));
  }
}
