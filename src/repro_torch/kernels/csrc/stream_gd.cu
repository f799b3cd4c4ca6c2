// The paper's Eq. 1 weight update, W = sum_j C_j * W^(j), for Hopper (sm_90a),
// over a list of tensors in one launch, with an optional second stage chained
// in the same pass.
//
// Replaces the Pallas TPU kernel `stream_gd` in src/repro/kernels/stream_gd.py
// (body `_gd_kernel`, wrapper `ops.stream_gd` in src/repro/kernels/ops.py).
// In the port it is the whole of the `sgd` and `momentum` updates
// (src/repro_torch/optim/optimizer.py): one launch per step over every leaf
// of the parameter tree.  sgd is one stage, w <- [1 - lr*wd, -lr] . (w, g);
// momentum is two, m <- [beta, 1] . (m, g) and w <- [1 - lr*wd, -lr] . (w, m),
// where stage 2 reads the m that stage 1 has just computed.
//
// What it computes, per leaf and element i < n: stage 1,
// o1 = C_0 * x_0[i] + ... + C_{J1-1} * x_{J1-1}[i], then (with two stages)
// o2 = D_0 * y_0[i] + ... over stage 2's streams, one of which may be stage
// 1's output (the "marker" slot).  Every sum runs in float32 in stream order
// with separate multiplies and adds (__fmul_rn / __fadd_rn, never an FMA) and
// is rounded once to its output's type: the plain version's arithmetic
// (separate torch ops), so the two are bit-equal.  Stage 2 reads stage 1's
// output as it would read it back from memory, rounded to o1's type and
// widened again, so one two-stage launch gives the bits of two one-stage
// launches for a float32 or a bfloat16 state.  Each stream and output has
// its own type (float32 or bfloat16): a momentum step mixes a bf16 weight
// with an f32 moment and f32 or bf16 grads.  An output may be one of its own
// stage's inputs, and stage 2's output one of stage 1's: a thread reads all
// of an element's inputs before it writes its outputs, so the update runs in
// place.  Stage 2 must not read stage 1's output tensor directly (that would
// see the old values); it names it through the marker.
//
// What bounds it on the H100: bytes.  Each element reads each stream once
// and writes each output once, with under 0.2 flop per byte, far below the
// card's ~20 float32 flops per byte.  A full-width qwen2.5-3b momentum step
// with float32 grads moves 16 bytes per parameter in one pass (m 4 + g 4 +
// w 2 read, m 4 + w 2 written), 49.4 GB, 14.74 ms at 3.35 TB/s; two
// one-stage passes moved 20 (m is written, then read again).
//
// The design:
// - One launch per list of leaves.  The leaf table (pointers, types, element
//   count, first chunk) is a kernel parameter passed by value, sized from
//   the parameter limit (32,764 bytes from CUDA 12.1, 4 KB before), so a
//   step over hundreds of leaves is one launch; a longer list is split into
//   as many launches as it needs, each counted by the caller.
// - One block per chunk of a leaf: U * 2,048 elements, U = 4, 2 or 1 by the
//   number of streams.  A block finds its leaf by a binary search of the
//   table's first chunks.  A persistent grid (SMs x resident blocks, each
//   walking chunks b, b + grid, ...) was slower on the H100 in the same
//   call: new blocks keep loads in flight while others store.
// - Bytes in flight: each thread issues every load of its U 8-element units
//   (16 bytes of bf16 or 32 of float32 per stream, about 128 bytes per
//   thread) before it converts, computes or stores any of them.  Loads and
//   stores are plain ld.global / st.global: the streaming hint (.cs) was
//   slower in the same call, and the non-coherent path (ld.global.nc,
//   __ldg) is not used because the update is in place, so the kernel reads
//   memory that it also writes.  This reaches torch.add's rate; a form that
//   loads each chunk into shared memory by cp.async.bulk on mbarriers tied
//   it, so the simpler one stays.
// - A leaf whose pointers are not all 16-byte aligned, and the last n % 8
//   elements of a leaf, go element by element, 4 loads in flight per stream
//   and thread.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kVec = 8;                  // elements per unit: 16 bytes of bf16, 32 of float32
constexpr int kBatch = 4;                // elements per thread in flight on the element path
constexpr int kMaxOne = 8;               // streams of a one-stage launch
constexpr int kMaxTwo = 4;               // streams of each stage of a two-stage launch
constexpr long long kMaxGrid = 1ll << 30;  // chunks after which a table takes no more leaves
#if CUDART_VERSION >= 12010
constexpr int kParamBytes = 32764;       // kernel parameter limit, CUDA 12.1 and later
#else
constexpr int kParamBytes = 4096;
#endif

template <int J1, int J2>
struct Leaf {
  const void* in[J1 + J2];    // stage 1's streams, then stage 2's (nullptr at the marker)
  void* out[2];               // stage 1's output, stage 2's (nullptr with one stage)
  long long n;                // elements
  long long chunk0;           // the leaf's first chunk (block) in this launch
  unsigned types;             // bit k: stream k is bf16; bits 16, 17: out[0], out[1] are
  unsigned vec;               // 1: every pointer is 16-byte aligned
};

template <int J1, int J2>
struct Head {
  float c[J1 + J2];           // stage 1's coefficients, then stage 2's
  int marker;                 // stage 2's stream that is stage 1's output, or -1
  int count;                  // leaves in this launch
  long long chunks;           // chunks over all of them: the grid
};

// units of 8 elements per thread, ~128 bytes in flight over S streams
template <int S>
constexpr int kUnits = S <= 2 ? 4 : (S <= 4 ? 2 : 1);

// elements per chunk: one block's work
template <int S>
constexpr int kChunk = kBlock * kVec * kUnits<S>;

template <int J1, int J2>
constexpr int kCap = (kParamBytes - static_cast<int>(sizeof(Head<J1, J2>)) - 16) /
                     static_cast<int>(sizeof(Leaf<J1, J2>));

template <int J1, int J2>
struct Table {
  Head<J1, J2> h;
  Leaf<J1, J2> leaf[kCap<J1, J2>];
};

constexpr unsigned kOutBf16 = 1u << 16;

__device__ __forceinline__ bool is_bf16(unsigned types, int bit) { return (types >> bit) & 1u; }

__device__ __forceinline__ float round_to(float x, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Eq. 1 for one element: x holds every stream widened to float32 (the
// marker's slot is ignored); o1 and, with two stages, o2 come out unrounded.
template <int J1, int J2>
__device__ __forceinline__ void eq1(const Head<J1, J2>& h, const float (&x)[J1 + J2],
                                    bool o1_bf16, float& o1, float& o2) {
  float acc = __fmul_rn(h.c[0], x[0]);
#pragma unroll
  for (int j = 1; j < J1; ++j) acc = __fadd_rn(acc, __fmul_rn(h.c[j], x[j]));
  o1 = acc;
  if (J2 > 0) {
    const float y1 = round_to(acc, o1_bf16);     // as stage 2 would read it back
    float acc2 = 0.f;
#pragma unroll
    for (int k = 0; k < J2; ++k) {
      const float term = __fmul_rn(h.c[J1 + k], k == h.marker ? y1 : x[J1 + k]);
      acc2 = k == 0 ? term : __fadd_rn(acc2, term);
    }
    o2 = acc2;
  }
}

// ---- 16-byte path: U units of 8 elements per thread, loads first ----------

__device__ __forceinline__ void widen8(const uint4 (&r)[2], bool bf16, float (&v)[kVec]) {
  if (bf16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r[0]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    v[0] = __uint_as_float(r[0].x), v[1] = __uint_as_float(r[0].y);
    v[2] = __uint_as_float(r[0].z), v[3] = __uint_as_float(r[0].w);
    v[4] = __uint_as_float(r[1].x), v[5] = __uint_as_float(r[1].y);
    v[6] = __uint_as_float(r[1].z), v[7] = __uint_as_float(r[1].w);
  }
}

__device__ __forceinline__ void store8(void* base, bool bf16, long long e, const float (&v)[kVec]) {
  if (bf16) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + e) = raw;
  } else {
    uint4* p = reinterpret_cast<uint4*>(static_cast<float*>(base) + e);
    p[0] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
    p[1] = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]), __float_as_uint(v[6]),
                      __float_as_uint(v[7]));
  }
}

// Units u * kBlock + threadIdx.x (u < U) of a chunk that starts at element
// `start` of leaf L and holds `units` whole units.
template <int J1, int J2>
__device__ __forceinline__ void vec_chunk(const Head<J1, J2>& h, const Leaf<J1, J2>& L,
                                          long long start, int units) {
  constexpr int S = J1 + J2;
  constexpr int U = kUnits<S>;
  uint4 r[U][S][2];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int unit = u * kBlock + static_cast<int>(threadIdx.x);
    if (unit < units) {
      const long long e = start + static_cast<long long>(unit) * kVec;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s >= J1 && s - J1 == h.marker) continue;
        const bool bf = is_bf16(L.types, s);
        const uint4* p = reinterpret_cast<const uint4*>(static_cast<const char*>(L.in[s]) +
                                                        e * (bf ? 2 : 4));
        r[u][s][0] = p[0];
        if (!bf) r[u][s][1] = p[1];
      }
    }
  }
  const bool o1_bf16 = L.types & kOutBf16;
  const bool o2_bf16 = L.types & (kOutBf16 << 1);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int unit = u * kBlock + static_cast<int>(threadIdx.x);
    if (unit < units) {
      const long long e = start + static_cast<long long>(unit) * kVec;
      float v[S][kVec];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s >= J1 && s - J1 == h.marker) {
#pragma unroll
          for (int i = 0; i < kVec; ++i) v[s][i] = 0.f;   // not read: eq1 takes o1
        } else {
          widen8(r[u][s], is_bf16(L.types, s), v[s]);
        }
      }
      float o1[kVec], o2[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float x[S];
#pragma unroll
        for (int s = 0; s < S; ++s) x[s] = v[s][i];
        eq1<J1, J2>(h, x, o1_bf16, o1[i], o2[i]);
      }
      store8(L.out[0], o1_bf16, e, o1);
      if (J2 > 0) store8(L.out[1], o2_bf16, e, o2);
    }
  }
}

// ---- element path: unaligned leaves and the last n % 8 elements -----------

__device__ __forceinline__ float load1(const void* base, bool bf16, long long i) {
  if (bf16) {
    const unsigned short raw = static_cast<const unsigned short*>(base)[i];
    return __uint_as_float(static_cast<unsigned>(raw) << 16);
  }
  return static_cast<const float*>(base)[i];
}

__device__ __forceinline__ void store1(void* base, bool bf16, long long i, float v) {
  if (bf16)
    static_cast<unsigned short*>(base)[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  else
    static_cast<float*>(base)[i] = v;
}

// Elements lo + b * kBlock + threadIdx.x (b < kBatch, below len) of the chunk
// that starts at element `start` of leaf L.
template <int J1, int J2>
__device__ __forceinline__ void elem_group(const Head<J1, J2>& h, const Leaf<J1, J2>& L,
                                           long long start, int lo, int len) {
  constexpr int S = J1 + J2;
  float x[kBatch][S];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int i = lo + b * kBlock + static_cast<int>(threadIdx.x);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      x[b][s] = 0.f;
      if (i < len && !(s >= J1 && s - J1 == h.marker))
        x[b][s] = load1(L.in[s], is_bf16(L.types, s), start + i);
    }
  }
  const bool o1_bf16 = L.types & kOutBf16;
  const bool o2_bf16 = L.types & (kOutBf16 << 1);
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int i = lo + b * kBlock + static_cast<int>(threadIdx.x);
    if (i < len) {
      float o1, o2;
      eq1<J1, J2>(h, x[b], o1_bf16, o1, o2);
      store1(L.out[0], o1_bf16, start + i, o1);
      if (J2 > 0) store1(L.out[1], o2_bf16, start + i, o2);
    }
  }
}

template <int J1, int J2>
__global__ void __launch_bounds__(kBlock)
    stream_gd_update(const __grid_constant__ Table<J1, J2> t) {
  constexpr int C = kChunk<J1 + J2>;
  const long long c = blockIdx.x;
  int lo = 0, hi = t.h.count - 1;          // the last leaf whose first chunk is <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.leaf[mid].chunk0 <= c)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Leaf<J1, J2>& L = t.leaf[lo];
  const long long start = (c - L.chunk0) * C;
  const long long rest = L.n - start;
  const int len = static_cast<int>(rest < C ? rest : C);
  int done = 0;
  if (L.vec) {
    vec_chunk<J1, J2>(t.h, L, start, len / kVec);
    done = len / kVec * kVec;
  }
  for (int lo_e = done; lo_e < len; lo_e += kBatch * kBlock)
    elem_group<J1, J2>(t.h, L, start, lo_e, len);
}

using LaunchFn = cudaError_t (*)(const float*, int, int, const unsigned long long*,
                                 const unsigned*, const long long*, cudaStream_t, int*);

// Packs the leaves into as many tables as they need and launches one grid
// per table; `launches` counts the grids launched.
template <int J1, int J2>
cudaError_t launch(const float* c, int marker, int n, const unsigned long long* ptrs,
                   const unsigned* types, const long long* numel, cudaStream_t stream,
                   int* launches) {
  static_assert(sizeof(Table<J1, J2>) <= kParamBytes, "the leaf table must fit the parameters");
  constexpr int S = J1 + J2;
  constexpr int C = kChunk<S>;
  Table<J1, J2> t;
  for (int k = 0; k < S; ++k) t.h.c[k] = c[k];
  t.h.marker = marker;
  int i = 0;
  while (true) {
    t.h.count = 0;
    t.h.chunks = 0;
    for (; i < n && t.h.count < kCap<J1, J2> && t.h.chunks <= kMaxGrid; ++i) {
      if (numel[i] <= 0) continue;
      Leaf<J1, J2>& L = t.leaf[t.h.count++];
      const unsigned long long* p = ptrs + static_cast<size_t>(i) * (S + 2);
      unsigned long long align = p[S] | p[S + 1];
      for (int s = 0; s < S; ++s) {
        L.in[s] = reinterpret_cast<const void*>(p[s]);
        align |= p[s];
      }
      L.out[0] = reinterpret_cast<void*>(p[S]);
      L.out[1] = reinterpret_cast<void*>(p[S + 1]);
      L.n = numel[i];
      L.chunk0 = t.h.chunks;
      L.types = types[i];
      L.vec = align % 16 == 0;
      t.h.chunks += (numel[i] + C - 1) / C;
    }
    if (t.h.count == 0) return cudaSuccess;
    if (t.h.chunks > INT_MAX) return cudaErrorInvalidValue;
    stream_gd_update<J1, J2><<<static_cast<unsigned>(t.h.chunks), kBlock, 0, stream>>>(t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
}

constexpr LaunchFn kOneStage[kMaxOne] = {launch<1, 0>, launch<2, 0>, launch<3, 0>, launch<4, 0>,
                                         launch<5, 0>, launch<6, 0>, launch<7, 0>, launch<8, 0>};
constexpr LaunchFn kTwoStage[kMaxTwo][kMaxTwo] = {
    {launch<1, 1>, launch<1, 2>, launch<1, 3>, launch<1, 4>},
    {launch<2, 1>, launch<2, 2>, launch<2, 3>, launch<2, 4>},
    {launch<3, 1>, launch<3, 2>, launch<3, 3>, launch<3, 4>},
    {launch<4, 1>, launch<4, 2>, launch<4, 3>, launch<4, 4>}};
constexpr int kOneCap[kMaxOne] = {kCap<1, 0>, kCap<2, 0>, kCap<3, 0>, kCap<4, 0>,
                                  kCap<5, 0>, kCap<6, 0>, kCap<7, 0>, kCap<8, 0>};
constexpr int kTwoCap[kMaxTwo][kMaxTwo] = {{kCap<1, 1>, kCap<1, 2>, kCap<1, 3>, kCap<1, 4>},
                                           {kCap<2, 1>, kCap<2, 2>, kCap<2, 3>, kCap<2, 4>},
                                           {kCap<3, 1>, kCap<3, 2>, kCap<3, 3>, kCap<3, 4>},
                                           {kCap<4, 1>, kCap<4, 2>, kCap<4, 3>, kCap<4, 4>}};

bool valid_shape(int j1, int j2) {
  return j2 == 0 ? (j1 >= 1 && j1 <= kMaxOne)
                 : (j1 >= 1 && j1 <= kMaxTwo && j2 >= 1 && j2 <= kMaxTwo);
}

}  // namespace

// Leaves per launch for j1 streams in stage 1 and j2 in stage 2 (0: one
// stage); 0 for a shape the kernel does not take.
extern "C" int stream_gd_capacity(int j1, int j2) {
  if (!valid_shape(j1, j2)) return 0;
  return j2 == 0 ? kOneCap[j1 - 1] : kTwoCap[j1 - 1][j2 - 1];
}

// n leaves of j1 stage-1 streams and j2 stage-2 streams (j2 = 0: one stage;
// one stage takes 1-8 streams, two stages 1-4 each).  c: the j1 + j2
// float32 coefficients, stage 1's first.  marker: the stage-2 stream that is
// stage 1's output, or -1.  ptrs: per leaf, j1 + j2 stream pointers (0 at
// the marker), then stage 1's and stage 2's outputs (0 with one stage).
// types: per leaf, bit k set where stream k is bfloat16 (else float32), bits
// 16 and 17 for the outputs.  numel: per leaf, its elements (a leaf of 0 is
// skipped).  Everything is contiguous; an output may be one of its stage's
// streams, or stage 2's one of stage 1's.  Launches on `stream` as many
// grids as the leaves need,
// counting them in *launches; allocates nothing and does not synchronise.
// Returns cudaGetLastError() after the last launch (0 = launched).
extern "C" int stream_gd_launch(int j1, int j2, int marker, const float* c, int n,
                                const unsigned long long* ptrs, const unsigned* types,
                                const long long* numel, void* stream, int* launches) {
  if (launches == nullptr) return cudaErrorInvalidValue;
  *launches = 0;
  if (!valid_shape(j1, j2) || marker < -1 || marker >= j2 || n < 0 || c == nullptr ||
      (n > 0 && (ptrs == nullptr || types == nullptr || numel == nullptr)))
    return cudaErrorInvalidValue;
  const int S = j1 + j2;
  for (int i = 0; i < n; ++i) {
    const unsigned long long* p = ptrs + static_cast<size_t>(i) * (S + 2);
    for (int s = 0; s < S; ++s)
      if (p[s] == 0 && !(s >= j1 && s - j1 == marker)) return cudaErrorInvalidValue;
    if (p[S] == 0 || (j2 > 0) != (p[S + 1] != 0)) return cudaErrorInvalidValue;
  }
  const LaunchFn fn = j2 == 0 ? kOneStage[j1 - 1] : kTwoStage[j1 - 1][j2 - 1];
  return static_cast<int>(
      fn(c, marker, n, ptrs, types, numel, static_cast<cudaStream_t>(stream), launches));
}
