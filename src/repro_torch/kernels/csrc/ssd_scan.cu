// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan` in src/repro/kernels/ssd_scan.py
// (body `_ssd_kernel`, wrapper `ops.ssd_scan` in src/repro/kernels/ops.py).
// In the port it is the card path of `models/ssm.py:ssd_chunked`, so every
// mamba2 prefill (whole prompt, or each slice of a chunked prefill) runs it
// once per layer.
//
// What it computes, in float32 whatever the input type (bf16 x, B and C are
// widened on load): over chunks of Q tokens, with seg the running sum of
// dt*a inside the chunk, mid = (seg[0] + seg[Q-1]) / 2,
//   y[i]  = e_out[i] * sum_{j<=i} (C_i . B_j) * dt_j * x_j * e_in[j]
//         + exp(seg[i]) * C_i . S
//   S'    = exp(seg[Q-1]) * S + sum_j exp(seg[Q-1] - seg[j]) * dt_j * x_j (x) B_j
// with e_out = exp(clip(seg - mid, +-60)) and e_in = exp(clip(mid - seg,
// +-60)), the decay factorization of ssd_chunked.  S (P x N per head)
// starts from the given initial state (zeros for a null pointer) and the
// final one is written out.  No D-skip: ssd_chunked adds it and casts.
//
// What bounds it on the H100: operations on the CUDA cores.  A 512-token
// prefill of full-width mamba2-130m (H=24, P=64, N=128, Q=256) needs
// ~0.62 GFLOP per layer (the causal halves of each chunk; ssm.py's cost
// model counts 0.84 with whole squares) against ~7 MB of operands; the
// kernel works in float32 (ssd_chunked casts everything to float32), so
// the rate is the 67 TFLOP/s of the CUDA cores, not the tensor cores'.
//
// What the design does about that.  The TPU kernel keeps all H x P x N of
// state (786 KB at full width) in VMEM and walks the chunks on a sequential
// grid axis; no Hopper block holds that much, and nothing carries over
// between blocks.  So one block owns one (batch row, head, 16 columns of P)
// and loops over the chunks itself, with its 16 x N slice of the state in
// shared memory (8 KB at N = 128): 96 blocks for one full-width prompt.
// Per chunk one thread scans dt*a for seg, the block stages z = dt*x*e_in and
// w = dt*x*exp(seg[Q-1] - seg) for its columns, then walks 64-row tiles of C
// against 64-row tiles of B at or below the diagonal: each thread forms
// 8 x 2 scores of a 64 x 64 tile with 16-byte shared-memory loads (N is the
// contraction) and then 4 outputs of y's tile.  The state is read for
// C . S before it is updated; the update keeps each thread's slice of it in
// registers.  Tiles are staged from L2 with 16-byte loads (element loads
// where a row is not 16-byte aligned), several in flight per thread.
// Ragged chunks (a 44-token extend slice) and tiles past the chunk's end
// are masked.
//
// Known waste, left for a later change: C . B^T does not depend on the head
// and is recomputed by every (head, P slice) block, 96 times over at full
// width, and B tiles are re-read from L2 for every row tile.  A three-pass
// form (chunk states, state passing, chunk scan) or mma on the tensor cores
// would remove both.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kT = 256;     // threads per block
constexpr int PB = 16;      // columns of P per block
constexpr int TI = 64;      // rows of C per tile
constexpr int TJ = 64;      // rows of B per tile
constexpr int kLoads = 16;  // element loads a thread keeps in flight when staging
constexpr int kVecs = 4;    // 16-byte loads a thread keeps in flight when staging

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ inline size_t smem_floats(int n, int q) {
  const size_t np = n + 4;
  return TI * np + TJ * np + PB * np + TI * (TJ + 1) + 2 * static_cast<size_t>(q) * PB +
         5 * static_cast<size_t>(q);
}

// Rows [r0, r0 + rows) of a (S, n) operand of this batch row into `dst`
// (row pitch n + 4), zeros past `lim`.  Each thread issues kLoads loads
// before it stores any, so L2 latency is paid once per batch, not per load.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row_stride, int r0,
                                      int rows, int lim, int n) {
  const int np = n + 4, total = rows * n;
  for (int base = threadIdx.x; base < total; base += kT * kLoads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = base + u * kT, r = e / n;
      v[u] = e < total && r0 + r < lim ? widen(src[(r0 + r) * row_stride + (e - r * n)]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = base + u * kT, r = e / n;
      if (e < total) dst[r * np + (e - r * n)] = v[u];
    }
  }
}

// The same with 16-byte loads: rows and `src` 16-byte aligned, n a
// multiple of the 16-byte vector.
template <typename T>
__device__ __forceinline__ void stage_vec(float* dst, const T* src, long long row_stride, int r0,
                                          int rows, int lim, int n) {
  constexpr int V = rt::Pack<T>::N;
  const int np = n + 4, vpr = n / V, total = rows * vpr;
  for (int base = threadIdx.x; base < total; base += kT * kVecs) {
    float v[kVecs][V];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = base + u * kT, r = e / vpr;
      if (e < total && r0 + r < lim) {
        rt::Pack<T>::load(src + (r0 + r) * row_stride + (e - r * vpr) * V, v[u]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[u][k] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int e = base + u * kT, r = e / vpr;
      if (e < total) {
        float4* d = reinterpret_cast<float4*>(dst + r * np + (e - r * vpr) * V);
#pragma unroll
        for (int k = 0; k < V / 4; ++k)
          d[k] = make_float4(v[u][4 * k], v[u][4 * k + 1], v[u][4 * k + 2], v[u][4 * k + 3]);
      }
    }
  }
}

template <bool VEC, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long row_stride, int r0,
                                           int rows, int lim, int n) {
  if (VEC)
    stage_vec(dst, src, row_stride, r0, rows, lim, n);
  else
    stage(dst, src, row_stride, r0, rows, lim, n);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kT)
    ssd_chunk_scan(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
                   const float* __restrict__ dt, const float* __restrict__ a,
                   const float* __restrict__ init, float* __restrict__ y,
                   float* __restrict__ fin, int S, int H, int P, int N, int Q, long long x_sb,
                   long long x_ss, long long b_sb, long long b_ss, long long c_sb,
                   long long c_ss) {
  extern __shared__ __align__(16) float smem[];
  const int np = N + 4;
  float* Cs = smem;                    // TI x np: a tile of C
  float* Bs = Cs + TI * np;            // TJ x np: a tile of B
  float* St = Bs + TJ * np;            // PB x np: this block's state slice
  float* Sc = St + PB * np;            // TI x (TJ + 1): a tile of scores
  float* Z = Sc + TI * (TJ + 1);       // Q x PB: dt * x * e_in
  float* W = Z + Q * PB;               // Q x PB: dt * x * exp(seg_last - seg)
  float* seg = W + Q * PB;             // Q each
  float* e_in = seg + Q;
  float* e_out = e_in + Q;
  float* dfs = e_out + Q;              // exp(seg)
  float* dte = dfs + Q;                // exp(seg_last - seg)

  const int t = threadIdx.x;
  const int p0 = blockIdx.x * PB, h = blockIdx.y, bi = blockIdx.z;
  const float ah = a[h];
  const T* xb = x + bi * x_sb + static_cast<long long>(h) * P + p0;
  const T* bb = bm + bi * b_sb;
  const T* cb = cm + bi * c_sb;
  const float* dtb = dt + static_cast<long long>(bi) * S * H + h;
  const long long state_off = (static_cast<long long>(bi) * H + h) * P * N;

  for (int e = t; e < PB * N; e += kT) {
    const int p = e / N, n = e - p * N;
    St[p * np + n] = init != nullptr && p0 + p < P ? init[state_off + (p0 + p) * N + n] : 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int L = min(Q, S - s0);
    for (int i = t; i < L; i += kT) seg[i] = dtb[static_cast<long long>(s0 + i) * H] * ah;
    __syncthreads();
    if (t == 0) {   // in order, as the plain version's cumsum sums
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        run += seg[i];
        seg[i] = run;
      }
    }
    __syncthreads();
    const float last = seg[L - 1];
    const float mid = 0.5f * (seg[0] + last);
    for (int i = t; i < L; i += kT) {
      const float sg = seg[i];
      e_out[i] = expf(fminf(fmaxf(sg - mid, -60.f), 60.f));
      e_in[i] = expf(fminf(fmaxf(mid - sg, -60.f), 60.f));
      dfs[i] = expf(sg);
      dte[i] = expf(last - sg);
    }
    __syncthreads();
    for (int base = t; base < L * PB; base += kT * kLoads) {
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = base + u * kT, i = e / PB, p = e - i * PB;
        v[u] = e < L * PB && p0 + p < P ? dtb[static_cast<long long>(s0 + i) * H] *
                                              widen(xb[(s0 + i) * x_ss + p])
                                        : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = base + u * kT, i = e / PB;
        if (e < L * PB) {
          Z[e] = v[u] * e_in[i];
          W[e] = v[u] * dte[i];
        }
      }
    }

    // y, one tile of TI rows at a time (acc: rows r + 16k, column p)
    const int yp = t & (PB - 1), yr = t / PB;
    for (int i0 = 0; i0 < L; i0 += TI) {
      stage_rows<VEC>(Cs, cb, c_ss, s0 + i0, TI, s0 + L, N);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const int jend = min(i0 + TI, L);
      for (int j0 = 0; j0 < jend; j0 += TJ) {
        stage_rows<VEC>(Bs, bb, b_ss, s0 + j0, TJ, s0 + L, N);
        __syncthreads();
        {   // 8 rows x kC columns of the scores tile per thread
          constexpr int kC = TJ / 32;
          const int g = t / 32, tj = t & 31;
          float s[8][kC] = {};
          const float* crow = Cs + g * 8 * np;
          for (int n = 0; n < N; n += 4) {
            float4 bv[kC];
#pragma unroll
            for (int c = 0; c < kC; ++c)
              bv[c] = *reinterpret_cast<const float4*>(Bs + (tj + 32 * c) * np + n);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float4 cv = *reinterpret_cast<const float4*>(crow + r * np + n);
#pragma unroll
              for (int c = 0; c < kC; ++c) s[r][c] = dot4(cv, bv[c], s[r][c]);
            }
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
#pragma unroll
            for (int c = 0; c < kC; ++c) {
              const int i = i0 + g * 8 + r, j = j0 + tj + 32 * c;
              Sc[(g * 8 + r) * (TJ + 1) + tj + 32 * c] = j <= i && i < L ? s[r][c] : 0.f;
            }
          }
        }
        __syncthreads();
        const int jn = min(TJ, L - j0);
        for (int jj = 0; jj < jn; ++jj) {
          const float zv = Z[(j0 + jj) * PB + yp];
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] = fmaf(Sc[(yr + 16 * k) * (TJ + 1) + jj], zv, acc[k]);
        }
        __syncthreads();
      }
      float yo[4] = {0.f, 0.f, 0.f, 0.f};
      for (int n = 0; n < N; n += 4) {
        const float4 sv = *reinterpret_cast<const float4*>(St + yp * np + n);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          yo[k] = dot4(*reinterpret_cast<const float4*>(Cs + (yr + 16 * k) * np + n), sv, yo[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + yr + 16 * k;
        if (i < L && p0 + yp < P)
          y[((static_cast<long long>(bi) * S + s0 + i) * H + h) * P + p0 + yp] =
              e_out[i] * acc[k] + dfs[i] * yo[k];
      }
      __syncthreads();
    }

    // the state after this chunk.  Where N divides the block (N = 16 ... 256)
    // a thread owns one column n and a run of `per` rows of P, kept in
    // registers over the chunk; otherwise it walks its elements in shared
    // memory.
    const float decay = expf(last);
    const bool owned = N % PB == 0 && kT % N == 0;
    const int per = owned ? PB * N / kT : 0;            // 1 ... 16
    const int on = t % N, op = owned ? (t / N) * per : 0;
    float sacc[PB];
#pragma unroll
    for (int k = 0; k < PB; ++k) sacc[k] = k < per ? St[(op + k) * np + on] * decay : 0.f;
    if (!owned) {
      for (int e = t; e < PB * N; e += kT) {
        const int p = e / N, n = e - p * N;
        St[p * np + n] *= decay;
      }
    }
    for (int j0 = 0; j0 < L; j0 += TJ) {
      stage_rows<VEC>(Bs, bb, b_ss, s0 + j0, TJ, s0 + L, N);
      __syncthreads();
      const int jn = min(TJ, L - j0);
      if (owned) {
        for (int jj = 0; jj < jn; ++jj) {
          const float bv = Bs[jj * np + on];
          const float* wr = W + (j0 + jj) * PB + op;
#pragma unroll
          for (int k = 0; k < PB; ++k)
            if (k < per) sacc[k] = fmaf(wr[k], bv, sacc[k]);
        }
      } else {
        for (int e = t; e < PB * N; e += kT) {
          const int p = e / N, n = e - p * N;
          float v = St[p * np + n];
          for (int jj = 0; jj < jn; ++jj) v = fmaf(W[(j0 + jj) * PB + p], Bs[jj * np + n], v);
          St[p * np + n] = v;
        }
      }
      __syncthreads();
    }
    if (owned) {
#pragma unroll
      for (int k = 0; k < PB; ++k)
        if (k < per) St[(op + k) * np + on] = sacc[k];
      __syncthreads();
    }
  }

  for (int e = t; e < PB * N; e += kT) {
    const int p = e / N, n = e - p * N;
    if (p0 + p < P) fin[state_off + (p0 + p) * N + n] = St[p * np + n];
  }
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* b, const void* c, const float* dt, const float* a,
                   const float* init, float* y, float* fin, int B, int S, int H, int P, int N,
                   int Q, long long x_sb, long long x_ss, long long b_sb, long long b_ss,
                   long long c_sb, long long c_ss, cudaStream_t stream) {
  const size_t bytes = smem_floats(N, Q) * sizeof(float);
  if (bytes > 232448) return cudaErrorInvalidValue;
  cudaError_t err = rt::allow_smem(ssd_chunk_scan<T, VEC>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + PB - 1) / PB, H, B);
  ssd_chunk_scan<T, VEC><<<grid, kT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(c), dt, a, init,
      y, fin, S, H, P, N, Q, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return cudaGetLastError();
}

// B and C tiles are staged with 16-byte loads where their rows allow it
// (the model's views of one conv output do), else element by element.
template <typename T>
cudaError_t dispatch(const void* x, const void* b, const void* c, const float* dt,
                     const float* a, const float* init, float* y, float* fin, int B, int S, int H,
                     int P, int N, int Q, long long x_sb, long long x_ss, long long b_sb,
                     long long b_ss, long long c_sb, long long c_ss, cudaStream_t s) {
  const long long es = sizeof(T);
  const bool vec = N % rt::Pack<T>::N == 0 &&
                   (reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(c)) % 16 == 0 &&
                   (b_sb * es) % 16 == 0 && (b_ss * es) % 16 == 0 && (c_sb * es) % 16 == 0 &&
                   (c_ss * es) % 16 == 0;
  return vec ? launch<T, true>(x, b, c, dt, a, init, y, fin, B, S, H, P, N, Q, x_sb, x_ss, b_sb,
                               b_ss, c_sb, c_ss, s)
             : launch<T, false>(x, b, c, dt, a, init, y, fin, B, S, H, P, N, Q, x_sb, x_ss,
                                b_sb, b_ss, c_sb, c_ss, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b and c).  x is (B, S, H, P) with
// H and P contiguous (strides x_sb, x_ss, P, 1 in elements); b and c are
// (B, S, N) with N contiguous; dt (B, S, H) and a (H,) are contiguous
// float32; init (B, H, P, N) float32 or null (zeros).  y (B, S, H, P) and
// fin (B, H, P, N) are contiguous float32.  Q is the chunk (S need not be a
// multiple; a short last chunk is masked).  N must be a multiple of 4.
// Returns cudaGetLastError() after the launch (0 = launched); launches on
// `stream`, allocates nothing, does not synchronise.
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* b, const void* c,
                               const float* dt, const float* a, const float* init, float* y,
                               float* fin, int B, int S, int H, int P, int N, int Q,
                               long long x_sb, long long x_ss, long long b_sb, long long b_ss,
                               long long c_sb, long long c_ss, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N % 4 != 0 || Q <= 0 || H > 65535 ||
      B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? dispatch<float>(x, b, c, dt, a, init, y, fin, B, S, H, P, N, Q, x_sb, x_ss,
                                   b_sb, b_ss, c_sb, c_ss, s)
      : dtype == 1
          ? dispatch<__nv_bfloat16>(x, b, c, dt, a, init, y, fin, B, S, H, P, N, Q, x_sb, x_ss,
                                    b_sb, b_ss, c_sb, c_ss, s)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
