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
// output rounded to x's type, then optionally out += bias[co] (rounded
// again) and ReLU, written once.  As a GEMM: M = N*YO*WO output pixels,
// N = Co, K = KH*KW*Ci.
//
// What bounds it on the H100: operations, for most VGG16 layers in bf16 at
// batch 16.  conv3_x (56x56, 256 -> 256) does 59.2 GFLOP, 60 us at 989
// TFLOP/s, against 16 us of bytes; conv1_2 (224x224, 64 -> 64) sits at the
// crossover, about 61 us of bytes against 60 us of operations.
//
// Two designs, chosen by shape in `pick` (the wrapper logs which one ran):
//
// wgmma + TMA (bf16 with Ci >= 64: every VGG16 layer but conv1_1).  A
// warp-specialised implicit GEMM with persistent blocks (one per SM, each
// walking tiles blockIdx.x, + gridDim.x, ...).  A tile is wb x hb output
// pixels of one image (an output row of up to 128 pixels split evenly,
// then as many rows as fit: 112 x 1 at 224 and 112 wide, 56 x 2, 28 x 4,
// 14 x 9) by TN output channels (64 for Co = 64, 256 where K >= 4096 and
// those tiles fill the card, else 128).  One producer thread keeps a ring
// of 192 KB of k-slices in flight, each one tap by 64 input channels, both
// operands by TMA with the 128-byte swizzle and reported to the stage's
// mbarrier by their byte count:
//   A, the tile's input rows: one 4-D box {64 channels, wb, hb, 1 image} of
//   x seen as (Ci, W, H, N), its corner at the tap's input pixel
//   (ox0 sx - px + dx, oy0 sy - py + dy) and the traversal strides (sx, sy),
//   so the hardware gathers the strided rows and zero-fills the padding,
//   the edges and channels past Ci.  This is im2col for one tap, done with
//   the tiled mode; it needs no thread to compute an address.
//   B, the weight's 64 x TN slice of HWIO seen as (taps, Ci, Co): TN / 64
//   boxes of 64 channels, zero-filled past Ci and Co.
// Two consumer warpgroups, 64 tile rows each, run wgmma.mma_async m64nTNk16
// from shared memory with float accumulators in registers (A K-major, B
// N-major through the transpose flag; no ldmatrix, no staging) and hand a
// stage back once the wgmma group that read it has retired (wait_group 1
// keeps one group in flight).  setmaxnreg moves registers from the
// producer warpgroup (40) to the consumers (232), which TN = 256 needs for
// its 128 accumulators a thread.  The epilogue rounds each accumulator to
// bf16 and, when asked, adds the bias (rounding again, as PyTorch's bf16
// add_ does) and applies ReLU, so the fused call is bit-equal to the conv
// followed by add_ and relu_.  It writes the tile into a staging buffer
// (128-byte swizzle) from which one thread stores it by TMA as a 4-D box
// of the output, the hardware clipping rows past the image and channels
// past Co; the consumers go on to the next tile while the store drains
// (the epilogue cost 15-25 % of the kernel as direct stores).  An output
// whose Co is not a multiple of 8 (no TMA map) is stored pair by pair.
//
// mma.sync (float32, and bf16 with Ci < 64: conv1_1 and AlexNet's conv1,
// which are bound by bytes): each block owns 128 output pixels x 64 output
// channels and walks K = (tap, channel) flat in 64-byte slices (32 bf16 or
// 16 float32 values; with Ci = 8 a bf16 slice holds four taps) through a
// 3-stage cp.async ring; bf16 multiplies on the tensor cores (mma.sync
// m16n8k16, fragments by ldmatrix), float32 on the CUDA cores, not TF32,
// so the card-versus-CPU check holds at 1e-4.  Same epilogue.
//
// Both read the input in place (no im2col copy, no padded copy).  Stride
// and padding are run-time arguments.  The loads are 16 bytes wide, so Ci
// and the weight's row pitch must be multiples of 8: the wrapper
// (kernels/ops.py) zero-pads Ci to 8 on x and w (VGG16's and AlexNet's
// conv1 have Ci = 3) and Co to 8 on w only; the output keeps Co.

#include <climits>

#include "common.cuh"
#include "gemm.cuh"
#include "hopper.cuh"

namespace {

using gemm::bf16;

struct ConvArgs {
  const void* x;            // (n, h, wd, ci) contiguous, ci % 8 == 0
  const void* w;            // (kh, kw, ci, ldw) contiguous, ldw % 8 == 0, ldw >= co
  void* out;                // (n, yo, wo, co) contiguous
  const void* bias;         // (co,) in x's type, or null
  int n, h, wd, ci, kh, kw, co, ldw, yo, wo, sy, sx, py, px;
  int m;                    // n * yo * wo
  int relu;
};

// The epilogue of one output: round to T, then (when asked) add the bias
// and round again, then ReLU; what conv, add_(b), relu_() compute in T.
template <typename T>
__device__ __forceinline__ float finish(float acc, const T* bias, int col, int relu) {
  float v = gemm::to_float(gemm::from_float<T>(acc));
  if (bias != nullptr) v = gemm::to_float(gemm::from_float<T>(v + gemm::to_float(bias[col])));
  if (relu && v < 0.f) v = 0.f;
  return v;
}

// Writes the pairs (r, c), (r, c + 1) that `each` hands out, of the output
// tile at (m0, n0), through the epilogue.  Without bias and ReLU a pair is
// rounded once, as it is stored.
template <typename T, typename Each>
__device__ __forceinline__ void store_tile(const ConvArgs& a, int m0, int n0, Each each) {
  T* out = static_cast<T*>(a.out) + static_cast<long long>(m0) * a.co + n0;
  const int rows = a.m - m0, cols = a.co - n0;
  const T* bias = a.bias == nullptr ? nullptr : static_cast<const T*>(a.bias) + n0;
  if (bias == nullptr && !a.relu) {
    each([&](int r, int c, float v0, float v1) {
      gemm::store_pair(out, a.co, rows, cols, r, c, v0, v1);
    });
  } else {
    each([&](int r, int c, float v0, float v1) {
      if (r >= rows || c >= cols) return;
      v0 = finish<T>(v0, bias, c, a.relu);
      v1 = c + 1 < cols ? finish<T>(v1, bias, c + 1, a.relu) : 0.f;
      gemm::store_pair(out, a.co, rows, cols, r, c, v0, v1);
    });
  }
}

// ---- mma.sync design ----------------------------------------------------------

constexpr int BM = 128;     // output pixels per block
constexpr int BN = 64;      // output channels per block
constexpr int STAGES = 3;

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

  // K runs over (tap, channel) flat, k = tap * ci + c, so a small Ci packs
  // several taps into one slice (Ci = 8: four bf16 taps) instead of padding
  // each tap to a slice; a 16-byte segment never straddles two taps, as
  // Ci is a multiple of 8.
  const int kdim = a.kh * a.kw * a.ci;
  const int nk = (kdim + BK - 1) / BK;

  auto load = [&](int stage, int ks) {
    T* As = smem + stage * L::STAGE;
    T* Bs = As + L::A_ELEMS;
    const int k0 = ks * BK + seg * VEC;
    const int tap = k0 / a.ci, c = k0 - tap * a.ci;
    const int dy = tap / a.kw, dx = tap - dy * a.kw;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = iy0[i] + dy, ix = ix0[i] + dx;
      const bool ok = k0 < kdim && iy >= 0 && iy < a.h && ix >= 0 && ix < a.wd;
      const T* src = ok ? x + img[i] + (static_cast<long long>(iy) * a.wd + ix) * a.ci + c : x;
      gemm::cp_async16(As + (tid / 4 + 32 * i) * AP + seg * VEC, src, ok);
    }
    constexpr int SEGS = BN / VEC;                 // 16-byte segments per weight row
    constexpr int PER_THREAD = BK * SEGS / gemm::kThreads;
    static_assert(BK * SEGS % gemm::kThreads == 0, "weight slice splits evenly");
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int idx = tid + j * gemm::kThreads, kr = idx / SEGS, cs = idx % SEGS;
      const int k = ks * BK + kr, col = n0 + cs * VEC;
      const bool ok = k < kdim && col < a.ldw;
      const T* src = ok ? w + static_cast<long long>(k) * a.ldw + col : w;
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

  store_tile<T>(a, m0, n0, [&](auto f) { tile.for_each_pair(f); });
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

// ---- wgmma + TMA design (bf16) ------------------------------------------------

namespace wg {
constexpr int BM = 128;                 // output pixels per tile: two consumer warpgroups
constexpr int THREADS = 384;            // producer warpgroup, then two consumer warpgroups
constexpr int SMEM_MAX = 227 * 1024;    // a block's shared memory

constexpr int BK = 64;                  // input channels per k-slice: one 128-byte row
constexpr int A_BYTES = BM * BK * 2;    // 16 KB: room for the tile's input rows

template <int TN>
struct Cfg {
  static constexpr int B_BYTES = BK * TN * 2;   // TN / 64 boxes of 64 x 64
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int OUT_BYTES = BM * TN * 2; // the output tile, staged for the TMA store
  static constexpr int RING = (SMEM_MAX - 2048 - OUT_BYTES) / STAGE;   // 1 KB for barriers
  static constexpr size_t SMEM = RING * STAGE + OUT_BYTES + 1024;      // + alignment to 1024
};

// A tile is a block of wb x hb output pixels of one image (wb * hb <= 128,
// row r of the tile is pixel (r / wb, r % wb) of the block) by TN output
// channels.  tma_store: the output tile goes out by TMA (needs Co % 8 == 0).
struct Tiles {
  int wb, hb, x_blocks, y_blocks, n_tiles, count, tma_store;
};
}  // namespace wg

template <int TN>
__global__ void __launch_bounds__(wg::THREADS, 1)
    conv_igemm_wgmma(const ConvArgs a, const wg::Tiles g,
                     const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap) {
  using C = wg::Cfg<TN>;
  using Mma = hop::Wgmma<TN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[C::RING], empty[C::RING];
  const uint32_t base = (hop::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t out_base = base + C::RING * C::STAGE;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::RING; ++s) {
      hop::mbar_init(hop::smem_u32(&full[s]), 1);        // the producer's arrival + bytes
      hop::mbar_init(hop::smem_u32(&empty[s]), 8);       // one per consumer warp
    }
    hop::mbar_init_fence();
  }
  __syncthreads();
  const int taps = a.kh * a.kw, chunks = (a.ci + wg::BK - 1) / wg::BK;
  const int per_image = g.y_blocks * g.x_blocks;

  if (tid < 128) {
    // ---- producer: one thread issues every load of the ring ----
    hop::regs_dec<40>();
    if (tid == 0) {
      const uint32_t tx = g.wb * g.hb * 128 + C::B_BYTES;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < g.count; t += gridDim.x) {
        const int pix = t / g.n_tiles, n0 = t % g.n_tiles * TN;
        const int img = pix / per_image, yb = pix % per_image / g.x_blocks;
        const int xb = pix % g.x_blocks;
        // input corner of tap (0, 0): padding and edges read as zeros (TMA's
        // out-of-bounds fill), strides by the map's traversal strides
        const int iy = yb * g.hb * a.sy - a.py, ix = xb * g.wb * a.sx - a.px;
        for (int c0 = 0; c0 < a.ci; c0 += wg::BK) {
          for (int tap = 0; tap < taps; ++tap) {     // the taps innermost
            const int dy = tap / a.kw, dx = tap - dy * a.kw;
            const uint32_t fb = hop::smem_u32(&full[stage]);
            hop::mbar_wait(hop::smem_u32(&empty[stage]), phase ^ 1);
            const uint32_t as = base + stage * C::STAGE, bs = as + wg::A_BYTES;
            hop::mbar_arrive_tx(fb, tx);
            hop::tma_load_4d(as, &xmap, fb, c0, ix + dx, iy + dy, img);
#pragma unroll
            for (int j = 0; j < TN / 64; ++j)
              hop::tma_load_3d(bs + j * (wg::BK * 128), &wmap, fb, n0 + 64 * j, c0, tap);
            if (++stage == C::RING) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows 64 h .. 64 h + 63 of the tile ----
    hop::regs_inc<232>();
    const int half = tid / 128 - 1, t = tid % 128, warp = t / 32, lane = t % 32;
    const int steps = taps * chunks;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    float acc[Mma::R];
    for (int tile = blockIdx.x; tile < g.count; tile += gridDim.x) {
      const int pix = tile / g.n_tiles, n0 = tile % g.n_tiles * TN;
      const int img = pix / per_image, yb = pix % per_image / g.x_blocks;
      const int xb = pix % g.x_blocks;
#pragma unroll
      for (int i = 0; i < Mma::R; ++i) acc[i] = 0.f;
      for (int ks = 0; ks < steps; ++ks) {
        hop::mbar_wait(hop::smem_u32(&full[stage]), phase);
        const uint32_t as = base + stage * C::STAGE + half * (64 * 128);
        const uint32_t bs = base + stage * C::STAGE + wg::A_BYTES;
        hop::fence_regs(acc);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < wg::BK / 16; ++kk) {
          // A: 64 rows of 128 bytes, 8-row groups 1024 bytes apart, k16 = 32 bytes;
          // B: 64-column boxes 64 x 128 bytes apart, 8-row groups 1024 apart, k16 = 16 rows
          Mma::mma(acc, hop::sw128_desc(as + kk * 32, 16, 1024),
                   hop::sw128_desc(bs + kk * 16 * 128, wg::BK * 128, 1024));
        }
        hop::wgmma_commit();
        hop::wgmma_wait<1>();                  // the previous slice's products retired
        if (ks > 0 && lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[prev]));
        prev = stage;
        if (++stage == C::RING) {
          stage = 0;
          phase ^= 1;
        }
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[prev]));
      // accumulator layout: d[4j + 2i + e] is row 16 warp + lane / 4 + 8 i,
      // column 8 j + 2 (lane % 4) + e of this warpgroup's 64 x TN tile; tile
      // row r is output pixel (yb hb + r / wb, xb wb + r % wb) of image img
      const int c0 = 2 * (lane % 4), rows = g.wb * g.hb;
      if (g.tma_store) {
        // through the staging tile, once the previous tile's store has read it
        if (t == 0 && half == 0) hop::bulk_wait_read<0>();
        hop::named_sync(1, 256);
        const bf16* bias = a.bias == nullptr ? nullptr : static_cast<const bf16*>(a.bias) + n0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = half * 64 + warp * 16 + lane / 4 + 8 * i;
          if (r >= rows) continue;
#pragma unroll
          for (int j = 0; j < TN / 8; ++j) {
            float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
            const int c = c0 + 8 * j;
            if (bias != nullptr || a.relu) {   // columns past Co read bias[0]; not stored
              v0 = finish<bf16>(v0, bias, n0 + c < a.co ? c : 0, a.relu);
              v1 = finish<bf16>(v1, bias, n0 + c + 1 < a.co ? c + 1 : 0, a.relu);
            }
            const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
            const uint32_t at = out_base + (j / 8) * (wg::BM * 128) + hop::swz(r, j % 8) + 2 * c0;
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                         "r"(*reinterpret_cast<const uint32_t*>(&pair))
                         : "memory");
          }
        }
        hop::fence_proxy_async();
        hop::named_sync(1, 256);
        if (t == 0 && half == 0) {
#pragma unroll
          for (int j = 0; j < TN / 64; ++j)
            hop::tma_store_4d(&omap, out_base + j * (wg::BM * 128), n0 + 64 * j, xb * g.wb,
                              yb * g.hb, img);
          hop::bulk_commit();
        }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = half * 64 + warp * 16 + lane / 4 + 8 * i;
          const int oy = yb * g.hb + r / g.wb, ox = xb * g.wb + r % g.wb;
          if (r >= rows || oy >= a.yo || ox >= a.wo) continue;
          store_tile<bf16>(a, (img * a.yo + oy) * a.wo + ox, n0, [&](auto f) {
#pragma unroll
            for (int j = 0; j < TN / 8; ++j)
              f(0, c0 + 8 * j, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
          });
        }
      }
    }
    if (t == 0 && half == 0) hop::bulk_wait_all();   // the last store, before the block ends
  }
}

// Tile geometry: an output row of up to 128 pixels split evenly (wb), then
// as many rows as fit in 128 (hb), within the 256-element box limit of the
// strided loads.  count = -1 when the grid would not fit an int.
wg::Tiles tiles_for(const ConvArgs& a, int tn) {
  wg::Tiles g;
  const int splits = (a.wo + wg::BM - 1) / wg::BM;
  g.wb = (a.wo + splits - 1) / splits;
  if (g.wb * a.sx > 256) g.wb = 256 / a.sx;
  g.hb = wg::BM / g.wb;
  if (g.hb > a.yo) g.hb = a.yo;
  if (g.hb * a.sy > 256) g.hb = 256 / a.sy;
  g.x_blocks = (a.wo + g.wb - 1) / g.wb;
  g.y_blocks = (a.yo + g.hb - 1) / g.hb;
  g.n_tiles = (a.co + tn - 1) / tn;
  g.tma_store = a.co % 8 == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  const long long count = static_cast<long long>(a.n) * g.y_blocks * g.x_blocks * g.n_tiles;
  g.count = count > INT_MAX ? -1 : static_cast<int>(count);
  return g;
}

template <int TN>
cudaError_t launch_wgmma(const ConvArgs& a, int sms, cudaStream_t stream) {
  const wg::Tiles g = tiles_for(a, TN);
  if (g.count < 0) return cudaErrorInvalidValue;
  // x as (ci, wd, h, n), boxes of 64 channels x wb x hb pixels at the strides
  CUtensorMap xmap, wmap, omap = {};
  const uint64_t xdims[4] = {static_cast<uint64_t>(a.ci), static_cast<uint64_t>(a.wd),
                             static_cast<uint64_t>(a.h), static_cast<uint64_t>(a.n)};
  const uint64_t xstr[3] = {static_cast<uint64_t>(a.ci) * 2,
                            static_cast<uint64_t>(a.ci) * a.wd * 2,
                            static_cast<uint64_t>(a.ci) * a.wd * a.h * 2};
  const uint32_t xbox[4] = {static_cast<uint32_t>(wg::BK), static_cast<uint32_t>(g.wb * a.sx),
                            static_cast<uint32_t>(g.hb * a.sy), 1};
  const uint32_t xtrav[4] = {1, static_cast<uint32_t>(a.sx), static_cast<uint32_t>(a.sy), 1};
  // the weight as (ldw, ci, taps), Co innermost; boxes of 64 channels x 64 k-rows
  const uint64_t wdims[3] = {static_cast<uint64_t>(a.ldw), static_cast<uint64_t>(a.ci),
                             static_cast<uint64_t>(a.kh) * a.kw};
  const uint64_t wstr[2] = {static_cast<uint64_t>(a.ldw) * 2,
                            static_cast<uint64_t>(a.ci) * a.ldw * 2};
  const uint32_t wbox[3] = {64, wg::BK, 1};
  // the output as (co, wo, yo, n), boxes of 64 channels x wb x hb pixels
  const uint64_t odims[4] = {static_cast<uint64_t>(a.co), static_cast<uint64_t>(a.wo),
                             static_cast<uint64_t>(a.yo), static_cast<uint64_t>(a.n)};
  const uint64_t ostr[3] = {static_cast<uint64_t>(a.co) * 2,
                            static_cast<uint64_t>(a.co) * a.wo * 2,
                            static_cast<uint64_t>(a.co) * a.wo * a.yo * 2};
  const uint32_t obox[4] = {64, static_cast<uint32_t>(g.wb), static_cast<uint32_t>(g.hb), 1};
  if (hop::encode_bf16(&xmap, a.x, 4, xdims, xstr, xbox, xtrav) != 0 ||
      hop::encode_bf16(&wmap, a.w, 3, wdims, wstr, wbox) != 0 ||
      (g.tma_store && hop::encode_bf16(&omap, a.out, 4, odims, ostr, obox) != 0))
    return cudaErrorNotSupported;
  constexpr size_t smem = wg::Cfg<TN>::SMEM;
  cudaError_t err = rt::allow_smem(conv_igemm_wgmma<TN>, smem);
  if (err != cudaSuccess) return err;
  const int grid = g.count < sms ? g.count : sms;
  conv_igemm_wgmma<TN><<<grid, wg::THREADS, smem, stream>>>(a, g, xmap, wmap, omap);
  return cudaGetLastError();
}

// The design a call takes: 0 = mma.sync 128 x 64 tiles; wgmma + TMA with
// 128-pixel tiles by 1 = 64, 2 = 128 or 3 = 256 channels.  Wgmma takes
// 64-channel k-slices, so a Ci under 64 (conv1_1 and AlexNet's conv1)
// stays on mma.sync, whose flat K packs its taps (wgmma with 16-channel
// slices ran slower than it there, see PERF.md).  64 channels suit
// Co = 64; 256 halves the weight traffic per product where K is long
// (>= 4096) and the wider tiles still fill the card, else 128.  float32
// takes mma.sync.
int pick(int dtype, const ConvArgs& a, int sms) {
  if (dtype != 1 || a.ci < wg::BK || a.sx > 256 || a.sy > 256) return 0;
  if (a.co <= 64) return 1;
  if (a.co % 256 == 0 && a.kh * a.kw * a.ci >= 4096 && tiles_for(a, 256).count >= sms) return 3;
  return 2;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bias: (co,) in x's type or null;
// relu: nonzero to apply ReLU after the bias.  sms: the card's
// multiprocessor count (the persistent grid's size).  Writes the design it
// takes (see `pick`) to *path.  Returns cudaGetLastError() after the launch
// (0 = launched).  Launches on `stream`, allocates nothing and does not
// synchronise.
extern "C" int stream_mac_conv_launch(int dtype, const void* x, const void* w, const void* bias,
                                      void* out, int n, int h, int wd, int ci, int kh, int kw,
                                      int co, int ldw, int sy, int sx, int py, int px, int relu,
                                      int sms, int* path, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || ci <= 0 || ci % 8 || kh <= 0 || kw <= 0 || co <= 0 ||
      ldw < co || ldw % 8 || sy <= 0 || sx <= 0 || py < 0 || px < 0 || sms <= 0)
    return cudaErrorInvalidValue;
  const int yo = (h + 2 * py - kh) / sy + 1, wo = (wd + 2 * px - kw) / sx + 1;
  if (h + 2 * py < kh || wd + 2 * px < kw) return cudaErrorInvalidValue;
  const long long m = static_cast<long long>(n) * yo * wo;
  if (m > INT_MAX || static_cast<long long>(n) * h * wd > INT_MAX) return cudaErrorInvalidValue;
  const ConvArgs a{x, w, out, bias, n, h, wd, ci, kh, kw, co, ldw, yo, wo, sy, sx, py, px,
                   static_cast<int>(m), relu != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  *path = pick(dtype, a, sms);
  switch (*path) {
    case 0: err = dtype == 0 ? launch<float>(a, s) : launch<bf16>(a, s); break;
    case 1: err = launch_wgmma<64>(a, sms, s); break;
    case 2: err = launch_wgmma<128>(a, sms, s); break;
    case 3: err = launch_wgmma<256>(a, sms, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
