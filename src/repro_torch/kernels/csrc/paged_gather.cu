// Block-table gather of page pools for Hopper (sm_90a): one launch for every
// pool that shares a block table, rows moved by 1-D bulk asynchronous copies.
//
// Replaces the Pallas TPU kernel `paged_gather` in
// src/repro/kernels/paged_attn.py (body `_gather_kernel`, wrapper
// `ops.paged_gather` in src/repro/kernels/ops.py).  In the port it reads
// the pages of every paged decode that does not run the paged-attention
// kernel: a windowed layer's k and v (`models/attention.py:
// paged_lane_views`), an MLA layer's latent and k_rope (`models/mla.py`),
// each one launch per layer and step, and every seq leaf of the cache tree
// on the gather decode path (`serve/paged_cache.py:gather_views`), one
// launch per decode step.
//
// What it computes, for each pool i of a list and every leading index l
// (the layers): out_i[l, b, p, :] = pool_i[l, bt[b, p], :], and zeros where
// bt[b, p] is -1.  Every pool reads the one (lanes, slots) int32 table; each
// has its own type, row size, page count and number of layers.  A row is one
// page (page_size x heads x head_dim elements of any type) and is copied as
// bytes, so the result is bit-equal to the plain version's.
//
// What bounds it on the H100: bytes.  Each filled row is read once, every
// slot written once and the table read once.  One recurrentgemma-9b
// attention layer's pool (8 lanes x 256 slots of 8 KiB rows, a third of them
// filled) moves 22 MB: 6.7 us at 3.35 TB/s.  So the card has to keep some
// 25-40 KB of reads in flight per SM from the start; the first design (a
// block per row, one 16-byte load in flight per thread, a launch per pool)
// reached 11 % of that bound at this shape.
//
// The design:
// - One launch per list of pools.  The pool table (pointers, layers, pages,
//   row bytes, first chunk) is a kernel parameter passed by value, so a call
//   copies nothing to the card; a list longer than one table's capacity
//   launches one grid per table.  A table holds 8 pools, more than any decode
//   step passes (at most 4: two seq leaves of two segments).
// - The work is cut in chunks of at most 16 KiB: up to 32 consecutive rows
//   of one pool (whose outputs are consecutive too), or a 16 KiB piece of a
//   longer row.  Persistent blocks, two per SM, take equal runs of chunks.
// - In a block, one warp moves the bytes.  Lane j copies row j of a chunk
//   with a 1-D bulk copy (cp.async.bulk: no tensor map, so the host encodes
//   nothing per call) from the pool into one of 4 ring stages of 16 KiB in
//   shared memory, completing on the stage's mbarrier, and from there with a
//   bulk store to the output.  Three chunks' loads are in flight while the
//   fourth is stored, and no thread spends registers on the data.  A -1 slot
//   reads nothing and is stored from a zeroed row.  Other rings were timed on
//   the H100 while this one was chosen (3-12 stages, 1-3 blocks per SM, 8 or
//   16 KiB stages): 8 x 16 KiB at one block per SM was faster alone on one
//   layer's pool but slower inside recurrentgemma-9b decode steps (fuller
//   tables); the others were slower or within a few percent.
// - The block copies the table into shared memory first (up to 4,096
//   entries; a larger one is read from device memory), so no chunk's loads
//   wait on a table read.
// - Rows whose size or bases are not multiples of 16 bytes (bulk copies need
//   that) take a vector path in the same launch, in blocks of their own: the
//   widest unit that divides the row and both bases, every thread's 8 loads
//   in flight before its stores.  The launch's dynamic shared memory (the
//   ring, ~82-98 KB) is given to every block, so where a list mixes bulk and
//   vector rows the vector blocks, which use none of it, also fit only two
//   per SM.  No decode step passes such a list.

#include <atomic>
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBlock = 128;            // all zero the row and copy the table; warp 0 copies
constexpr int kLanes = 32;             // rows per chunk at most: one per lane of the copy warp
constexpr int kStage = 16384;          // bytes of a ring stage: one chunk
constexpr int kStages = 4;
constexpr int kBlocksPerSm = 2;
constexpr int kTableCache = 4096;      // table entries a block keeps in shared memory
constexpr int kVecUnits = 8;           // units per thread in flight on the vector path
constexpr long long kVecChunk = static_cast<long long>(kBlock) * kVecUnits;
constexpr int kBarBytes = (kStages * 8 + 15) / 16 * 16;   // the table after them stays 16-aligned
constexpr int kSmemBase = (kStages + 1) * kStage + kBarBytes;   // stages, zero row, barriers
constexpr int kSmemMax = kSmemBase + kTableCache * 4;
constexpr int kCap = 8;                // pools per launch: a longer list takes one grid per 8
constexpr int kDesc = 5;               // per pool: pool, out, layers, pages, row bytes

struct Entry {
  const unsigned char* pool;
  unsigned char* out;
  long long rows;        // layers * lanes * slots
  long long chunk0;      // the entry's first chunk (bulk entries) or vector chunk (the others)
  long long row_bytes;
  long long n_pages;
  int unit;              // 16: bulk copies; 8, 4, 2 or 1: the vector path's unit in bytes
  int per_chunk;         // bulk entries: rows per chunk, or 0 where a row is cut in pieces
};

struct Head {
  const int* bt;
  long long ls;          // lanes * slots
  long long chunks;      // chunks of the bulk entries
  long long per_block;   // of them per bulk block
  int n_bulk;            // entries [0, n_bulk) take bulk copies, [n_bulk, count) the vector path
  int count;
  int bulk_blocks;       // blocks [0, bulk_blocks) copy in bulk, the rest one vector chunk each
  int cached;            // 1: the bulk blocks copy the table into shared memory
};

struct Table {
  Head h;
  Entry e[kCap];
};

static_assert(sizeof(Table) <= 4096, "the pool table must fit the kernel parameters");

// The last entry in [lo, hi] whose first chunk is <= c.
__device__ __forceinline__ int find_entry(const Table& t, int lo, int hi, long long c) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.e[mid].chunk0 <= c)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// This lane's row of chunk c (local to entry E), or -1 when it has none;
// sets the byte offset into the row and the bytes to move.
__device__ __forceinline__ long long chunk_row(const Entry& E, long long c, int lane,
                                               long long& off, unsigned& bytes) {
  if (E.per_chunk > 0) {
    const long long row = c * E.per_chunk + lane;
    if (lane >= E.per_chunk || row >= E.rows) return -1;
    off = 0;
    bytes = static_cast<unsigned>(E.row_bytes);
    return row;
  }
  if (lane != 0) return -1;
  const long long pieces = (E.row_bytes + kStage - 1) / kStage;
  const long long row = c / pieces;
  off = (c - row * pieces) * kStage;
  const long long rest = E.row_bytes - off;
  bytes = static_cast<unsigned>(rest < kStage ? rest : kStage);
  return row;
}

// The copy warp issues chunk c's loads into `stage` (arming `bar` with their
// bytes) and notes this lane's store: to `dst`, `len` bytes from `src` (the
// lane's place in the stage, or the zero row for a -1 slot; len 0: none).
// `e` is the entry of the previous chunk issued (chunks only grow).
__device__ __forceinline__ void issue(const Table& t, const int* tab, int& e, long long c,
                                      uint32_t stage, uint32_t bar, uint32_t zero, int lane,
                                      unsigned char*& dst, uint32_t& src, unsigned& len) {
  while (e + 1 < t.h.n_bulk && t.e[e + 1].chunk0 <= c) ++e;
  const Entry& E = t.e[e];
  long long off = 0;
  unsigned bytes = 0, load = 0;
  const unsigned char* from = nullptr;
  const long long row = chunk_row(E, c - E.chunk0, lane, off, bytes);
  len = 0;
  if (row >= 0) {
    const long long layer = row / t.h.ls;
    const int page = tab[row - layer * t.h.ls];
    dst = E.out + row * E.row_bytes + off;
    len = bytes;
    src = zero;
    if (page >= 0) {
      from = E.pool + (layer * E.n_pages + page) * E.row_bytes + off;
      src = stage + static_cast<uint32_t>(E.per_chunk > 0 ? lane * E.row_bytes : 0);
      load = bytes;
    }
  }
  const unsigned total = __reduce_add_sync(0xffffffffu, load);
  if (lane == 0) hop::mbar_arrive_tx(bar, total);     // armed before any load can land
  __syncwarp();
  if (load) hop::bulk_load(src, from, load, bar);
}

__device__ __forceinline__ void bulk_block(const Table& t, unsigned char* smem) {
  unsigned char* zero = smem + kStages * kStage;
  uint64_t* bars = reinterpret_cast<uint64_t*>(zero + kStage);
  int* tab_s = reinterpret_cast<int*>(zero + kStage + kBarBytes);
  for (int i = threadIdx.x; i < kStage / 16; i += kBlock)
    reinterpret_cast<uint4*>(zero)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (t.h.cached) {
    const int n = static_cast<int>(t.h.ls);
    if (reinterpret_cast<uintptr_t>(t.h.bt) % 16 == 0 && n % 4 == 0) {
      const int4* from = reinterpret_cast<const int4*>(t.h.bt);
#pragma unroll 4
      for (int i = threadIdx.x; i < n / 4; i += kBlock) reinterpret_cast<int4*>(tab_s)[i] = from[i];
    } else {
#pragma unroll 4
      for (int i = threadIdx.x; i < n; i += kBlock) tab_s[i] = t.h.bt[i];
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) hop::mbar_init(hop::smem_u32(bars + s), 1);
    hop::mbar_init_fence();
  }
  hop::fence_proxy_async();            // the zero row, written here, is read by bulk stores
  __syncthreads();
  if (threadIdx.x >= kLanes) return;

  const int lane = threadIdx.x;
  const int* tab = t.h.cached ? tab_s : t.h.bt;
  const long long first = static_cast<long long>(blockIdx.x) * t.h.per_block;
  const long long left = t.h.chunks - first;
  const long long n = left < t.h.per_block ? left : t.h.per_block;   // this block's chunks
  int e = find_entry(t, 0, t.h.n_bulk - 1, first);
  const uint32_t stage0 = hop::smem_u32(smem), zero_u = hop::smem_u32(zero);
  const uint32_t bar0 = hop::smem_u32(bars);
  unsigned char* dst[kStages];
  uint32_t src[kStages];
  unsigned len[kStages];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < n)
      issue(t, tab, e, first + s, stage0 + s * kStage, bar0 + s * 8, zero_u, lane, dst[s], src[s],
            len[s]);
  for (long long base = 0; base < n; base += kStages) {
    const uint32_t parity = static_cast<uint32_t>(base / kStages) & 1u;
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const long long i = base + s;
      if (i < n) {
        hop::mbar_wait(bar0 + s * 8, parity);
        hop::fence_proxy_async();
        if (len[s]) hop::bulk_store(dst[s], src[s], len[s]);
        hop::bulk_commit();
        // chunk i + kStages - 1 takes the stage of chunk i - 1 once that one's
        // stores have read it
        const long long j = i + kStages - 1;
        if (j < n) {
          const int r = (s + kStages - 1) % kStages;
          hop::bulk_wait_read<1>();
          __syncwarp();
          issue(t, tab, e, first + j, stage0 + r * kStage, bar0 + r * 8, zero_u, lane, dst[r],
                src[r], len[r]);
        }
      }
    }
  }
  hop::bulk_wait_all();
}

template <typename U>
__device__ __forceinline__ void vec_chunk(const Entry& E, const int* bt, long long ls,
                                          long long c) {
  const long long upr = E.row_bytes / static_cast<long long>(sizeof(U));
  const long long total = E.rows * upr;
  const U* pool = reinterpret_cast<const U*>(E.pool);
  U* out = reinterpret_cast<U*>(E.out);
  const long long base = c * kVecChunk + threadIdx.x;
  U v[kVecUnits];
#pragma unroll
  for (int k = 0; k < kVecUnits; ++k) {
    const long long u = base + k * kBlock;
    v[k] = U{};
    if (u < total) {
      const long long row = u / upr;
      const long long layer = row / ls;
      const int page = bt[row - layer * ls];
      if (page >= 0) v[k] = pool[(layer * E.n_pages + page) * upr + (u - row * upr)];
    }
  }
#pragma unroll
  for (int k = 0; k < kVecUnits; ++k) {
    const long long u = base + k * kBlock;
    if (u < total) out[u] = v[k];
  }
}

__global__ void __launch_bounds__(kBlock) paged_gather_bulk(const __grid_constant__ Table t) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) < t.h.bulk_blocks) {
    bulk_block(t, smem);
    return;
  }
  long long c = static_cast<long long>(blockIdx.x) - t.h.bulk_blocks;
  const Entry& E = t.e[find_entry(t, t.h.n_bulk, t.h.count - 1, c)];
  c -= E.chunk0;
  switch (E.unit) {
    case 8:
      vec_chunk<uint2>(E, t.h.bt, t.h.ls, c);
      break;
    case 4:
      vec_chunk<uint32_t>(E, t.h.bt, t.h.ls, c);
      break;
    case 2:
      vec_chunk<uint16_t>(E, t.h.bt, t.h.ls, c);
      break;
    default:
      vec_chunk<uint8_t>(E, t.h.bt, t.h.ls, c);
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// the widest unit of 16, 8, 4, 2 or 1 bytes dividing the pool's and the
// output's base and the row
int unit_of(const long long* d) {
  const unsigned long long a = static_cast<unsigned long long>(d[0] | d[1] | d[4]);
  for (int u = 16; u > 1; u >>= 1)
    if (a % u == 0) return u;
  return 1;
}

// The kernel's dynamic shared-memory limit is raised once per device.
cudaError_t allow_once() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = rt::allow_smem(paged_gather_bulk, kSmemMax);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// One grid over n <= kCap pools (bulk entries first, in their order, then the
// vector ones).
cudaError_t launch(const long long* desc, int n, const int* bt, long long ls, int sms,
                   cudaStream_t stream) {
  Table t;
  t.h.bt = bt;
  t.h.ls = ls;
  t.h.count = 0;
  long long bulk = 0, vec = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < n; ++i) {
      const long long* d = desc + static_cast<size_t>(i) * kDesc;
      const int unit = unit_of(d);
      if ((unit == 16) != (pass == 0)) continue;
      Entry& E = t.e[t.h.count++];
      E.pool = reinterpret_cast<const unsigned char*>(d[0]);
      E.out = reinterpret_cast<unsigned char*>(d[1]);
      E.rows = d[2] * ls;
      E.n_pages = d[3];
      E.row_bytes = d[4];
      E.unit = unit;
      E.per_chunk = 0;
      if (unit == 16) {
        if (d[4] <= kStage) E.per_chunk = static_cast<int>(kStage / d[4] < kLanes ? kStage / d[4]
                                                                                    : kLanes);
        E.chunk0 = bulk;
        bulk += E.per_chunk ? ceil_div(E.rows, E.per_chunk) : E.rows * ceil_div(d[4], kStage);
      } else {
        E.chunk0 = vec;
        vec += ceil_div(E.rows * (d[4] / unit), kVecChunk);
      }
    }
    if (pass == 0) t.h.n_bulk = t.h.count;
  }
  const long long cap = static_cast<long long>(kBlocksPerSm) * sms;
  long long blocks = bulk < cap ? bulk : cap;
  t.h.chunks = bulk;
  t.h.per_block = blocks ? ceil_div(bulk, blocks) : 0;
  if (blocks) blocks = ceil_div(bulk, t.h.per_block);
  if (blocks + vec > INT_MAX) return cudaErrorInvalidValue;
  t.h.bulk_blocks = static_cast<int>(blocks);
  t.h.cached = ls <= kTableCache;
  const size_t smem = blocks ? kSmemBase + (t.h.cached ? ls * 4 : 0) : 0;
  cudaError_t err = allow_once();
  if (err != cudaSuccess) return err;
  paged_gather_bulk<<<static_cast<unsigned>(blocks + vec), kBlock, smem, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace

// Pools per launch: a longer list goes out in several.
extern "C" int paged_gather_capacity() { return kCap; }

// Dynamic shared memory of a bulk block for a table of `entries` entries.
extern "C" long long paged_gather_smem(long long entries) {
  return kSmemBase + (entries <= kTableCache ? entries * 4 : 0);
}

// n pools gathered through one (lanes, slots) int32 table whose entries are
// -1 or name a page of every pool (not checked on the card).  args: the
// table's address, lanes, slots, the card's SM count (sizes the grid), the
// stream, a slot that receives the number of grids launched, then per pool
// its contiguous (layers, n_pages, row_bytes) pool's address, its contiguous
// (layers, lanes, slots, row_bytes) output's address, layers, n_pages and
// row_bytes.  One array, so that a call converts two arguments.  Launches on
// the stream one grid per table of paged_gather_capacity() pools; allocates
// nothing and does not synchronise.  Returns cudaGetLastError() after the
// last launch (0 = launched).
extern "C" int paged_gather_launch(int n, long long* args) {
  if (args == nullptr) return cudaErrorInvalidValue;
  args[5] = 0;
  const int* bt = reinterpret_cast<const int*>(args[0]);
  const long long lanes = args[1], slots = args[2];
  const int sms = static_cast<int>(args[3]);
  const long long* desc = args + 6;
  if (n < 0 || bt == nullptr || lanes <= 0 || slots <= 0 || lanes > INT_MAX ||
      slots > INT_MAX || sms <= 0)
    return cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + static_cast<size_t>(i) * kDesc;
    if (d[0] == 0 || d[1] == 0 || d[2] <= 0 || d[3] <= 0 || d[3] > INT_MAX || d[4] <= 0)
      return cudaErrorInvalidValue;
  }
  const long long ls = lanes * slots;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(args[4]);
  for (int i = 0; i < n; i += kCap) {
    const int m = n - i < kCap ? n - i : kCap;
    const long long* d = desc + static_cast<size_t>(i) * kDesc;
    const cudaError_t err = launch(d, m, bt, ls, sms, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++args[5];
  }
  return cudaSuccess;
}
