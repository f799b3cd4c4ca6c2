// Drop-mode scatter of one decode step's new cache rows into page pools, for
// Hopper (sm_90a): one launch for every pool a step writes.
//
// Replaces no TPU kernel: the JAX package leaves this scatter to XLA, as
// `pool.at[page, off].set(rows, mode="drop")` with idle lanes and unallocated
// pages sent to an above-pool sentinel (src/repro/models/transformer.py:
// attn_decode_paged, src/repro/models/mla.py: mla_decode_paged,
// src/repro/serve/paged_cache.py: absorb_decode).  PyTorch has no drop mode
// for a scatter, and any real row that took the dropped writes could collide
// with a lane's genuine write; picking the writing lanes with `nonzero` reads
// the card back once per step, which a CUDA graph cannot hold.  This kernel
// decides on the card which lanes write, so the decode step has a fixed
// shape, no host read and every pool keeps its shape.  In the port it writes
// a dense or windowed layer's k and v (`models/transformer.py:
// decode_step_paged`), an MLA layer's latent and k_rope (`models/mla.py:
// mla_decode_paged`), each one launch per layer and step, and every seq leaf
// of the cache tree on the gather decode path (`serve/paged_cache.py:
// absorb_decode`), one launch per step.
//
// What it computes, for each pool i of a list, with page size PS: for every
// lane b with active[b], 0 <= pos[b] < slots * PS and page = bt[b, pos[b] /
// PS] in [0, n_pages), and every leading index l (the layers):
//   pool_i[l, page, pos[b] % PS, :] = rows_i[l, b, :]
// Nothing else is written.  A row (heads x head_dim or a latent of any type)
// is copied as bytes, so the result is bit-equal to the plain version's.
//
// What bounds it on the H100: neither bytes nor operations but the launch.
// A full-width qwen2.5-3b layer writes 8 lanes x 2 rows of 512 bytes; the
// gather path's one launch per step writes 36 layers of them, 295 KB.  The
// design is the simplest that keeps every row's copy coalesced: one block of
// 128 threads per (lane, pool layer), each thread moving the widest unit (16,
// 8, 4, 2 or 1 bytes) that divides the row and both bases; a lane that
// writes nothing returns after reading its position, flag and table entry.
// The pool table is a kernel parameter passed by value, so a launch copies
// nothing to the card and a captured launch keeps its arguments.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kCap = 8;                // pools per launch: a longer list is refused
constexpr int kDesc = 5;               // per pool: pool, rows, layers, n_pages, row bytes

struct Entry {
  unsigned char* pool;
  const unsigned char* rows;
  long long n_pages;
  long long row_bytes;
  int layer0;            // the entry's first blockIdx.y
  int unit;              // bytes a thread moves at a time: 16, 8, 4, 2 or 1
};

struct Table {
  const int* bt;
  const long long* pos;
  const unsigned char* active;
  int lanes;
  int slots;
  int page_size;
  int count;
  Entry e[kCap];
};

static_assert(sizeof(Table) <= 4096, "the pool table must fit the kernel parameters");

template <typename U>
__device__ __forceinline__ void copy_row(unsigned char* dst, const unsigned char* src,
                                         long long bytes) {
  const long long n = bytes / static_cast<long long>(sizeof(U));
  U* d = reinterpret_cast<U*>(dst);
  const U* s = reinterpret_cast<const U*>(src);
  for (long long i = threadIdx.x; i < n; i += kBlock) d[i] = s[i];
}

// blockIdx.x: the lane; blockIdx.y: one layer of one pool.
__global__ void __launch_bounds__(kBlock) paged_write_rows(const __grid_constant__ Table t) {
  const int b = blockIdx.x;
  const long long pos = t.pos[b];
  if (!t.active[b] || pos < 0) return;
  const long long slot = pos / t.page_size;
  if (slot >= t.slots) return;
  const int page = t.bt[static_cast<long long>(b) * t.slots + slot];
  if (page < 0) return;
  const int y = blockIdx.y;
  int i = 0;
  while (i + 1 < t.count && t.e[i + 1].layer0 <= y) ++i;
  const Entry& E = t.e[i];
  if (page >= E.n_pages) return;
  const long long l = y - E.layer0;
  const long long off = pos - slot * t.page_size;
  unsigned char* dst = E.pool + ((l * E.n_pages + page) * t.page_size + off) * E.row_bytes;
  const unsigned char* src = E.rows + (l * t.lanes + b) * E.row_bytes;
  switch (E.unit) {
    case 16:
      copy_row<uint4>(dst, src, E.row_bytes);
      break;
    case 8:
      copy_row<uint2>(dst, src, E.row_bytes);
      break;
    case 4:
      copy_row<uint32_t>(dst, src, E.row_bytes);
      break;
    case 2:
      copy_row<uint16_t>(dst, src, E.row_bytes);
      break;
    default:
      copy_row<uint8_t>(dst, src, E.row_bytes);
  }
}

// the widest unit of 16, 8, 4, 2 or 1 bytes dividing the pool's and the
// rows' base and the row
int unit_of(const long long* d) {
  const unsigned long long a = static_cast<unsigned long long>(d[0] | d[1] | d[4]);
  for (int u = 16; u > 1; u >>= 1)
    if (a % u == 0) return u;
  return 1;
}

}  // namespace

// n pools (at most kCap = 8) written through one (lanes, slots) int32 table.
// args: the table's address, the positions' ((lanes,) int64) address, the
// active flags' ((lanes,) bool) address, lanes, slots, the page size, the
// stream, then per pool its contiguous (layers, n_pages, page_size,
// row_bytes) pool's address, its contiguous (layers, lanes, row_bytes) rows'
// address, layers, n_pages and row_bytes.  Launches one grid on the stream;
// allocates nothing and does not synchronise.  Returns cudaGetLastError()
// after the launch (0 = launched); a longer list is refused.
extern "C" int paged_write_launch(int n, const long long* args) {
  if (args == nullptr) return cudaErrorInvalidValue;
  const long long lanes = args[3], slots = args[4], ps = args[5];
  if (n < 0 || n > kCap || args[0] == 0 || args[1] == 0 || args[2] == 0 || lanes <= 0 ||
      lanes > INT_MAX || slots <= 0 || slots > INT_MAX || ps <= 0 || ps > INT_MAX)
    return cudaErrorInvalidValue;
  Table t;
  t.bt = reinterpret_cast<const int*>(args[0]);
  t.pos = reinterpret_cast<const long long*>(args[1]);
  t.active = reinterpret_cast<const unsigned char*>(args[2]);
  t.lanes = static_cast<int>(lanes);
  t.slots = static_cast<int>(slots);
  t.page_size = static_cast<int>(ps);
  t.count = n;
  long long layers = 0;
  for (int i = 0; i < n; ++i) {
    const long long* d = args + 7 + static_cast<size_t>(i) * kDesc;
    if (d[0] == 0 || d[1] == 0 || d[2] <= 0 || d[3] <= 0 || d[3] > INT_MAX || d[4] <= 0)
      return cudaErrorInvalidValue;
    Entry& E = t.e[i];
    E.pool = reinterpret_cast<unsigned char*>(d[0]);
    E.rows = reinterpret_cast<const unsigned char*>(d[1]);
    E.n_pages = d[3];
    E.row_bytes = d[4];
    E.layer0 = static_cast<int>(layers);
    E.unit = unit_of(d);
    layers += d[2];
  }
  if (n == 0) return cudaSuccess;
  if (layers > 65535) return cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(args[6]);
  paged_write_rows<<<dim3(static_cast<unsigned>(lanes), static_cast<unsigned>(layers)), kBlock,
                     0, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}
