// Block-table gather of page pools for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_gather` in
// src/repro/kernels/paged_attn.py (body `_gather_kernel`, wrapper
// `ops.paged_gather` in src/repro/kernels/ops.py).  In the port it is the
// card path of `serve/paged_cache.py:gather_views`, which the engine's
// `decode_path="gather"` runs once per seq leaf per decode step.
//
// What it computes: out[l, b, p, :] = pool[l, bt[b, p], :], and zeros where
// bt[b, p] is -1, for every leading index l (the layers).  A row is one
// page (page_size x heads x head_dim elements of any type) and is copied as
// bytes, so the result is bit-equal to the plain version's.
//
// What bounds it on the H100: bytes.  At full-width qwen2.5-3b (36 layers,
// 16-token pages of 2 x 128 bf16, 8 lanes x 64 slots) one leaf writes
// 151 MB and reads as much of the pool as the table names.
//
// What the design does about that: a block copies one page row at a time
// (its table entry read once), one thread per 16 bytes, neighbouring
// threads on neighbouring bytes, so loads and stores are 16-byte accesses
// and a warp moves 512 contiguous bytes.  A -1 slot writes
// zeros without reading the pool.  The pool is read in the port's own
// (layers, n_pages, row) layout and the output written as (layers, lanes,
// slots, row): one launch covers every layer, and the TPU wrapper's
// moveaxis and 128-lane padding copies are gone.  Rows whose size or base
// is not a multiple of 16 bytes take the same kernel with a narrower unit.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBlock = 256;

template <typename U>
__global__ void __launch_bounds__(kBlock)
    gather_rows(const U* __restrict__ pool, const int* __restrict__ bt, U* __restrict__ out,
                int n_pages, int lanes, int slots, long long row_units, long long rows) {
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {   // (layer, lane, slot)
    const int slot = static_cast<int>(row % slots);
    const long long ls = row / slots;
    const int lane = static_cast<int>(ls % lanes);
    const long long layer = ls / lanes;
    const int page = bt[lane * slots + slot];
    U* dst = out + row * row_units;
    if (page >= 0) {
      const U* src = pool + (layer * n_pages + page) * row_units;
      for (long long u = threadIdx.x; u < row_units; u += kBlock) dst[u] = src[u];
    } else {
      for (long long u = threadIdx.x; u < row_units; u += kBlock) dst[u] = U{};
    }
  }
}

template <typename U>
cudaError_t launch(const void* pool, const int* bt, void* out, long long layers, int n_pages,
                   int lanes, int slots, long long row_bytes, int sms, cudaStream_t stream) {
  const long long row_units = row_bytes / static_cast<long long>(sizeof(U));
  const long long rows = layers * lanes * slots;
  const long long cap = static_cast<long long>(sms) * 16;      // blocks loop beyond that
  const long long blocks = rows < cap ? rows : cap;
  gather_rows<U><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      static_cast<const U*>(pool), bt, static_cast<U*>(out), n_pages, lanes, slots, row_units,
      rows);
  return cudaGetLastError();
}

}  // namespace

// pool is contiguous (layers, n_pages, row_bytes) of any type, bt a
// contiguous (lanes, slots) int32 table whose entries are -1 or name a page
// (not checked on the card), out contiguous (layers, lanes, slots,
// row_bytes).  sms: the card's SM count (sizes the grid).  Returns
// cudaGetLastError() after the launch (0 = launched); launches on
// `stream`, allocates nothing, does not synchronise.
extern "C" int paged_gather_launch(const void* pool, const int* bt, void* out, long long layers,
                                   int n_pages, int lanes, int slots, long long row_bytes,
                                   int sms, void* stream) {
  if (layers <= 0 || n_pages <= 0 || lanes <= 0 || slots <= 0 || row_bytes <= 0 || sms <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(pool) | reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  cudaError_t err;
  if (align % 16 == 0)
    err = launch<uint4>(pool, bt, out, layers, n_pages, lanes, slots, row_bytes, sms, s);
  else if (align % 8 == 0)
    err = launch<uint2>(pool, bt, out, layers, n_pages, lanes, slots, row_bytes, sms, s);
  else if (align % 4 == 0)
    err = launch<uint32_t>(pool, bt, out, layers, n_pages, lanes, slots, row_bytes, sms, s);
  else if (align % 2 == 0)
    err = launch<uint16_t>(pool, bt, out, layers, n_pages, lanes, slots, row_bytes, sms, s);
  else
    err = launch<uint8_t>(pool, bt, out, layers, n_pages, lanes, slots, row_bytes, sms, s);
  return static_cast<int>(err);
}
