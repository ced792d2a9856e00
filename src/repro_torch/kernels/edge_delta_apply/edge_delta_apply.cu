// Last-writer-wins reconstruction of the 1-D edge-slot mask for a batch
// of time windows — the O(E) layout, no N² state anywhere.
//
// Replaces: repro/kernels/edge_delta_apply/edge_delta_apply.py::
// edge_delta_apply_tiles (Pallas body ``_kernel``; glue
// ``ops.py::bucket_slot_ops``).
//
// What it computes.  For query q, slot s is decided by the edge ops on
// that slot with t in (min(ta, tq), max(ta, tq)]: forward the LAST one
// (value = addEdge), backward the FIRST one (value = remEdge); other
// slots keep the anchor's bit.  One entry per op (no mirror).
//
// Design.  Same rule as delta_apply.cu on a 1-D tile of TS slots: the
// glue buckets the window's edge ops by slot tile without a cap; one
// block per (slot tile, query) resolves each slot's deciding op with a
// shared-memory atomicMax / atomicMin over key = 2·rank + (op ==
// addEdge), then writes decided values or the anchor's.
//
// What bounds it on the H100.  Bytes: E bool read and E bool written per
// query (2·E), plus 16 bytes per window entry re-read per query.  At
// E = 2^21 that is 4 MiB per query — about 1.3 µs at 3.35 TB/s, so at
// this size launch latency and the entry reads dominate.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int TS = 4096;        // slots per tile: 16 KiB of int32 smem
constexpr int THREADS = 256;

__global__ void edge_delta_apply_kernel(const int4* __restrict__ entries,
                                        const int* __restrict__ tile_start,
                                        const uint8_t* __restrict__ anchor,
                                        long long anchor_stride,
                                        uint8_t* __restrict__ out,
                                        const int* __restrict__ t_anchor,
                                        const int* __restrict__ t_query,
                                        int e_cap) {
  __shared__ int dec[TS];
  const int tile = blockIdx.x;
  const int q = blockIdx.y;
  const int ta = t_anchor[q];
  const int tq = t_query[q];
  const bool fwd = tq >= ta;
  const int lo = min(ta, tq);
  const int hi = max(ta, tq);
  const int init = fwd ? -1 : INT_MAX;

  for (int c = threadIdx.x; c < TS; c += blockDim.x) dec[c] = init;
  __syncthreads();

  const int s = tile_start[tile];
  const int e = tile_start[tile + 1];
  for (int j = s + threadIdx.x; j < e; j += blockDim.x) {
    const int4 en = entries[j];
    if (en.y <= lo || en.y > hi) continue;
    if (fwd) atomicMax(&dec[en.x], en.z);
    else atomicMin(&dec[en.x], en.z);
  }
  __syncthreads();

  const uint8_t* a = anchor + (long long)q * anchor_stride;
  uint8_t* o = out + (long long)q * e_cap;
  for (int c = threadIdx.x; c < TS; c += blockDim.x) {
    const int slot = tile * TS + c;
    if (slot >= e_cap) continue;
    const int k = dec[c];
    uint8_t val;
    if (k == init) val = a[slot];
    else val = fwd ? (uint8_t)(k & 1) : (uint8_t)((k & 1) ^ 1);
    o[slot] = val;
  }
}

}  // namespace

int edge_delta_apply_launch(const void* entries, const void* tile_start,
                            const void* anchor, long long anchor_stride,
                            void* out, const void* t_anchor,
                            const void* t_query, int e_cap, int n_queries,
                            long long stream) {
  const int tiles = (e_cap + TS - 1) / TS;
  if (n_queries <= 0 || tiles <= 0) return (int)cudaSuccess;
  dim3 grid(tiles, n_queries);
  edge_delta_apply_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int4*)entries, (const int*)tile_start, (const uint8_t*)anchor,
      anchor_stride, (uint8_t*)out, (const int*)t_anchor,
      (const int*)t_query, e_cap);
  return (int)cudaGetLastError();
}
