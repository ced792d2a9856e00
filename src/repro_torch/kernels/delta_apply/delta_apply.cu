// Dense last-writer-wins reconstruction of the adjacency for a batch of
// time windows (paper Algorithms 1 & 2, vectorized; Definition 5 for the
// backward direction).
//
// Replaces: repro/kernels/delta_apply/delta_apply.py::delta_apply_tiles
// (Pallas body ``_kernel``; glue ``ops.py::bucket_ops`` and
// ``_node_mask_lww``).
//
// What it computes.  For query q with anchor time ta[q] and query time
// tq[q], every adjacency cell (r, c) is decided by the edge ops on that
// cell with t in (min(ta, tq), max(ta, tq)]: going forward the LAST such
// op decides (value = op is addEdge), going backward the FIRST decides
// (value = op is remEdge).  Undecided cells keep the anchor's bit.
//
// Design.  The TPU kernel replays a per-tile op list in order, capped at
// ``cap`` entries so the list fits VMEM.  Here the plain-PyTorch glue
// (ops.py::bucket_ops) sorts the window's entries by destination tile
// with no cap — a block loops over however many its tile has.  Each
// entry is {cell, t, key} with key = 2·rank + (op == addEdge), rank
// being the op's position in the delta (= time order), and both mirrors
// (u,v) and (v,u) are entries.  One block per (tile, query):
//   1. the block's TN×TN int32 decision tile lives in shared memory;
//   2. every in-window entry does an atomicMax (forward) or atomicMin
//      (backward) of its key — the max/min key carries the deciding op's
//      rank AND its add bit, so the order in which threads arrive does
//      not matter and no per-tile sequential replay is needed;
//   3. each thread writes its cells: decided value or the anchor's.
// Entries carry their time, so one bucketing serves a whole batch of
// queries with different windows (gridDim.y = queries).
//
// What bounds it on the H100.  Bytes: each query reads the N² bool
// anchor and writes the N² bool output (2·N² bytes), plus 16 bytes per
// window entry per query that reads the tile (entries are re-read by
// every query of the batch).  At N = 8192 that is 128 MiB per query,
// about 40 µs at 3.35 TB/s.  This first version moves bytes one at a
// time per thread (coalesced across the warp); wide vector stores and a
// persistent grid are later work.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int TN = 64;          // tile edge: TN*TN int32 = 16 KiB smem
constexpr int THREADS = 256;

__global__ void delta_apply_kernel(const int4* __restrict__ entries,
                                   const int* __restrict__ tile_start,
                                   const uint8_t* __restrict__ anchor,
                                   long long anchor_stride,
                                   uint8_t* __restrict__ out,
                                   const int* __restrict__ t_anchor,
                                   const int* __restrict__ t_query,
                                   const uint8_t* __restrict__ row_mask,
                                   int n, int tiles_c) {
  __shared__ int dec[TN * TN];
  const int tile = blockIdx.x;
  const int q = blockIdx.y;
  const int tr = tile / tiles_c;
  const int tc = tile - tr * tiles_c;
  const int ta = t_anchor[q];
  const int tq = t_query[q];
  const bool fwd = tq >= ta;
  const int lo = min(ta, tq);
  const int hi = max(ta, tq);
  const int init = fwd ? -1 : INT_MAX;

  for (int c = threadIdx.x; c < TN * TN; c += blockDim.x) dec[c] = init;
  __syncthreads();

  const uint8_t* rm = row_mask ? row_mask + (long long)q * n : nullptr;
  const int s = tile_start[tile];
  const int e = tile_start[tile + 1];
  for (int j = s + threadIdx.x; j < e; j += blockDim.x) {
    const int4 en = entries[j];
    if (en.y <= lo || en.y > hi) continue;
    if (rm) {
      const int gr = tr * TN + en.x / TN;
      const int gc = tc * TN + en.x % TN;
      if (!(rm[gr] | rm[gc])) continue;
    }
    if (fwd) atomicMax(&dec[en.x], en.z);
    else atomicMin(&dec[en.x], en.z);
  }
  __syncthreads();

  const uint8_t* a = anchor + (long long)q * anchor_stride;
  uint8_t* o = out + (long long)q * n * n;
  for (int c = threadIdx.x; c < TN * TN; c += blockDim.x) {
    const int gr = tr * TN + c / TN;
    const int gc = tc * TN + c % TN;
    if (gr >= n || gc >= n) continue;
    const long long off = (long long)gr * n + gc;
    const int k = dec[c];
    uint8_t val;
    if (k == init) val = a[off];
    else val = fwd ? (uint8_t)(k & 1) : (uint8_t)((k & 1) ^ 1);
    o[off] = val;
  }
}

}  // namespace

// Plain C++ entry point (the binding in ../binding.cpp passes raw
// pointers).  Returns cudaGetLastError() right after the launch.
int delta_apply_launch(const void* entries, const void* tile_start,
                       const void* anchor, long long anchor_stride,
                       void* out, const void* t_anchor, const void* t_query,
                       const void* row_mask, int n, int n_queries,
                       long long stream) {
  const int tiles_r = (n + TN - 1) / TN;
  const int tiles = tiles_r * tiles_r;
  if (n_queries <= 0 || tiles <= 0) return (int)cudaSuccess;
  dim3 grid(tiles, n_queries);
  delta_apply_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int4*)entries, (const int*)tile_start, (const uint8_t*)anchor,
      anchor_stride, (uint8_t*)out, (const int*)t_anchor,
      (const int*)t_query, (const uint8_t*)row_mask, n, tiles_r);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
