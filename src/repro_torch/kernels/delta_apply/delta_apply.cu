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
// What bounds it on the H100.  Bytes: the N² bool anchor is read once
// (once per query where each query has its own) and Q N² bool outputs
// are written; the window entries are a few percent of that.  At
// N = 8192 and Q = 3 that is 270 MB, 81 µs at 3.35 TB/s.  The entries
// are sparse: 5.9 a 64×64 tile on average in the dense session, and a
// third of the (tile, query) pairs have none in their window.
//
// Design.  The plain-PyTorch glue (ops.py::bucket_ops) sorts the
// window's entries by destination tile with no cap; each entry is
// {cell, t, key} with key = 2·rank + (op == addEdge), rank being the
// op's position in the delta (= time order), and both mirrors (u,v) and
// (v,u) are entries.  One block of 256 threads per 64×64 tile serves
// EVERY query of the launch:
//   * each thread owns 16 consecutive cells of one row of the tile and
//     moves them as one 16-byte word (uint4); a shared anchor's word is
//     read once, before the loop over queries, and kept in registers;
//   * each warp owns 8 rows of the tile and, for each query, walks the
//     tile's entries 32 at a time, keeping those in the window that land
//     in its rows (__ballot_sync).  A warp that finds none writes its
//     anchor words straight out: no shared memory, no barrier;
//   * a warp that finds some resolves them in its own 512 cells of a
//     64×64 int32 key array in shared memory: each lane fills its 16
//     cells (four int4 stores), __syncwarp, every such entry does an
//     atomicMax (forward) or atomicMin (backward) of its key — the
//     max/min key carries the deciding op's rank AND its add bit, so
//     arrival order does not matter — __syncwarp, and each lane reads
//     its 16 keys back as four int4 and merges the decided cells into
//     its word.  A lane only reads its own cells, so the next query
//     needs no third sync.  No block-wide barrier at all: the warps of a
//     block never wait for each other.
// Where N is not a multiple of 16 (rows are then not 16-byte aligned)
// the same kernel moves the 16 cells byte by byte; the ragged right and
// bottom edges of the last tiles are masked either way.
// Row blocks.  The adjacency may be a block of R = ``n_rows`` rows of
// an N-column matrix (a row-sharded group: rows [row0, row0 + R) of the
// global graph, their entries made local by the glue, which drops every
// entry of another block's rows).  The grid is then tiles_r × tiles_c
// with tiles_r = ceil(R / 64), and rows at or past R, the pad band of a
// block that is not a multiple of 64 rows, are neither read nor written.
// A ``row_mask`` indexes rows and columns alike, so it needs the square
// N × N case (row sharding excludes partial reconstruction).
// Launch: one block per tile (16,384 at N = 8192; not persistent), 256
// threads, 16 KiB of static shared memory, 40 registers a thread on the
// 16-byte path (31 on the byte path), so six blocks an SM (ptxas's
// report: ``chip_smoke.py --first-call``).  Holding the kernel to 32
// registers (eight blocks an SM) spilled and ran slower.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int TN = 64;          // tile edge (== TILE in ops.py)
constexpr int CELLS = 16;       // cells a thread: one 16-byte word
constexpr int THREADS = TN * TN / CELLS;
constexpr int WARP_CELLS = 32 * CELLS;   // a warp's 8 rows of the tile
constexpr unsigned FULL = 0xffffffffu;

// The 16 bytes at (gr, gc .. gc + 15) of an n_rows×n byte matrix;
// cells outside the matrix read 0.
template <bool VEC>
__device__ __forceinline__ uint4 load_cells(const uint8_t* p, int gr,
                                            int gc, int n_rows, int n) {
  uint4 w = make_uint4(0, 0, 0, 0);
  if (gr >= n_rows || gc >= n) return w;
  const uint8_t* row = p + (long long)gr * n + gc;
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(row));
  uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < CELLS; ++i)
    if (gc + i < n) b[i >> 2] |= (uint32_t)__ldg(row + i) << (8 * (i & 3));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

template <bool VEC>
__device__ __forceinline__ void store_cells(uint8_t* p, int gr, int gc,
                                            int n_rows, int n, uint4 w) {
  if (gr >= n_rows || gc >= n) return;
  uint8_t* row = p + (long long)gr * n + gc;
  if (VEC) {
    __stcs(reinterpret_cast<uint4*>(row), w);   // written once, not reread
    return;
  }
  const uint32_t b[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < CELLS; ++i)
    if (gc + i < n) row[i] = (uint8_t)(b[i >> 2] >> (8 * (i & 3)));
}

// Four cells' bytes with the decided ones (key != init) replaced:
// forward the deciding op's add bit, backward its complement.
__device__ __forceinline__ uint32_t merge4(uint32_t bytes, int4 k, int init,
                                           uint32_t flip) {
  const int ks[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (ks[i] != init)
      bytes = (bytes & ~(0xffu << (8 * i)))
              | ((((uint32_t)ks[i] & 1u) ^ flip) << (8 * i));
  return bytes;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
delta_apply_kernel(const int4* __restrict__ entries,
                   const int* __restrict__ tile_start,
                   const uint8_t* __restrict__ anchor,
                   long long anchor_stride, uint8_t* __restrict__ out,
                   const int* __restrict__ t_anchor,
                   const int* __restrict__ t_query,
                   const uint8_t* __restrict__ row_mask, int n_rows, int n,
                   int tiles_c, int n_queries) {
  __shared__ __align__(16) int dec[TN * TN];
  const int tile = blockIdx.x;
  const int tr = tile / tiles_c;
  const int tc = tile - tr * tiles_c;
  // thread i owns cells i*16 .. i*16 + 15 of the tile: row i / 4,
  // columns (i % 4) * 16 ..; the same cells in ``dec``.  So warp w owns
  // rows 8w .. 8w + 7, the cells [512w, 512w + 512).
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = threadIdx.x / (TN / CELLS);
  const int col = (threadIdx.x % (TN / CELLS)) * CELLS;
  const int gr = tr * TN + row;
  const int gc = tc * TN + col;
  int4* mine = reinterpret_cast<int4*>(dec + threadIdx.x * CELLS);
  const int s = tile_start[tile];
  const int e = tile_start[tile + 1];

  uint4 a = load_cells<VEC>(anchor, gr, gc, n_rows, n);
  for (int q = 0; q < n_queries; ++q) {
    if (anchor_stride && q)
      a = load_cells<VEC>(anchor + q * anchor_stride, gr, gc, n_rows, n);
    const int ta = t_anchor[q];
    const int tq = t_query[q];
    const bool fwd = tq >= ta;
    const int lo = min(ta, tq);
    const int hi = max(ta, tq);
    const int init = fwd ? -1 : INT_MAX;
    const uint8_t* rm = row_mask ? row_mask + (long long)q * n : nullptr;
    // the warp walks the tile's entries 32 at a time and resolves those
    // in the window that land in its own rows; its key cells are filled
    // only once one does
    bool dirty = false;
    for (int base = s; base < e; base += 32) {
      int4 en = make_int4(0, lo, 0, 0);         // t = lo: outside
      if (base + lane < e) en = __ldg(&entries[base + lane]);
      bool hit = en.y > lo && en.y <= hi && en.x / WARP_CELLS == warp;
      if (hit && rm)
        hit = rm[tr * TN + en.x / TN] | rm[tc * TN + en.x % TN];
      if (!__ballot_sync(FULL, hit)) continue;
      if (!dirty) {
        const int4 init4 = make_int4(init, init, init, init);
#pragma unroll
        for (int k = 0; k < CELLS / 4; ++k) mine[k] = init4;
        __syncwarp();
        dirty = true;
      }
      if (hit) {
        if (fwd) atomicMax(&dec[en.x], en.z);
        else atomicMin(&dec[en.x], en.z);
      }
    }
    uint4 w = a;
    if (dirty) {
      __syncwarp();
      const uint32_t flip = fwd ? 0u : 1u;
      w.x = merge4(w.x, mine[0], init, flip);
      w.y = merge4(w.y, mine[1], init, flip);
      w.z = merge4(w.z, mine[2], init, flip);
      w.w = merge4(w.w, mine[3], init, flip);
    }
    store_cells<VEC>(out + (long long)q * n_rows * n, gr, gc, n_rows, n,
                     w);
  }
}

}  // namespace

// Plain C++ entry point (the binding in ../binding.cpp passes raw
// pointers).  Returns cudaGetLastError() right after the launch.
int delta_apply_launch(const void* entries, const void* tile_start,
                       const void* anchor, long long anchor_stride,
                       void* out, const void* t_anchor, const void* t_query,
                       const void* row_mask, int n_rows, int n,
                       int n_queries, long long stream) {
  const int tiles_r = (n_rows + TN - 1) / TN;
  const int tiles_c = (n + TN - 1) / TN;
  const int tiles = tiles_r * tiles_c;
  if (n_queries <= 0 || tiles <= 0) return (int)cudaSuccess;
  // 16-byte words need 16-byte aligned rows: n % 16 == 0 and aligned
  // bases (then every query's matrix, n_rows·n bytes on, is aligned too)
  const bool vec = n % CELLS == 0 && (uintptr_t)anchor % 16 == 0
                   && (uintptr_t)out % 16 == 0;
  auto kernel = vec ? delta_apply_kernel<true> : delta_apply_kernel<false>;
  kernel<<<tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const int4*)entries, (const int*)tile_start, (const uint8_t*)anchor,
      anchor_stride, (uint8_t*)out, (const int*)t_anchor,
      (const int*)t_query, (const uint8_t*)row_mask, n_rows, n, tiles_c,
      n_queries);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
