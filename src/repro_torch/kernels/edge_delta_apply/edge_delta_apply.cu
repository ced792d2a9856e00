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
// What bounds it on the H100.  Bytes: the E-byte anchor read once (once
// per query where each query has its own), Q·E bytes of output, and 8
// bytes per entry, each read once.  At E = 2^21, Q = 6 and 1.24 M
// entries that is 24.6 MB, 7.3 µs at 3.35 TB/s.  Only 3.9 M of the
// 7.4 M (entry, query) pairs are in a window, and half the slot space
// holds no registered slot.
//
// Design.  The glue (ops.py::bucket_slot_ops) buckets the window's edge
// ops by tile of WS = 512 slots with no cap, as 8-byte entries {t,
// local slot·2 + is_add}, ordered by tile and within a tile by time,
// then rank — for the store's time-ordered log, rank order.  So an
// entry's position j in the array orders the ops of one slot as their
// ranks do, and the key 2·j + is_add decides LWW as 2·rank + is_add
// would: forward the maximum, backward the minimum, and the key carries
// the add bit.  And a query's window (lo, hi] holds one contiguous run
// of each tile's entries.
// A warp owns one tile (its 512 slots, 16 a lane, moved as one 16-byte
// word), and up to four warps share a tile, each taking every fourth
// (or second) query of the launch, so that every query of the launch
// is served from the one tile bucket while the per-query chains of
// dependent loads run side by side:
//   * a shared anchor's word is read before the loop over queries and
//     kept in registers;
//   * before the loop each lane also reads one coarse sample, the t of
//     entry s + lane·step of its tile (32 samples spanning it); for
//     each query the warp finds its run [a, b) of in-window entries
//     from the samples (a ballot each end) and 32 probes of each gap
//     they leave, both ends' probes in flight at once (more steps for
//     tiles of over 1,024 entries).  A warp whose run is empty writes
//     its anchor words straight out: no shared memory, no barrier (the
//     tiles without a registered slot, and most tiles of a short
//     window);
//   * otherwise it resolves the run in its own 512 int32 keys in shared
//     memory: each lane fills its 16 keys (four int4 stores),
//     __syncwarp, the run's entries (four a lane in flight) do an
//     atomicMax (forward) or atomicMin (backward) of their key,
//     __syncwarp, and each lane reads its 16 keys back and merges the
//     decided slots into its word.  A lane reads only its own keys, so
//     the next query needs no third sync, and no block-wide barrier
//     exists: warps never wait on each other.  An entry outside every
//     window is read by the searches at most, and one inside once per
//     query whose window holds it.
// Where E is not a multiple of 16 the same kernel moves the 16 slots
// byte by byte; slots past E are masked either way.
// Launch: 256 threads a block, 8 / G tiles of G warps each (G = 4 from
// four queries, 2 from two, else 1): 2,048 blocks at E = 2^21 and
// Q = 6, not persistent, 16 KiB of static shared memory, 40 registers.
// What holds it at about twice its bound is the chain of dependent
// loads each warp runs per query (probes, run, key merge, store) times
// the waves of warps: its atomics, staging the entries in shared
// memory, prefetching them, more loads in flight, a register cap and
// two or eight warps a tile were each tried and none was faster.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int WS = 512;         // slots a warp (== TILE in ops.py)
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CELLS = 16;       // slots a lane: one 16-byte word
constexpr int UNROLL = 4;       // entries a lane in flight in a run
constexpr unsigned FULL = 0xffffffffu;

// The 16 bytes at slots s .. s + 15 of a row of e bytes; slots past the
// row read 0.
template <bool VEC>
__device__ __forceinline__ uint4 load_cells(const uint8_t* row, long long s,
                                            int e) {
  if (s >= e) return make_uint4(0, 0, 0, 0);
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(row + s));
  uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < CELLS; ++i)
    if (s + i < e) b[i >> 2] |= (uint32_t)__ldg(row + s + i) << (8 * (i & 3));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

template <bool VEC>
__device__ __forceinline__ void store_cells(uint8_t* row, long long s,
                                            int e, uint4 w) {
  if (s >= e) return;
  if (VEC) {
    __stcs(reinterpret_cast<uint4*>(row + s), w);   // written once
    return;
  }
  const uint32_t b[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < CELLS; ++i)
    if (s + i < e) row[s + i] = (uint8_t)(b[i >> 2] >> (8 * (i & 3)));
}

// Four slots' bytes with the decided ones (key != init) replaced:
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

// The first j in [s, e) whose entry's t is past x (e if none), for
// entries ordered by t: the warp probes 32 evenly spaced entries and
// narrows to the gap between the last probe at or before x and the
// first past it, until 32 probes cover what is left.
__device__ __forceinline__ int first_after(const int2* __restrict__ ent,
                                           int s, int e, int x, int lane) {
  while (e - s > 32) {
    const int step = (e - s + 31) / 32;
    const int j = s + lane * step;
    const unsigned m = __ballot_sync(FULL, j < e && __ldg(&ent[j]).x > x);
    if (m & 1u) return s;
    // the last probe at or before x, then the first past it (if any)
    s += (m ? __ffs(m) - 2 : (e - 1 - s) / step) * step + 1;
    if (m) e = s - 1 + step;
  }
  const unsigned m = __ballot_sync(FULL, s + lane < e
                                   && __ldg(&ent[s + lane]).x > x);
  return m ? s + __ffs(m) - 1 : e;
}

// The run [a0, a1) of [s, e) with lo < t <= hi: the coarse samples (one
// a lane, at s + lane·step) narrow each end to the gap after the last
// sample at or before it, and 32 probes of each gap (both at once where
// a gap fits them) finish the search.
__device__ __forceinline__ void find_run(const int2* __restrict__ ent,
                                         int s, int e, int step, int sample,
                                         int lo, int hi, int lane, int& a0,
                                         int& a1) {
  const unsigned mlo = __ballot_sync(FULL, sample > lo);
  const unsigned mhi = __ballot_sync(FULL, sample > hi);
  const int flo = mlo ? __ffs(mlo) - 1 : 32;   // the first sample past lo
  const int fhi = mhi ? __ffs(mhi) - 1 : 32;
  const int slo = flo ? s + (flo - 1) * step + 1 : s;
  const int elo = flo ? min(e, s + flo * step) : s;
  const int shi = fhi ? s + (fhi - 1) * step + 1 : s;
  const int ehi = fhi ? min(e, s + fhi * step) : s;
  if (step > 32) {
    a0 = first_after(ent, slo, elo, lo, lane);
    a1 = first_after(ent, shi, ehi, hi, lane);
    return;
  }
  const int jl = slo + lane;
  const int jh = shi + lane;
  const int tl = jl < elo ? __ldg(&ent[jl]).x : INT_MAX;
  const int th = jh < ehi ? __ldg(&ent[jh]).x : INT_MAX;
  const unsigned pl = __ballot_sync(FULL, jl < elo && tl > lo);
  const unsigned ph = __ballot_sync(FULL, jh < ehi && th > hi);
  a0 = pl ? slo + __ffs(pl) - 1 : elo;
  a1 = ph ? shi + __ffs(ph) - 1 : ehi;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
edge_delta_apply_kernel(const int2* __restrict__ entries,
                        const int* __restrict__ tile_start,
                        const uint8_t* __restrict__ anchor,
                        long long anchor_stride, uint8_t* __restrict__ out,
                        const int* __restrict__ t_anchor,
                        const int* __restrict__ t_query, int e_cap,
                        int tiles, int n_queries, int groups) {
  __shared__ __align__(16) int dec[WARPS * WS];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // ``groups`` warps share a tile, warp g of them taking queries g,
  // g + groups, ...
  const int tile = blockIdx.x * (WARPS / groups) + warp / groups;
  const int group = warp % groups;
  if (tile >= tiles || group >= n_queries) return;
  // lane i owns slots i*16 .. i*16 + 15 of the warp's tile, and the same
  // keys of the warp's slice of ``dec``
  const long long s0 = (long long)tile * WS + lane * CELLS;
  int* wdec = dec + warp * WS;
  int4* mine = reinterpret_cast<int4*>(wdec + lane * CELLS);
  const int s = tile_start[tile];
  const int e = tile_start[tile + 1];
  // coarse samples of the tile's times, kept for every query: lane i
  // holds the t of entry s + i·step (INT_MAX past the end)
  const int step = max(1, (e - s + 31) / 32);
  const int sj = s + lane * step;
  const int sample = sj < e ? __ldg(&entries[sj]).x : INT_MAX;

  uint4 a = load_cells<VEC>(anchor, s0, e_cap);
  for (int q = group; q < n_queries; q += groups) {
    if (anchor_stride && q)
      a = load_cells<VEC>(anchor + q * anchor_stride, s0, e_cap);
    const int ta = t_anchor[q];
    const int tq = t_query[q];
    const bool fwd = tq >= ta;
    const int lo = min(ta, tq);
    const int hi = max(ta, tq);
    const int init = fwd ? -1 : INT_MAX;
    int a0, a1;
    find_run(entries, s, e, step, sample, lo, hi, lane, a0, a1);
    const bool dirty = a0 < a1;
    if (dirty) {
      const int4 init4 = make_int4(init, init, init, init);
#pragma unroll
      for (int k = 0; k < CELLS / 4; ++k) mine[k] = init4;
      __syncwarp();
      for (int base = a0 + lane; base < a1; base += 32 * UNROLL) {
        int2 en[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = base + u * 32;
          en[u] = j < a1 ? __ldg(&entries[j]) : make_int2(0, -1);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (en[u].y < 0) continue;
          const int key = 2 * (base + u * 32) + (en[u].y & 1);
          if (fwd) atomicMax(&wdec[en[u].y >> 1], key);
          else atomicMin(&wdec[en[u].y >> 1], key);
        }
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
    store_cells<VEC>(out + (long long)q * e_cap, s0, e_cap, w);
  }
}

}  // namespace

int edge_delta_apply_launch(const void* entries, const void* tile_start,
                            const void* anchor, long long anchor_stride,
                            void* out, const void* t_anchor,
                            const void* t_query, int e_cap, int n_queries,
                            long long stream) {
  const int tiles = (e_cap + WS - 1) / WS;
  if (n_queries <= 0 || tiles <= 0) return (int)cudaSuccess;
  // 16-byte words need every query's row 16-byte aligned: E % 16 == 0
  // and aligned bases
  const bool vec = e_cap % CELLS == 0 && (uintptr_t)anchor % 16 == 0
                   && (uintptr_t)out % 16 == 0;
  auto kernel = vec ? edge_delta_apply_kernel<true>
                    : edge_delta_apply_kernel<false>;
  // warps a tile: 1, 2 or 4, as many as the queries fill
  const int groups = n_queries >= 4 ? 4 : (n_queries >= 2 ? 2 : 1);
  const int per_block = WARPS / groups;
  kernel<<<(tiles + per_block - 1) / per_block, THREADS, 0,
           (cudaStream_t)stream>>>(
      (const int2*)entries, (const int*)tile_start, (const uint8_t*)anchor,
      anchor_stride, (uint8_t*)out, (const int*)t_anchor,
      (const int*)t_query, e_cap, tiles, n_queries, groups);
  return (int)cudaGetLastError();
}
