// Forward degree sweep: every node's degree at each sample
// t_lo + b·stride of a batch of sweep queries — the forward twin of
// degree_series.cu.
//
// Replaces: repro/kernels/evolve_sweep/sweep.py::sweep_series_tiles
// (Pallas body ``_kernel``; glue ``bucket_sweep_events``).
//
// What it computes.  For sweep query q starting from degrees deg0[q] at
// t_lo[q], an edge op at time t in (t_lo[q], t_last[q]] is first seen by
// sample k = ceil((t - t_lo[q]) / stride), clipped to [0, B), and
//   deg(v, t_lo + b·stride) = deg0(v) + sum_{b' <= b} net[b', v].
// Rows past a query's last real sample repeat it.
//
// What bounds it on the H100.  Bytes: Q·B·N·4 of int32 output, Q·N·4 of
// start degrees and 8 bytes per event (read once per query).  At
// N = 131072, B = 64, Q = 1 and 2.45 M events that is 53.7 MB, 16 µs at
// 3.35 TB/s.  The events are skewed: preferential attachment puts the
// hubs in the first node tiles, and tile 0 holds 30× the mean.
//
// Design.  The glue (sweep.py) buckets every edge op of the sweep delta
// by 256-node tile once, as {t, local node·2 + is_add}; the window test
// and the sample index are computed per query inside the kernel, so one
// bucketing serves the whole group.  The T_PAD overflow guard of the TPU
// wrapper (sweep.py: padding rows pinned to sample 1) is kept by
// construction: padding ops are never events, and the window test runs
// before any arithmetic on t.  A first, light kernel then cuts each
// tile's run of events into chunks of at most ``chunk`` (sweep.py's
// CHUNK) events: one block per row of the work list, each scanning the
// tiles' chunk counts from tile_start itself (ref.py::sweep_work_ref
// is the plain version).  The host reads nothing back: the list has as
// many rows as the event count can need, and the surplus rows' blocks
// exit at once.  The same kernel zeroes the global nets and counters
// the launch will use, so the wrapper's scratch, sized for the most
// the event count can need, is left uninitialised and costs no
// traffic.  The sweep's grid walks (row, query), so no block walks more
// than CHUNK events, however skewed the tiles.  A block:
//   1. adds its events' signs into a B × 256 net in shared memory,
//      packed two samples to a 32-bit word (low 16 bits sample 2i, high
//      16 bits sample 2i+1: a word's halves are exact while each stays
//      within ±32767, which CHUNK <= 32767 guarantees), so
//      B = 64 takes 32 KB and seven blocks fit an SM;
//   2. a tile of one chunk (the great majority) then runs the forward
//      running sum from deg0, one thread per node, and writes its
//      output rows with streaming stores;
//   3. a tile of several chunks adds the non-zero entries of its
//      partial net into a zeroed int32 net of the tile in global
//      scratch (atomicAdd), fences, and adds its event count to the
//      tile's counter; the block that brings it to the tile's count
//      finishes last and runs the running sum over the global net,
//      eight loads in flight.  Atomics were chosen over a cluster
//      reduction through distributed shared memory because the chunks
//      of one tile number up to ceil(events / CHUNK) — 18 for the
//      heaviest tile at the main shape — past a cluster's 8 (16
//      non-portable) blocks, and a cluster size is fixed per launch.
// Where the packed net would not fit in 226 KB (B > 452), every tile's
// net lives in global scratch and the events are added there directly;
// multi-chunk tiles count as above.
// Launch: the work kernel on 811 rows at the main shape (591 real),
// then the sweep on a (row, query) grid, not persistent, 256 threads,
// 32 registers a thread, ceil(B/2)·1 KB of dynamic shared memory — 32
// KB at B = 64, so seven blocks an SM (ptxas's report: ``chip_smoke.py
// --first-call``).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TN = 256;                   // node tile (== TILE in sweep.py)
constexpr int UNROLL = 4;                 // events in flight a thread
constexpr int LOADS = 8;                  // global-net loads in flight
constexpr long long SMEM_MAX = 226 * 1024;   // dynamic, beside the static

// The two halves of a packed word w = hi·2^16 + lo (mod 2^32).
__device__ __forceinline__ int low_half(int w) {
  return (int)(int16_t)(w & 0xffff);
}
__device__ __forceinline__ int high_half(int w) {
  return (w - low_half(w)) >> 16;
}

template <bool SMEM>
__global__ void __launch_bounds__(TN)
sweep_series_kernel(const int* __restrict__ deg0,
                    const int2* __restrict__ events,
                    const int* __restrict__ tile_start,
                    const int4* __restrict__ work,
                    const int* __restrict__ t_lo,
                    const int* __restrict__ t_last, int* __restrict__ out,
                    int* __restrict__ gnet, int* __restrict__ counters,
                    int n, int nb, int stride, int regions) {
  extern __shared__ int4 smem4[];
  int* pnet = reinterpret_cast<int*>(smem4);
  __shared__ int s_last;
  const int4 job = work[blockIdx.x];     // {tile, first event, end, slot}
  const int tile = job.x;
  if (tile < 0) return;                  // a surplus row
  const int slot = job.w;                // >= 0: the tile has several chunks
  const int q = blockIdx.y;
  // the tile's global net: a slot of its own per multi-chunk tile, or,
  // without shared memory, one per tile
  const int region = SMEM ? slot : tile;
  int* g = region >= 0
      ? gnet + ((long long)q * regions + region) * nb * TN : nullptr;
  const int words = (nb + 1) / 2 * TN;   // packed words, a multiple of 4

  if (SMEM) {
    for (int i = threadIdx.x; i < words / 4; i += TN)
      smem4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
  }

  const int lo = t_lo[q];
  const int last = t_last[q];
  for (int base = job.y + threadIdx.x; base < job.z; base += UNROLL * TN) {
    int2 ev[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * TN;
      ev[u] = j < job.z ? __ldg(&events[j]) : make_int2(lo, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = ev[u].x;
      if (t <= lo || t > last) continue;   // before any arithmetic on t
      int k = (t - lo + stride - 1) / stride;
      k = min(max(k, 0), nb - 1);
      const int node = ev[u].y >> 1;
      const int sign = (ev[u].y & 1) ? 1 : -1;
      if (SMEM)
        atomicAdd(&pnet[(k >> 1) * TN + node], (k & 1) ? sign * 65536 : sign);
      else
        atomicAdd(&g[k * TN + node], sign);
    }
  }
  __syncthreads();

  if (slot >= 0) {
    if (SMEM) {
      // word i holds samples 2·(i / TN) and 2·(i / TN) + 1 of node
      // i % TN == threadIdx.x
      for (int i = threadIdx.x; i < words; i += TN) {
        const int w = pnet[i];
        if (!w) continue;
        int* gb = g + 2 * (i / TN) * TN + threadIdx.x;
        const int l = low_half(w);
        const int h = high_half(w);
        if (l) atomicAdd(gb, l);
        if (h) atomicAdd(gb + TN, h);     // h != 0 only below nb
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      // every chunk of a split tile holds at least one event, so one
      // block alone sees the count reached
      const int mine = job.z - job.y;
      s_last = atomicAdd(&counters[q * regions + region], mine) + mine
               == tile_start[tile + 1] - tile_start[tile];
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
  }

  // the running sum from deg0, one thread per node; the output is
  // written once and not reread (streaming stores)
  const int node = tile * TN + threadIdx.x;
  if (node >= n) return;
  int acc = deg0[(long long)q * n + node];
  int* o = out + (long long)q * nb * n + node;
  if (SMEM && slot < 0) {
    for (int b = 0; b < nb; b += 2) {
      const int w = pnet[(b >> 1) * TN + threadIdx.x];
      acc += low_half(w);
      __stcs(o + (long long)b * n, acc);
      if (b + 1 < nb) {
        acc += high_half(w);
        __stcs(o + (long long)(b + 1) * n, acc);
      }
    }
  } else {
    // written by atomics at L2: read there, past L1, LOADS at a time
    // (one at a time, the 64 round trips to L2 of a split tile's last
    // block outlast the rest of the kernel)
    for (int b0 = 0; b0 < nb; b0 += LOADS) {
      int v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u)
        v[u] = b0 + u < nb ? __ldcg(g + (b0 + u) * TN + threadIdx.x) : 0;
#pragma unroll
      for (int u = 0; u < LOADS && b0 + u < nb; ++u) {
        acc += v[u];
        __stcs(o + (long long)(b0 + u) * n, acc);
      }
    }
  }
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Row r = blockIdx.x of the work list (ref.py::sweep_work_ref is its
// plain version): the tiles' chunk counts k = max(1, ceil(count /
// chunk)) and split flags (k > 1) are scanned across the block, TN
// tiles at a time, until the tile holding row r is found; rows past
// the last are {-1, 0, 0, -1}.  The block then zeroes, for every query,
// the global net and counter of the tile the row starts, if the tile
// uses one (a split tile, or any tile without shared memory).
template <bool SMEM>
__global__ void __launch_bounds__(TN)
sweep_work_kernel(const int* __restrict__ tile_start, int tiles,
                  int chunk, int4* __restrict__ work,
                  int* __restrict__ gnet, int* __restrict__ counters,
                  int nb, int regions, int n_queries) {
  __shared__ int s_k[TN / 32], s_split[TN / 32];
  __shared__ int4 s_row;
  __shared__ int s_first;
  const int r = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_row = make_int4(-1, 0, 0, -1);
    s_first = 0;
  }
  int rows_before = 0, split_before = 0;  // over the tiles scanned so far
  for (int base = 0; base < tiles; base += TN) {
    const int t = base + threadIdx.x;
    int count = 0, k = 0, split = 0;
    if (t < tiles) {
      count = tile_start[t + 1] - tile_start[t];
      k = max(1, (count + chunk - 1) / chunk);
      split = k > 1;
    }
    int ik = warp_incl_scan(k);
    int isplit = warp_incl_scan(split);
    if ((threadIdx.x & 31) == 31) {
      s_k[warp] = ik;
      s_split[warp] = isplit;
    }
    __syncthreads();
    int tk = 0, tsplit = 0;
#pragma unroll
    for (int w = 0; w < TN / 32; ++w) {
      if (w < warp) {
        ik += s_k[w];
        isplit += s_split[w];
      }
      tk += s_k[w];
      tsplit += s_split[w];
    }
    const int end = rows_before + ik;
    if (t < tiles && r >= end - k && r < end) {
      const long long idx = r - (end - k);
      const int st = tile_start[t];
      s_row = make_int4(t, st + (int)(idx * count / k),
                        st + (int)((idx + 1) * count / k),
                        split ? split_before + isplit - 1 : -1);
      s_first = idx == 0;
    }
    rows_before += tk;
    split_before += tsplit;
    __syncthreads();
    if (rows_before > r) break;            // the same in every thread
  }
  const int4 row = s_row;
  if (threadIdx.x == 0) work[r] = row;
  const int region = SMEM ? row.w : row.x;
  if (!regions || !s_first || region < 0) return;
  for (int q = 0; q < n_queries; ++q) {
    const long long g = (long long)q * regions + region;
    int4* net = reinterpret_cast<int4*>(gnet + g * nb * TN);
    for (int i = threadIdx.x; i < nb * TN / 4; i += TN)
      net[i] = make_int4(0, 0, 0, 0);
    if (threadIdx.x == 0) counters[g] = 0;
  }
}

}  // namespace

long long sweep_series_smem_bytes(int nb) {
  const long long bytes = (long long)((nb + 1) / 2) * TN * 4;
  return bytes <= SMEM_MAX ? bytes : 0;
}

int sweep_work_launch(const void* tile_start, void* work, int tiles,
                      int n_rows, int chunk, long long stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  sweep_work_kernel<true><<<n_rows, TN, 0, (cudaStream_t)stream>>>(
      (const int*)tile_start, tiles, chunk, (int4*)work, nullptr, nullptr,
      0, 0, 0);
  return (int)cudaGetLastError();
}

int sweep_series_launch(const void* deg0, const void* events,
                        const void* tile_start, void* work,
                        const void* t_lo, const void* t_last, void* out,
                        void* scratch, int n, int nb, int stride, int chunk,
                        int tiles, int n_rows, int regions, int n_queries,
                        long long stream) {
  if (n_rows <= 0 || nb <= 0 || n_queries <= 0) return (int)cudaSuccess;
  if (regions > 0 && !scratch) return (int)cudaErrorInvalidValue;
  const long long smem = sweep_series_smem_bytes(nb);
  // global nets (regions per query, nb × TN each), then the counters
  int* gnet = (int*)scratch;
  int* counters = gnet + (long long)n_queries * regions * nb * TN;
  const cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(n_rows, n_queries);
  if (smem) {
    sweep_work_kernel<true><<<n_rows, TN, 0, st>>>(
        (const int*)tile_start, tiles, chunk, (int4*)work, gnet, counters,
        nb, regions, n_queries);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          sweep_series_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    sweep_series_kernel<true><<<grid, TN, smem, st>>>(
        (const int*)deg0, (const int2*)events, (const int*)tile_start,
        (const int4*)work, (const int*)t_lo, (const int*)t_last, (int*)out,
        gnet, counters, n, nb, stride, regions);
  } else {
    sweep_work_kernel<false><<<n_rows, TN, 0, st>>>(
        (const int*)tile_start, tiles, chunk, (int4*)work, gnet, counters,
        nb, regions, n_queries);
    sweep_series_kernel<false><<<grid, TN, 0, st>>>(
        (const int*)deg0, (const int2*)events, (const int*)tile_start,
        (const int4*)work, (const int*)t_lo, (const int*)t_last, (int*)out,
        gnet, counters, n, nb, stride, regions);
  }
  return (int)cudaGetLastError();
}
