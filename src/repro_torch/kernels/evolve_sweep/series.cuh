// Degree series over node-tile-bucketed endpoint events, in both
// directions: the work kernel and the series kernel that sweep.cu
// (forward, the degree sweep) and ../degree_series/degree_series.cu
// (backward, the hybrid plan's series) instantiate.  Each of those two
// files says what it computes, what bounds it and what it replaces; this
// header holds the one copy of the code they share.
//
// Events are {t, local node·2 + is_add}, bucketed by TN-node tile with
// no cap (sweep.py::bucket_sweep_events).  For query q an event at t in
// (t_lo[q], t_last[q]] falls in bucket k of the B = nb rows:
//   forward   k = clamp(ceil((t - lo) / stride), 0, nb - 1),
//             out[b] = base + sum_{k <= b} net[k];
//   backward  k = min(ceil((t - lo) / stride), nb) - 1,
//             out[b] = base - sum_{k >= b} net[k]
// (backward: an op after sample b = lo + b·stride has
// ceil((t - lo) / stride) > b; ops past the last sample all land in the
// last row).  The window test runs before any arithmetic on t, so
// padding times (T_PAD) never reach the subtraction.
//
// The launch is ONE kernel.  Each block first finds its own row of the
// work list (find_row; ref.py::sweep_work_ref is the plain version):
// every tile's run of events cut into chunks of at most ``chunk``
// events (sweep.py's CHUNK), one row {tile, first event, end, slot}
// per block — the split tiles' chunks past their first, found by a
// scan (so the heaviest tiles start first), then every tile's first
// chunk, read off tile_start — and surplus rows {-1, 0, 0, -1} after
// the split tiles' chunks.  The grid walks (row, query), so no block
// walks more than CHUNK events however skewed the tiles.  The kernel is
// held to 64 registers, four blocks an SM: at 94 it ran in several
// waves, the last one holding the heaviest chunks.  A block adds its events' signs into a net in shared
// memory, two buckets packed to a 32-bit word (exact while each half
// stays within ±32767, which chunk <= 32767 guarantees), then a tile of
// one chunk runs the running sum from its net; a tile of several chunks
// adds its non-zero partial net into the tile's global net (atomics),
// fences, adds its event count to the tile's counter, and the block that
// brings the counter to the tile's count runs the running sum over the
// global net, LOADS loads in flight.  Where the packed net would not fit
// in SMEM_MAX (nb > 452), every tile's net lives in global memory.
// No kernel runs before the series to zero the global nets: the first
// block of a tile to arrive zeroes its net and flags it, the others
// wait for the flag only when they come to add into it, after their
// events have loaded.  Three counters a (query, tile) carry that
// (arrived, zeroed, events added); they are zero at every launch's
// start and end, reset by the block that reads the net (the wrapper
// keeps them in a buffer per device and stream, zeroed once when it is
// allocated).  work_kernel writes the rows alone, for holding them
// against their plain version.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TN = 256;                   // node tile (== TILE in sweep.py)
constexpr int UNROLL = 16;                // events in flight a thread
constexpr int LOADS = 8;                  // global-net loads in flight
constexpr long long SMEM_MAX = 226 * 1024;   // dynamic, beside the static

// The two halves of a packed word w = hi·2^16 + lo (mod 2^32).
__device__ __forceinline__ int low_half(int w) {
  return (int)(int16_t)(w & 0xffff);
}
__device__ __forceinline__ int high_half(int w) {
  return (w - low_half(w)) >> 16;
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

// Row r of the work list, the same in every thread of the block.  Rows
// [0, extra_rows) are the split tiles' chunks past their first, in tile
// order, then surplus rows: the block scans the tiles' chunk counts
// less one (k - 1, for a tile of count events cut into k = max(1,
// ceil(count / chunk)) chunks of near-equal size) across its threads,
// TN tiles at a time, until it finds the tile that holds its row.  So
// the heaviest tiles' chunks start first.  Rows from extra_rows on are
// the tiles' first chunks, read off tile_start.  The row's slot is its
// tile for a split tile, else -1.
__device__ int4 find_row(const int* __restrict__ tile_start, int tiles,
                         int chunk, int extra_rows, int r) {
  if (r >= extra_rows) {
    const int t = r - extra_rows;
    const int st = tile_start[t];
    const int count = tile_start[t + 1] - st;
    const int k = max(1, (count + chunk - 1) / chunk);
    return make_int4(t, st, st + count / k, k > 1 ? t : -1);
  }
  __shared__ int s_x[TN / 32];
  __shared__ int4 s_row;
  const int warp = threadIdx.x >> 5;
  const int x = r;                         // the x-th extra chunk
  if (threadIdx.x == 0) s_row = make_int4(-1, 0, 0, -1);
  int before = 0;                          // extra chunks of earlier tiles
  for (int t0 = 0; t0 < tiles; t0 += TN) {
    const int t = t0 + threadIdx.x;
    int count = 0, extra = 0;
    if (t < tiles) {
      count = tile_start[t + 1] - tile_start[t];
      extra = max(1, (count + chunk - 1) / chunk) - 1;
    }
    int ix = warp_incl_scan(extra);
    if ((threadIdx.x & 31) == 31) s_x[warp] = ix;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < TN / 32; ++w) {
      if (w < warp) ix += s_x[w];
      total += s_x[w];
    }
    const int end = before + ix;
    if (t < tiles && x >= end - extra && x < end) {
      const int k = extra + 1;
      const long long idx = x - (end - extra) + 1;   // chunk 1 .. k - 1
      const int st = tile_start[t];
      s_row = make_int4(t, st + (int)(idx * count / k),
                        st + (int)((idx + 1) * count / k), t);
    }
    before += total;
    __syncthreads();
    if (before > x) break;                 // the same in every thread
  }
  return s_row;
}

// The work list alone, one block a row.
__global__ void __launch_bounds__(TN)
work_kernel(const int* __restrict__ tile_start, int tiles, int chunk,
            int extra_rows, int4* __restrict__ work) {
  const int4 row = find_row(tile_start, tiles, chunk, extra_rows,
                            blockIdx.x);
  if (threadIdx.x == 0) work[blockIdx.x] = row;
}

// ceil(x / d) for x >= 1, d >= 1, without an integer division: the
// float64 quotient of x - 1 is within one of floor((x - 1) / d), and one
// step of the remainder corrects it.
__device__ __forceinline__ int ceil_div(int x, int d, double rd) {
  if (d == 1) return x;
  int q = (int)((double)(x - 1) * rd);
  const int r = (x - 1) - q * d;
  q += r < 0 ? -1 : (r >= d ? 1 : 0);
  return q + 1;
}

// t_lo / t_last: one time per query, or null with lo0 / last0 for a
// launch of one query.  ``sync``: three ints a (query, tile) — chunks
// arrived, net zeroed, events added — zero at launch and reset by the
// block that reads the net.
template <bool SMEM, bool BACKWARD>
__global__ void __launch_bounds__(TN, 4)
series_kernel(const int* __restrict__ base, const int2* __restrict__ events,
              const int* __restrict__ tile_start, int tiles, int chunk,
              const int* __restrict__ t_lo,
              const int* __restrict__ t_last, int lo0, int last0,
              int* __restrict__ out, int* __restrict__ gnet,
              int* __restrict__ sync, int n, int nb, int stride,
              int extra_rows) {
  extern __shared__ int4 smem4[];
  int* pnet = reinterpret_cast<int*>(smem4);
  __shared__ int s_flag;
  // {tile, first event, end, slot}
  const int4 job = find_row(tile_start, tiles, chunk, extra_rows,
                            blockIdx.x);
  const int tile = job.x;
  if (tile < 0) return;                  // a surplus row
  const int slot = job.w;                // >= 0: the tile has several chunks
  const int q = blockIdx.y;
  // the tile's global net, where it has one: a tile of several chunks,
  // or, without shared memory, every tile
  int* g = SMEM && slot < 0
      ? nullptr : gnet + ((long long)q * tiles + tile) * nb * TN;
  int* arrived = g ? sync + 3 * (q * tiles + tile) : nullptr;
  const int words = (nb + 1) / 2 * TN;   // packed words, a multiple of 4

  // a global net is zeroed by the first block of its tile to arrive
  // (the only one, for a tile of one chunk), which then flags it; the
  // others wait for the flag before they add into it, while their own
  // events load.  The block that zeroes is running and waits on no
  // one, so the wait ends.
  if (g) {
    if (threadIdx.x == 0)
      s_flag = slot < 0 || atomicAdd(arrived, 1) == 0;
    __syncthreads();
    if (s_flag) {
      int4* g4 = reinterpret_cast<int4*>(g);
      for (int i = threadIdx.x; i < nb * TN / 4; i += TN)
        g4[i] = make_int4(0, 0, 0, 0);
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0 && slot >= 0) atomicExch(arrived + 1, 1);
    }
  }
  if (SMEM) {
    for (int i = threadIdx.x; i < words / 4; i += TN)
      smem4[i] = make_int4(0, 0, 0, 0);
  }
  if (g && slot >= 0 && (!SMEM)) {
    // without shared memory the events go straight into the net
    if (threadIdx.x == 0)
      while (((volatile int*)arrived)[1] == 0) {}
    __threadfence();
  }
  __syncthreads();

  const int lo = t_lo ? t_lo[q] : lo0;
  const int last = t_last ? t_last[q] : last0;
  const double rd = 1.0 / stride;
  for (int j0 = job.y + threadIdx.x; j0 < job.z; j0 += UNROLL * TN) {
    int2 ev[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * TN;
      ev[u] = j < job.z ? __ldg(&events[j]) : make_int2(lo, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = ev[u].x;
      if (t <= lo || t > last) continue;   // before any arithmetic on t
      int k = ceil_div(t - lo, stride, rd);
      k = BACKWARD ? min(k, nb) - 1 : min(k, nb - 1);
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
      if (threadIdx.x == 0)
        while (((volatile int*)arrived)[1] == 0) {}
      __threadfence();
      __syncthreads();
      // word i holds buckets 2·(i / TN) and 2·(i / TN) + 1 of node
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
      s_flag = atomicAdd(arrived + 2, mine) + mine
               == tile_start[tile + 1] - tile_start[tile];
    }
    __syncthreads();
    if (!s_flag) return;
    __threadfence();
    if (threadIdx.x == 0) {              // every chunk is done with them
      arrived[0] = 0;
      arrived[1] = 0;
      arrived[2] = 0;
    }
  }

  // the running sum from the base degrees, one thread per node, forward
  // from bucket 0 or backward from bucket nb - 1; the output is written
  // once and not reread (streaming stores)
  const int node = tile * TN + threadIdx.x;
  if (node >= n) return;
  int acc = base[(long long)q * n + node];
  int* o = out + (long long)q * nb * n + node;
  if (SMEM && slot < 0) {
    for (int i = 0; i < nb; ++i) {
      const int b = BACKWARD ? nb - 1 - i : i;
      const int w = pnet[(b >> 1) * TN + threadIdx.x];
      const int v = (b & 1) ? high_half(w) : low_half(w);
      acc += BACKWARD ? -v : v;
      __stcs(o + (long long)b * n, acc);
    }
  } else {
    // written by atomics at L2: read there, past L1, LOADS at a time
    // (one at a time, the 64 round trips to L2 of a split tile's last
    // block outlast the rest of the kernel)
    for (int i0 = 0; i0 < nb; i0 += LOADS) {
      int v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int b = BACKWARD ? nb - 1 - (i0 + u) : i0 + u;
        v[u] = i0 + u < nb ? __ldcg(g + b * TN + threadIdx.x) : 0;
      }
#pragma unroll
      for (int u = 0; u < LOADS && i0 + u < nb; ++u) {
        const int b = BACKWARD ? nb - 1 - (i0 + u) : i0 + u;
        acc += BACKWARD ? -v[u] : v[u];
        __stcs(o + (long long)b * n, acc);
      }
    }
  }
}

// Dynamic shared memory of the packed net, or 0 where it does not fit.
inline long long series_smem_bytes(int nb) {
  const long long bytes = (long long)((nb + 1) / 2) * TN * 4;
  return bytes <= SMEM_MAX ? bytes : 0;
}

inline int work_launch(const void* tile_start, void* work, int tiles,
                       int n_rows, int chunk, long long stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  work_kernel<<<n_rows, TN, 0, (cudaStream_t)stream>>>(
      (const int*)tile_start, tiles, chunk, n_rows - tiles, (int4*)work);
  return (int)cudaGetLastError();
}

// The series kernel on a (row, query) grid.  ``nets``: a global net a
// (query, tile), nb × TN ints, any contents; ``sync``: three ints a
// (query, tile), zero.
template <bool BACKWARD>
int series_launch(const void* base, const void* events,
                  const void* tile_start, const void* t_lo,
                  const void* t_last, int lo0, int last0, void* out,
                  void* nets, void* sync, int n, int nb, int stride,
                  int chunk, int tiles, int n_rows, int n_queries,
                  long long stream) {
  if (n_rows <= 0 || nb <= 0 || n_queries <= 0) return (int)cudaSuccess;
  if (!nets || !sync) return (int)cudaErrorInvalidValue;
  const long long smem = series_smem_bytes(nb);
  int* gnet = (int*)nets;
  int* counters = (int*)sync;
  const cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(n_rows, n_queries);
  if (smem) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          series_kernel<true, BACKWARD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    series_kernel<true, BACKWARD><<<grid, TN, smem, st>>>(
        (const int*)base, (const int2*)events, (const int*)tile_start,
        tiles, chunk, (const int*)t_lo, (const int*)t_last, lo0, last0,
        (int*)out, gnet, counters, n, nb, stride, n_rows - tiles);
  } else {
    series_kernel<false, BACKWARD><<<grid, TN, 0, st>>>(
        (const int*)base, (const int2*)events, (const int*)tile_start,
        tiles, chunk, (const int*)t_lo, (const int*)t_last, lo0, last0,
        (int*)out, gnet, counters, n, nb, stride, n_rows - tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace
