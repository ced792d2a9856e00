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
// Design.  The glue buckets every edge op of the sweep delta by node
// tile once, as {local node, t, sign}; the window test and the sample
// index are computed per query inside the kernel, so one bucketing
// serves the whole group.  The T_PAD overflow guard of the TPU wrapper
// (sweep.py: padding rows pinned to sample 1) is kept by construction:
// padding ops are never entries, and the window test runs before any
// arithmetic on t.  One block per (node tile, query): the B x TN int32
// net array in shared memory while it fits in 227 KB, else in global
// scratch; events are atomicAdd'ed; one thread per node column runs the
// forward running sum.
//
// What bounds it on the H100.  Bytes: Q·B·N·4 of int32 output plus
// Q·N·4 of start degrees and 16 bytes per event per query.  At
// N = 131072, B = 64 and Q = 4 that is 128 MiB, about 40 µs.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TN = 256;

__global__ void sweep_series_kernel(const int* __restrict__ deg0,
                                    const int4* __restrict__ events,
                                    const int* __restrict__ tile_start,
                                    const int* __restrict__ t_lo,
                                    const int* __restrict__ t_last,
                                    int* __restrict__ out,
                                    int* __restrict__ scratch, int n,
                                    int nb, int stride) {
  extern __shared__ int smem_net[];
  const int tile = blockIdx.x;
  const int q = blockIdx.y;
  const int tiles = gridDim.x;
  int* net = scratch
      ? scratch + ((long long)q * tiles + tile) * nb * TN
      : smem_net;

  for (int i = threadIdx.x; i < nb * TN; i += blockDim.x) net[i] = 0;
  __syncthreads();

  const int lo = t_lo[q];
  const int last = t_last[q];
  const int s = tile_start[tile];
  const int e = tile_start[tile + 1];
  for (int j = s + threadIdx.x; j < e; j += blockDim.x) {
    const int4 ev = events[j];          // {local node, t, sign, 0}
    if (ev.y <= lo || ev.y > last) continue;
    int k = (ev.y - lo + stride - 1) / stride;
    k = min(max(k, 0), nb - 1);
    atomicAdd(&net[k * TN + ev.x], ev.z);
  }
  __syncthreads();

  const int col = threadIdx.x;
  const int node = tile * TN + col;
  if (node >= n) return;
  const int d = deg0[(long long)q * n + node];
  int* o = out + (long long)q * nb * n;
  int acc = 0;
  for (int b = 0; b < nb; ++b) {
    acc += net[b * TN + col];
    o[(long long)b * n + node] = d + acc;
  }
}

}  // namespace

long long sweep_series_smem_bytes(int nb) {
  const long long bytes = (long long)nb * TN * 4;
  return bytes <= 227 * 1024 ? bytes : 0;
}

int sweep_series_launch(const void* deg0, const void* events,
                        const void* tile_start, const void* t_lo,
                        const void* t_last, void* out, void* scratch, int n,
                        int nb, int stride, int n_queries, long long stream) {
  const int tiles = (n + TN - 1) / TN;
  if (tiles <= 0 || nb <= 0 || n_queries <= 0) return (int)cudaSuccess;
  const long long smem = scratch ? 0 : sweep_series_smem_bytes(nb);
  if (!scratch && smem == 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_series_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(tiles, n_queries);
  sweep_series_kernel<<<grid, TN, smem, (cudaStream_t)stream>>>(
      (const int*)deg0, (const int4*)events, (const int*)tile_start,
      (const int*)t_lo, (const int*)t_last, (int*)out, (int*)scratch, n, nb,
      stride);
  return (int)cudaGetLastError();
}
