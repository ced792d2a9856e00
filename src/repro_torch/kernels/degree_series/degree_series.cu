// Hybrid-plan degree time series: every node's degree at each time unit
// t_k + b, b in [0, B), from the current degrees and the window's edge
// ops (paper §3.2.3, evaluated for all nodes at once).
//
// Replaces: repro/kernels/degree_series/degree_series.py::
// degree_series_tiles (Pallas body ``_kernel``; glue
// ``ops.py::bucket_node_events``).
//
// What it computes.  Each in-suffix edge op (t > t_k) gives a signed
// event (+1 add, -1 remove) to both endpoints at bucket
// clip(t - t_k, 0, B) — bucket B is the virtual tail for ops past the
// window.  Then
//   deg(v, t_k + b) = deg_cur(v) - sum_{b' > b} net[b', v].
//
// Design.  The plain-PyTorch glue buckets events by node tile (no cap).
// One block per tile of TN nodes: the (B+1) x TN int32 net array lives
// in shared memory while it fits in the 227 KB a block may use
// (B <= 225 at TN = 256), else in global scratch the wrapper allocates.
// Events are atomicAdd'ed into it (integer adds commute, so arrival
// order does not matter); then one thread per node column runs the
// reverse running sum and writes the B outputs, coalesced along nodes.
//
// What bounds it on the H100.  Bytes: the B·N·4-byte int32 output, plus
// N·4 of degrees and 16 bytes per event.  At N = 8192 and B = 64 that
// is 2 MiB — under a microsecond of HBM time, so launch latency bounds
// it at the main path's shapes.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TN = 256;         // nodes per tile == threads per block

__global__ void degree_series_kernel(const int* __restrict__ deg_cur,
                                     const int4* __restrict__ events,
                                     const int* __restrict__ tile_start,
                                     int* __restrict__ out,
                                     int* __restrict__ scratch, int n,
                                     int nb) {
  extern __shared__ int smem_net[];
  const int tile = blockIdx.x;
  const int rows = nb + 1;
  int* net = scratch ? scratch + (long long)tile * rows * TN : smem_net;

  for (int i = threadIdx.x; i < rows * TN; i += blockDim.x) net[i] = 0;
  __syncthreads();

  const int s = tile_start[tile];
  const int e = tile_start[tile + 1];
  for (int j = s + threadIdx.x; j < e; j += blockDim.x) {
    const int4 ev = events[j];          // {local node, bucket, sign, 0}
    atomicAdd(&net[ev.y * TN + ev.x], ev.z);
  }
  __syncthreads();

  const int col = threadIdx.x;
  const int node = tile * TN + col;
  if (node >= n) return;
  const int d = deg_cur[node];
  int acc = 0;
  for (int b = nb - 1; b >= 0; --b) {
    acc += net[(b + 1) * TN + col];
    out[(long long)b * n + node] = d - acc;
  }
}

}  // namespace

// Bytes of shared memory the net array needs; 0 when it must go to
// global scratch (the wrapper then passes a scratch buffer).
long long degree_series_smem_bytes(int nb) {
  const long long bytes = (long long)(nb + 1) * TN * 4;
  return bytes <= 227 * 1024 ? bytes : 0;
}

int degree_series_launch(const void* deg_cur, const void* events,
                         const void* tile_start, void* out, void* scratch,
                         int n, int nb, long long stream) {
  const int tiles = (n + TN - 1) / TN;
  if (tiles <= 0 || nb <= 0) return (int)cudaSuccess;
  const long long smem = scratch ? 0 : degree_series_smem_bytes(nb);
  if (!scratch && smem == 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        degree_series_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  degree_series_kernel<<<tiles, TN, smem, (cudaStream_t)stream>>>(
      (const int*)deg_cur, (const int4*)events, (const int*)tile_start,
      (int*)out, (int*)scratch, n, nb);
  return (int)cudaGetLastError();
}
