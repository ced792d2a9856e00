// Flash-attention forward: softmax(scale · Q Kᵀ + mask) V with GQA,
// causal and sliding-window masks and a kv_len padding mask, never
// materializing the Sq × Skv score matrix.
//
// Replaces: repro/kernels/flash_attention/flash_attention.py::
// flash_attention_fwd (Pallas body ``_kernel``; wrapper
// ``ops.py::flash_attention``).
//
// What it computes.  For query row i (position i) and key j (position
// j), key j is visible when j < kv_len, j <= i (causal) and
// j > i - window (sliding window).  The output row is the softmax-
// weighted sum of the visible value rows, or 0 for a row that sees no
// key.  Query head h reads key/value head h / group (GQA): nothing is
// widened to Hq heads.  Inputs and output are float32 or bfloat16 (one
// template); the running max, normaliser and accumulator are float32.
//
// Design.  The TPU grid carries m / l / acc across its sequential KV
// axis in VMEM.  Here one block of 256 threads owns BQ = 64 query rows
// of one (batch, q-head) and loops over KV tiles itself, from the first
// tile the window can see to the last one the causal mask allows (this
// replaces the TPU kernel's ``pl.when`` block skip).  Four threads
// share a query row: each holds BK/4 of the tile's scores and D/4 of
// the row's accumulator columns in registers; the row max and sum are
// two xor-shuffles, and P·V takes each score from its owner by
// shuffle, so neither S nor P goes through shared memory.  Q, K and V
// tiles are staged in shared memory as float32 rows padded by 4 floats,
// read as float4 without bank conflicts.  Ragged edges (Sq, Skv not a
// multiple of the tile) are masked in the kernel: the wrapper makes no
// padded copies.  Arbitrary batch / head / sequence strides are taken,
// so [B, S, H, D] activations are read in place through a transposed
// view.  The arithmetic runs on the CUDA cores in float32 (no tensor
// cores yet).
//
// What bounds it on the H100.  Operations: 4·D FLOPs per visible
// (query, key) pair — at the smollm-360m prefill (B 8, S 2048, Hq 15,
// D 64, causal) 6.4e10 FLOPs, 65 µs at the 989 TFLOP/s bf16 tensor-core
// rate, against 84 MB of Q/K/V/O (25 µs at 3.35 TB/s).  This kernel does
// the work on the float32 CUDA cores (67 TFLOP/s) and so sits far from
// that bound; mma/wgmma tiles are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int THREADS = 256;    // four threads per query row
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;            // in elements; the head_dim stride is 1
};

struct Params {
  Strides q, k, v, o;
  int hq, group, sq, kv_len, window, causal;
  float scale;
};

template <typename T, int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Params p) {
  constexpr int LD = D + 4;     // padded float32 row (float4 aligned)
  constexpr int NJ = BK / 4;    // scores per thread per KV tile
  constexpr int NC = D / 16;    // float4 accumulator groups per thread
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);   // [BQ][LD], pre-scaled
  float* sk = sq + BQ * LD;                      // [BK][LD]
  float* sv = sk + BK * LD;                      // [BK][LD]

  const int b = blockIdx.x / p.hq;
  const int h = blockIdx.x % p.hq;
  const int hk = h / p.group;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 2;
  const int quad = tid & 3;
  const int qpos = q0 + row;

  const T* qb = q + b * p.q.b + h * p.q.h;
  const T* kb = k + b * p.k.b + hk * p.k.h;
  const T* vb = v + b * p.v.b + hk * p.v.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    sq[r * LD + d] = q0 + r < p.sq
        ? to_f32(qb[(long long)(q0 + r) * p.q.s + d]) * p.scale : 0.f;
  }

  // the keys any row of this block can see
  int k_lo = 0;
  int k_hi = p.kv_len;
  if (p.causal) k_hi = min(k_hi, q0 + BQ);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  k_lo -= k_lo % BK;

  float m = -INFINITY, l = 0.f;
  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();            // the previous tile has been consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int kp = k0 + r;
      const bool in = kp < p.kv_len;
      sk[r * LD + d] = in ? to_f32(kb[(long long)kp * p.k.s + d]) : 0.f;
      sv[r * LD + d] = in ? to_f32(vb[(long long)kp * p.v.s + d]) : 0.f;
    }
    __syncthreads();

    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
    const float4* qrow = reinterpret_cast<const float4*>(sq + row * LD);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 qv = qrow[d4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 kv =
            reinterpret_cast<const float4*>(sk + (4 * j + quad) * LD)[d4];
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    unsigned visible = 0;       // bit j: score j of this thread counts
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kp = k0 + 4 * j + quad;
      const bool ok = kp < p.kv_len && (!p.causal || kp <= qpos) &&
                      (p.window <= 0 || kp > qpos - p.window);
      if (ok) {
        visible |= 1u << j;
        mt = fmaxf(mt, s[j]);
      }
    }
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
    const float m_new = fmaxf(m, mt);
    // rows with no visible key yet keep m = -inf and stay inert
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_safe);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j] = (visible >> j) & 1u ? expf(s[j] - m_safe) : 0.f;
      ls += s[j];
    }
    ls += __shfl_xor_sync(FULL, ls, 1);
    ls += __shfl_xor_sync(FULL, ls, 2);
    l = alpha * l + ls;
    m = m_new;

#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c][0] *= alpha;
      acc[c][1] *= alpha;
      acc[c][2] *= alpha;
      acc[c][3] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float pk = __shfl_sync(FULL, s[j], (lane & ~3) | src);
        const float4* vrow =
            reinterpret_cast<const float4*>(sv + (4 * j + src) * LD);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = vrow[c * 4 + quad];
          acc[c][0] = fmaf(pk, vv.x, acc[c][0]);
          acc[c][1] = fmaf(pk, vv.y, acc[c][1]);
          acc[c][2] = fmaf(pk, vv.z, acc[c][2]);
          acc[c][3] = fmaf(pk, vv.w, acc[c][3]);
        }
      }
    }
  }

  if (qpos < p.sq) {
    const float denom = l > 0.f ? l : 1.f;
    T* orow = o + b * p.o.b + h * p.o.h + (long long)qpos * p.o.s;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(orow + 16 * c + 4 * quad + e, acc[c][e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Params& p, int bh, long long stream) {
  constexpr int BK = D == 256 ? 32 : 64;
  const int smem = (BQ + 2 * BK) * (D + 4) * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<T, D, BK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (p.sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             const Params& p, int bh, int d, long long stream) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, o, p, bh, stream);
    case 128: return launch<T, 128>(q, k, v, o, p, bh, stream);
    case 256: return launch<T, 256>(q, k, v, o, p, bh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: q, k, v, o in that order, each (batch, head, seq) in
// elements.  dtype: 0 float32, 1 bfloat16.  window <= 0: none.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const long long* strides, int batch,
                           int hq, int hkv, int sq, int kv_len, int d,
                           int dtype, int causal, int window, float scale,
                           long long stream) {
  if (batch <= 0 || hq <= 0 || sq <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = {strides[0], strides[1], strides[2]};
  p.k = {strides[3], strides[4], strides[5]};
  p.v = {strides[6], strides[7], strides[8]};
  p.o = {strides[9], strides[10], strides[11]};
  p.hq = hq;
  p.group = hq / hkv;
  p.sq = sq;
  p.kv_len = kv_len;
  p.window = window;
  p.causal = causal;
  p.scale = scale;
  if (dtype == 0) return launch_d<float>(q, k, v, o, p, batch * hq, d, stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, p, batch * hq, d, stream);
  return (int)cudaErrorInvalidValue;
}
