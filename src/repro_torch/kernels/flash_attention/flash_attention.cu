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
// widened to Hq heads.  The running max, normaliser and accumulator are
// float32.  Both instances take arbitrary batch / head / sequence
// strides (the head dim unit-stride), so [B, S, H, D] activations are
// read in place through a transposed view, and both mask ragged Sq / Skv
// edges themselves: the wrapper makes no padded copies.
//
// bfloat16: the tensor cores.  One block of two consumer warpgroups
// owns 128 query rows of one (batch, q-head), 64 rows a warpgroup, and
// loops over 64-key tiles from the first one the window can see to the
// last one the causal mask allows.  Both products are wgmma
// (m64n64k16, float32 accumulators):
//   S = Q·Kᵀ with Q and K from shared memory, K-major (a key's D values
//     are contiguous, as they come), the scale applied in float32 after
//     the product;
//   O += P·V with P in registers as the A operand and V from shared
//     memory through the transpose bit (MN-major), so V is never
//     transposed in memory.
// P is held to more than bf16: it is split as P = P_hi + P_lo, both
// bf16, and both go through the tensor cores into the same accumulator
// (relative error ~2^-17 per weight instead of 2^-9 for one rounding,
// which a row that sees few keys and cancels would show: see
// tests/test_torch_attention.py::test_p_needs_more_than_bf16).  The row
// sum l is taken from the float32 P.  Each row's exponent offset moves
// only when the row's max passes it by more than 2^8 (P then stays
// below 2^8), so the accumulator is rescaled only then; O = acc / l
// does not depend on the offset.  K / V tiles arrive in a three-stage
// shared-memory ring (two at D 256) by cp.async (16-byte rows,
// zero-filled past kv_len), two tiles in flight while one is
// multiplied, one block barrier a tile; cp.async rather than TMA
// because one 16-byte copy per thread takes any row stride the model's
// strided views have.  Shared memory uses the 128-byte swizzle the
// wgmma descriptors name, written by the copies themselves.  A tile
// wholly inside the causal / window / kv_len limits of a warpgroup's
// rows takes no mask (the masked loop is a separate branch: masking
// every tile cost more than the whole softmax); one wholly outside is
// skipped.  Blocks go out longest causal q tile first, so that the
// short diagonal tiles fill the tail wave.  GQA: one block per q head,
// the group's other heads find the same K / V tiles in L2.  Two blocks
// (four warpgroups) share an SM at D 64, so one block's softmax runs
// while the other's products are on the tensor cores.
//
// float32: the CUDA cores (TF32 would round the products).  One block
// of 256 threads owns 64 query rows; four threads share a query row,
// each holding BK/4 of the tile's scores and D/4 of the row's
// accumulator columns in registers; row max and sum are two
// xor-shuffles, and P·V takes each score from its owner by shuffle.
// Q, K and V tiles are staged in shared memory as float32 rows padded by
// 4 floats, read as float4 without bank conflicts.
//
// What bounds it on the H100.  Operations: 4·D FLOPs per visible
// (query, key) pair — at the smollm-360m prefill (B 8, S 2048, Hq 15,
// D 64, causal) 6.4e10 FLOPs, 65 µs at the 989 TFLOP/s bf16 tensor-core
// rate, against 84 MB of Q/K/V/O (25 µs at 3.35 TB/s).  The bf16
// instance spends 1.5× that on the tensor cores (P_hi and P_lo) plus
// the masked halves of diagonal tiles; its exp2 per pair runs on the
// special-function units, 16 a clock per SM (~70 µs for the 2.5e8
// pairs), between a tile's two products; and each 128-row block reads
// its whole K / V range from L2 (0.5 GB at that shape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, h, s;            // in elements; the head_dim stride is 1
};

struct Params {
  Strides q, k, v, o;
  int hq, group, sq, kv_len, window, causal;
  float scale;
};

// ---------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------

constexpr int BQ = 64;          // query rows per block
constexpr int THREADS = 256;    // four threads per query row

template <int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              Params p) {
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

  const float* qb = q + b * p.q.b + h * p.q.h;
  const float* kb = k + b * p.k.b + hk * p.k.h;
  const float* vb = v + b * p.v.b + hk * p.v.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    sq[r * LD + d] = q0 + r < p.sq
        ? qb[(long long)(q0 + r) * p.q.s + d] * p.scale : 0.f;
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
      sk[r * LD + d] = in ? kb[(long long)kp * p.k.s + d] : 0.f;
      sv[r * LD + d] = in ? vb[(long long)kp * p.v.s + d] : 0.f;
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
    float* orow = o + b * p.o.b + h * p.o.h + (long long)qpos * p.o.s;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[16 * c + 4 * quad + e] = acc[c][e] / denom;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const Params& p, int bh, long long stream) {
  constexpr int BK = D == 256 ? 32 : 64;
  const int smem = (BQ + 2 * BK) * (D + 4) * (int)sizeof(float);
  auto kernel = flash_fwd_f32<D, BK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (p.sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// bfloat16: wgmma
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int WG_ROWS = 64;     // query rows of one consumer warpgroup
constexpr int BQ_TC = 128;      // query rows of a block (two warpgroups)
constexpr int BK_TC = 64;       // keys of a K / V tile
constexpr int THREADS_TC = 256;
// One 128-byte swizzle atom is 8 rows of 64 bf16; a tile of R rows and
// D columns is stored as D / 64 slabs of [R][64], each row 128 bytes,
// the 16-byte chunk c of row r at chunk c ^ (r % 8).
constexpr int ROW_BYTES = 128;
constexpr int ATOM_BYTES = 8 * ROW_BYTES;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  // bytes 0: the 16 bytes at dst are zero-filled and nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// what cp.async wrote (generic proxy) becomes visible to wgmma (async
// proxy)
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous wgmma
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define WG_D32                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),        \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),   \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
      "+f"(d[30]), "+f"(d[31])
#define WG_REGS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"

// d (+)= A · B, 64 × 64 × 16; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A · B, 64 × 64 × 16; A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_D32
#undef WG_REGS32

__device__ __forceinline__ float ex2(float x) {   // 2^x, ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + ROWS) of a [rows, D] strided matrix into the
// swizzled slabs at dst; rows at and past ``limit`` are zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          long long stride, int row0,
                                          int limit, int tid) {
  constexpr int CH = D / 8;     // 16-byte chunks a row
  static_assert(ROWS * CH % THREADS_TC == 0, "tile / thread mismatch");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS_TC; ++i) {
    const int idx = tid + i * THREADS_TC;
    const int r = idx / CH, c = idx % CH;
    const bool ok = row0 + r < limit;
    const bf16* g = src + (long long)(ok ? row0 + r : 0) * stride + c * 8;
    cp_async16(dst + (c >> 3) * (ROWS * ROW_BYTES) + r * ROW_BYTES +
                   (((c & 7) ^ (r & 7)) << 4),
               g, ok ? 16 : 0);
  }
}

// K / V stages of the ring: three where shared memory allows
__host__ __device__ constexpr int kv_stages(int d) {
  return d == 256 ? 2 : 3;
}


template <int D>
__global__ void __launch_bounds__(THREADS_TC, D == 64 ? 2 : 1)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, Params p,
               int n_qtiles, int n_bh) {
  constexpr int SLABS = D / 64;
  constexpr int STAGES = kv_stages(D);
  constexpr int Q_BYTES = BQ_TC * D * 2;
  constexpr int KV_BYTES = BK_TC * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_kv = s_q + Q_BYTES;   // stage s: K, then V

  // longest causal q tiles first
  const int qt = n_qtiles - 1 - (int)blockIdx.x / n_bh;
  const int bh = (int)blockIdx.x % n_bh;
  const int b = bh / p.hq, h = bh % p.hq, hk = h / p.group;
  const int q0 = qt * BQ_TC;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int r0 = q0 + wg * WG_ROWS;      // this warpgroup's first row
  const int row_a = r0 + warp * 16 + (lane >> 2);   // and row_a + 8

  const bf16* qb = q + b * p.q.b + h * p.q.h;
  const bf16* kb = k + b * p.k.b + hk * p.k.h;
  const bf16* vb = v + b * p.v.b + hk * p.v.h;

  // the keys any row of this block can see
  int k_hi = p.kv_len;
  if (p.causal) k_hi = min(k_hi, q0 + BQ_TC);
  int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_lo -= k_lo % BK_TC;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK_TC - 1) / BK_TC : 0;

  // tile t's K and V go to stage t % STAGES as one cp.async group; the
  // first STAGES - 1 tiles (Q with the first) are in flight before the
  // loop, and each iteration starts the tile STAGES - 1 ahead
  auto load_kv = [&](int t) {
    const int k0 = k_lo + t * BK_TC;
    const uint32_t st = s_kv + (t % STAGES) * 2 * KV_BYTES;
    load_rows<BK_TC, D>(st, kb, p.k.s, k0, p.kv_len, tid);
    load_rows<BK_TC, D>(st + KV_BYTES, vb, p.v.s, k0, p.kv_len, tid);
  };
  load_rows<BQ_TC, D>(s_q, qb, p.q.s, q0, p.sq, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();          // an empty group where there is no tile
  }

  float acc[SLABS][32];
#pragma unroll
  for (int c = 0; c < SLABS; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};       // this thread's share of the row sums
  // 2^(s · scale · log2 e) = e^(s · scale)
  const float scale_log2 = p.scale * 1.4426950408889634f;
  const bool live = r0 < p.sq;   // the warpgroup has rows to write

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * BK_TC;
    cp_async_wait<STAGES - 2>();   // tile t has landed
    fence_async_proxy();
    // every warpgroup is done with tile t - 1, whose stage is refilled
    __syncthreads();
    if (t + STAGES - 1 < n_tiles) load_kv(t + STAGES - 1);
    cp_async_commit();
    const uint32_t s_k = s_kv + (t % STAGES) * 2 * KV_BYTES;
    const uint32_t s_v = s_k + KV_BYTES;

    // the same for all 128 threads of a warpgroup
    const bool skip = !live || (p.causal && k0 > r0 + WG_ROWS - 1) ||
                      (p.window > 0 && k0 + BK_TC - 1 <= r0 - p.window);
    if (!skip) {
      const bool whole = k0 + BK_TC <= p.kv_len &&
                         (!p.causal || k0 + BK_TC - 1 <= r0) &&
                         (p.window <= 0 ||
                          k0 > r0 + WG_ROWS - 1 - p.window);
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk & 3) * 32;   // 16 of a slab's 64
        const uint64_t da = sw128_desc(
            s_q + (kk >> 2) * BQ_TC * ROW_BYTES + wg * WG_ROWS * ROW_BYTES +
                koff, 16, ATOM_BYTES);
        const uint64_t db = sw128_desc(
            s_k + (kk >> 2) * BK_TC * ROW_BYTES + koff, 16, ATOM_BYTES);
        wgmma_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);

      // element i: row row_a + 8·((i >> 1) & 1), key
      // k0 + 8·(i >> 2) + 2·(lane & 3) + (i & 1)
      if (!whole) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kp = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const int qp = row_a + 8 * ((i >> 1) & 1);
          const bool ok = kp < p.kv_len && (!p.causal || kp <= qp) &&
                          (p.window <= 0 || kp > qp - p.window);
          s[i] = ok ? s[i] : -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      // m: each row's exponent offset, in log2 units.  It moves only
      // when the row's max passes it by more than 8, so P stays <= 2^8
      // and the accumulator is rescaled only then; O = acc / l does not
      // depend on the offset
      bool grow = false;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        mx[r] *= scale_log2;        // scale > 0: the max of the scaled
        grow |= mx[r] > m[r] + 8.f;
      }
      if (__any_sync(FULL, grow)) {
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = mx[r] > m[r] + 8.f ? mx[r] : m[r];
          // 0 when a row sees its first key; a row that has seen none
          // yet (m_new still -inf) keeps its zeros: ex2(-inf + inf) is
          // NaN
          alpha[r] = m_new == -INFINITY ? 1.f : ex2(m[r] - m_new);
          m[r] = m_new;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int c = 0; c < SLABS; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
      }
      // rows with no visible key yet keep m = -inf and stay inert
      const float ms[2] = {m[0] == -INFINITY ? 0.f : m[0],
                           m[1] == -INFINITY ? 0.f : m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float pr = ex2(fmaf(s[i], scale_log2, -ms[(i >> 1) & 1]));
        l[(i >> 1) & 1] += pr;
        s[i] = pr;
      }

      // P as the A operand of four k16 steps, split into bf16 hi + lo;
      // register e of step kc holds elements 8·kc + 2·e and + 1
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x0 = s[8 * kc + 2 * e], x1 = s[8 * kc + 2 * e + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          p_hi[kc][e] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kc][e] = pack_bf16(x0 - __low2float(hi),
                                  x1 - __high2float(hi));
        }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < SLABS; ++c)
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          // keys 16·kc.. of d-slab c: 8-key groups 1024 bytes apart
          const uint64_t db = sw128_desc(
              s_v + c * BK_TC * ROW_BYTES + kc * 2 * ATOM_BYTES,
              ATOM_BYTES, ATOM_BYTES);
          wgmma_rs_tb(acc[c], p_hi[kc], db);
          wgmma_rs_tb(acc[c], p_lo[kc], db);
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < SLABS; ++c) pin(acc[c]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    l[r] = l[r] > 0.f ? l[r] : 1.f;
  }
  bf16* ob = o + b * p.o.b + h * p.o.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row_a + 8 * r;
    if (qp >= p.sq) continue;
    bf16* orow = ob + (long long)qp * p.o.s + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < SLABS; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 64 + 8 * j) =
            __floats2bfloat162_rn(acc[c][4 * j + 2 * r] / l[r],
                                  acc[c][4 * j + 2 * r + 1] / l[r]);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const Params& p, int bh, long long stream) {
  const int n_qtiles = (p.sq + BQ_TC - 1) / BQ_TC;
  const int smem = 1024 + BQ_TC * D * 2 + kv_stages(D) * 2 * BK_TC * D * 2;
  auto kernel = flash_fwd_bf16<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_qtiles * bh, THREADS_TC, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, p,
      n_qtiles, bh);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: q, k, v, o in that order, each (batch, head, seq) in
// elements.  dtype: 0 float32, 1 bfloat16.  window <= 0: none.
// bfloat16 operands must be 16-byte aligned with strides a multiple of
// 8 elements (checked by the wrapper).
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
  const int bh = batch * hq;
  if (dtype == 0) {
    switch (d) {
      case 64: return launch_f32<64>(q, k, v, o, p, bh, stream);
      case 128: return launch_f32<128>(q, k, v, o, p, bh, stream);
      case 256: return launch_f32<256>(q, k, v, o, p, bh, stream);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 64: return launch_bf16<64>(q, k, v, o, p, bh, stream);
      case 128: return launch_bf16<128>(q, k, v, o, p, bh, stream);
      case 256: return launch_bf16<256>(q, k, v, o, p, bh, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}
