// Chunked SSD scan forward (Mamba2 state-space dual), one group of B/C:
// per (batch, head), y_t = C_t · h_t with h_t = exp(a·dt_t) h_{t-1} +
// dt_t x_t ⊗ B_t, evaluated chunk by chunk in the dual (quadratic) form,
// with the final state written out.
//
// Replaces: repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_fwd (Pallas
// body ``_kernel``; wrapper ``ops.py::ssd_scan``).
//
// What it computes.  Within a chunk of Q steps, cum_i = Σ_{j<=i} a·dt_j,
//   y_i = Σ_{j<=i} (C_i·B_j) exp(cum_i − cum_j) dt_j x_j
//         + exp(cum_i) C_i · h          (h: the state entering the chunk)
//   h'  = exp(cum_last) h + Σ_j exp(cum_last − cum_j) dt_j x_j ⊗ B_j.
// The mask j <= i is applied before the exp.  Everything is float32, as
// the model computes it.  Unlike the TPU kernel, which keeps the state
// in scratch and drops it, this one takes an optional initial state and
// writes the final one: the model's prefill puts it in the decode cache.
//
// Design.  One block of 256 threads per (batch, head) walks the chunks
// in order (the TPU's sequential chunk axis), the P × N state resident
// in shared memory (32 KB at P 64, N 128).  A Q × Q float32 score at
// Q = 256 would be 256 KB, over the 227 KB a block may have, so each
// chunk is done in 64-row tiles: for each row tile of C, the carried-
// state term, then one 64 × 64 score tile per column tile of B and x
// up to the diagonal (tiles past it are all masked and skipped), each
// multiplied into the row tile's 64 × P output kept in registers.  The
// state update follows, 32 state elements per thread.  dt·x and a·dt
// are formed on the fly, and B / C are read once as [B, S, N] per batch
// — nothing is broadcast to H heads.  The in-chunk cumsum is a warp
// scan.  The inner loops are unrolled so that each thread issues a
// batch of shared-memory loads before the FMAs that use them: at one
// block (8 warps) per SM there is little else to hide their latency.
// Sequential chunks within one block are the limit on
// parallelism (B·H blocks: 192 at B 8, H 24); a two-pass
// chunk-parallel design is later work.
//
// What bounds it on the H100.  Operations, in float32: per chunk and
// (batch, head), Q(Q+1)·N for C·Bᵀ, Q(Q+1)·P for score·(dt·x), 2·Q·P·N
// for C·stateᵀ and 2·Q·P·N for the state update — 32 GFLOP at the
// mamba2-130m prefill (B 8, S 2048, H 24, P 64, N 128, Q 256), 0.48 ms
// at the 67 TFLOP/s float32 rate, against 225 MB of inputs and outputs
// (67 µs at 3.35 TB/s).  Float32 because the model's scan is float32
// and TF32 tensor cores would round the products.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int T = 64;           // rows / columns of a score tile
constexpr int PMAX = 64;        // head dim the register tiles hold
constexpr int NMAX = 128;       // state size the register tiles hold
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* x;       // [B, S, H, P]
  const float* dt;      // [B, S, H]
  const float* a;       // [H]
  const float* bm;      // [B, S, N]
  const float* cm;      // [B, S, N]
  const float* state0;  // [B, H, P, N] or null
  float* y;             // [B, S, H, P]
  float* state;         // [B, H, P, N]
  int seqlen, heads, p, n, q;
};

__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(Args g) {
  extern __shared__ float smem[];
  const int P = g.p, N = g.n, Q = g.q, LN = N + 1;
  float* hs = smem;                 // [P][LN]  state
  float* cum = hs + P * LN;         // [Q]      in-chunk cumsum of a·dt
  float* dts = cum + Q;             // [Q]
  float* ct = dts + Q;              // [T][LN]  C row tile
  float* bt = ct + T * LN;          // [T][LN]  B column tile
  float* xt = bt + T * LN;          // [T][P]   x column tile
  float* st = xt + T * P;           // [T][T+1] score tile

  const int b = blockIdx.x / g.heads;
  const int h = blockIdx.x % g.heads;
  const int H = g.heads;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  const float a = g.a[h];
  const long long sh = (long long)H * P;   // x / y stride between steps

  const long long st_off = ((long long)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += THREADS)
    hs[(i / N) * LN + i % N] = g.state0 ? g.state0[st_off + i] : 0.f;

  for (int c0 = 0; c0 < g.seqlen; c0 += Q) {
    const long long s0 = (long long)b * g.seqlen + c0;   // first step
    __syncthreads();            // the previous chunk's state is written
    for (int i = tid; i < Q; i += THREADS)
      dts[i] = g.dt[(s0 + i) * H + h];
    __syncthreads();
    if (tid < 32) {             // warp scan of a·dt over the chunk
      const int per = (Q + 31) / 32, lo = lane * per;
      const int hi = min(lo + per, Q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += a * dts[i];
        cum[i] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += t;
      }
      const float prev = __shfl_up_sync(FULL, incl, 1);
      const float excl = lane ? prev : 0.f;
      for (int i = lo; i < hi; ++i) cum[i] += excl;
    }
    __syncthreads();

    for (int i0 = 0; i0 < Q; i0 += T) {
      const int ni = min(T, Q - i0);
      for (int i = tid; i < T * N; i += THREADS) {
        const int r = i / N, nn = i % N;
        ct[r * LN + nn] = r < ni ? g.cm[(s0 + i0 + r) * N + nn] : 0.f;
      }
      __syncthreads();

      // carried-state term: exp(cum_i) · C_i · hᵀ
      float yacc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[r][c] = 0.f;
#pragma unroll 8
      for (int nn = 0; nn < N; ++nn) {
        float cv[4], hv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ct[(ty + 16 * r) * LN + nn];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = tx + 16 * c;
          hv[c] = pp < P ? hs[pp * LN + nn] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) yacc[r][c] = fmaf(cv[r], hv[c],
                                                         yacc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const float e = i < ni ? expf(cum[i0 + i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[r][c] *= e;
      }

      for (int j0 = 0; j0 <= i0; j0 += T) {
        const int nj = min(T, Q - j0);
        __syncthreads();        // the previous column tile is consumed
        for (int i = tid; i < T * N; i += THREADS) {
          const int r = i / N, nn = i % N;
          bt[r * LN + nn] = r < nj ? g.bm[(s0 + j0 + r) * N + nn] : 0.f;
        }
        for (int i = tid; i < T * P; i += THREADS) {
          const int r = i / P, pp = i % P;
          xt[i] = r < nj ? g.x[(s0 + j0 + r) * sh + (long long)h * P + pp]
                         : 0.f;
        }
        __syncthreads();

        // score tile (C_i·B_j) exp(cum_i − cum_j) dt_j, j <= i
        float sacc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sacc[r][c] = 0.f;
#pragma unroll 8
        for (int nn = 0; nn < N; ++nn) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = ct[(ty + 16 * r) * LN + nn];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = bt[(tx + 16 * c) * LN + nn];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) sacc[r][c] = fmaf(cv[r], bv[c],
                                                           sacc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            const bool ok = j <= i && i < Q && j < Q;
            st[(ty + 16 * r) * (T + 1) + tx + 16 * c] =
                ok ? sacc[r][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
          }
        }
        __syncthreads();

        // y_i += Σ_j score_ij x_j
#pragma unroll 8
        for (int jj = 0; jj < T; ++jj) {
          float sv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) sv[r] = st[(ty + 16 * r) * (T + 1) + jj];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int pp = tx + 16 * c;
            xv[c] = pp < P ? xt[jj * P + pp] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) yacc[r][c] = fmaf(sv[r], xv[c],
                                                           yacc[r][c]);
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= ni) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = tx + 16 * c;
          if (pp < P)
            g.y[(s0 + i0 + i) * sh + (long long)h * P + pp] = yacc[r][c];
        }
      }
      __syncthreads();          // ct is rewritten by the next row tile
    }

    // state update: h' = exp(cum_last) h + Σ_j exp(cum_last − cum_j)
    // dt_j x_j ⊗ B_j; thread owns p = ty + 16·r, n = tx + 16·c
    const float last = cum[Q - 1];
    float hacc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) hacc[r][c] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += T) {
      const int nj = min(T, Q - j0);
      __syncthreads();
      for (int i = tid; i < T * N; i += THREADS) {
        const int r = i / N, nn = i % N;
        bt[r * LN + nn] = r < nj ? g.bm[(s0 + j0 + r) * N + nn] : 0.f;
      }
      for (int i = tid; i < T * P; i += THREADS) {
        const int r = i / P, pp = i % P;
        xt[i] = r < nj ? g.x[(s0 + j0 + r) * sh + (long long)h * P + pp]
                       : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < nj; ++jj) {
        const float w = expf(last - cum[j0 + jj]) * dts[j0 + jj];
        float xv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int pp = ty + 16 * r;
          xv[r] = pp < P ? w * xt[jj * P + pp] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int nn = tx + 16 * c;
          bv[c] = nn < N ? bt[jj * LN + nn] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) hacc[r][c] = fmaf(xv[r], bv[c],
                                                         hacc[r][c]);
      }
    }
    const float decay = expf(last);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pp = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int nn = tx + 16 * c;
        if (pp < P && nn < N)
          hs[pp * LN + nn] = hs[pp * LN + nn] * decay + hacc[r][c];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS)
    g.state[st_off + i] = hs[(i / N) * LN + i % N];
}

long long smem_bytes(int p, int n, int q) {
  return 4LL * ((long long)p * (n + 1) + 2LL * q + 2LL * T * (n + 1) +
                (long long)T * p + (long long)T * (T + 1));
}

}  // namespace

// x [B, S, H, P], dt [B, S, H], a [H], bm / cm [B, S, N], state0
// [B, H, P, N] or null (zeros) → y [B, S, H, P], state [B, H, P, N];
// all float32, contiguous.  S must be a multiple of chunk.
int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* bm, const void* cm, const void* state0,
                    void* y, void* state, int batch, int seqlen, int heads,
                    int p, int n, int chunk, long long stream) {
  if (batch <= 0 || heads <= 0) return (int)cudaSuccess;
  if (p <= 0 || p > PMAX || n <= 0 || n > NMAX || chunk <= 0 ||
      seqlen % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(p, n, chunk);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  Args g{(const float*)x, (const float*)dt, (const float*)a,
         (const float*)bm, (const float*)cm, (const float*)state0,
         (float*)y, (float*)state, seqlen, heads, p, n, chunk};
  ssd_scan_kernel<<<batch * heads, THREADS, (size_t)smem,
                    (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
