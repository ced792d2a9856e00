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
//         + exp(cum_i) C_i · h_in      (h_in: the state entering the chunk)
//   S_c = Σ_j exp(cum_last − cum_j) dt_j x_j ⊗ B_j
//   h_in[c + 1] = exp(cum_last) h_in[c] + S_c,  h_in[0] = state0 or 0.
// The mask j <= i is applied before the exp.  Everything is float32, as
// the model computes it, except cum: its float32 rounding dominates the
// float32 scan's error (cum reaches −10^3 at mamba2-130m, and
// cum_i − cum_j then loses most of its digits to cancellation), so the
// kernel keeps cum in float64 and forms each segment sum in float64
// before the float32 exp.  Unlike the TPU kernel, which keeps the state
// in scratch and drops it, this one takes an optional initial state and
// writes the final one: the model's prefill puts it in the decode cache.
//
// Design.  The TPU walks the chunks in order on one core.  Here the
// steps of ``ref.py::ssd_chunked`` are four launches, each of which
// fills the card (at the mamba2-130m prefill, B 8, S 2048, H 24, chunk
// 256: 640, 1,536, 1,536 and 6,144 blocks):
//   0. chunk_cb, one block per (batch, chunk, 64 × 64 tile on or below
//      the diagonal): C·Bᵀ within the chunk into a scratch.  B and C
//      are one group shared by every head, so the product is formed
//      once for all H heads (the TPU kernel forms it per head; it was
//      half of the scan's time here when each head formed its own);
//   1. chunk_states, one block per (batch·head, chunk): the in-chunk
//      cumsum of a·dt (a warp scan, written out for step 3) and S_c,
//      P × N, into a scratch;
//   2. pass_states, one block per (batch·head, 1,024 state elements):
//      walks the chunks, writes h_in[c] over S_c in the scratch and the
//      final state;
//   3. chunk_scan, one block per (batch·head, chunk, 64-row tile): the
//      carried-state term from C and h_in, then 64 × 32 score tiles
//      (C·Bᵀ from step 0 times exp(cum_i − cum_j)·dt_j) up to the
//      diagonal, each multiplied into the tile's 64 × P output kept in
//      registers; warps whose rows lie wholly above a tile skip it.
// The wrapper allocates the scratch.  C·Bᵀ and x tiles are staged with
// cp.async in a two-stage ring so the next tile is in flight while one
// is multiplied; shared-memory rows are padded (x's columns permuted) so
// the float4 reads of the inner loops have no bank conflicts.  Step 3
// takes 78 KB of shared memory at chunk 256 and step 1 51 KB, so two or
// more blocks share an SM.  dt·x and a·dt are formed on the fly, and
// B / C are read as [B, S, N] per batch — nothing is broadcast to H
// heads.
//
// What bounds it on the H100.  Operations, in float32: per chunk and
// (batch, head), Q(Q+1)·P for score·(dt·x), 2·Q·P·N for C·stateᵀ and
// 2·Q·P·N for the state update, and per chunk and batch Q(Q+1)·N for
// C·Bᵀ — 19.9 GFLOP at the mamba2-130m prefill (B 8, S 2048, H 24, P
// 64, N 128, Q 256), 0.30 ms at the 67 TFLOP/s float32 rate, against
// 225 MB of inputs and outputs (67 µs at 3.35 TB/s); the scratch adds
// 2 × 50 MB of chunk states and 17 MB of C·Bᵀ to the traffic.  Float32
// because the model's scan is float32 and TF32 tensor cores would round
// the products.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int PMAX = 64;        // head dim the register tiles hold
constexpr int NMAX = 128;       // state size the register tiles hold
constexpr int JT = 32;          // rows of a staged B / x tile
constexpr int IT = 64;          // rows of a chunk_scan output tile
constexpr int LN = NMAX + 4;    // padded row of a C / B / state tile
constexpr int LS = IT + 4;      // padded row of the transposed score
constexpr int LC = JT + 4;      // padded row of a staged C·Bᵀ tile

// chunk_scan's stage of the ring, and the region the stages share with
// the state entering the chunk
constexpr int STAGE = IT * LC + JT * PMAX;
constexpr int REGION = 2 * STAGE > PMAX * LN ? 2 * STAGE : PMAX * LN;

// row stride of the C·Bᵀ scratch: whole 16-byte pieces
__host__ __device__ inline int cb_stride(int q) { return (q + 3) & ~3; }
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
  float* chunk;         // [B, H, S / Q, P, N]: S_c, then h_in
  double* cum;          // [B, H, S]: in-chunk cumsum of a·dt
  float* cb;            // [B, S / Q, Q, QP]: C_i · B_j within a chunk
  int seqlen, heads, p, n, q;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  // not ok: the 16 bytes at dst are zero-filled and nothing is read
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ROWS rows of ``width`` floats (a multiple of 4) from a row-major
// matrix with row stride ``gstride`` into smem rows of SSTRIDE; rows at
// and past ``valid`` and columns at and past ``width`` of the COLS-wide
// smem row are zero-filled
template <int ROWS, int COLS, int SSTRIDE>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long gstride, int valid,
                                           int width, int tid) {
  constexpr int C4 = COLS / 4;
  static_assert(ROWS * C4 % THREADS == 0, "tile / thread mismatch");
#pragma unroll
  for (int k = 0; k < ROWS * C4 / THREADS; ++k) {
    const int i = tid + k * THREADS;
    const int r = i / C4, c = 4 * (i % C4);
    const bool ok = r < valid && c < width;
    cp_async16(dst + r * SSTRIDE + c,
               src + (ok ? r * gstride + c : 0), ok);
  }
}

__device__ __forceinline__ float dot4(float4 u, float4 v, float acc) {
  acc = fmaf(u.x, v.x, acc);
  acc = fmaf(u.y, v.y, acc);
  acc = fmaf(u.z, v.z, acc);
  return fmaf(u.w, v.w, acc);
}

// ---------------------------------------------------------------------
// 0. C·Bᵀ within each chunk, once for all heads
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) chunk_cb(Args g) {
  extern __shared__ float4 smem4[];
  float* ct = reinterpret_cast<float*>(smem4);   // [IT][LN] C rows
  float* bt = ct + IT * LN;                      // [IT][LN] B rows
  const int N = g.n, Q = g.q, qs = cb_stride(Q);
  const int nt = (Q + IT - 1) / IT;
  const int ntri = nt * (nt + 1) / 2;            // tiles on and below
  const int tri = blockIdx.x % ntri;             // the diagonal
  const long long bc = blockIdx.x / ntri;        // batch · chunks + chunk
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= tri) ++it;
  const int i0 = it * IT, j0 = (tri - it * (it + 1) / 2) * IT;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long s0 = bc * Q;                   // first step of the chunk
  stage_rows<IT, NMAX, LN>(ct, g.cm + (s0 + i0) * N, N, Q - i0, N, tid);
  stage_rows<IT, NMAX, LN>(bt, g.bm + (s0 + j0) * N, N, Q - j0, N, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this thread owns rows 4·ty + r and columns tx + 16·cc
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
#pragma unroll 2
  for (int n4 = 0; n4 < N / 4; ++n4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cv[r] = *reinterpret_cast<const float4*>(ct + (4 * ty + r) * LN +
                                               4 * n4);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      bv[cc] = *reinterpret_cast<const float4*>(bt + (tx + 16 * cc) * LN +
                                                4 * n4);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[r][cc] = dot4(cv[r], bv[cc],
                                                       acc[r][cc]);
  }
  // columns in [Q, qs) come out 0 (their B rows were zero-filled)
  float* out = g.cb + bc * Q * qs;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int j = j0 + tx + 16 * cc;
      if (i < Q && j < qs) out[(long long)i * qs + j] = acc[r][cc];
    }
  }
}

// ---------------------------------------------------------------------
// 1. chunk states
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) chunk_states(Args g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = g.p, N = g.n, Q = g.q, H = g.heads;
  const int nc = g.seqlen / Q;
  float* stage = smem;          // 2 × {x [JT][PMAX], B [JT][NMAX]}
  float* w = stage + 2 * JT * (PMAX + NMAX);     // [Q]: dt, then weights
  double* cum = reinterpret_cast<double*>(w + Q + (Q & 1));   // [Q]

  const int bh = blockIdx.x / nc, c = blockIdx.x % nc;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  const long long s0 = (long long)b * g.seqlen + (long long)c * Q;
  const float* xg = g.x + (s0 * H + h) * P;  // row stride H·P
  const float* bg = g.bm + s0 * N;           // row stride N
  const int nt = (Q + JT - 1) / JT;

  auto prefetch = [&](int t) {
    float* st = stage + (t & 1) * JT * (PMAX + NMAX);
    const int rows = min(JT, Q - t * JT);
    stage_rows<JT, PMAX, PMAX>(st, xg + (long long)t * JT * H * P,
                               (long long)H * P, rows, P, tid);
    stage_rows<JT, NMAX, NMAX>(st + JT * PMAX, bg + (long long)t * JT * N,
                               N, rows, N, tid);
    cp_async_commit();
  };
  prefetch(0);

  for (int i = tid; i < Q; i += THREADS) w[i] = g.dt[(s0 + i) * H + h];
  __syncthreads();
  if (tid < 32) {               // warp scan of a·dt over the chunk
    const double a = g.a[h];
    const int per = (Q + 31) / 32, lo = lane * per;
    const int hi = min(lo + per, Q);
    double run = 0.0;
    for (int i = lo; i < hi; ++i) {
      run += a * w[i];
      cum[i] = run;
    }
    double incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const double t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += t;
    }
    const double prev = __shfl_up_sync(FULL, incl, 1);
    const double excl = lane ? prev : 0.0;
    for (int i = lo; i < hi; ++i) cum[i] += excl;
  }
  __syncthreads();
  double* cum_g = g.cum + (long long)bh * g.seqlen + (long long)c * Q;
  const double last = cum[Q - 1];
  for (int i = tid; i < Q; i += THREADS) {
    cum_g[i] = cum[i];
    w[i] = expf((float)(last - cum[i])) * w[i];
  }

  // S_c[p][n]: this thread owns p = 4·ty + r and n = 4·tx + e, 64 + 4·tx
  // + e
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      prefetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xt = stage + (t & 1) * JT * (PMAX + NMAX);
    const float* bt = xt + JT * PMAX;
    const int rows = min(JT, Q - t * JT);
#pragma unroll 4
    for (int j = 0; j < rows; ++j) {
      const float wj = w[t * JT + j];
      const float4 xv = *reinterpret_cast<const float4*>(xt + j * PMAX +
                                                         4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bt + j * NMAX +
                                                         4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bt + j * NMAX +
                                                         64 + 4 * tx);
      const float xr[4] = {wj * xv.x, wj * xv.y, wj * xv.z, wj * xv.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(xr[r], bv[e],
                                                     acc[r][e]);
    }
    __syncthreads();            // the stage is refilled next iteration
  }

  float* out = g.chunk + ((long long)bh * nc + c) * P * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int pp = 4 * ty + r;
    if (pp >= P) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nn = 64 * half + 4 * tx;
      if (nn < N)
        *reinterpret_cast<float4*>(out + pp * N + nn) = make_float4(
            acc[r][4 * half], acc[r][4 * half + 1], acc[r][4 * half + 2],
            acc[r][4 * half + 3]);
    }
  }
}

// ---------------------------------------------------------------------
// 2. state passing
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) pass_states(Args g) {
  const int pn = g.p * g.n;                  // a multiple of 4
  const int per_bh = (pn / 4 + THREADS - 1) / THREADS;
  const int bh = blockIdx.x / per_bh;
  const int e = 4 * ((blockIdx.x % per_bh) * THREADS + threadIdx.x);
  if (e >= pn) return;
  const int nc = g.seqlen / g.q;
  const double* cum_last = g.cum + (long long)bh * g.seqlen + g.q - 1;
  float4* sc = reinterpret_cast<float4*>(g.chunk + (long long)bh * nc * pn +
                                         e);
  const int step = pn / 4;                   // float4s between chunks
  float4 h = g.state0 ? *reinterpret_cast<const float4*>(
                            g.state0 + (long long)bh * pn + e)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 cur = nc > 0 ? sc[0] : h;
  for (int c = 0; c < nc; ++c) {
    const float4 nxt = c + 1 < nc ? sc[(long long)(c + 1) * step] : cur;
    const float d = expf((float)cum_last[(long long)c * g.q]);
    sc[(long long)c * step] = h;              // h_in[c] over S_c
    h = make_float4(fmaf(d, h.x, cur.x), fmaf(d, h.y, cur.y),
                    fmaf(d, h.z, cur.z), fmaf(d, h.w, cur.w));
    cur = nxt;
  }
  *reinterpret_cast<float4*>(g.state + (long long)bh * pn + e) = h;
}

// ---------------------------------------------------------------------
// 3. chunk scan
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 2) chunk_scan(Args g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = g.p, N = g.n, Q = g.q, H = g.heads;
  const int nc = g.seqlen / Q;
  const int n_it = (Q + IT - 1) / IT;
  float* ct = smem;                   // [IT][LN]   C row tile
  float* region = ct + IT * LN;       // h_in [PMAX][LN], then 2 stages of
                                      // {C·Bᵀ [IT][LC], x [JT][PMAX]}
  float* st = region + REGION;        // [JT][LS]   score tile, transposed
  float* dts = st + JT * LS;          // [Q]
  double* cum = reinterpret_cast<double*>(dts + Q + (Q & 1));   // [Q]

  const int it = blockIdx.x % n_it;
  const int c = (blockIdx.x / n_it) % nc;
  const int bh = blockIdx.x / (n_it * nc);
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int i0 = it * IT;
  const int ni = min(IT, Q - i0);
  const long long s0 = (long long)b * g.seqlen + (long long)c * Q;
  const float* xg = g.x + (s0 * H + h) * P;  // row stride H·P
  const int qs = cb_stride(Q);
  const float* cbg = g.cb + ((long long)b * nc + c) * Q * qs +
                     (long long)i0 * qs;      // row stride qs

  stage_rows<IT, NMAX, LN>(ct, g.cm + (s0 + i0) * N, N, ni, N, tid);
  stage_rows<PMAX, NMAX, LN>(region,
                             g.chunk + ((long long)bh * nc + c) * P * N, N,
                             P, N, tid);
  cp_async_commit();
  const double* cum_g = g.cum + (long long)bh * g.seqlen +
                        (long long)c * Q;
  for (int i = tid; i < Q; i += THREADS) {
    cum[i] = cum_g[i];
    dts[i] = g.dt[(s0 + i) * H + h];
  }
  cp_async_wait<0>();
  __syncthreads();

  // this thread owns rows i = 4·ty + r and p = tx + 16·cc
  // carried-state term: exp(cum_i) · C_i · h_inᵀ
  float yacc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) yacc[r][cc] = 0.f;
#pragma unroll 2
  for (int n4 = 0; n4 < N / 4; ++n4) {
    float4 cv[4], hv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cv[r] = *reinterpret_cast<const float4*>(ct + (4 * ty + r) * LN +
                                               4 * n4);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      hv[cc] = *reinterpret_cast<const float4*>(region +
                                                (tx + 16 * cc) * LN + 4 * n4);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) yacc[r][cc] = dot4(cv[r], hv[cc],
                                                        yacc[r][cc]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
    const float e = i < ni ? expf((float)cum[min(i0 + i, Q - 1)]) : 0.f;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) yacc[r][cc] *= e;
  }
  __syncthreads();              // h_in's region becomes the stages

  const int nt = (i0 + ni + JT - 1) / JT;     // column tiles to the diagonal
  auto prefetch = [&](int t) {
    float* sb = region + (t & 1) * STAGE;
    const int rows = min(JT, Q - t * JT);
    stage_rows<IT, JT, LC>(sb, cbg + t * JT, qs, ni, qs - t * JT, tid);
    // x with its columns permuted: smem column 4·(p % 16) + p / 16
    // holds p, so a thread's four p = tx + 16·cc are one float4
    float* sx = sb + IT * LC;
    const float* gx = xg + (long long)t * JT * H * P;
#pragma unroll
    for (int k = 0; k < JT * PMAX / THREADS; ++k) {
      const int i = tid + k * THREADS;
      const int r = i / PMAX, pp = i % PMAX;
      const bool ok = r < rows && pp < P;
      cp_async4(sx + r * PMAX + 4 * (pp & 15) + (pp >> 4),
                gx + (ok ? (long long)r * H * P + pp : 0), ok);
    }
    cp_async_commit();
  };
  prefetch(0);
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      prefetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cbt = region + (t & 1) * STAGE;
    const float* xt = cbt + IT * LC;
    const int j0 = t * JT;
    // whole warps whose rows all lie above this tile's columns (the
    // upper half of the diagonal block) have nothing to add
    const bool active = i0 + 4 * ty + 3 >= j0;

    // score (C_i·B_j) exp(cum_i − cum_j) dt_j for j <= i; this thread
    // owns rows 4·ty + r and columns tx + 16·cc
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int j = min(j0 + tx + 16 * cc, Q - 1);   // clamped: masked
      const bool jok = j0 + tx + 16 * cc < Q;
      float v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = min(i0 + 4 * ty + r, Q - 1);
        const bool ok = jok && j <= i && i0 + 4 * ty + r < Q;
        v[r] = ok ? cbt[(4 * ty + r) * LC + tx + 16 * cc] *
                        expf((float)(cum[i] - cum[j])) * dts[j]
                  : 0.f;
      }
      *reinterpret_cast<float4*>(st + (tx + 16 * cc) * LS + 4 * ty) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();

    // y_i += Σ_j score_ij x_j
#pragma unroll 8
    for (int jj = 0; jj < (active ? JT : 0); ++jj) {
      const float4 sv = *reinterpret_cast<const float4*>(st + jj * LS +
                                                         4 * ty);
      const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
      const float4 x4 = *reinterpret_cast<const float4*>(xt + jj * PMAX +
                                                         4 * tx);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) yacc[r][cc] = fmaf(s4[r], xv[cc],
                                                          yacc[r][cc]);
    }
    __syncthreads();            // st and the stage are rewritten next
  }

  float* yg = g.y + ((s0 + i0) * H + h) * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
    if (i >= ni) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int pp = tx + 16 * cc;
      if (pp < P) yg[(long long)i * H * P + pp] = yacc[r][cc];
    }
  }
}

long long states_smem(int q) {
  return 4LL * (2 * JT * (PMAX + NMAX) + q + (q & 1)) + 8LL * q;
}

long long scan_smem(int q) {
  return 4LL * (IT * LN + REGION + JT * LS + q + (q & 1)) + 8LL * q;
}

}  // namespace

// x [B, S, H, P], dt [B, S, H], a [H], bm / cm [B, S, N], state0
// [B, H, P, N] or null (zeros) → y [B, S, H, P], state [B, H, P, N];
// scratch chunk [B, H, S / chunk, P, N], cum [B, H, S] (float64) and
// cb [B, S / chunk, chunk, ssd_scan_cb_stride(chunk)]; all float32 but
// cum, contiguous, 16-byte aligned.  S must be a multiple of chunk, P
// and N multiples of 4.
int ssd_scan_cb_stride(int chunk) { return cb_stride(chunk); }

int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* bm, const void* cm, const void* state0,
                    void* y, void* state, void* chunk_scratch,
                    void* cum_scratch, void* cb_scratch, int batch,
                    int seqlen, int heads, int p, int n, int chunk,
                    long long stream) {
  if (batch <= 0 || heads <= 0) return (int)cudaSuccess;
  if (p <= 0 || p > PMAX || p % 4 || n <= 0 || n > NMAX || n % 4 ||
      chunk <= 0 || seqlen % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const long long smem1 = states_smem(chunk), smem3 = scan_smem(chunk);
  if (smem3 > 227 * 1024 || smem1 > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const int smem0 = 2 * IT * LN * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_cb, cudaFuncAttributeMaxDynamicSharedMemorySize, smem0);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      chunk_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      chunk_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return (int)err;
  Args g{(const float*)x, (const float*)dt, (const float*)a,
         (const float*)bm, (const float*)cm, (const float*)state0,
         (float*)y, (float*)state, (float*)chunk_scratch,
         (double*)cum_scratch, (float*)cb_scratch, seqlen, heads, p, n,
         chunk};
  const cudaStream_t s = (cudaStream_t)stream;
  const int bh = batch * heads;
  const int nc = seqlen / chunk;
  if (nc > 0) {
    const int nt = (chunk + IT - 1) / IT;
    chunk_cb<<<batch * nc * (nt * (nt + 1) / 2), THREADS, smem0, s>>>(g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    chunk_states<<<bh * nc, THREADS, (size_t)smem1, s>>>(g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int per_bh = (p * n / 4 + THREADS - 1) / THREADS;
  pass_states<<<bh * per_bh, THREADS, 0, s>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return (int)err;
  chunk_scan<<<bh * nc * ((chunk + IT - 1) / IT), THREADS, (size_t)smem3,
               s>>>(g);
  return (int)cudaGetLastError();
}
