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
// Design (the code is series.cuh's, shared with degree_series.cu, the
// same series run backward; this file instantiates it forward).  The
// glue (sweep.py) buckets every edge op of the sweep delta by 256-node
// tile once, as {t, local node·2 + is_add}; the window test and the
// sample index are computed per query inside the kernel, so one
// bucketing serves the whole group.  The T_PAD overflow guard of the
// TPU wrapper (sweep.py: padding rows pinned to sample 1) is kept by
// construction: padding ops are never events, and the window test runs
// before any arithmetic on t.  One kernel: each block first finds its
// own row of the work list, which cuts each tile's run of events into
// chunks of at most CHUNK (sweep.py) events — a tile's first chunk read
// off tile_start, a split tile's other chunks by a scan of the tiles'
// chunk counts (ref.py::sweep_work_ref is the plain version); the host
// reads nothing back, the grid has as many rows as the event count can
// need and the surplus rows' blocks exit once they know it.
// The grid walks (row, query), so no block walks more than CHUNK
// events, however skewed the tiles.  A block:
//   1. adds its events' signs into a B × 256 net in shared memory,
//      packed two samples to a 32-bit word (low 16 bits sample 2i, high
//      16 bits sample 2i+1: a word's halves are exact while each stays
//      within ±32767, which CHUNK <= 32767 guarantees), so
//      B = 64 takes 32 KB;
//   2. a tile of one chunk (the great majority) then runs the forward
//      running sum from deg0, one thread per node, and writes its
//      output rows with streaming stores;
//   3. a tile of several chunks adds the non-zero entries of its
//      partial net into an int32 net of the tile in global scratch
//      (atomicAdd), fences, and adds its event count to the tile's
//      counter; the block that brings it to the tile's count finishes
//      last and runs the running sum over the global net, eight loads
//      in flight.  The net is zeroed by the tile's first block to
//      arrive, which flags it; the others wait for the flag only when
//      they come to add into it, so no kernel zeroes anything before
//      the series.  Atomics were chosen over a cluster reduction through
//      distributed shared memory because the chunks of one tile number
//      up to ceil(events / CHUNK) — 18 for the heaviest tile at the
//      main shape — past a cluster's 8 (16 non-portable) blocks, and a
//      cluster size is fixed per launch.
// Where the packed net would not fit in 226 KB (B > 452), every tile's
// net lives in global scratch and the events are added there directly;
// multi-chunk tiles count as above.
// Launch: one kernel on a (row, query) grid, 811 rows at the main shape
// (591 real), the split tiles' extra chunks first, not persistent, 256
// threads, sixteen events in flight a thread, at most 64 registers so
// that four blocks fit an SM (thirty-two events took 94 and left two),
// ceil(B/2)·1 KB of dynamic shared memory — 32 KB at B = 64 (ptxas's
// report: ``chip_smoke.py --first-call``).

#include "series.cuh"

int sweep_work_launch(const void* tile_start, void* work, int tiles,
                      int n_rows, int chunk, long long stream) {
  return work_launch(tile_start, work, tiles, n_rows, chunk, stream);
}

int sweep_series_launch(const void* deg0, const void* events,
                        const void* tile_start, const void* t_lo,
                        const void* t_last, void* out, void* nets,
                        void* sync, int n, int nb, int stride, int chunk,
                        int tiles, int n_rows, int n_queries,
                        long long stream) {
  return series_launch<false>(deg0, events, tile_start, t_lo, t_last, 0, 0,
                              out, nets, sync, n, nb, stride, chunk, tiles,
                              n_rows, n_queries, stream);
}
