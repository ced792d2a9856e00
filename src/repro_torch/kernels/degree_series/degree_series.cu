// Hybrid-plan degree time series: every node's degree at each time unit
// t_k + b, b in [0, B), from the current degrees and the edge ops after
// t_k (paper §3.2.3, evaluated for all nodes at once) — the backward
// twin of the forward degree sweep (../evolve_sweep/sweep.cu).
//
// Replaces: repro/kernels/degree_series/degree_series.py::
// degree_series_tiles (Pallas body ``_kernel``; glue
// ``ops.py::bucket_node_events``).
//
// What it computes.  Each edge op after t_k (t > t_k) gives a signed
// event (+1 add, -1 remove) to both endpoints at bucket
// min(t - t_k, B) — bucket B is the virtual tail for ops past the
// window.  Then
//   deg(v, t_k + b) = deg_cur(v) - sum_{b' > b} net[b', v].
// Written with k = b' - 1 in [0, B), that is series.cuh's backward
// series at stride 1: out[b] = deg_cur - sum_{k >= b} net[k].
//
// What bounds it on the H100.  Bytes: the B·N·4-byte int32 output, N·4
// of current degrees and 8 bytes per event, each read once.  At
// N = 131072, B = 16 and 1.24 M events that is 18.8 MB, 5.6 µs at
// 3.35 TB/s.  The events are skewed twice: preferential attachment
// puts the hubs in node tile 0 (60,714 events, 25× the mean), and at
// that shape all but 0.03 % of them land in the tail bucket B, where a
// hub's events hit one address.
//
// Design: B4's (sweep.cu), run backward, from the one copy of the code
// in ../evolve_sweep/series.cuh.  The glue is the sweep's
// bucket_sweep_events with no upper time bound: events {t, local
// node·2 + is_add} by 256-node tile; the bucket is computed in the
// kernel, only for events that passed the t > t_k test (the T_PAD
// guard, by construction).  One kernel: each block finds its own row
// of the work list, which cuts each tile's events into chunks of at
// most CHUNK (8,192; tile 0 becomes 8 blocks at the main shape); a
// block adds its events into a packed shared-memory net (two buckets a
// word: B = 16 takes 8 KB), a single-chunk tile runs the reverse
// running sum from deg_cur, and split tiles combine through global
// atomics and the last block's reverse running sum.  B > 452 keeps
// every tile's net in global memory, as the sweep does.
// Launch: one kernel, 663 blocks at the main shape (529 real; tile 0's
// seven extra chunks first), 256 threads, at most 64 registers, 8 KB of
// dynamic shared memory at B = 16.

#include "../evolve_sweep/series.cuh"

// One series (a single query): t_k as the window's lower end, no upper
// end; the same arguments as sweep_series_launch otherwise.
int degree_series_launch(const void* deg_cur, const void* events,
                         const void* tile_start, int t_k, void* out,
                         void* nets, void* sync, int n, int nb, int chunk,
                         int tiles, int n_rows, long long stream) {
  return series_launch<true>(deg_cur, events, tile_start, nullptr, nullptr,
                             t_k, 0x7fffffff, out, nets, sync, n, nb, 1,
                             chunk, tiles, n_rows, 1, stream);
}
