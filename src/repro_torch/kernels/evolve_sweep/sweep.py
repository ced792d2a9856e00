"""Wrapper of the forward degree-sweep kernel (``sweep.cu``): bucket
the sweep delta's edge-op endpoint events by node tile in plain
PyTorch, launch over a batch of sweep queries (the kernel cuts each
tile's run of events into chunks itself)."""
from __future__ import annotations

import torch

from repro_torch.core.delta import ADD_EDGE, Delta
from repro_torch.kernels import build
from repro_torch.kernels.evolve_sweep.ref import (sweep_series_ref,
                                                  sweep_work_ref)

TILE = 256     # == TN in sweep.cu
# Most events one block walks.  The heaviest node tile of the edge
# session's sweep holds 142,820 events, the mean 4,786: chunks of 8192
# keep 470 of its 512 tiles whole (one pass, no combining) and cut the
# rest into 79 more blocks.  At most 32767: sweep.cu packs two samples'
# nets into one 32-bit word, whose halves stay exact only while a block
# adds at most 32767 signs to each.
CHUNK = 8192


def bucket_sweep_events(delta: Delta, n: int, t_lo, t_last):
    """Events of the edge ops with t in (t_lo, t_last], one per
    endpoint, as i32 ``[t, local node·2 + (op == addEdge)]`` ordered by
    node tile (first endpoints, then second endpoints).  The sample
    index is computed per query inside the kernel, so one bucketing
    serves a whole sweep group (pass the group's union window).
    Returns (events i32[2W, 2], tile_start i32[T + 1])."""
    keep = (delta.valid_mask() & delta.is_edge_op()
            & (delta.t > int(t_lo)) & (delta.t <= int(t_last))
            & (delta.u < n) & (delta.v < n))
    idx = torch.nonzero(keep).flatten()
    add = (delta.op[idx] == ADD_EDGE).to(torch.int64)
    t = delta.t[idx].to(torch.int64)
    nodes = torch.cat([delta.u[idx], delta.v[idx]]).to(torch.int64)
    tiles = -(-n // TILE)
    tile_id = nodes // TILE
    order = torch.argsort(tile_id, stable=True)
    tile_start = torch.searchsorted(
        tile_id[order], torch.arange(tiles + 1, device=nodes.device))
    events = torch.stack([torch.cat([t, t]),
                          (nodes % TILE) * 2 + torch.cat([add, add])], 1)
    return (events[order].to(torch.int32).contiguous(),
            tile_start.to(torch.int32))


def sweep_work(tile_start: torch.Tensor, n_events: int) -> torch.Tensor:
    """The sweep kernel's work list for ``n_events`` bucketed events, as
    ``sweep_work_ref`` gives it at CHUNK (which see).  CPU tensors run
    the plain version; CUDA tensors launch the work kernel that
    ``sweep_series`` runs before its sweep (so its rows can be held
    against the plain ones; the main path never calls this)."""
    if tile_start.device.type == "cpu":
        return sweep_work_ref(tile_start, n_events, CHUNK)
    build.check_cuda("tile_start", tile_start, torch.int32, 1)
    rows = torch.empty((tile_start.numel() - 1 + n_events // CHUNK, 4),
                       dtype=torch.int32, device=tile_start.device)
    build.ext().sweep_work(tile_start, rows, CHUNK,
                           build.stream_handle(tile_start.device))
    return rows


def sweep_series(deg0: torch.Tensor, events: torch.Tensor,
                 tile_start: torch.Tensor, t_lo: torch.Tensor,
                 t_last: torch.Tensor, stride: int,
                 num_buckets: int) -> torch.Tensor:
    """i32[Q, B, N]: every node's degree at each sample
    t_lo[q] + b·stride of Q sweeps starting from degrees deg0 i32[Q, N].
    CPU tensors run the plain version; CUDA tensors launch the kernel,
    which first derives its work list (``sweep_work``) on the card."""
    if deg0.device.type == "cpu":
        return sweep_series_ref(deg0, events, tile_start, t_lo, t_last,
                                stride, num_buckets, TILE)
    q, n = deg0.shape
    build.check_cuda("deg0", deg0, torch.int32, 2)
    build.check_cuda("events", events, torch.int32, 2)
    build.check_cuda("tile_start", tile_start, torch.int32, 1)
    build.check_cuda("t_lo", t_lo, torch.int32, 1)
    build.check_cuda("t_last", t_last, torch.int32, 1)
    tiles = -(-n // TILE)
    if events.shape[1] != 2 or tile_start.numel() != tiles + 1:
        raise ValueError("events/tile_start do not match the tiling")
    if t_lo.numel() != q or t_last.numel() != q:
        raise ValueError("t_lo/t_last need one entry per query")
    if num_buckets < 1 or stride < 1:
        raise ValueError("num_buckets and stride must be >= 1")
    build.check_same_device(deg0=deg0, events=events, tile_start=tile_start,
                            t_lo=t_lo, t_last=t_last)
    n_events = events.shape[0]
    work = torch.empty((tiles + n_events // CHUNK, 4), dtype=torch.int32,
                       device=deg0.device)
    ext = build.ext()
    # a global net per split tile (a split tile holds more than CHUNK
    # events), or per tile where the shared one does not fit; then one
    # counter each.  The kernel zeroes the ones it uses.
    regions = (min(tiles, n_events // (CHUNK + 1))
               if ext.sweep_series_smem_bytes(num_buckets) else tiles)
    scratch = torch.empty(q * regions * (num_buckets * TILE + 1),
                          dtype=torch.int32, device=deg0.device)
    out = torch.empty((q, num_buckets, n), dtype=torch.int32,
                      device=deg0.device)
    ext.sweep_series(deg0, events, tile_start, work, t_lo, t_last, out,
                     scratch, num_buckets, stride, CHUNK, regions,
                     build.stream_handle(deg0.device))
    build.LAUNCHES["sweep_series"] += 1
    return out


def sweep_degree_series(deg0: torch.Tensor, delta: Delta, t_lo, t_last,
                        stride: int, num_buckets: int) -> torch.Tensor:
    """i32[B, N]: one sweep's degree series (row b = degrees at
    t_lo + b·stride; rows past the last real sample repeat it)."""
    events, tile_start = bucket_sweep_events(delta, deg0.shape[0], t_lo,
                                             t_last)
    dev = deg0.device
    lo = torch.tensor([int(t_lo)], dtype=torch.int32, device=dev)
    last = torch.tensor([int(t_last)], dtype=torch.int32, device=dev)
    return sweep_series(deg0.reshape(1, -1).contiguous(), events,
                        tile_start, lo, last, stride, num_buckets)[0]
