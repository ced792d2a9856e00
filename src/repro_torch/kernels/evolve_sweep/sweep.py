"""Wrapper of the forward degree-sweep kernel (``sweep.cu``): bucket
the sweep delta's edge-op endpoint events by node tile in plain
PyTorch, launch over a batch of sweep queries (the kernel cuts each
tile's run of events into chunks itself).  The hybrid plan's backward
series (``degree_series``) runs the same kernel code (``series.cuh``)
on the same glue and buffers."""
from __future__ import annotations

import torch

from repro_torch.core.delta import ADD_EDGE, Delta
from repro_torch.kernels import build
from repro_torch.kernels.evolve_sweep.ref import (sweep_series_ref,
                                                  sweep_work_ref)

TILE = 256     # == TN in series.cuh
# Most events one block walks.  The heaviest node tile of the edge
# session's sweep holds 142,820 events, the mean 4,786: chunks of 8192
# keep 470 of its 512 tiles whole (one pass, no combining) and cut the
# rest into 79 more blocks.  At most 32767: series.cuh packs two
# samples' nets into one 32-bit word, whose halves stay exact only while
# a block adds at most 32767 signs to each.
CHUNK = 8192


def bucket_sweep_events(delta: Delta, n: int, t_lo, t_last=None,
                        row0: int = 0):
    """Events of the edge ops with t in (t_lo, t_last] (t > t_lo where
    ``t_last`` is None), one per endpoint in nodes [row0, row0 + n), as
    i32 ``[t, local node·2 + (op == addEdge)]`` ordered by node tile of
    the block (first endpoints, then second endpoints), node ids local
    to ``row0``.  The bucket is computed per query inside the kernel,
    so one bucketing serves a whole sweep group (pass the group's union
    window).  ``row0`` cuts a node block (the JAX package's
    ``bucket_node_events(row0=, n_valid=)``): ``n`` is the block's own,
    unpadded node count, so no later block's events reach its last
    tile.  Returns (events i32[W', 2], tile_start i32[T + 1])."""
    keep = (delta.valid_mask() & delta.is_edge_op()
            & (delta.t > int(t_lo)))
    if t_last is not None:
        keep &= delta.t <= int(t_last)
    idx = torch.nonzero(keep).flatten()
    add = (delta.op[idx] == ADD_EDGE).to(torch.int64)
    t = delta.t[idx].to(torch.int64)
    nodes = torch.cat([delta.u[idx], delta.v[idx]]).to(torch.int64) - row0
    inb = (nodes >= 0) & (nodes < n)
    nodes = nodes[inb]
    t = torch.cat([t, t])[inb]
    add = torch.cat([add, add])[inb]
    tiles = -(-n // TILE)
    tile_id = nodes // TILE
    order = torch.argsort(tile_id, stable=True)
    tile_start = torch.searchsorted(
        tile_id[order], torch.arange(tiles + 1, device=nodes.device))
    events = torch.stack([t, (nodes % TILE) * 2 + add], 1)
    return (events[order].to(torch.int32).contiguous(),
            tile_start.to(torch.int32))


def sweep_work(tile_start: torch.Tensor, n_events: int) -> torch.Tensor:
    """The sweep kernel's work list for ``n_events`` bucketed events, as
    ``sweep_work_ref`` gives it at CHUNK (which see).  CPU tensors run
    the plain version; CUDA tensors launch a kernel that writes the
    rows that ``sweep_series``'s blocks find for themselves, with the
    same code (so those rows can be held against the plain ones; the
    main path never calls this)."""
    if tile_start.device.type == "cpu":
        return sweep_work_ref(tile_start, n_events, CHUNK)
    build.check_cuda("tile_start", tile_start, torch.int32, 1)
    rows = torch.empty((tile_start.numel() - 1 + n_events // CHUNK, 4),
                       dtype=torch.int32, device=tile_start.device)
    build.ext().sweep_work(tile_start, rows, CHUNK,
                           build.stream_handle(tile_start.device))
    return rows


# The counters of the series launches, one buffer per device and
# stream: zero at every launch's start and end (series.cuh), so zeroed
# only when allocated.
_SYNC: dict[tuple[int, int], torch.Tensor] = {}


def series_scratch(q: int, n: int, n_events: int, num_buckets: int,
                   device):
    """What one series launch (``sweep.cu`` or ``degree_series.cu``)
    needs besides its operands: the global nets, one a (query, tile),
    which the kernel zeroes where it uses them (the split tiles', or
    every tile's where the packed shared net does not fit); their zero
    counters, three a net; and the grid's rows, as many as ``n_events``
    events can need.  Returns (nets, sync, rows)."""
    tiles = -(-n // TILE)
    nets = torch.empty(q * tiles * num_buckets * TILE, dtype=torch.int32,
                       device=device)
    key = (device.index, build.stream_handle(device))
    sync = _SYNC.get(key)
    if sync is None or sync.numel() < 3 * q * tiles:
        sync = torch.zeros(3 * q * tiles, dtype=torch.int32, device=device)
        _SYNC[key] = sync
    return nets, sync, tiles + n_events // CHUNK


def check_series_operands(base: torch.Tensor, events: torch.Tensor,
                          tile_start: torch.Tensor, num_buckets: int,
                          stride: int = 1) -> None:
    """What both series launches refuse before they run."""
    build.check_cuda("events", events, torch.int32, 2)
    build.check_cuda("tile_start", tile_start, torch.int32, 1)
    if (events.shape[1] != 2
            or tile_start.numel() != -(-base.shape[-1] // TILE) + 1):
        raise ValueError("events/tile_start do not match the tiling")
    if num_buckets < 1 or stride < 1:
        raise ValueError("num_buckets and stride must be >= 1")


def sweep_series(deg0: torch.Tensor, events: torch.Tensor,
                 tile_start: torch.Tensor, t_lo: torch.Tensor,
                 t_last: torch.Tensor, stride: int,
                 num_buckets: int) -> torch.Tensor:
    """i32[Q, B, N]: every node's degree at each sample
    t_lo[q] + b·stride of Q sweeps starting from degrees deg0 i32[Q, N].
    CPU tensors run the plain version; CUDA tensors launch the kernel,
    each of whose blocks finds its own row of the work list
    (``sweep_work``) on the card."""
    if deg0.device.type == "cpu":
        return sweep_series_ref(deg0, events, tile_start, t_lo, t_last,
                                stride, num_buckets, TILE)
    q, n = deg0.shape
    build.check_cuda("deg0", deg0, torch.int32, 2)
    check_series_operands(deg0, events, tile_start, num_buckets, stride)
    build.check_cuda("t_lo", t_lo, torch.int32, 1)
    build.check_cuda("t_last", t_last, torch.int32, 1)
    if t_lo.numel() != q or t_last.numel() != q:
        raise ValueError("t_lo/t_last need one entry per query")
    build.check_same_device(deg0=deg0, events=events, tile_start=tile_start,
                            t_lo=t_lo, t_last=t_last)
    nets, sync, rows = series_scratch(q, n, events.shape[0], num_buckets,
                                      deg0.device)
    out = torch.empty((q, num_buckets, n), dtype=torch.int32,
                      device=deg0.device)
    build.ext().sweep_series(deg0, events, tile_start, t_lo, t_last, out,
                             nets, sync, num_buckets, stride, CHUNK, rows,
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
