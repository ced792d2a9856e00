"""Wrapper of the degree-series kernel (``degree_series.cu``): bucket
edge-op endpoint events by node tile in plain PyTorch, launch."""
from __future__ import annotations

import torch

from repro_torch.core.delta import ADD_EDGE, Delta
from repro_torch.kernels import build
from repro_torch.kernels.degree_series.ref import degree_series_ref

TILE = 256   # == TN in degree_series.cu


def bucket_node_events(delta: Delta, n: int, t_k, num_buckets: int):
    """Events of the in-suffix edge ops (t > t_k), one per endpoint, as
    i32 ``[local node, bucket, sign, 0]`` with bucket clip(t − t_k, 0,
    B), ordered by node tile (all first endpoints, then all second
    endpoints, as ``repro``'s ``bucket_node_events``).  No per-tile cap.
    Returns (events i32[2W, 4], tile_start i32[T + 1])."""
    t_k = int(t_k)
    keep = (delta.valid_mask() & delta.is_edge_op() & (delta.t > t_k)
            & (delta.u < n) & (delta.v < n))
    idx = torch.nonzero(keep).flatten()
    sign = torch.where(delta.op[idx] == ADD_EDGE, 1, -1).to(torch.int64)
    # T_PAD guard: only real (in-suffix) ops reach the subtraction
    b = torch.clamp(delta.t[idx].to(torch.int64) - t_k, 0, num_buckets)
    nodes = torch.cat([delta.u[idx], delta.v[idx]]).to(torch.int64)
    tiles = -(-n // TILE)
    tile_id = nodes // TILE
    order = torch.argsort(tile_id, stable=True)
    tile_start = torch.searchsorted(
        tile_id[order], torch.arange(tiles + 1, device=nodes.device))
    events = torch.stack([nodes % TILE, torch.cat([b, b]),
                          torch.cat([sign, sign]),
                          torch.zeros_like(nodes)], 1)
    return (events[order].to(torch.int32).contiguous(),
            tile_start.to(torch.int32))


def degree_series_kernel(deg_cur: torch.Tensor, events: torch.Tensor,
                         tile_start: torch.Tensor,
                         num_buckets: int) -> torch.Tensor:
    """i32[B, N]: every node's degree at t_k + b.  CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    if deg_cur.device.type == "cpu":
        return degree_series_ref(deg_cur, events, tile_start, num_buckets,
                                 TILE)
    n = deg_cur.shape[0]
    build.check_cuda("deg_cur", deg_cur, torch.int32, 1)
    build.check_cuda("events", events, torch.int32, 2)
    build.check_cuda("tile_start", tile_start, torch.int32, 1)
    tiles = -(-n // TILE)
    if events.shape[1] != 4 or tile_start.numel() != tiles + 1:
        raise ValueError("events/tile_start do not match the tiling")
    if num_buckets < 1:
        raise ValueError("num_buckets must be >= 1")
    build.check_same_device(deg_cur=deg_cur, events=events,
                            tile_start=tile_start)
    ext = build.ext()
    if ext.degree_series_smem_bytes(num_buckets):
        scratch = torch.empty(0, dtype=torch.int32, device=deg_cur.device)
    else:
        scratch = torch.empty(tiles * (num_buckets + 1) * TILE,
                              dtype=torch.int32, device=deg_cur.device)
    out = torch.empty((num_buckets, n), dtype=torch.int32,
                      device=deg_cur.device)
    ext.degree_series(deg_cur, events, tile_start, out, scratch,
                      num_buckets, build.stream_handle(deg_cur.device))
    build.LAUNCHES["degree_series"] += 1
    return out
