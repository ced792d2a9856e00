"""Wrapper of the degree-series kernel (``degree_series.cu``): the
hybrid plan's backward series over the sweep's glue and buffers
(``evolve_sweep/sweep.py``: ``bucket_sweep_events`` with no upper time
bound, ``series_scratch``), and the launch; ``degree_series_rows`` runs
it on one node block (the JAX package's ``degree_series_rows``)."""
from __future__ import annotations

import torch

from repro_torch.core.delta import Delta
from repro_torch.kernels import build
from repro_torch.kernels.degree_series.ref import degree_series_ref
from repro_torch.kernels.evolve_sweep import sweep
from repro_torch.kernels.evolve_sweep.sweep import TILE


def degree_series_kernel(deg_cur: torch.Tensor, events: torch.Tensor,
                         tile_start: torch.Tensor, t_k: int,
                         num_buckets: int) -> torch.Tensor:
    """i32[B, N]: every node's degree at t_k + b, from the current
    degrees and ``bucket_sweep_events(delta, N, t_k)``'s events.  CPU
    tensors run the plain version; CUDA tensors launch the kernel, whose
    blocks find their rows of the work list on the card (as
    ``sweep_series``'s)."""
    if deg_cur.device.type == "cpu":
        return degree_series_ref(deg_cur, events, tile_start, t_k,
                                 num_buckets, TILE)
    n = deg_cur.shape[0]
    build.check_cuda("deg_cur", deg_cur, torch.int32, 1)
    sweep.check_series_operands(deg_cur, events, tile_start, num_buckets)
    build.check_same_device(deg_cur=deg_cur, events=events,
                            tile_start=tile_start)
    nets, sync, rows = sweep.series_scratch(
        1, n, events.shape[0], num_buckets, deg_cur.device)
    out = torch.empty((num_buckets, n), dtype=torch.int32,
                      device=deg_cur.device)
    build.ext().degree_series(deg_cur, events, tile_start, int(t_k), out,
                              nets, sync, num_buckets, sweep.CHUNK, rows,
                              build.stream_handle(deg_cur.device))
    build.LAUNCHES["degree_series"] += 1
    return out


def degree_series_rows(deg_block: torch.Tensor, delta: Delta, t_k: int,
                       num_buckets: int, row0: int = 0) -> torch.Tensor:
    """i32[B, R]: the series of nodes [row0, row0 + R) only, from their
    current degrees ``deg_block`` i32[R] — one kernel launch on the
    block's events (``bucket_sweep_events(row0=)``).  The blocks of a
    node-sharded graph, concatenated along nodes, equal the whole
    graph's series (``row0=0`` with every node's degrees)."""
    events, tile_start = sweep.bucket_sweep_events(
        delta, deg_block.shape[0], t_k, row0=row0)
    return degree_series_kernel(deg_block, events, tile_start, t_k,
                                num_buckets)
