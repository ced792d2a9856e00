"""Plain references for the sweep.

* ``sweep_series_ref`` — the plain-PyTorch version of the degree-sweep
  kernel (``sweep.cu``) on the same bucketed events.
* ``sweep_work_ref`` — the plain version of the work list that
  ``sweep.cu``'s first kernel derives from the bucketing.
* ``evolve_ref`` — B independent point reconstructions + measures: the
  semantics ``batch_evolve`` must bit-match (what a client pays by
  issuing B point queries).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.delta_apply.ref import entry_tiles


def sweep_series_ref(deg0: torch.Tensor, events: torch.Tensor,
                     tile_start: torch.Tensor, t_lo: torch.Tensor,
                     t_last: torch.Tensor, stride: int, num_buckets: int,
                     tile: int) -> torch.Tensor:
    """i32[Q, B, N]: deg0(v) + Σ_{b' ≤ b} net[b', v] per sweep, from
    events ``[t, local node·2 + is_add]``."""
    q, n = deg0.shape
    code = events[:, 1]
    node = entry_tiles(tile_start) * tile + (code >> 1).to(torch.int64)
    sign = (code & 1) * 2 - 1
    t = events[:, 0].to(torch.int64).view(1, -1)
    lo = t_lo.to(torch.int64).view(q, 1)
    win = (t > lo) & (t <= t_last.to(torch.int64).view(q, 1))
    k = torch.clamp((t - lo + stride - 1) // stride, 0, num_buckets - 1)
    flat = (torch.arange(q, device=deg0.device).view(q, 1) * num_buckets
            + k) * n + node.view(1, -1)
    net = torch.zeros((q * num_buckets * n,), dtype=torch.int32,
                      device=deg0.device)
    net.index_add_(0, flat[win], sign.view(1, -1).expand_as(win)[win])
    net = net.view(q, num_buckets, n)
    return deg0.view(q, 1, n) + torch.cumsum(net, 1, dtype=torch.int32)


def sweep_work_ref(tile_start: torch.Tensor, n_events: int,
                   chunk: int) -> torch.Tensor:
    """i32[n_events // chunk + tiles, 4]: one row ``[tile, first event,
    end, slot]`` per block, every tile's run of events cut into
    ceil(count / chunk) chunks of near-equal size (one chunk for a tile
    with none).  The first n_events // chunk rows, as many as the event
    count can need, are the chunks past the first of the tiles cut into
    several, in tile and chunk order, then surplus rows ``[-1, 0, 0,
    -1]``; the last ``tiles`` rows are the tiles' first chunks.
    ``slot`` is the tile for a tile of several chunks, -1 for one of a
    single chunk."""
    ts = tile_start.to(torch.int64)
    counts = ts[1:] - ts[:-1]
    tiles = counts.numel()
    k = torch.clamp((counts + chunk - 1) // chunk, min=1)
    ends = torch.cumsum(k - 1, 0)                  # extra chunks so far
    x = torch.arange(n_events // chunk, device=ts.device)
    tile_x = torch.searchsorted(ends, x, right=True)
    real = torch.cat([tile_x < tiles,
                      torch.ones(tiles, dtype=torch.bool, device=ts.device)])
    tile_x = torch.clamp(tile_x, max=tiles - 1)
    tile = torch.cat([tile_x, torch.arange(tiles, device=ts.device)])
    idx = torch.cat([x - (ends - (k - 1))[tile_x] + 1,
                     torch.zeros(tiles, dtype=torch.int64,
                                 device=ts.device)])
    kt, ct, st = k[tile], counts[tile], ts[:-1][tile]
    rows = torch.stack([tile, st + idx * ct // kt,
                        st + (idx + 1) * ct // kt,
                        torch.where(kt > 1, tile, -1)], 1)
    pad = torch.tensor([-1, 0, 0, -1], device=ts.device)
    return torch.where(real.unsqueeze(1), rows, pad).to(
        torch.int32).contiguous()


def evolve_ref(anchor, delta, t_anchor, t_lo, t_hi, stride: int,
               measure: str, scope: str, v=None):
    """One reconstruction per sample — the O(B · window) baseline."""
    from repro_torch.core.graph import EdgeGraph
    from repro_torch.core.plans import measure_named
    from repro_torch.core.reconstruct import (reconstruct_dense,
                                              reconstruct_edge)
    recon = (reconstruct_edge if isinstance(anchor, EdgeGraph)
             else reconstruct_dense)
    return torch.stack([
        measure_named(recon(anchor, delta, t_anchor, t), measure, scope, v)
        for t in range(int(t_lo), int(t_hi) + 1, int(stride))])
