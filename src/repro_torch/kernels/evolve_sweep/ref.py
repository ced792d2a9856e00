"""Plain references for the sweep.

* ``sweep_series_ref`` — the plain-PyTorch version of the degree-sweep
  kernel (``sweep.cu``) on the same bucketed events.
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
    """i32[Q, B, N]: deg0(v) + Σ_{b' ≤ b} net[b', v] per sweep."""
    q, n = deg0.shape
    node = entry_tiles(tile_start) * tile + events[:, 0].to(torch.int64)
    t = events[:, 1].to(torch.int64).view(1, -1)
    lo = t_lo.to(torch.int64).view(q, 1)
    win = (t > lo) & (t <= t_last.to(torch.int64).view(q, 1))
    k = torch.clamp((t - lo + stride - 1) // stride, 0, num_buckets - 1)
    flat = (torch.arange(q, device=deg0.device).view(q, 1) * num_buckets
            + k) * n + node.view(1, -1)
    net = torch.zeros((q * num_buckets * n,), dtype=torch.int32,
                      device=deg0.device)
    net.index_add_(0, flat[win], events[:, 2].view(1, -1).expand_as(win)[win])
    net = net.view(q, num_buckets, n)
    return deg0.view(q, 1, n) + torch.cumsum(net, 1, dtype=torch.int32)


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
