"""Incremental time-sweep (``evolve``) executor — the PyTorch mirror of
``repro.kernels.evolve_sweep.ops``.

A sweep query asks for a measure at every sample time
``t_lo, t_lo + stride, ..., t_lo + (B-1)·stride (≤ t_hi)``.  Instead of
B reconstructions with overlapping windows:

1. reconstruct SG_{t_lo} from the group anchor (one batched LWW launch
   for every query of the group),
2. every node's degree at every sample comes from the degree-sweep
   kernel (``sweep.cu``): an op at time t lands in sample
   ceil((t − t_lo)/stride), the first sample that observes it, and a
   forward running sum applies the nets,
3. node validity and the node/edge counts follow the same signed nets
   in plain PyTorch (N-sized), and the measure is a fixed f32
   expression of those integers — copied from ``core.queries`` — so
   samples bit-match B point queries.

Bit-exactness rests on the store's legal transition log (it refuses
double-adds and ghost-removes), which is why the sweep-window delta must
be LEAF segments, never merged-tree nodes (``core.segments``).
"""
from __future__ import annotations

import torch

from repro_torch.core.delta import ADD_EDGE, ADD_NODE, NOP, Delta
from repro_torch.core.graph import EdgeGraph
from repro_torch.core.queries import (DEGREE_DIST_BINS, _avg_degree,
                                      _degree_histogram, _density)
from repro_torch.kernels.evolve_sweep.sweep import (bucket_sweep_events,
                                                    sweep_series)

I32 = torch.int32

# Measures the incremental executor supports on BOTH layouts: pure
# functions of (degrees, node validity, num_nodes, num_edges).
SWEEP_MEASURES = ("degree", "num_nodes", "num_edges", "density",
                  "avg_degree", "degree_distribution")


def _signed_rows(delta: Delta, t_lo, t_last, stride: int,
                 num_buckets: int):
    """For Q sweeps (``t_lo``/``t_last`` i32[Q]): the flat (query,
    sample) row of every op [Q, M] and its signed edge / node weight
    [Q, M] (0 outside the window).  An op at t in (t_lo, t_last] is
    first seen by sample ceil((t − t_lo)/stride); out-of-window rows
    (padding included) are pinned to sample 1 before the arithmetic —
    the T_PAD overflow guard."""
    lo = t_lo.view(-1, 1)
    win = (delta.valid_mask() & (delta.t > lo)
           & (delta.t <= t_last.view(-1, 1)) & (delta.op != NOP))
    t = torch.where(win, delta.t, lo + 1).to(torch.int64)
    k = torch.clamp((t - lo + stride - 1) // stride, 0, num_buckets - 1)
    q = win.shape[0]
    rows = torch.arange(q, device=delta.device).view(q, 1) * num_buckets + k
    sign = torch.where((delta.op == ADD_EDGE) | (delta.op == ADD_NODE),
                       1, -1).to(I32)
    is_e = delta.is_edge_op()
    we = torch.where(win & is_e, sign, 0).to(I32)
    wn = torch.where(win & ~is_e, sign, 0).to(I32)
    return rows, we, wn


def _count_nets(delta: Delta, rows, we, wn, num_buckets: int, n_cap: int):
    """(node_net i32[Q,B,N], ne_net i32[Q,B], nn_net i32[Q,B]) — the
    nets besides the degrees (which the sweep kernel computes)."""
    q = rows.shape[0]
    dev = delta.device
    ne_net = torch.zeros((q * num_buckets,), dtype=I32, device=dev)
    ne_net.index_add_(0, rows.flatten(), we.flatten())
    nn_net = torch.zeros_like(ne_net)
    nn_net.index_add_(0, rows.flatten(), wn.flatten())
    node_net = torch.zeros((q * num_buckets * n_cap,), dtype=I32, device=dev)
    node_ops = torch.nonzero((wn != 0).any(0)).flatten()
    u = delta.u[node_ops].to(torch.int64).clamp(0, n_cap - 1)
    node_net.index_add_(0, (rows[:, node_ops] * n_cap + u).flatten(),
                        wn[:, node_ops].flatten())
    return (node_net.view(q, num_buckets, n_cap),
            ne_net.view(q, num_buckets), nn_net.view(q, num_buckets))


def sweep_nets(delta: Delta, t_lo, t_last, stride: int, num_buckets: int,
               n_cap: int):
    """Per-sample signed NET counts of Q sweeps (``t_lo``/``t_last``
    i32[Q]): (deg_net i32[Q,B,N], node_net i32[Q,B,N], ne_net i32[Q,B],
    nn_net i32[Q,B]).  Sample 0 *is* t_lo, so row 0 is always zero."""
    rows, we, wn = _signed_rows(delta, t_lo, t_last, stride, num_buckets)
    q = rows.shape[0]
    deg_net = torch.zeros((q * num_buckets * n_cap,), dtype=I32,
                          device=delta.device)
    for end in (delta.u, delta.v):
        idx = rows * n_cap + end.to(torch.int64).clamp(0, n_cap - 1)
        deg_net.index_add_(0, idx.flatten(), we.flatten())
    return (deg_net.view(q, num_buckets, n_cap),
            *_count_nets(delta, rows, we, wn, num_buckets, n_cap))


def measure_from_state(measure: str, scope: str, v, deg, nodes_i, nn, ne):
    """The registered measure as a function of the swept integer state
    (``deg``/``nodes_i`` [..., N], ``nn``/``ne`` [...], ``v`` one node
    per leading row).  Expressions are verbatim from ``core.queries`` —
    what makes sweep samples bit-equal to point queries."""
    if scope == "node":
        if measure == "degree":
            idx = torch.as_tensor(v, dtype=torch.int64).to(deg.device)
            idx = idx.view((-1,) + (1,) * (deg.dim() - 1))
            return deg.gather(-1, idx.expand(deg.shape[:-1] + (1,))
                              ).squeeze(-1)
        raise ValueError(f"measure {measure!r} is not sweepable")
    if measure == "num_nodes":
        return nn
    if measure == "num_edges":
        return ne
    if measure == "density":
        return _density(nn, ne)
    if measure == "avg_degree":
        return _avg_degree(nn, ne)
    if measure == "degree_distribution":
        return _degree_histogram(deg, nodes_i.bool(), DEGREE_DIST_BINS)
    raise ValueError(f"measure {measure!r} is not sweepable")


def _start_state(g, dense: bool):
    """(degrees i32[Q,N], nodes bool[Q,N], num_nodes i32[Q],
    num_edges i32[Q]) of a batch of reconstructed start snapshots."""
    if dense:
        deg = g.adj.sum(-1, dtype=I32)
        ne = torch.div(g.adj.sum((-2, -1), dtype=I32), 2,
                       rounding_mode="floor")
    else:
        live = (g.emask & g.reg_mask()).to(I32)
        deg = torch.zeros(g.nodes.shape, dtype=I32, device=g.device)
        deg.index_add_(1, g.eu, live)
        deg.index_add_(1, g.ev, live)
        ne = live.sum(-1, dtype=I32)
    return deg, g.nodes, g.nodes.sum(-1, dtype=I32), ne


def batch_evolve(anchor, d_rec: Delta, d_net: Delta, t_anchor, t_los,
                 widths, vs, *, measure: str, scope: str, stride: int,
                 num_buckets: int):
    """The engine's sweep-group entry point: Q sweeps at once.

    ``anchor``/``d_rec``/``t_anchor`` reconstruct each query's start
    state (``d_rec`` may be merged-tree-covered — LWW only); ``d_net``
    is the LEAF delta covering every sweep window.  ``t_los``/``widths``
    /``vs`` hold one entry per query; the group shares (measure, scope,
    stride).  Output: [Q, num_buckets] (i32 or f32 per measure), or
    [Q, num_buckets, bins] for degree_distribution.  Samples past a
    query's width repeat its last state — callers slice ``[:width]``.
    """
    # imported here: core.reconstruct imports this package (the hybrid
    # series shares the sweep's glue and kernel code)
    from repro_torch.core.reconstruct import (as_times,
                                              reconstruct_dense_many,
                                              reconstruct_edge_many)
    dense = not isinstance(anchor, EdgeGraph)
    recon = reconstruct_dense_many if dense else reconstruct_edge_many
    g = recon(anchor, d_rec, t_anchor, as_times(t_los, None, anchor.device))
    return sweep_from_state(_start_state(g, dense), d_net, t_los, widths,
                            vs, measure=measure, scope=scope, stride=stride,
                            num_buckets=num_buckets)


def sweep_from_state(state, d_net: Delta, t_los, widths, vs, *,
                     measure: str, scope: str, stride: int,
                     num_buckets: int):
    """The sweep half of ``batch_evolve``: Q sweeps from their given
    start state ``(deg0 i32[Q,N], nodes0 [Q,N], nn0 i32[Q], ne0
    i32[Q])`` — reconstructed on one device, or summed from the slot
    shards' integer partials (``core.distributed.evolve_slots``) — over
    the LEAF delta ``d_net`` on its device."""
    from repro_torch.core.reconstruct import as_times
    deg0, nodes0, nn0, ne0 = state
    dev = deg0.device
    n_cap = deg0.shape[-1]
    t_lo = as_times(t_los, None, dev)
    t_last = t_lo + (as_times(widths, None, dev) - 1) * int(stride)
    lo_all, last_all = int(t_lo.min()), int(t_last.max())
    events, tile_start = bucket_sweep_events(d_net, n_cap, lo_all, last_all)
    deg = sweep_series(deg0, events, tile_start, t_lo, t_last, stride,
                       num_buckets)
    node_net, ne_net, nn_net = _count_nets(
        d_net, *_signed_rows(d_net, t_lo, t_last, stride, num_buckets),
        num_buckets, n_cap)
    nodes_i = nodes0.to(I32).unsqueeze(1) + torch.cumsum(node_net, 1,
                                                         dtype=I32)
    nn = nn0.unsqueeze(1) + torch.cumsum(nn_net, 1, dtype=I32)
    ne = ne0.unsqueeze(1) + torch.cumsum(ne_net, 1, dtype=I32)
    return measure_from_state(measure, scope, vs, deg, nodes_i, nn, ne)
