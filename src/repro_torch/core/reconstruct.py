"""Snapshot reconstruction from deltas — the PyTorch mirror of
``repro.core.reconstruct``.

1. ``reconstruct_sequential`` — the paper-faithful baseline: replays one
   operation per step, exactly Algorithm 1 (forward) / Algorithm 2
   (backward, via the inverted delta of Definition 5).  Plain host code:
   it is the paper's baseline, not a kernel.

2. ``reconstruct_dense`` / ``reconstruct_edge`` — last-writer-wins:
   validity of a key at t′ is decided by the last op with t ≤ t′
   (forward from an anchor) or the first op with t > t′ (backward).  On
   CUDA tensors the edge part runs the hand-written kernels
   (``kernels/delta_apply``, ``kernels/edge_delta_apply``); the
   ``*_many`` forms reconstruct a batch of times in one launch (the
   leading batch dimension stands in for ``vmap``).

3. ``degree_series`` — all-times degrees for range queries (hybrid
   plan), on the ``kernels/degree_series`` kernel.

Windows are half-open: SG_t contains the effect of every op with time
≤ t; the direction follows from ``t_query`` vs ``t_anchor``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.delta import (ADD_EDGE, ADD_NODE, NOP, REM_EDGE,
                                    REM_NODE, Delta)
from repro_torch.core.graph import DenseGraph, EdgeGraph
from repro_torch.kernels.degree_series import degree_series_rows
from repro_torch.kernels.delta_apply import (bucket_ops, delta_apply,
                                             node_mask_lww)
from repro_torch.kernels.edge_delta_apply import (bucket_slot_ops,
                                                  edge_delta_apply)

I32 = torch.int32


def as_times(t, q: int | None, device) -> torch.Tensor:
    """A time or sequence of times as i32[Q] on ``device`` (a scalar is
    broadcast to ``q`` entries)."""
    t = torch.as_tensor(t, dtype=I32).to(device).reshape(-1)
    if q is not None and t.numel() == 1 and q != 1:
        t = t.expand(q).contiguous()
    return t


def fit_batch(device, item_bytes: int, q: int) -> int:
    """How many reconstructions of ``item_bytes`` each one launch may
    produce: a quarter of the device's free memory (256 MiB on the CPU),
    at least one, at most ``q``.  Chunking never changes an answer —
    every query's window is resolved independently."""
    if torch.device(device).type == "cuda":
        free = torch.cuda.mem_get_info(device)[0] // 4
    else:
        free = 1 << 28
    return max(1, min(q, free // max(item_bytes, 1)))


def window_of(t_anchor: torch.Tensor, t_query: torch.Tensor):
    """The union (t_lo, t_hi] of Q anchor↔query windows, as host ints."""
    both = torch.cat([t_anchor, t_query]).cpu()
    return int(both.min()), int(both.max())


# --------------------------------------------------------------------------
# Vectorized last-writer-wins reconstruction
# --------------------------------------------------------------------------


def reconstruct_dense_many(anchor: DenseGraph, delta: Delta, t_anchor,
                           t_query, row_mask: torch.Tensor | None = None,
                           buckets=None) -> DenseGraph:
    """SG_t for Q times at once: nodes bool[Q, N], adj bool[Q, N, N].

    ``anchor`` is one snapshot or a batch of Q (one per query — a
    range-differential reuses each query's own SG_tl); ``t_anchor`` a
    time or i32[Q]; ``row_mask`` an optional bool[Q, N] partial
    reconstruction filter (paper §3.3.1: only ops touching masked nodes
    apply).  ``buckets`` may carry a precomputed ``bucket_ops`` result
    covering every window (the engine buckets a group once).
    """
    dev = anchor.device
    t_query = as_times(t_query, None, dev)
    q = t_query.numel()
    t_anchor = as_times(t_anchor, q, dev)
    n = anchor.n_cap
    if buckets is None:
        buckets = bucket_ops(delta, n, *window_of(t_anchor, t_query))
    adj = delta_apply(anchor.adj, *buckets, t_anchor, t_query, row_mask)
    nodes = node_mask_lww(anchor.nodes, delta, t_anchor, t_query, row_mask)
    return DenseGraph(nodes=nodes, adj=adj)


def reconstruct_dense(anchor: DenseGraph, delta: Delta, t_anchor, t_query,
                      row_mask: torch.Tensor | None = None,
                      restrict_rows: bool = False) -> DenseGraph:
    """Last-writer-wins reconstruction of SG_{t_query} from an anchor
    snapshot at ``t_anchor`` (forward or backward chosen automatically).

    ``row_mask``/``restrict_rows`` implement partial reconstruction
    (paper §3.3.1): only keys touching masked nodes are reconstructed;
    everything else keeps its anchor value.
    """
    rm = None
    if restrict_rows:
        if row_mask is None:
            raise ValueError("restrict_rows needs a row_mask")
        rm = row_mask.reshape(1, -1)
    return reconstruct_dense_many(anchor, delta, t_anchor, [int(t_query)],
                                  rm).take(0)


def reconstruct_edge_many(anchor: EdgeGraph, delta: Delta, t_anchor,
                          t_query, buckets=None) -> EdgeGraph:
    """Slot-layout SG_t for Q times: nodes bool[Q, N], emask bool[Q, E].
    O(M + E) per query, independent of N²."""
    dev = anchor.device
    t_query = as_times(t_query, None, dev)
    q = t_query.numel()
    t_anchor = as_times(t_anchor, q, dev)
    if buckets is None:
        buckets = bucket_slot_ops(delta, anchor.e_cap,
                                  *window_of(t_anchor, t_query))
    emask = edge_delta_apply(anchor.emask, *buckets, t_anchor, t_query)
    nodes = node_mask_lww(anchor.nodes, delta, t_anchor, t_query)
    return dataclasses.replace(anchor, nodes=nodes, emask=emask)


def reconstruct_edge(anchor: EdgeGraph, delta: Delta, t_anchor,
                     t_query) -> EdgeGraph:
    """Last-writer-wins reconstruction on the edge-slot layout."""
    return reconstruct_edge_many(anchor, delta, t_anchor,
                                 [int(t_query)]).take(0)


def reconstruct_at(anchor, delta: Delta, t_anchor, t_query, **kw):
    """Dispatch on snapshot layout: dense LWW (B1 on the card) for a
    ``DenseGraph``, edge-slot LWW (B2) for an ``EdgeGraph``."""
    if isinstance(anchor, DenseGraph):
        return reconstruct_dense(anchor, delta, t_anchor, t_query, **kw)
    return reconstruct_edge(anchor, delta, t_anchor, t_query)


# --------------------------------------------------------------------------
# Paper-faithful sequential replay (Algorithms 1 & 2)
# --------------------------------------------------------------------------


def reconstruct_sequential(anchor: DenseGraph, delta: Delta, t_anchor,
                           t_query) -> DenseGraph:
    """One-op-at-a-time replay, exactly the paper's ForRec/BackRec.

    Forward: scan ops in log order, apply those with t_anchor < t ≤ t_query.
    Backward: scan in reverse order, apply the *inverse* op (Definition 5)
    for those with t_query < t ≤ t_anchor.
    """
    t_anchor, t_query = int(t_anchor), int(t_query)
    forward = t_query >= t_anchor
    nodes = anchor.nodes.cpu().numpy().copy()
    adj = anchor.adj.cpu().numpy().copy()
    cols = [x.cpu().numpy() for x in (delta.op, delta.u, delta.v, delta.t)]
    order = range(delta.capacity) if forward else range(
        delta.capacity - 1, -1, -1)
    for i in order:
        op, u, v, t = (int(c[i]) for c in cols)
        if op == NOP:
            continue
        if forward:
            if not (t_anchor < t <= t_query):
                continue
        else:
            if not (t_query < t <= t_anchor):
                continue
            op ^= 1                               # invert (Def. 5)
        if op in (ADD_EDGE, REM_EDGE):
            adj[u, v] = adj[v, u] = op == ADD_EDGE
        elif op in (ADD_NODE, REM_NODE):
            nodes[u] = op == ADD_NODE
    dev = anchor.device
    return DenseGraph(nodes=torch.from_numpy(nodes).to(dev),
                      adj=torch.from_numpy(adj).to(dev))


# --------------------------------------------------------------------------
# All-times degree series (for range queries / hybrid plans)
# --------------------------------------------------------------------------


def degree_series(current, delta: Delta, t_k, t_l, num_buckets: int,
                  t_cur) -> torch.Tensor:
    """Degree of every node at each time unit in [t_k, t_l].

    Hybrid-plan primitive (paper §3.2.3): measure once on SG_tcur, then
    correct backwards with per-bucket net edge counts — one pass over the
    delta.  Bucket b is time t_k + b; ``num_buckets`` must be ≥ t_l − t_k
    + 1.  ``current`` is layout-polymorphic (only ``degrees()`` is read).

    Returns i32[num_buckets, N]: row b = degrees at time t_k + b.
    """
    return degree_series_rows(current.degrees(), delta, int(t_k),
                              num_buckets)


def node_degree_series(current_degree, delta: Delta, v, t_k,
                       num_buckets: int) -> torch.Tensor:
    """Degree time-series for a single node (hybrid plan, no N² state).

    Returns i32[num_buckets]: entry b = degree(v) at time t_k + b.
    """
    t_k = int(t_k)
    valid = delta.valid_mask() & delta.is_edge_op()
    touch = (delta.u == v) | (delta.v == v)
    sign = torch.where(delta.op == ADD_EDGE, 1, -1).to(I32)
    in_suffix = (delta.t > t_k) & valid & touch
    sign = sign * in_suffix.to(I32)
    # T_PAD guard: padding rows carry sign 0, pin them to bucket 0
    t = torch.where(in_suffix, delta.t, t_k)
    b = torch.clamp(t.to(torch.int64) - t_k, 0, num_buckets)
    net = torch.zeros((num_buckets + 1,), dtype=I32, device=delta.device)
    net.index_add_(0, b, sign)
    suffix_after = torch.flip(torch.cumsum(torch.flip(net[1:], (0,)), 0,
                                           dtype=I32), (0,))
    return (torch.as_tensor(current_degree, dtype=I32).to(delta.device)
            - suffix_after)

