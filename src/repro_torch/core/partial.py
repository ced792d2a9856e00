"""Partial snapshot reconstruction (paper §3.3.1) — the PyTorch mirror
of ``repro.core.partial``.

Node-centric queries touch a subgraph G' = (V', E'); instead of
reconstructing all of SG_t we reconstruct only the rows of V'.  The
closure is a bounded fixpoint over "nodes touched by ops touching the
current set".  Every function takes a leading batch dimension on the
masks (one seed set per query).
"""
from __future__ import annotations

import torch

from repro_torch.core.delta import NOP, Delta
from repro_torch.core.graph import DenseGraph
from repro_torch.core.reconstruct import as_times, reconstruct_dense_many


def seed_mask(n_cap: int, v, device="cuda") -> torch.Tensor:
    """Seed sets for node-centric queries — bool[N] for one node,
    bool[Q, N] for a sequence of Q nodes.  Shared by ``plans.two_phase``
    and the engine so both build bit-identical seeds."""
    vs = torch.as_tensor(v, dtype=torch.int64).to(device)
    m = torch.zeros(vs.shape + (n_cap,), dtype=torch.bool, device=device)
    m.scatter_(-1, vs.unsqueeze(-1), True)
    return m


def closure_mask(current: DenseGraph, delta: Delta, seed: torch.Tensor,
                 t_lo, t_hi, passes: int = 2) -> torch.Tensor:
    """Expand seed node sets (bool[..., N]) to every node whose state can
    influence the queried subgraph: current neighbors plus endpoints of
    window ops that touch the set.  ``t_lo``/``t_hi`` are times or
    per-set i32 tensors."""
    valid = delta.valid_mask()
    lo = torch.as_tensor(t_lo, dtype=torch.int32).to(delta.device)
    hi = torch.as_tensor(t_hi, dtype=torch.int32).to(delta.device)
    win = ((delta.t > lo.unsqueeze(-1)) & (delta.t <= hi.unsqueeze(-1))
           & (delta.op != NOP) & valid)                  # [..., M]
    adj_f = current.adj.to(torch.float32)
    u = delta.u.to(torch.int64)
    v = delta.v.to(torch.int64)
    mask = seed
    for _ in range(passes):
        nbr = (mask.to(torch.float32) @ adj_f) > 0
        touch = (win & (mask[..., u] | mask[..., v])).to(torch.uint8)
        scat = torch.zeros(mask.shape, dtype=torch.uint8,
                           device=mask.device)
        scat.scatter_reduce_(-1, u.expand_as(touch), touch, reduce="amax")
        scat.scatter_reduce_(-1, v.expand_as(touch), touch, reduce="amax")
        mask = mask | nbr | scat.bool()
    return mask


def partial_reconstruct_many(current: DenseGraph, delta: Delta, t_cur,
                             t_query, seeds: torch.Tensor,
                             passes: int = 2, buckets=None) -> DenseGraph:
    """SG_{t_query[q]} restricted to the closure of ``seeds[q]``, for Q
    queries (nodes bool[Q, N], adj bool[Q, N, N]).  Only meaningful on
    the closure — other rows are zeroed so accidental reads are loud."""
    dev = current.device
    t_query = as_times(t_query, None, dev)
    t_cur = as_times(t_cur, t_query.numel(), dev)
    lo = torch.minimum(t_cur, t_query)
    hi = torch.maximum(t_cur, t_query)
    mask = closure_mask(current, delta, seeds, lo, hi, passes=passes)
    g = reconstruct_dense_many(current, delta, t_cur, t_query,
                               row_mask=mask, buckets=buckets)
    adj = g.adj & mask[:, :, None] & mask[:, None, :]
    return DenseGraph(nodes=g.nodes & mask, adj=adj)


def partial_reconstruct(current: DenseGraph, delta: Delta, t_cur, t_query,
                        seed: torch.Tensor, passes: int = 2) -> DenseGraph:
    """Reconstruct SG_{t_query} restricted to the closure of ``seed``
    (the paper's contract: "it suffices to reconstruct the corresponding
    snapshots of the subgraph G'")."""
    return partial_reconstruct_many(current, delta, t_cur, [int(t_query)],
                                    seed.reshape(1, -1),
                                    passes=passes).take(0)
