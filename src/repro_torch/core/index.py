"""Delta indexes (paper §3.3.2): temporal and node-centric — the
PyTorch mirror of ``repro.core.index``.

*Temporal index* — the delta is append-only and time-sorted, so a query
window (t_lo, t_hi] maps to a contiguous op range by binary search over
the ``t`` column.

*Node-centric index* — CSR over nodes: for every node, the sorted list
of op indices that touch it (edge ops are listed under both endpoints).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.delta import NOP, T_PAD, Delta

I32 = torch.int32


# ---------------------------------------------------------------------------
# Temporal index
# ---------------------------------------------------------------------------


def temporal_range(delta: Delta, t_lo, t_hi) -> tuple[int, int]:
    """Op-index range [i0, i1) of ops with t in (t_lo, t_hi]
    (padding sorts to the end, t == T_PAD)."""
    q = torch.tensor([int(t_lo), int(t_hi)], dtype=I32, device=delta.device)
    i = torch.searchsorted(delta.t, q, right=True).cpu()
    return int(i[0]), int(i[1])


def gather_window(delta: Delta, t_lo, t_hi, window_cap: int) -> Delta:
    """The ops of (t_lo, t_hi] compacted into a Delta of capacity
    ``window_cap`` via the temporal index.  Ops beyond ``window_cap``
    are dropped — callers size the capacity from host-side counts."""
    i0, i1 = temporal_range(delta, t_lo, t_hi)
    n = min(i1 - i0, window_cap)

    def slice1(x, fill):
        out = torch.full((window_cap,), fill, dtype=I32, device=x.device)
        out[:n] = x[i0:i0 + n]
        return out

    return Delta(op=slice1(delta.op, NOP), u=slice1(delta.u, 0),
                 v=slice1(delta.v, 0), slot=slice1(delta.slot, 0),
                 t=slice1(delta.t, T_PAD), n_ops=n)


def count_window_ops(delta: Delta, t_lo, t_hi) -> int:
    """#ops in (t_lo, t_hi] — the operation-based selection metric
    (paper §2.2) at O(log M)."""
    i0, i1 = temporal_range(delta, t_lo, t_hi)
    return i1 - i0


# ---------------------------------------------------------------------------
# Node-centric index (CSR)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NodeIndex:
    """CSR: ops touching each node.  Edge ops appear twice (once per
    endpoint); node ops once."""

    row_ptr: torch.Tensor   # i32[N + 1]
    op_idx: torch.Tensor    # i32[2M] — delta op indices, grouped by
                            # node, time-ordered within a node
    n_cap: int

    def ops_of(self, v, cap: int):
        """Up to ``cap`` op indices touching node v (padded with -1)."""
        ids = self.ops_of_many([int(v)], cap)[0]
        return ids, int((ids >= 0).sum())

    def ops_of_many(self, vs, cap: int) -> torch.Tensor:
        """i32[B, cap]: row b holds up to ``cap`` op indices touching
        node vs[b] (padded with -1) — gathered on the index's device,
        with no read back to the host."""
        dev = self.op_idx.device
        vv = torch.as_tensor(vs, dtype=torch.int64).to(dev)
        start = self.row_ptr[vv].to(torch.int64)
        count = self.row_ptr[vv + 1].to(torch.int64) - start
        k = torch.arange(cap, dtype=torch.int64, device=dev)
        keep = k < count.unsqueeze(-1)
        if self.op_idx.numel() == 0:
            return torch.full(keep.shape, -1, dtype=I32, device=dev)
        ids = (start.unsqueeze(-1) + k).clamp(max=self.op_idx.numel() - 1)
        return torch.where(keep, self.op_idx[ids], -1).to(I32)


def _csr(op: torch.Tensor, u: torch.Tensor, v: torch.Tensor, n_ops: int,
         n_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    m = op.shape[0]
    dev = op.device
    valid = (torch.arange(m, device=dev) < n_ops) & (op != NOP)
    is_edge = (op == 2) | (op == 3)
    # Two entries per op, interleaved (u0, v0, u1, v1, ...) so that a
    # stable sort by node keeps each node's op list in time order.
    key_u = torch.where(valid, u, n_cap)
    key_v = torch.where(valid & is_edge, v, n_cap)
    keys = torch.stack([key_u, key_v], 1).reshape(-1).to(torch.int64)
    idxs = torch.arange(m, dtype=I32, device=dev).repeat_interleave(2)
    order = torch.argsort(keys, stable=True)
    counts = torch.bincount(keys[order].clamp(0, n_cap),
                            minlength=n_cap + 1)
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(counts[:n_cap], 0)]).to(I32)
    return row_ptr, idxs[order]


def build_node_index(delta: Delta, n_cap: int) -> NodeIndex:
    """The CSR node-centric index with one stable argsort, on the
    delta's device.  Padding ops are parked under a virtual row
    ``n_cap`` and truncated."""
    row_ptr, op_idx = _csr(delta.op, delta.u, delta.v, delta.n_ops, n_cap)
    return NodeIndex(row_ptr=row_ptr, op_idx=op_idx, n_cap=n_cap)


def build_node_index_host(delta: Delta, n_cap: int) -> NodeIndex:
    """The same index built on the host (large logs), moved back to the
    delta's device."""
    cols = [torch.from_numpy(np.asarray(x.cpu()))
            for x in (delta.op, delta.u, delta.v)]
    row_ptr, op_idx = _csr(*cols, delta.n_ops, n_cap)
    return NodeIndex(row_ptr=row_ptr.to(delta.device),
                     op_idx=op_idx.to(delta.device), n_cap=n_cap)


def _gather(delta: Delta, ids: torch.Tensor, n_ops: int) -> Delta:
    safe = ids.clamp(min=0).to(torch.int64)
    good = ids >= 0

    def g(x, fill):
        return torch.where(good, x[safe], torch.full_like(ids, fill))

    return Delta(op=g(delta.op, NOP), u=g(delta.u, 0), v=g(delta.v, 0),
                 slot=g(delta.slot, 0), t=g(delta.t, T_PAD), n_ops=n_ops)


def gather_node_ops(delta: Delta, index: NodeIndex, v, cap: int) -> Delta:
    """Delta restricted to ops touching node v, via the node index —
    O(deg_ops) gathers instead of an O(M) scan."""
    ids, n = index.ops_of(v, cap)
    return _gather(delta, ids, n)


def gather_nodes_ops(delta: Delta, index: NodeIndex, vs, cap: int) -> Delta:
    """``gather_node_ops`` for a batch of nodes in one step on the
    delta's device: a Delta whose columns are [B, cap], row b holding
    node vs[b]'s ops.  Padding entries are NOP at T_PAD, so every
    entry counts as valid (``n_ops == cap``) — the batched plans
    (``plans._signed_touch``) skip NOPs by their op code."""
    return _gather(delta, index.ops_of_many(vs, cap), cap)
