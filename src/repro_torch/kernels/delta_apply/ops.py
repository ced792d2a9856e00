"""Wrapper of the dense LWW kernel (``delta_apply.cu``): window
filtering and tile bucketing in plain PyTorch, the launch, and the
node-mask update (nodes are N-sized and stay plain PyTorch, as they stay
on XLA in ``repro/kernels/delta_apply/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.delta import ADD_EDGE, ADD_NODE, Delta
from repro_torch.kernels import build
from repro_torch.kernels.delta_apply.ref import delta_apply_ref, lww_resolve

TILE = 64   # == TN in delta_apply.cu


def bucket_ops(delta: Delta, n: int, t_lo=None, t_hi=None, *,
               row0: int = 0, n_rows: int | None = None):
    """Bucket the delta's edge ops by destination TILE×TILE tile.

    Every edge op with t in (t_lo, t_hi] (all of them when unbounded)
    gives two entries, (u,v) and (v,u), as i32 ``[cell, t, key, 0]``
    with ``cell`` local to the tile and ``key = 2·rank + (op ==
    addEdge)``.  Entries are ordered by tile, and by rank within a tile
    (mirror after original).  There is no per-tile cap: the kernel loops
    over whatever its tile holds.  Returns (entries i32[E, 4],
    tile_start i32[T + 1]).

    ``row0``/``n_rows`` make the bucketing shard-safe: a device that
    owns only adjacency rows [row0, row0 + n_rows) (columns global)
    keeps exactly the entries whose row lies in its block, with the row
    made local, over its own tiles_r × tiles_c grid.  An entry of the
    next block's rows never lands in this block's pad band (rows past
    ``n_rows`` in its last tile row).
    """
    n_rows = n if n_rows is None else int(n_rows)
    keep = delta.valid_mask() & delta.is_edge_op()
    keep &= (delta.u < n) & (delta.v < n)
    if t_lo is not None:
        keep &= delta.t > int(t_lo)
    if t_hi is not None:
        keep &= delta.t <= int(t_hi)
    idx = torch.nonzero(keep).flatten()
    u = delta.u[idx].to(torch.int64)
    v = delta.v[idx].to(torch.int64)
    key = idx * 2 + (delta.op[idx] == ADD_EDGE).to(torch.int64)
    rows = torch.stack([u, v], 1).reshape(-1)
    cols = torch.stack([v, u], 1).reshape(-1)
    t2 = delta.t[idx].to(torch.int64).repeat_interleave(2)
    key2 = key.repeat_interleave(2)
    if row0 or n_rows != n:
        mine = (rows >= row0) & (rows < row0 + n_rows)
        rows, cols, t2, key2 = (rows[mine] - row0, cols[mine], t2[mine],
                                key2[mine])
    tiles_c = -(-n // TILE)
    tiles_r = -(-n_rows // TILE)
    tile_id = (rows // TILE) * tiles_c + cols // TILE
    order = torch.argsort(tile_id, stable=True)
    tid_s = tile_id[order]
    tile_start = torch.searchsorted(
        tid_s, torch.arange(tiles_r * tiles_c + 1, device=tid_s.device))
    cell = (rows % TILE) * TILE + cols % TILE
    entries = torch.stack([cell, t2, key2, torch.zeros_like(cell)], 1)
    return (entries[order].to(torch.int32).contiguous(),
            tile_start.to(torch.int32))


def delta_apply(anchor_adj: torch.Tensor, entries: torch.Tensor,
                tile_start: torch.Tensor, t_anchor: torch.Tensor,
                t_query: torch.Tensor,
                row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """bool[Q, R, N]: LWW reconstruction of Q adjacencies (R = N) or Q
    row blocks of R rows (the buckets of ``bucket_ops(..., row0=,
    n_rows=R)``).

    ``anchor_adj`` is bool[R, N] (shared) or bool[Q, R, N] (one per
    query); ``t_anchor``/``t_query`` i32[Q]; ``row_mask`` an optional
    bool[Q, N] partial-reconstruction filter (an entry counts only if it
    touches a masked row or column; square adjacencies only).  CPU
    tensors run the plain version; CUDA tensors launch the kernel.
    """
    if row_mask is not None and anchor_adj.shape[-2] != anchor_adj.shape[-1]:
        raise ValueError("a row_mask needs the square N×N adjacency, not "
                         "a row block")
    if anchor_adj.device.type == "cpu":
        return delta_apply_ref(anchor_adj, entries, tile_start, t_anchor,
                               t_query, row_mask, TILE)
    r, n = anchor_adj.shape[-2:]
    q = t_query.numel()
    build.check_cuda("anchor_adj", anchor_adj, torch.bool)
    if anchor_adj.dim() not in (2, 3) \
            or (anchor_adj.dim() == 3 and anchor_adj.shape[0] != q):
        raise ValueError(f"anchor_adj shape {tuple(anchor_adj.shape)} is "
                         f"not [R, N] or [{q}, R, N]")
    build.check_cuda("entries", entries, torch.int32, 2)
    build.check_cuda("tile_start", tile_start, torch.int32, 1)
    build.check_cuda("t_anchor", t_anchor, torch.int32, 1)
    build.check_cuda("t_query", t_query, torch.int32, 1)
    tiles = -(-r // TILE) * -(-n // TILE)
    if entries.shape[1] != 4 or tile_start.numel() != tiles + 1:
        raise ValueError("entries/tile_start do not match the tiling")
    if t_anchor.numel() != q:
        raise ValueError("t_anchor and t_query differ in length")
    if row_mask is None:
        rm = torch.empty(0, dtype=torch.bool, device=anchor_adj.device)
    else:
        build.check_cuda("row_mask", row_mask, torch.bool, 2)
        if tuple(row_mask.shape) != (q, n):
            raise ValueError(f"row_mask must be [{q}, {n}]")
        rm = row_mask
    build.check_same_device(anchor_adj=anchor_adj, entries=entries,
                            tile_start=tile_start, t_anchor=t_anchor,
                            t_query=t_query, row_mask=rm)
    out = torch.empty((q, r, n), dtype=torch.bool, device=anchor_adj.device)
    build.ext().delta_apply(
        entries, tile_start, anchor_adj,
        r * n if anchor_adj.dim() == 3 else 0, out, t_anchor, t_query, rm,
        r, n, build.stream_handle(anchor_adj.device))
    build.LAUNCHES["delta_apply"] += 1
    if r != n:
        build.BLOCK_LAUNCHES["delta_apply"] += 1
    return out


def node_mask_lww(nodes: torch.Tensor, delta: Delta, t_anchor: torch.Tensor,
                  t_query: torch.Tensor,
                  row_mask: torch.Tensor | None = None, *,
                  row0: int = 0) -> torch.Tensor:
    """bool[Q, N]: the LWW node-mask update for Q windows — plain
    PyTorch on both devices (N-sized, negligible next to the N² edge
    part).  ``nodes`` is bool[N] or bool[Q, N]; with ``row0`` it holds
    nodes [row0, row0 + N) of a row block."""
    n = nodes.shape[-1]
    keep = (delta.valid_mask() & delta.is_node_op() & (delta.u >= row0)
            & (delta.u < row0 + n))
    idx = torch.nonzero(keep).flatten()
    u = delta.u[idx].to(torch.int64) - row0
    key = (idx * 2 + (delta.op[idx] == ADD_NODE).to(torch.int64)).to(
        torch.int32)
    touch = None
    if row_mask is not None:
        v = delta.v[idx].to(torch.int64).clamp(0, n - 1)
        touch = row_mask[:, u] | row_mask[:, v]
    return lww_resolve(u, delta.t[idx], key, n, nodes, t_anchor, t_query,
                       touch)


def delta_apply_row_block(nodes_block: torch.Tensor,
                          adj_block: torch.Tensor, delta: Delta, t_anchor,
                          t_query, row0: int, buckets=None):
    """LWW reconstruction of one adjacency *row block* for Q windows —
    what each device of a row-sharded mesh runs.  ``adj_block`` is
    bool[R, N] (or bool[Q, R, N]): rows [row0, row0 + R) of the global
    adjacency, columns global; ``nodes_block`` the same rows of the node
    mask.  ``t_anchor``/``t_query`` are i32[Q]; ``buckets`` may carry a
    ``bucket_ops(..., row0=row0, n_rows=R)`` covering every window.
    Returns (nodes bool[Q, R], adj bool[Q, R, N])."""
    r, n = adj_block.shape[-2:]
    if buckets is None:
        # graphlint: ignore[host-sync] one host copy of the Q windows' times a call, to size the launch's buckets
        both = torch.cat([t_anchor, t_query]).cpu()
        buckets = bucket_ops(delta, n, int(both.min()), int(both.max()),
                             row0=row0, n_rows=r)
    adj = delta_apply(adj_block, *buckets, t_anchor, t_query)
    nodes = node_mask_lww(nodes_block, delta, t_anchor, t_query, row0=row0)
    return nodes, adj
