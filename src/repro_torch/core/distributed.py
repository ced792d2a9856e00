"""Multi-device temporal-graph engine — the PyTorch mirror of
``repro.core.distributed``, function by function.

One process drives the mesh (``sharding.graph.GraphMesh``), as the
reference's single controller does: where the reference runs a
``shard_map`` program, the port runs the same per-shard work on each
mesh device in turn, every shard a tensor of its own on its own device,
and its ``psum`` is the sum of the shards' integer partials on the
mesh's first device.  Integer partials sum exactly in any order, so
every sharded answer equals the single-device path's bit for bit.

**Sharded group execution** (the engine's ``evaluate_many`` groups
queries by (plan, anchor); a group is the unit that is
device-parallel):

* hybrid / delta-only groups (and two-phase groups whose measure does
  not decompose) → ``batch_sharded``: graph + delta replicated, the
  padded query batch split into contiguous per-device slices, each run
  by the single-device batched executor (on the card: B1–B4 per slice),
  concatenated in order — bit-identical by construction;
* dense two-phase groups → ``two_phase_rows``: adjacency rows split;
  every device runs B1 on its row block only (``bucket_ops(row0=,
  n_rows=)``) and contributes integer partial sums;
* edge two-phase groups → ``two_phase_slots``: edge slots split; every
  device runs B2 on its slot block (``bucket_slot_ops(slot0=)``);
* edge sweep groups → ``evolve_slots``: B2 at each query's t_lo per
  slot block, one psum of the start state's integer partials, then the
  sweep (B4) once on the summed state.

**Primitives** (bottom half): row-parallel reconstruction and global
measures over a row-sharded snapshot.

On the CPU every kernel call runs its plain version, as everywhere in
the port; on CUDA devices it launches the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.delta import ADD_EDGE
from repro_torch.core.graph import DenseGraph, EdgeGraph
from repro_torch.core.plans import masked_aggregate
from repro_torch.core.queries import _avg_degree, _density
from repro_torch.core.reconstruct import as_times, fit_batch
from repro_torch.kernels.delta_apply import bucket_ops, delta_apply_row_block
from repro_torch.kernels.edge_delta_apply import (
    bucket_slot_ops, edge_delta_apply_slot_block)
from repro_torch.sharding.graph import (GraphMesh, Replicated,  # noqa: F401
                                        graph_mesh, put, shard_rows,
                                        shard_slots)
# graph_mesh is re-exported, as the reference's module does

I32 = torch.int32


def shard_graph(g: DenseGraph, mesh: GraphMesh) -> tuple:
    """Adjacency rows / node mask row-sharded on the mesh (one
    ``DenseGraph`` block a device)."""
    return shard_rows(g, mesh)


def shard_edge_graph(g: EdgeGraph, mesh: GraphMesh) -> tuple:
    """An edge-layout snapshot slot-sharded on the mesh (one
    ``EdgeGraph`` block a device)."""
    return shard_slots(g, mesh)


def psum(parts, mesh: GraphMesh) -> torch.Tensor:
    """The sum of the shards' partials (one tensor per device) on the
    mesh's first device — exact for integers in any order."""
    total = parts[0].to(mesh.first)
    for p in parts[1:]:
        total = total + p.to(mesh.first)
    return total


def _local(x, i: int, mesh: GraphMesh):
    """Device i's copy of an operand: its entry of a ``Replicated``, a
    copy placed now for any other tensor tree, scalars as they are."""
    if isinstance(x, Replicated):
        return x[i]
    return put(x, mesh.devices[i])


# ---------------------------------------------------------------------------
# Sharded group execution: batch-axis sharding (hybrid / delta-only)
# ---------------------------------------------------------------------------


def batch_sharded(mesh: GraphMesh, kernel, statics: tuple, args: tuple,
                  qmask: tuple):
    """Run ``kernel(*args, **dict(statics))`` with the query-batch axis
    of the ``qmask``-flagged args split over the mesh.

    Every other arg (graph, delta, index) is device i's copy
    (``Replicated`` operands, or a copy placed now); scalars pass as
    they are.  Each device runs the *same* single-device executor on a
    contiguous slice of the batch, so per-query results are
    bit-identical; the slices' results are concatenated in order on the
    mesh's first device.  The batch length must be a multiple of the
    device count (``sharding.graph.batch_pad``).
    """
    n = mesh.size
    b = next(len(a) for a, q in zip(args, qmask) if q)
    if b % n:
        raise ValueError(f"batch {b} does not split over {n} devices")
    per = b // n
    outs = []
    for i in range(n):
        local = [a[i * per:(i + 1) * per] if q else _local(a, i, mesh)
                 for a, q in zip(args, qmask)]
        outs.append(kernel(*local, **dict(statics)))
    return torch.cat([o.to(mesh.first) for o in outs])


# ---------------------------------------------------------------------------
# Sharded group execution: row-sharded two-phase with psum measures
# ---------------------------------------------------------------------------

# Measures whose value decomposes into a sum of per-row-block integer
# partials (finalized with the single-device formula after the psum).
# Everything else routes through batch_sharded.
ROW_MEASURES = ("degree", "num_nodes", "num_edges", "density",
                "avg_degree")


def _row_parts(nodes_l, adj_l, v, row0: int, measure: str):
    """Integer partial sums of one shard's row blocks: i32[Q, 2] =
    (node-ish partial, edge partial) for Q reconstructed blocks
    (``nodes_l`` [Q, R], ``adj_l`` [Q, R, N], ``v`` i64[Q]).  Edge rows
    count each edge twice across the mesh — finalization halves, as
    ``DenseGraph.num_edges`` does."""
    if measure == "degree":
        r = adj_l.shape[-2]
        lv = v - row0
        ok = (lv >= 0) & (lv < r)
        rows = adj_l[torch.arange(adj_l.shape[0], device=adj_l.device),
                     lv.clamp(0, r - 1)]
        deg = torch.where(ok, rows.sum(-1, dtype=I32),
                          torch.zeros((), dtype=I32, device=adj_l.device))
        return torch.stack([deg, torch.zeros_like(deg)], -1)
    return torch.stack([nodes_l.sum(-1, dtype=I32),
                        adj_l.sum((-2, -1), dtype=I32)], -1)


def _row_finalize(tot, measure: str):
    """Global measure from psum'd partials — the same arithmetic as the
    single-device measures of ``core.queries`` (exact for integers, the
    same f32 expression for density / avg_degree)."""
    if measure in ("degree", "num_nodes"):
        return tot[..., 0]
    e = torch.div(tot[..., 1], 2, rounding_mode="floor")
    if measure == "num_edges":
        return e
    if measure == "density":
        return _density(tot[..., 0], e)
    if measure == "avg_degree":
        return _avg_degree(tot[..., 0], e)
    raise ValueError(f"measure {measure} is not row-decomposable")


def _finish(kind: str, parts, finalize, measure: str, mesh: GraphMesh,
            tks, tls, num_buckets: int, agg: str):
    """psum the shards' partials and finalize one group: ``parts`` is a
    list over shards of i32[B, 2] (point), of (i32[B, 2], i32[B, 2])
    (diff: SG_tl, SG_tk), or of i32[B, nb, 2] (agg)."""
    if kind == "point":
        return finalize(psum(parts, mesh), measure)
    if kind == "diff":
        a = finalize(psum([p[0] for p in parts], mesh), measure)
        b = finalize(psum([p[1] for p in parts], mesh), measure)
        return torch.abs(a - b)
    vals = finalize(psum(parts, mesh), measure)              # [B, nb]
    width = torch.as_tensor(tls - tks + 1).to(vals.device)
    return masked_aggregate(vals, width, num_buckets, agg)


def _group_times(kind: str, t_anchor: int, tks, tls, vs,
                 num_buckets: int):
    """One group's reconstructions: (times, nodes) with one entry each —
    point → t_k, diff → t_l (SG_tk then comes from SG_tl), agg → t_k + b
    for every bucket (times past a query's t_l are computed and masked)
    — and the union (t_lo, t_hi] of every window the group resolves, as
    host ints."""
    if kind == "point":
        ts, vv = tks, vs
    elif kind == "diff":
        ts, vv = tls, vs
    else:
        ts = (tks[:, None] + np.arange(num_buckets, dtype=np.int32)
              ).reshape(-1)
        vv = np.repeat(vs, num_buckets)
    span = np.concatenate([[int(t_anchor)], ts, tks])
    return ts, vv, (int(span.min()), int(span.max()))


def _shard_parts(kind: str, device, t_anchor: int, ts, tks, vv,
                 item_bytes: int, num_buckets: int, parts_at):
    """One shard's partials over a group's reconstructions (``ts``/``vv``
    from ``_group_times``), in memory-sized chunks.  ``parts_at(ta, tq,
    tk, v)`` reconstructs the shard's block at the times ``tq`` and
    returns its i32[q, 2] partials — for diff (``tk`` given) stacked
    with those at ``tk``, reconstructed from the blocks at ``tq``.
    Returns i32[B, 2], a pair of them (diff) or i32[B, nb, 2] (agg)."""
    step = fit_batch(device, item_bytes, len(ts))
    out = []
    for s in range(0, len(ts), step):
        sl = slice(s, s + step)
        tq = as_times(ts[sl], None, device)
        out.append(parts_at(
            as_times(t_anchor, tq.numel(), device), tq,
            as_times(tks[sl], None, device) if kind == "diff" else None,
            torch.as_tensor(vv[sl], dtype=torch.int64).to(device)))
    p = torch.cat(out, -2)
    if kind == "diff":
        return p[0], p[1]
    if kind == "agg":
        return p.view(len(tks), num_buckets, 2)
    return p


def two_phase_rows(mesh: GraphMesh, anchor_rows, delta, t_anchor, tks, tls,
                   vs, *, kind: str, measure: str, agg: str = "",
                   num_buckets: int = 0):
    """One two-phase (plan, anchor) group as a row-parallel program.

    ``anchor_rows`` holds one row block per device (``shard_rows``);
    the delta is replicated (``Replicated``, or copied now) and the
    query arrays (i32 numpy, one entry per query) go to every device.
    Each device LWW-reconstructs only its row block at every query time
    — B1 on a ``[Q, N/D, N]`` block at ``row0`` — and emits integer
    partial sums; one psum per group combines them, and the measure is
    finalized with the single-device formula, so results bit-match the
    engine's ``batch_two_phase_*``.

    Supported: kind ∈ {point, diff, agg} × measure ∈ ROW_MEASURES.
    """
    ts, v_all, (lo, hi) = _group_times(kind, t_anchor, tks, tls, vs,
                                       num_buckets)
    parts = []
    for i, blk in enumerate(anchor_rows):
        d = _local(delta, i, mesh)
        r, n = blk.adj.shape
        row0 = i * r
        buckets = bucket_ops(d, n, lo, hi, row0=row0, n_rows=r)

        def parts_at(ta, tq, tk, v):
            nodes, adj = delta_apply_row_block(blk.nodes, blk.adj, d, ta, tq,
                                               row0, buckets)
            p = _row_parts(nodes, adj, v, row0, measure)
            if tk is None:
                return p
            # SG_tk from each query's own SG_tl — the nearer snapshot, as
            # the single-device diff reuses it
            nk, ak = delta_apply_row_block(nodes, adj, d, tq, tk, row0,
                                           buckets)
            return torch.stack([p, _row_parts(nk, ak, v, row0, measure)])

        parts.append(_shard_parts(kind, mesh.devices[i], t_anchor, ts, tks,
                                  v_all, r * n + r, num_buckets, parts_at))
    return _finish(kind, parts, _row_finalize, measure, mesh, tks, tls,
                   num_buckets, agg)


# ---------------------------------------------------------------------------
# Sharded group execution: slot-sharded edge-layout two-phase
# ---------------------------------------------------------------------------

# Slots partition the edge set (each undirected edge lives in exactly
# one slot), so per-shard popcounts / incident-slot counts sum to the
# global count — the same exactness argument as row sharding, with no
# edge counted twice.
SLOT_MEASURES = ROW_MEASURES


def _slot_parts(nodes_cur, live_l, eu_l, ev_l, v, measure: str):
    """Integer partial sums of one shard's slot blocks: i32[Q, 2] =
    (node-ish partial, edge partial) for Q reconstructed blocks
    (``live_l`` bool[Q, S]).  ``nodes_cur`` is the replicated node mask
    [Q, N] on shard 0 and None on the others, which count no node."""
    if measure == "degree":
        touch = live_l & ((eu_l == v[:, None]) | (ev_l == v[:, None]))
        deg = touch.sum(-1, dtype=I32)
        return torch.stack([deg, torch.zeros_like(deg)], -1)
    ee = live_l.sum(-1, dtype=I32)
    nn = (nodes_cur.sum(-1, dtype=I32) if nodes_cur is not None
          else torch.zeros_like(ee))
    return torch.stack([nn, ee], -1)


def _slot_finalize(tot, measure: str):
    """Global measure from psum'd slot partials — the single-device edge
    measures' arithmetic: slots count each edge once, so no halving."""
    if measure in ("degree", "num_nodes"):
        return tot[..., 0]
    if measure == "num_edges":
        return tot[..., 1]
    if measure == "density":
        return _density(tot[..., 0], tot[..., 1])
    if measure == "avg_degree":
        return _avg_degree(tot[..., 0], tot[..., 1])
    raise ValueError(f"measure {measure} is not slot-decomposable")


def _reg_block(blk: EdgeGraph, slot0: int) -> torch.Tensor:
    """Which slots of a block are registered (global slot < n_reg)."""
    s = blk.emask.shape[-1]
    return (slot0 + torch.arange(s, device=blk.device)) < blk.n_edges_reg


def two_phase_slots(mesh: GraphMesh, anchor_slots, delta, t_anchor, tks,
                    tls, vs, *, kind: str, measure: str, agg: str = "",
                    num_buckets: int = 0):
    """One edge-layout two-phase (plan, anchor) group as a
    slot-parallel program.

    ``anchor_slots`` holds one slot block per device (``shard_slots``:
    eu / ev / emask cut, the node mask replicated); the delta is
    replicated and the query arrays go to every device.  Each device
    LWW-reconstructs only its slot block per query time — B2 on
    ``[E/D]`` slots at ``slot0`` — and emits integer partial sums; one
    psum per group combines them and the single-device edge formula
    finalizes them, so results bit-match ``batch_two_phase_*`` on the
    edge layout, and hence the dense path too.

    Supported: kind ∈ {point, diff, agg} × measure ∈ SLOT_MEASURES.
    """
    ts, v_all, (lo, hi) = _group_times(kind, t_anchor, tks, tls, vs,
                                       num_buckets)
    nodes_needed = measure != "degree"
    parts = []
    for i, blk in enumerate(anchor_slots):
        d = _local(delta, i, mesh)
        s_len = blk.emask.shape[-1]
        slot0 = i * s_len
        reg_l = _reg_block(blk, slot0)
        buckets = bucket_slot_ops(d, s_len, lo, hi, slot0=slot0)
        # the replicated node mask is resolved and counted on shard 0
        nodes = blk.nodes if i == 0 and nodes_needed else None

        def parts_at(ta, tq, tk, v):
            nd, em = edge_delta_apply_slot_block(nodes, blk.emask, d, ta, tq,
                                                 slot0, buckets)
            p = _slot_parts(nd, em & reg_l, blk.eu, blk.ev, v, measure)
            if tk is None:
                return p
            ndk, emk = edge_delta_apply_slot_block(nd, em, d, tq, tk, slot0,
                                                   buckets)
            return torch.stack([p, _slot_parts(ndk, emk & reg_l, blk.eu,
                                               blk.ev, v, measure)])

        parts.append(_shard_parts(kind, mesh.devices[i], t_anchor, ts, tks,
                                  v_all, s_len + blk.nodes.shape[-1],
                                  num_buckets, parts_at))
    return _finish(kind, parts, _slot_finalize, measure, mesh, tks, tls,
                   num_buckets, agg)


# ---------------------------------------------------------------------------
# Sharded group execution: slot-sharded incremental time sweeps (evolve)
# ---------------------------------------------------------------------------


def evolve_slots(mesh: GraphMesh, anchor_slots, d_rec, d_net, t_anchor,
                 t_los, widths, vs, *, measure: str, scope: str,
                 stride: int, num_buckets: int):
    """One evolve (sweep) group as a slot-parallel program.

    The reconstruction at each query's t_lo is what shards: each device
    runs B2 on its slot block and emits integer partials of the start
    state (per-node degree counts from its live slots, its live-slot
    count; the replicated node mask counts on shard 0 only).  ONE psum
    of those partials rebuilds the exact start state on the first
    device, and the sweep half (``kernels.evolve_sweep.ops.
    sweep_from_state``: B4 over the LEAF ``d_net``) runs once there, so
    the outputs bit-match the single-device ``batch_evolve``.
    """
    from repro_torch.kernels.evolve_sweep.ops import sweep_from_state
    parts = []
    for i, blk in enumerate(anchor_slots):
        dev = mesh.devices[i]
        d = _local(d_rec, i, mesh)
        s_len = blk.emask.shape[-1]
        slot0 = i * s_len
        n = blk.nodes.shape[-1]
        tq = as_times(t_los, None, dev)
        ta = as_times(t_anchor, tq.numel(), dev)
        nd, em = edge_delta_apply_slot_block(blk.nodes if i == 0 else None,
                                             blk.emask, d, ta, tq, slot0)
        live = (em & _reg_block(blk, slot0)).to(I32)
        deg_p = torch.zeros((tq.numel(), n), dtype=I32, device=dev)
        deg_p.index_add_(1, blk.eu, live)
        deg_p.index_add_(1, blk.ev, live)
        nd = torch.zeros_like(deg_p) if nd is None else nd.to(I32)
        parts.append((deg_p, nd, nd.sum(-1, dtype=I32),
                      live.sum(-1, dtype=I32)))
    state = tuple(psum([p[k] for p in parts], mesh) for k in range(4))
    return sweep_from_state(state, _local(d_net, 0, mesh), t_los, widths, vs,
                            measure=measure, scope=scope, stride=stride,
                            num_buckets=num_buckets)


# ---------------------------------------------------------------------------
# Row-parallel reconstruction
# ---------------------------------------------------------------------------


def dist_reconstruct(mesh: GraphMesh, current_rows, delta, t_anchor,
                     t_query) -> tuple:
    """SG_{t_query}, each row block reconstructed on its own device (B1
    on the block), no communication: one DenseGraph block per device."""
    out = []
    for i, blk in enumerate(current_rows):
        dev = mesh.devices[i]
        nodes, adj = delta_apply_row_block(
            blk.nodes, blk.adj, _local(delta, i, mesh),
            as_times(t_anchor, 1, dev), as_times([int(t_query)], None, dev),
            i * blk.adj.shape[0])
        out.append(DenseGraph(nodes=nodes[0], adj=adj[0]))
    return tuple(out)


# ---------------------------------------------------------------------------
# Global measures with psum combination
# ---------------------------------------------------------------------------


def dist_num_edges(mesh: GraphMesh, g_rows):
    return torch.div(psum([b.adj.sum(dtype=I32) for b in g_rows], mesh), 2,
                     rounding_mode="floor")


def dist_degrees(mesh: GraphMesh, g_rows) -> torch.Tensor:
    return torch.cat([b.adj.sum(-1, dtype=I32).to(mesh.first)
                      for b in g_rows])


def dist_degree_distribution(mesh: GraphMesh, g_rows, max_deg: int):
    parts = []
    for b in g_rows:
        deg = torch.clamp(b.adj.sum(-1, dtype=I32), 0, max_deg)
        hist = torch.zeros((max_deg + 1,), dtype=I32, device=b.device)
        parts.append(hist.index_add_(0, deg, b.nodes.to(I32)))
    return psum(parts, mesh)


def dist_triangles(mesh: GraphMesh, g_rows):
    """trace(A³)/6 with row-sharded A: on each device a float32 product
    of its row block with the gathered adjacency, elementwise with the
    block, summed; psum.  A plain product (``torch.matmul``, TF32 off),
    as the reference leaves it to XLA outside any kernel; exact while
    the path counts stay below 2^24."""
    parts = []
    for b in g_rows:
        a_l = b.adj.to(torch.float32)
        a_full = torch.cat([x.adj.to(b.device, torch.float32)
                            for x in g_rows])
        parts.append(torch.sum(torch.matmul(a_l, a_full) * a_l))
        del a_full
    return (psum(parts, mesh) / 6.0).to(I32)


# ---------------------------------------------------------------------------
# Batched historical query serving (hybrid plan)
# ---------------------------------------------------------------------------


def dist_batch_point_degree(mesh: GraphMesh, current_rows, delta, vs, ts,
                            t_cur):
    """A batch of point node-centric degree queries: degree(vs[i]) at
    ts[i].  Current-degree partials come from the owning shard (psum);
    the delta correction is O(B·M) integer work on the log, done once on
    the first device (every shard's copy would give the same)."""
    parts = []
    for i, b in enumerate(current_rows):
        r = b.adj.shape[0]
        lv = torch.as_tensor(vs, dtype=torch.int64).to(b.device) - i * r
        ok = (lv >= 0) & (lv < r)
        deg = b.adj[lv.clamp(0, r - 1)].sum(-1, dtype=I32)
        parts.append(torch.where(ok, deg, torch.zeros_like(deg)))
    deg_cur = psum(parts, mesh)
    d = _local(delta, 0, mesh)
    dev = mesh.first
    v = torch.as_tensor(vs, dtype=torch.int64).to(dev)[:, None]
    t = torch.as_tensor(ts, dtype=I32).to(dev)[:, None]
    win = (d.t[None, :] > t) & (d.t[None, :] <= int(t_cur)) \
        & d.valid_mask()[None, :]
    touch = (d.u[None, :] == v) | (d.v[None, :] == v)
    sign = torch.where(d.op == ADD_EDGE, 1,
                       torch.where(d.is_edge_op(), -1, 0)).to(I32)[None, :]
    corr = torch.sum(sign * (win & touch).to(I32), 1, dtype=I32)
    return deg_cur - corr
