"""Unified historical-query engine: anchor planner + batched executor —
the PyTorch mirror of ``repro.core.engine`` (single device).

* ``AnchorSelector`` — §2.2 (materialized snapshots + Theorem 1): the
  anchor candidates are SG_tcur plus every materialized snapshot, costed
  by time distance or by #ops in the connecting delta window.

* ``Planner`` — §3.2 (Table 2 plans) × §3.3 (partial reconstruction,
  delta indexes): picks {two-phase, delta-only, hybrid}, the variant and
  the layout per query.  Its cost constants are ``repro``'s, copied as
  they are.

* ``evaluate_many`` — the batched multi-query executor: B queries are
  grouped by (plan choice, anchor), and each group runs as batched
  tensor programs — for two-phase groups, ONE launch of the LWW
  reconstruction kernel over all the group's times (chunked by free
  device memory), then the measures.  The leading batch dimension
  stands in for ``vmap``; batched results bit-match the single-query
  path.

* Multi-device serving: given a mesh (``sharding.graph.GraphMesh``)
  and ``shard="force"``, every group runs as one sharded program
  (``core.distributed``) along the axis the planner names
  (``Planner.shard_mode``): the query batch split (``"batch"``), the
  adjacency rows (``"rows"``) or the edge slots (``"slots"``).  Sharded
  and single-device execution return bit-identical results.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Literal, Sequence

import numpy as np
import torch

from repro_torch.core import distributed as D
from repro_torch.core.delta import Delta, pow2_capacity as _pow2
from repro_torch.core.graph import DenseGraph, EdgeGraph, dense_to_edge
from repro_torch.core.index import (NodeIndex, count_window_ops,
                                    gather_nodes_ops, gather_window)
from repro_torch.core.partial import partial_reconstruct_many, seed_mask
from repro_torch.core.plans import (Query, applicable_plans,
                                    delta_only_degree_diff,
                                    hybrid_point_degree, masked_aggregate,
                                    measure_named)
from repro_torch.core.queries import edge_supported
from repro_torch.core.reconstruct import (as_times, degree_series,
                                          fit_batch,
                                          node_degree_series,
                                          reconstruct_dense,
                                          reconstruct_dense_many,
                                          reconstruct_edge,
                                          reconstruct_edge_many, window_of)
from repro_torch.core.segments import (SegmentedDeltaView,
                                       window_ops_count as _window_ops_host)
from repro_torch.kernels.delta_apply import bucket_ops
from repro_torch.kernels.edge_delta_apply import bucket_slot_ops
from repro_torch.obs import clock as _clock
from repro_torch.obs.metrics import COUNT_BUCKETS, default_registry
from repro_torch.obs.trace import trace_span
from repro_torch.sharding.graph import (batch_pad, check_mesh, divides,
                                        mesh_size, replicate, shard_rows,
                                        shard_slots)

I32 = torch.int32


class WatermarkError(ValueError, RuntimeError):
    """A query's time lies beyond the engine's serving watermark
    ``t_served``: ops at that time may still sit in a pending ingest
    buffer, so the frozen state cannot answer it exactly.  A
    ``ValueError`` (an invalid argument at this instant) that keeps the
    historic ``RuntimeError`` base."""


# ---------------------------------------------------------------------------
# Anchor selection (paper §2.2, Theorem 1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnchorCandidate:
    """One reconstruction anchor: the current snapshot (id == -1) or a
    materialized snapshot (id == index into the materialized store)."""

    anchor_id: int
    t: int
    cost: int


class AnchorSelector:
    """Picks the cheapest anchor snapshot for reconstructing SG_t.

    Candidates are SG_tcur (when given) plus every materialized
    snapshot.  ``method='ops'`` prices a candidate by #ops in the window
    between it and the query time (exact cost proxy); ``'time'`` by
    |t_candidate - t_query|.
    """

    def __init__(self, times: Sequence[int], snapshots: Sequence,
                 *, t_cur: int | None = None, current=None, t_host=None):
        if len(times) != len(snapshots):
            raise ValueError("times and snapshots differ in length")
        self.times = [int(t) for t in times]
        self.snapshots = list(snapshots)
        self.t_cur = t_cur
        self.current = current
        # host timestamps — or a SegmentedDeltaView — for sync-free
        # window costing
        self.t_host = t_host

    def candidates(self, t_query: int, delta,
                   method: Literal["time", "ops"] = "ops"
                   ) -> list[AnchorCandidate]:
        cands = []

        def cost(t_a: int) -> int:
            if method == "time":
                return abs(int(t_a) - int(t_query))
            lo, hi = min(t_a, t_query), max(t_a, t_query)
            if self.t_host is not None:
                return _window_ops_host(self.t_host, lo, hi)
            if isinstance(delta, SegmentedDeltaView):
                return delta.window_ops(lo, hi)
            return count_window_ops(delta, lo, hi)

        if self.current is not None and self.t_cur is not None:
            cands.append(AnchorCandidate(-1, int(self.t_cur),
                                         cost(self.t_cur)))
        for i, t_a in enumerate(self.times):
            cands.append(AnchorCandidate(i, t_a, cost(t_a)))
        if not cands:
            raise ValueError("no anchor candidates (no current snapshot "
                             "and no materialized snapshots)")
        return cands

    def select(self, t_query: int, delta,
               method: Literal["time", "ops"] = "ops") -> AnchorCandidate:
        # stable tie-break: earliest candidate wins (current first)
        return min(self.candidates(t_query, delta, method),
                   key=lambda c: c.cost)

    def get(self, anchor_id: int):
        if anchor_id == -1:
            if self.current is None:
                raise ValueError("no current snapshot registered")
            return int(self.t_cur), self.current
        return self.times[anchor_id], self.snapshots[anchor_id]


# ---------------------------------------------------------------------------
# Plan choice (paper §3.2 Table 2 × §3.3 variants)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanChoice:
    """A fully resolved execution recipe for one query."""

    plan: str                 # two_phase | delta_only | hybrid
    anchor_id: int = -1       # -1 = current snapshot
    t_anchor: int = 0
    indexed: bool = False     # node-centric index (§3.3.2)
    windowed: bool = False    # temporal-index window slice (§3.3.2)
    partial: bool = False     # partial reconstruction (§3.3.1)
    layout: str = "dense"     # dense (N² adjacency) | edge (E slots)
    cost: int = 0             # planner's op-count estimate


class Planner:
    """Cost-based plan selection from delta / index statistics.

    Costs are op counts (the paper's unit): a plan pays for the delta
    window it must traverse, plus a layout surcharge for dense
    reconstruction (the N² LWW scatter) that the measure-only plans
    avoid.  Degree queries admit all of Table 2; other measures fall
    back to two-phase, as in the paper.

    The planner also names a group's *cross-device axis*
    (``shard_mode``): given a (plan, anchor) group and a mesh size, the
    axis it can shard along (query batch, adjacency rows or edge slots).
    """

    def __init__(self, selector: AnchorSelector, *, n_cap: int,
                 index: NodeIndex | None = None, node_cap: int = 1024,
                 selection: Literal["time", "ops"] = "ops",
                 e_cap: int = 0, dense_available: bool = True,
                 edge_available: bool = False, seg_view=None):
        self.selector = selector
        self.n_cap = int(n_cap)
        self.index = index
        self.node_cap = int(node_cap)
        self.selection = selection
        self.e_cap = int(e_cap)
        self.dense_available = bool(dense_available)
        self.edge_available = bool(edge_available)
        # per-segment node-count statistics stand in for the index's
        # row extents
        self.seg_view = seg_view
        self._row_ptr_host: np.ndarray | None = None

    def _window_ops(self, delta, t_lo, t_hi) -> int:
        if self.selector.t_host is not None:
            return _window_ops_host(self.selector.t_host, t_lo, t_hi)
        return count_window_ops(delta, t_lo, t_hi)

    def _node_ops(self, v: int) -> int | None:
        """#ops touching node v: index row extent, else the segmented
        log's per-segment node counts, else unknown."""
        if v is None:
            return None
        if self.index is not None:
            if self._row_ptr_host is None:
                # graphlint: ignore[host-sync] one host copy of the index's row pointers a session, cached for the planner's per-node costs
                self._row_ptr_host = self.index.row_ptr.cpu().numpy()
            ptr = self._row_ptr_host
            return int(ptr[v + 1] - ptr[v])
        if self.seg_view is not None:
            return self.seg_view.node_ops(v)
        return None

    def layout_for(self, q: Query, plan: str) -> str:
        """{dense, edge} execution layout for one query: the N²-vs-E
        cost term among eligible queries (a slot registry present and an
        edge implementation of the measure)."""
        if not self.edge_available or not edge_supported(q.measure,
                                                         q.scope):
            return "dense"
        if not self.dense_available:
            return "edge"
        if plan != "two_phase":
            return "dense"
        dense_scatter = (self.n_cap if q.scope == "node"
                         and q.measure == "degree" and q.kind != "diff"
                         else self.n_cap ** 2 // 64)
        return "edge" if self.e_cap // 64 < dense_scatter else "dense"

    def choose(self, q: Query, delta, t_cur: int) -> PlanChoice:
        plans = applicable_plans(q)
        anchor = self.selector.select(q.t_k, delta, self.selection)
        if q.kind == "evolve":
            # the sweep reconstructs ONCE at t_lo: only the anchor and
            # the layout are real choices
            return PlanChoice(plan="two_phase", anchor_id=anchor.anchor_id,
                              t_anchor=anchor.t,
                              layout=self.layout_for(q, "two_phase"),
                              cost=anchor.cost)
        scatter = self.n_cap if q.scope == "node" else self.n_cap ** 2 // 64
        cost_two = anchor.cost + scatter
        # partial reconstruction only where its closure provably covers
        # the query: single-window reconstructions of a degree measure
        use_partial = (q.scope == "node" and q.measure == "degree"
                       and q.kind != "diff")

        best_plan, best_cost = "two_phase", cost_two
        if q.measure == "degree" and q.scope == "node":
            n_ops = self._node_ops(q.v)
            if "hybrid" in plans:
                c = self._window_ops(delta, q.t_k, t_cur)
                if n_ops is not None:
                    c = min(c, n_ops)
                if c < best_cost:
                    best_plan, best_cost = "hybrid", c
            if "delta_only" in plans:
                c = self._window_ops(delta, q.t_k, q.t_l)
                if n_ops is not None:
                    c = min(c, n_ops)
                if c < best_cost:
                    best_plan, best_cost = "delta_only", c

        # the index gathers a node's ops by position: only for node
        # scope, the measure-only plans, and nodes within node_cap ops
        indexed = (self.index is not None and q.scope == "node"
                   and best_plan in ("delta_only", "hybrid")
                   and (self._node_ops(q.v) or 0) <= self.node_cap)
        windowed = (best_plan == "two_phase"
                    and _pow2(anchor.cost, 64) * 2 <= delta.capacity)
        layout = self.layout_for(q, best_plan)
        return PlanChoice(plan=best_plan, anchor_id=anchor.anchor_id,
                          t_anchor=anchor.t, indexed=indexed,
                          windowed=windowed,
                          partial=(use_partial and best_plan == "two_phase"
                                   and layout == "dense"),
                          layout=layout, cost=best_cost)

    # ------------------------------------------------- cross-device dispatch

    def shard_mode(self, key, n_dev: int) -> str | None:
        """The axis one (plan, anchor) group shards along over ``n_dev``
        devices: ``"rows"`` (dense two-phase, B1 on row blocks + psum
        measures), ``"slots"`` (edge two-phase, B2 on slot blocks + psum
        measures), ``"batch"`` (replicate the graph, split the query
        axis), or ``None`` (nothing to shard over).  Every group can
        batch-shard; the axis never makes an unshardable group
        shardable.
        """
        if n_dev <= 1:
            return None
        evolve = getattr(key, "kind", "") == "evolve"
        if key.plan == "two_phase" and getattr(key, "layout",
                                               "dense") == "edge":
            # slots partition the edge set, so per-shard popcounts and
            # degree counts sum to the global value; evolve also admits
            # degree_distribution, a finalization of the summed degrees
            slot_ok = (key.measure in D.SLOT_MEASURES
                       or (evolve and key.measure == "degree_distribution"))
            if slot_ok and divides(self.e_cap, n_dev):
                return "slots"
        elif key.plan == "two_phase":
            # rows need a row-decomposable measure, an even split, and no
            # partial reconstruction (the closure mask is a full-graph
            # object); a dense sweep batch-shards instead
            if (key.measure in D.ROW_MEASURES and not key.partial
                    and not evolve and divides(self.n_cap, n_dev)):
                return "rows"
            # fall through: a two-phase group is still batch-shardable
        return "batch"


# ---------------------------------------------------------------------------
# Batched executors (a leading query dimension in place of vmap)
# ---------------------------------------------------------------------------


def _snapshot_bytes(g) -> int:
    """Approximate device footprint of a snapshot (bool N² for dense,
    (4+4+1)·E + N for edge) — the reconstruction LRU's byte budget."""
    if isinstance(g, EdgeGraph):
        return 9 * g.e_cap + g.n_cap
    return g.n_cap * g.n_cap + g.n_cap


def _chunk(g, q: int) -> int:
    """How many reconstructions of ``g``'s size one launch may produce
    (``core.reconstruct.fit_batch``)."""
    return fit_batch(g.device, _snapshot_bytes(g), q)


def _measure_rows(g, measure: str, scope: str, vs: Sequence[int]):
    """Measure each snapshot of a batch (row i at node vs[i])."""
    return torch.stack([measure_named(g.take(i), measure, scope, int(v))
                        for i, v in enumerate(vs)])


def batch_measure(g, vs, *, measure: str, scope: str):
    """Measure one (already reconstructed) snapshot at B nodes — the
    execution half of the reconstruction cache."""
    return torch.stack([measure_named(g, measure, scope, int(v))
                        for v in vs])


class _Recon:
    """Chunked batched reconstruction for one group against one anchor:
    buckets the group's delta once, then reconstructs in chunks sized
    from free memory (a dense agg group holds B × buckets snapshots of
    N² each) and hands each chunk to a measuring function."""

    def __init__(self, anchor, delta: Delta, t_anchor, times, *,
                 partial: bool = False, passes: int = 2):
        self.anchor = anchor
        self.delta = delta
        self.t_anchor = t_anchor
        self.edge = isinstance(anchor, EdgeGraph)
        self.partial = partial and not self.edge
        self.passes = passes
        dev = anchor.device
        lo, hi = window_of(as_times(t_anchor, None, dev),
                           as_times(np.asarray(times), None, dev))
        self.buckets = (bucket_slot_ops(delta, anchor.e_cap, lo, hi)
                        if self.edge else
                        bucket_ops(delta, anchor.n_cap, lo, hi))

    def at(self, ts, vs, *, anchor=None, t_anchor=None,
           partial: bool | None = None):
        """Reconstruct at ``ts`` (i32 numpy, one per query) from the
        group anchor — or from per-query ``anchor``/``t_anchor``."""
        anchor = self.anchor if anchor is None else anchor
        t_anchor = self.t_anchor if t_anchor is None else t_anchor
        partial = self.partial if partial is None else partial
        if self.edge:
            return reconstruct_edge_many(anchor, self.delta, t_anchor, ts,
                                         buckets=self.buckets)
        if partial:
            seeds = seed_mask(anchor.n_cap, vs, anchor.device)
            return partial_reconstruct_many(anchor, self.delta, t_anchor,
                                            ts, seeds, passes=self.passes,
                                            buckets=self.buckets)
        return reconstruct_dense_many(anchor, self.delta, t_anchor, ts,
                                      buckets=self.buckets)

    def map(self, ts: np.ndarray, vs: np.ndarray, fn) -> torch.Tensor:
        """``fn(snapshots, rows)`` over memory-sized chunks of queries,
        concatenated.  Chunking never changes an answer: every window is
        resolved independently."""
        q = ts.shape[0]
        step = _chunk(self.anchor, q)
        return torch.cat([fn(self.at(ts[s:s + step], vs[s:s + step]),
                             slice(s, min(q, s + step)))
                          for s in range(0, q, step)])


def batch_two_phase_point(anchor, delta: Delta, t_anchor, ts, vs, *,
                          measure: str, scope: str,
                          use_partial: bool = False, passes: int = 2):
    """B point queries against one anchor (either layout): one batched
    LWW launch per memory chunk, then the measures."""
    r = _Recon(anchor, delta, t_anchor, ts,
               partial=use_partial and scope == "node", passes=passes)
    return r.map(ts, vs, lambda g, rows: _measure_rows(g, measure, scope,
                                                       vs[rows]))


def batch_two_phase_diff(anchor, delta: Delta, t_anchor, tks, tls, vs, *,
                         measure: str, scope: str,
                         use_partial: bool = False, passes: int = 2):
    """B range-differential queries: SG_tl from the anchor, then SG_tk
    from each query's own SG_tl (the nearer snapshot is reused exactly
    as the single-query plan does, so bitwise parity holds)."""
    r = _Recon(anchor, delta, t_anchor, np.concatenate([tks, tls]),
               partial=use_partial and scope == "node", passes=passes)

    def diff(g_l, rows):
        g_k = r.at(tks[rows], vs[rows], anchor=g_l, t_anchor=tls[rows],
                   partial=False)
        return torch.abs(_measure_rows(g_l, measure, scope, vs[rows])
                         - _measure_rows(g_k, measure, scope, vs[rows]))

    return r.map(tls, vs, diff)


def batch_two_phase_agg(anchor, delta: Delta, t_anchor, tks, tls, vs, *,
                        measure: str, scope: str, num_buckets: int,
                        agg: str, use_partial: bool = False,
                        passes: int = 2):
    """B range-aggregate queries over ≤ num_buckets time units each:
    the B × num_buckets reconstructions go through the kernel in
    memory-sized chunks (buckets past t_l are masked)."""
    q = tks.shape[0]
    ts = (tks[:, None] + np.arange(num_buckets, dtype=np.int32)).reshape(-1)
    vv = np.repeat(vs, num_buckets)
    r = _Recon(anchor, delta, t_anchor, ts,
               partial=use_partial and scope == "node", passes=passes)
    vals = r.map(ts, vv, lambda g, rows: _measure_rows(g, measure, scope,
                                                       vv[rows]))
    vals = vals.reshape((q, num_buckets) + vals.shape[1:])
    width = torch.as_tensor(tls - tks + 1).to(vals.device)
    return masked_aggregate(vals, width, num_buckets, agg)


def batch_hybrid_diff(current, delta: Delta, vs, tks, tls, t_cur):
    d_l = hybrid_point_degree(current, delta, vs, tls, t_cur)
    d_k = hybrid_point_degree(current, delta, vs, tks, t_cur)
    return torch.abs(d_l - d_k)


# The indexed executors: each query's node ops gathered through the
# node-centric index in one step for the group (``gather_nodes_ops``, at
# most ``cap`` of them, a [B, cap] sub-delta in place of ``vmap``), then
# the same batched plan as the unindexed group.


def batch_hybrid_point_indexed(current, delta: Delta, index: NodeIndex,
                               vs, tks, t_cur, cap: int):
    return hybrid_point_degree(current,
                               gather_nodes_ops(delta, index, vs, cap),
                               vs, tks, t_cur)


def batch_hybrid_diff_indexed(current, delta: Delta, index: NodeIndex,
                              vs, tks, tls, t_cur, cap: int):
    return batch_hybrid_diff(current, gather_nodes_ops(delta, index, vs, cap),
                             vs, tks, tls, t_cur)


def batch_delta_only_diff_indexed(delta: Delta, index: NodeIndex, vs, tks,
                                  tls, cap: int):
    return delta_only_degree_diff(gather_nodes_ops(delta, index, vs, cap),
                                  vs, tks, tls)


def batch_hybrid_agg_per_node(current, delta: Delta, vs, tks, tls,
                              w_q: int, agg: str):
    """Fallback for groups whose union window is too wide to
    materialize as an all-nodes series: one O(w_q) per-node series per
    query (no n_cap factor)."""
    degs = current.degrees()
    series = torch.stack([node_degree_series(degs[int(v)], delta, int(v),
                                             int(tk), w_q)
                          for v, tk in zip(vs, tks)])
    width = torch.as_tensor(np.asarray(tls) - np.asarray(tks) + 1).to(
        series.device)
    return masked_aggregate(series, width, w_q, agg)


def batch_hybrid_agg(current, delta: Delta, vs, tks, tls, t0, t_cur,
                     w_total: int, w_q: int, agg: str):
    """B range-aggregate degree queries off ONE shared all-nodes degree
    time-series (the degree-series kernel over the union window
    [t0, t0 + w_total)), then per-query gathers + masked aggregation —
    one delta pass amortized over every query of the group."""
    series = degree_series(current, delta, t0, t0 + w_total - 1, w_total,
                           t_cur)                       # i32[w_total, N]
    dev = series.device
    tk = torch.as_tensor(np.asarray(tks, np.int64)).to(dev)
    v = torch.as_tensor(np.asarray(vs, np.int64)).to(dev)
    idx = (tk - t0).unsqueeze(-1) + torch.arange(w_q, device=dev)
    vals = series[idx.clamp(0, w_total - 1), v.unsqueeze(-1)]
    width = torch.as_tensor(np.asarray(tls) - np.asarray(tks) + 1).to(dev)
    return masked_aggregate(vals, width, w_q, agg)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _GroupKey:
    """Everything that must be equal for two queries to share one
    batched dispatch (plan, anchor, static arguments)."""

    plan: str
    kind: str
    scope: str
    measure: str
    agg: str            # "" unless kind == "agg"
    anchor_id: int
    indexed: bool
    windowed: bool
    partial: bool
    layout: str = "dense"
    stride: int = 0     # 0 unless kind == "evolve" (sweep sample step)


class GroupStats(list):
    """``last_group_stats``: the per-call list of (group key, batch,
    shard mode) rows, plus the reconstruction-cache counters for the
    call."""

    def __init__(self, *a):
        super().__init__(*a)
        self.cache_hits = 0
        self.cache_misses = 0


class HistoricalQueryEngine:
    """Planner + batched executor over one store state.

    Construct via ``HistoricalQueryEngine.from_store(store)`` (or let
    ``TemporalGraphStore.engine()`` cache one).  The engine is a pure
    view: it never mutates the store.
    """

    def __init__(self, current: DenseGraph | None, delta, t_cur: int, *,
                 mat_times: Sequence[int] = (),
                 mat_snapshots: Sequence[DenseGraph] = (),
                 index: NodeIndex | None = None, node_cap: int = 1024,
                 selection: Literal["time", "ops"] = "ops",
                 passes: int = 2, series_budget: int = 1 << 24,
                 mesh=None, current_edge: EdgeGraph | None = None,
                 snap_cache_cap: int = 16, t_host=None):
        if current is None and current_edge is None:
            raise ValueError("need a current snapshot in at least one "
                             "layout")
        self.current = current
        self.current_edge = current_edge
        self.device = (current if current is not None
                       else current_edge).device
        # serving mesh (None: single device).  Snapshot / delta tensors
        # are placed on it lazily per role — replicated for batch-axis
        # groups, row / slot blocks per anchor for two-phase groups —
        # and cached, so steady-state serving copies nothing
        if mesh is not None:
            check_mesh(mesh, self.device)
        self.mesh = mesh
        self._placed_rep: dict = {}     # (mesh, role) -> Replicated
        self._placed_rows: dict = {}    # (mesh, anchor_id) -> row blocks
        self._placed_slots: dict = {}   # (mesh, anchor_id) -> slot blocks
        # the full device log (a bare Delta) OR a SegmentedDeltaView:
        # planning reads only .capacity / window counts from it, and
        # executors materialize per-group windows
        self.delta = delta
        self.view = delta if isinstance(delta, SegmentedDeltaView) else None
        self.t_cur = int(t_cur)
        # node-centric index (§3.3.2) over the full log, by position;
        # indexed groups gather at most node_cap ops of their node
        self.index = index
        self.node_cap = int(node_cap)
        self.passes = int(passes)
        # max elements of the shared all-nodes degree series one agg
        # group may materialize (i32; 1<<24 ≈ 64 MB)
        self.series_budget = int(series_budget)
        # per-anchor reconstruction LRU: (anchor_id, t, layout) ->
        # snapshot, bounded by entry count AND device bytes
        self.snap_cache_cap = int(snap_cache_cap)
        self.snap_cache_bytes = 256 << 20
        self._snap_cache_total = 0
        self._snap_cache: OrderedDict = OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0
        self.last_group_stats: GroupStats = GroupStats()
        self._stats_active = False
        self.slow_log = None
        self.bind_metrics(default_registry())
        # serving plumbing (repro_torch.serving): the live watermark and
        # an optional workload recorder
        self.t_served: int | None = None
        self.workload = None
        self._edge_anchors: dict = {}
        if self.view is not None:
            self.t_host = self.view
        elif t_host is not None:
            self.t_host = t_host
        else:
            # graphlint: ignore[host-sync] one host copy of the log's times at engine build, for the planner's window counts
            self.t_host = delta.t[:delta.n_ops].cpu().numpy()
        n_cap = (current.n_cap if current is not None
                 else current_edge.n_cap)
        # edge-only engines register the edge current as the -1 anchor
        self.selector = AnchorSelector(
            mat_times, mat_snapshots, t_cur=self.t_cur,
            current=current if current is not None else current_edge,
            t_host=self.t_host)
        self.planner = Planner(
            self.selector, n_cap=n_cap, index=index, node_cap=node_cap,
            selection=selection,
            e_cap=current_edge.e_cap if current_edge is not None else 0,
            dense_available=current is not None,
            edge_available=current_edge is not None,
            seg_view=self.view)

    @classmethod
    def from_store(cls, store, *, indexed: bool = False,
                   node_cap: int = 1024,
                   selection: Literal["time", "ops"] = "ops", mesh=None):
        current = store.current
        if not isinstance(current, DenseGraph):
            current = None  # edge-layout store: no N² state anywhere
        if store.segmented:
            # the segment view: no full-log device conversion, no O(M)
            # host timestamp copy
            dref, t_host = store.delta_view(), None
        else:
            dref, t_host = store.delta(), store.op_times_host()
        return cls(current, dref, store.t_cur,
                   mat_times=store.materialized.times,
                   mat_snapshots=store.materialized.snapshots,
                   index=store.node_index() if indexed else None,
                   node_cap=node_cap, selection=selection, mesh=mesh,
                   current_edge=store.current_edge_snapshot(),
                   t_host=t_host)

    # --------------------------------------------------- device placement

    def _replicated(self, mesh, role, tree):
        """Cache a copy of ``tree`` on every mesh device (graph / delta /
        index operands of batch-axis-sharded groups)."""
        key = (mesh, role)
        if key not in self._placed_rep:
            self._placed_rep[key] = replicate(tree, mesh)
        return self._placed_rep[key]

    def _row_sharded_anchor(self, mesh, anchor_id: int):
        """Cache the row blocks of one dense anchor snapshot."""
        key = (mesh, anchor_id)
        if key not in self._placed_rows:
            _, g = self.selector.get(anchor_id)
            self._placed_rows[key] = shard_rows(g, mesh)
        return self._placed_rows[key]

    def _slot_sharded_anchor(self, mesh, anchor_id: int):
        """Cache the slot blocks of one edge-layout anchor."""
        key = (mesh, anchor_id)
        if key not in self._placed_slots:
            _, g = self.edge_anchor(anchor_id)
            self._placed_slots[key] = shard_slots(g, mesh)
        return self._placed_slots[key]

    # ------------------------------------------------------ edge anchors

    def edge_anchor(self, anchor_id: int) -> tuple[int, EdgeGraph]:
        """(t, snapshot) of an anchor in edge-slot layout; materialized
        (dense) anchors are converted once through ``dense_to_edge``."""
        if self.current_edge is None:
            raise ValueError("engine has no edge-slot registry")
        if anchor_id == -1:
            return self.t_cur, self.current_edge
        cached = self._edge_anchors.get(anchor_id)
        if cached is None:
            t_a, g = self.selector.get(anchor_id)
            if not isinstance(g, EdgeGraph):
                g = dense_to_edge(g, self.current_edge)
            cached = (t_a, g)
            self._edge_anchors[anchor_id] = cached
        return cached

    # -------------------------------------------------------- observability

    def bind_metrics(self, registry) -> None:
        """Resolve this engine's metric children against ``registry``
        (the serving layer rebinds every frozen epoch's engine)."""
        self.metrics = registry
        self._m_queries = registry.counter(
            "engine_queries_total", "queries evaluated (batched path)")
        self._m_calls = registry.counter(
            "engine_calls_total", "evaluate_many invocations")
        self._m_eval_seconds = registry.histogram(
            "engine_evaluate_seconds",
            "wall seconds per evaluate_many call")
        self._m_group_batch = registry.histogram(
            "engine_group_batch", "queries per dispatched group",
            buckets=COUNT_BUCKETS)
        self._m_cache_hits = registry.counter(
            "engine_snap_cache_hits_total",
            "reconstruction-LRU hits (LWW replay skipped)")
        self._m_cache_misses = registry.counter(
            "engine_snap_cache_misses_total",
            "reconstruction-LRU misses (full LWW replay)")
        self._m_slow = registry.counter(
            "engine_slow_queries_total",
            "evaluate_many calls past the slow-query threshold")

    def _slow_entry(self, queries, seconds: float, trace_seq) -> dict:
        """Full plan attribution for one slow call."""
        from repro_torch.obs.trace import active_tracer
        entry = {
            "n_queries": len(queries),
            "cache_hits": self.last_group_stats.cache_hits,
            "cache_misses": self.last_group_stats.cache_misses,
            "groups": [
                {"plan": k.plan, "kind": k.kind, "measure": k.measure,
                 "layout": k.layout, "anchor_id": k.anchor_id,
                 "indexed": k.indexed, "windowed": k.windowed,
                 "partial": k.partial, "batch": b, "shard_mode": mode}
                for k, b, mode in self.last_group_stats],
        }
        tracer = active_tracer()
        if tracer is not None and trace_seq is not None:
            entry["spans"] = tracer.events_since(trace_seq)
        return entry

    # ------------------------------------------- reconstruction cache

    def reconstruct_cached(self, anchor_id: int, t: int,
                           layout: str = "dense"):
        """LWW reconstruction of SG_t from one anchor, through the
        per-anchor LRU: repeated queries at hot timestamps skip the
        delta replay and only pay the measure."""
        key = (int(anchor_id), int(t), layout)
        g = self._snap_cache.get(key)
        if g is not None:
            self._snap_cache.move_to_end(key)
            self.cache_hits += 1
            self._m_cache_hits.inc()
            if self._stats_active:
                self.last_group_stats.cache_hits += 1
            return g
        self.cache_misses += 1
        self._m_cache_misses.inc()
        if self._stats_active:
            self.last_group_stats.cache_misses += 1
        with trace_span("reconstruct", anchor=int(anchor_id), t=int(t),
                        layout=layout):
            if layout == "edge":
                t_a, g_a = self.edge_anchor(anchor_id)
            else:
                t_a, g_a = self.selector.get(anchor_id)
            # a single-window LWW reconstruction masks exactly at the
            # window bounds, so the merged tree may cover the window
            d = (self.view.window_delta(min(t_a, t), max(t_a, t),
                                        merged=True)
                 if self.view is not None else self.delta)
            if layout == "edge":
                g = reconstruct_edge(g_a, d, t_a, t)
            else:
                g = reconstruct_dense(g_a, d, t_a, t)
        if self.snap_cache_cap > 0:
            self._snap_cache[key] = g
            self._snap_cache_total += _snapshot_bytes(g)
            while self._snap_cache and (
                    len(self._snap_cache) > self.snap_cache_cap
                    or self._snap_cache_total > self.snap_cache_bytes):
                _, old = self._snap_cache.popitem(last=False)
                self._snap_cache_total -= _snapshot_bytes(old)
        return g

    # ------------------------------------------------------------- planning

    def plan(self, q: Query) -> PlanChoice:
        return self.planner.choose(q, self.delta, self.t_cur)

    def _resolve(self, q: Query, plan: str, indexed: bool | None,
                 partial_rows: bool | None, windowed: bool | None,
                 layout: str | None = None) -> PlanChoice:
        """Forced-plan / forced-variant resolution (mirrors the
        ``plans.evaluate`` kwargs).  ``layout="edge"`` falls back to
        dense per query when the measure has no edge implementation."""
        if plan == "auto":
            c = self.plan(q)
        else:
            if plan not in applicable_plans(q):
                raise ValueError(f"plan {plan} not applicable to {q}")
            anchor = (self.selector.select(q.t_k, self.delta)
                      if plan == "two_phase"
                      else AnchorCandidate(-1, self.t_cur, 0))
            c = PlanChoice(plan=plan, anchor_id=anchor.anchor_id,
                           t_anchor=anchor.t,
                           layout=self.planner.layout_for(q, plan))
        if indexed is not None:
            c = dataclasses.replace(
                c, indexed=indexed and self.index is not None)
        if partial_rows is not None:
            c = dataclasses.replace(c, partial=partial_rows)
        if windowed is not None:
            c = dataclasses.replace(c, windowed=windowed)
        if c.plan != "two_phase" and q.measure != "degree":
            # the delta-only/hybrid kernels are degree-specialised
            anchor = self.selector.select(q.t_k, self.delta)
            c = dataclasses.replace(
                c, plan="two_phase", anchor_id=anchor.anchor_id,
                t_anchor=anchor.t, indexed=False,
                layout=self.planner.layout_for(q, "two_phase"))
        if c.plan != "two_phase":
            c = dataclasses.replace(c, partial=False, windowed=False,
                                    anchor_id=-1, t_anchor=self.t_cur)
        if layout is not None and layout != "auto":
            if layout == "edge":
                ok = (self.current_edge is not None
                      and edge_supported(q.measure, q.scope))
                if not ok and self.current is None:
                    raise ValueError(f"measure {q.measure} has no "
                                     "edge-layout implementation and "
                                     "the engine has no dense state")
                c = dataclasses.replace(c,
                                        layout="edge" if ok else "dense")
            elif layout == "dense":
                if self.current is None:
                    raise ValueError("engine has no dense snapshot")
                c = dataclasses.replace(c, layout="dense")
            else:
                raise ValueError(f"unknown layout {layout!r}")
        if c.layout == "edge":
            # partial reconstruction is a dense-rows concept
            c = dataclasses.replace(c, partial=False)
        if q.kind == "evolve":
            c = dataclasses.replace(c, indexed=False, windowed=False,
                                    partial=False)
        return c

    def _group_key(self, q: Query, c: PlanChoice) -> _GroupKey:
        return _GroupKey(plan=c.plan, kind=q.kind, scope=q.scope,
                         measure=q.measure, agg=q.agg if q.kind == "agg"
                         else "", anchor_id=c.anchor_id,
                         indexed=c.indexed, windowed=c.windowed,
                         partial=c.partial, layout=c.layout,
                         stride=q.stride if q.kind == "evolve" else 0)

    # ------------------------------------------------------------ execution

    def _group_delta(self, key: _GroupKey, t_anchor: int,
                     ts: np.ndarray) -> Delta:
        """The delta operand of one two-phase group: the union window
        covering every query in the group.  Reconstruction only reads
        in-window ops, so results are identical to the full log."""
        t_lo = int(min(ts.min(), t_anchor))
        t_hi = int(max(ts.max(), t_anchor))
        if self.view is not None:
            # merged-tree nodes only where EVERY window of the group
            # fully contains them: (t_anchor, min ts] going forward,
            # (max ts, t_anchor] going backward, leaves otherwise
            ts_min, ts_max = int(ts.min()), int(ts.max())
            if ts_min >= t_anchor:
                return self.view.window_delta(t_lo, t_hi, merged=True,
                                              merged_lo=t_anchor,
                                              merged_hi=ts_min)
            if ts_max <= t_anchor:
                return self.view.window_delta(t_lo, t_hi, merged=True,
                                              merged_lo=ts_max,
                                              merged_hi=t_anchor)
            return self.view.window_delta(t_lo, t_hi)
        if not key.windowed:
            return self.delta
        cap = _pow2(_window_ops_host(self.t_host, t_lo, t_hi), 64)
        if cap >= self.delta.capacity:
            return self.delta
        return gather_window(self.delta, t_lo, t_hi, cap)

    def _plan_delta(self, key: _GroupKey, tks: np.ndarray,
                    tls: np.ndarray) -> Delta:
        """The delta operand of one delta-only / hybrid group: the union
        window — (min t_k, max t_l] for delta-only, the (min t_k, log
        end] suffix for hybrid (its correction runs against SG_tcur).
        Indexed groups gather by log position, so they take the full
        (position-stable) log."""
        if self.view is None:
            return self.delta
        if key.indexed:
            return self.view.full_delta()
        if key.plan == "delta_only":
            return self.view.window_delta(int(tks.min()), int(tls.max()))
        return self.view.window_delta(int(tks.min()), None)

    def _maybe_replicated_delta(self, mesh, d: Delta):
        """A group's delta operand on the mesh: only the monolithic full
        log is cached under a stable role.  Window materializations —
        segmented or ``gather_window`` slices — pass through and are
        copied to each device by the sharded call itself (an
        identity-keyed cache would keep replicated copies alive and
        could serve a stale window after an id is reused)."""
        if self.view is None and d is self.delta:
            return self._replicated(mesh, "delta", d)
        return d

    def _anchor_role(self, key: _GroupKey):
        """The placement-cache role of a group's anchor (anchor -1 IS
        the current snapshot: one placement serves both)."""
        if key.layout == "edge":
            return ("current_edge" if key.anchor_id == -1
                    else ("edge_anchor", key.anchor_id))
        return ("current" if key.anchor_id == -1
                else ("anchor", key.anchor_id))

    def _shard_mode(self, key: _GroupKey, mesh, shard: str) -> str | None:
        """Group-level sharding decision: the planner's axis under
        ``"force"``, ``None`` otherwise (and on a mesh of one).

        ``"auto"`` keeps every group on one device: this executor runs
        the shards in turn from one thread, with host reads inside each
        shard, and a forced mix measured on the card (``chip_smoke.py``
        phase 10) ran slower than the unsharded one.  A mesh of the
        wrong device type is refused under every mode but ``"never"``.
        """
        if shard not in ("auto", "force", "never"):
            raise ValueError(f"unknown shard mode {shard!r}")
        if mesh is None or shard == "never":
            return None
        check_mesh(mesh, self.device)
        if shard == "auto":
            return None
        return self.planner.shard_mode(key, mesh_size(mesh))

    def _run_group(self, key: _GroupKey, qs: list[Query], mesh=None,
                   shard: str = "auto"):
        """Dispatch one group; returns a device tensor with one row per
        query (callers move every group's result to the host once).

        With a multi-device ``mesh`` and ``shard="force"`` the group
        runs as one sharded program (``core.distributed``) along the
        planner's axis — the query batch for hybrid / delta-only (and
        non-decomposable two-phase), adjacency rows or edge slots for
        two-phase with psum-combinable measures.  Either way the values
        are bit-identical to the single-device path's.
        """
        b = len(qs)
        mode = self._shard_mode(key, mesh, shard)
        self.last_group_stats.append((key, b, mode))
        # per-group accounting: plan / layout / shard-mode labels come
        # from closed vocabularies; the batch size goes to a histogram
        self.metrics.counter(
            "engine_groups_total", "device programs dispatched",
            plan=key.plan, layout=key.layout, shard=mode or "none").inc()
        self._m_group_batch.observe(b)
        # a batch-sharded group is padded (repeating its last query) to
        # an even split; the padding rows are cut off the result
        pad = (batch_pad(b, mesh_size(mesh)) - b) if mode == "batch" else 0
        qs = list(qs) + [qs[-1]] * pad
        tks = np.asarray([q.t_k for q in qs], np.int32)
        tls = np.asarray([q.t_l if q.t_l is not None else q.t_k
                          for q in qs], np.int32)
        vs = np.asarray([q.v if q.v is not None else 0 for q in qs],
                        np.int32)

        # Per-anchor reconstruction cache: a point group whose times
        # repeat (or already sit in the LRU) reconstructs each unique
        # time once and pays only the measures.
        if (key.plan == "two_phase" and key.kind == "point"
                and mode is None and not key.partial
                and self.snap_cache_cap > 0):
            uts = np.unique(tks)
            hits = sum((key.anchor_id, int(t), key.layout)
                       in self._snap_cache for t in uts)
            if 2 * len(uts) <= b or hits == len(uts):
                return self._run_point_group_cached(key, tks, vs)

        # One dispatch descriptor: (executor, static kwargs, positional
        # args, query-axis mask).  The same descriptor runs locally or
        # split over the mesh — the executor is the same.
        if key.plan in ("delta_only", "hybrid"):
            cur = (self.current_edge if key.layout == "edge"
                   else self.current)
            idx = self.index
            with trace_span("window_delta", plan=key.plan):
                dlt = self._plan_delta(key, tks, tls)
            if mode == "batch":
                # (the group's anchor is the current snapshot)
                cur = self._replicated(mesh, self._anchor_role(key), cur)
                dlt = self._maybe_replicated_delta(mesh, dlt)
                if idx is not None:
                    idx = self._replicated(mesh, "index", idx)
            desc = self._measure_only_desc(key, cur, dlt, idx, tks, tls, vs)
        else:
            with trace_span("anchor_select", anchor=key.anchor_id,
                            layout=key.layout):
                if key.layout == "edge":
                    t_anchor, g_anchor = self.edge_anchor(key.anchor_id)
                else:
                    t_anchor, g_anchor = self.selector.get(key.anchor_id)
            if key.kind == "evolve":
                out = self._run_evolve_group(key, mode, mesh, t_anchor,
                                             g_anchor, tks, tls, vs)
                return out[:b]
            with trace_span("window_delta", plan="two_phase",
                            anchor=key.anchor_id):
                d = self._group_delta(
                    key, t_anchor,
                    np.concatenate([tks, tls]) if key.kind != "point"
                    else tks)
            nb = (_pow2(int((tls - tks).max()) + 1) if key.kind == "agg"
                  else 0)
            if mode in ("rows", "slots"):
                d = self._maybe_replicated_delta(mesh, d)
                if mode == "rows":
                    fn = D.two_phase_rows
                    blocks = self._row_sharded_anchor(mesh, key.anchor_id)
                else:
                    fn = D.two_phase_slots
                    blocks = self._slot_sharded_anchor(mesh, key.anchor_id)
                return fn(mesh, blocks, d, t_anchor, tks, tls, vs,
                          kind=key.kind, measure=key.measure, agg=key.agg,
                          num_buckets=nb)
            if mode == "batch":
                g_anchor = self._replicated(mesh, self._anchor_role(key),
                                            g_anchor)
                d = self._maybe_replicated_delta(mesh, d)
            statics = (("measure", key.measure), ("scope", key.scope))
            if key.layout == "dense":
                statics += (("use_partial", key.partial),
                            ("passes", self.passes))
            if key.kind == "point":
                desc = (batch_two_phase_point, statics,
                        (g_anchor, d, t_anchor, tks, vs), (0, 0, 0, 1, 1))
            elif key.kind == "diff":
                desc = (batch_two_phase_diff, statics,
                        (g_anchor, d, t_anchor, tks, tls, vs),
                        (0, 0, 0, 1, 1, 1))
            else:
                desc = (batch_two_phase_agg,
                        statics + (("num_buckets", nb), ("agg", key.agg)),
                        (g_anchor, d, t_anchor, tks, tls, vs),
                        (0, 0, 0, 1, 1, 1))

        kernel, statics, args, qmask = desc
        if mode == "batch":
            return D.batch_sharded(mesh, kernel, statics, args, qmask)[:b]
        return kernel(*args, **dict(statics))

    def _measure_only_desc(self, key: _GroupKey, cur, dlt, idx, tks, tls,
                           vs) -> tuple:
        """The dispatch descriptor of one delta-only / hybrid group."""
        cap = (("cap", self.node_cap),)
        if key.plan == "delta_only":
            if key.indexed:
                return (batch_delta_only_diff_indexed, cap,
                        (dlt, idx, vs, tks, tls), (0, 0, 1, 1, 1))
            return (delta_only_degree_diff, (), (dlt, vs, tks, tls),
                    (0, 1, 1, 1))
        if key.kind == "point":
            if key.indexed:
                return (batch_hybrid_point_indexed, cap,
                        (cur, dlt, idx, vs, tks, self.t_cur),
                        (0, 0, 0, 1, 1, 0))
            return (hybrid_point_degree, (),
                    (cur, dlt, vs, tks, self.t_cur), (0, 0, 1, 1, 0))
        if key.kind == "diff":
            if key.indexed:
                return (batch_hybrid_diff_indexed, cap,
                        (cur, dlt, idx, vs, tks, tls, self.t_cur),
                        (0, 0, 0, 1, 1, 1, 0))
            return (batch_hybrid_diff, (),
                    (cur, dlt, vs, tks, tls, self.t_cur),
                    (0, 0, 1, 1, 1, 0))
        # agg: one shared series over the union window; per-query values
        # past each query's own t_l are masked
        t0 = int(tks.min())
        w_total = _pow2(int(tls.max()) - t0 + 1)
        w_q = _pow2(int((tls - tks).max()) + 1)
        n_cap = self.planner.n_cap
        if w_total * n_cap > self.series_budget:
            return (batch_hybrid_agg_per_node,
                    (("w_q", w_q), ("agg", key.agg)),
                    (cur, dlt, vs, tks, tls), (0, 0, 1, 1, 1))
        return (batch_hybrid_agg,
                (("w_total", w_total), ("w_q", w_q), ("agg", key.agg)),
                (cur, dlt, vs, tks, tls, t0, self.t_cur),
                (0, 0, 1, 1, 1, 0, 0))

    def _run_evolve_group(self, key: _GroupKey, mode, mesh, t_anchor: int,
                          g_anchor, tks: np.ndarray, tls: np.ndarray,
                          vs: np.ndarray):
        """One sweep group (``kernels.evolve_sweep.batch_evolve``):
        reconstruct each query's start state from the shared anchor in
        one launch, then the degree sweep kernel over every query — or,
        slot-sharded, ``core.distributed.evolve_slots``.

        Two delta operands with different coverage contracts: ``d_rec``
        (anchor ↔ every t_lo) feeds pure LWW reconstructions, so the
        merged tree may cover its anchor-side common subrange; ``d_net``
        (every sweep window) feeds signed counts, which need EVERY
        logged op — leaf segments only.
        """
        from repro_torch.kernels.evolve_sweep.ops import (SWEEP_MEASURES,
                                                          batch_evolve)
        if key.measure not in SWEEP_MEASURES:
            raise ValueError(
                f"measure {key.measure!r} has no incremental sweep; "
                "store.evolve falls back to point queries for it")
        stride = max(int(key.stride), 1)
        widths = ((tls - tks) // stride + 1).astype(np.int32)
        nb = _pow2(int(widths.max()))
        ts_last = tks + (widths - 1) * stride
        lo_all, hi_all = int(tks.min()), int(tks.max())
        if self.view is not None:
            w_lo = min(lo_all, t_anchor)
            w_hi = max(hi_all, t_anchor)
            if lo_all >= t_anchor:
                d_rec = self.view.window_delta(w_lo, w_hi, merged=True,
                                               merged_lo=t_anchor,
                                               merged_hi=lo_all)
            elif hi_all <= t_anchor:
                d_rec = self.view.window_delta(w_lo, w_hi, merged=True,
                                               merged_lo=hi_all,
                                               merged_hi=t_anchor)
            else:
                d_rec = self.view.window_delta(w_lo, w_hi)
            d_net = self.view.window_delta(lo_all, int(ts_last.max()))
        else:
            d_rec = d_net = self.delta
        statics = (("measure", key.measure), ("scope", key.scope),
                   ("stride", stride), ("num_buckets", nb))
        if mode is not None:
            d_rec = self._maybe_replicated_delta(mesh, d_rec)
            d_net = self._maybe_replicated_delta(mesh, d_net)
            if mode == "slots":
                return D.evolve_slots(
                    mesh, self._slot_sharded_anchor(mesh, key.anchor_id),
                    d_rec, d_net, t_anchor, tks, widths, vs,
                    **dict(statics))
            g_anchor = self._replicated(mesh, self._anchor_role(key),
                                        g_anchor)
            return D.batch_sharded(
                mesh, batch_evolve, statics,
                (g_anchor, d_rec, d_net, t_anchor, tks, widths, vs),
                (0, 0, 0, 0, 1, 1, 1))
        return batch_evolve(g_anchor, d_rec, d_net, t_anchor, tks, widths,
                            vs, **dict(statics))

    def _run_point_group_cached(self, key: _GroupKey, tks: np.ndarray,
                                vs: np.ndarray):
        """Serve one two-phase point group through the per-anchor
        reconstruction LRU: one LWW replay per *unique* query time, then
        the measures — the same functions as the batch executor, so
        per-query values are bit-identical."""
        uts, inv = np.unique(tks, return_inverse=True)
        rows: list = [None] * len(tks)
        for k, t in enumerate(uts):
            sel = np.nonzero(inv == k)[0]
            g = self.reconstruct_cached(key.anchor_id, int(t), key.layout)
            m = batch_measure(g, vs[sel], measure=key.measure,
                              scope=key.scope)
            for j, i in enumerate(sel):
                rows[i] = m[j]
        return torch.stack(rows)

    def evaluate_many(self, queries: Sequence[Query], plan: str = "auto",
                      *, indexed: bool | None = None,
                      partial_rows: bool | None = None,
                      windowed: bool | None = None,
                      layout: str | None = None,
                      return_choices: bool = False, mesh=None,
                      shard: str = "auto", enforce_watermark: bool = True):
        """Evaluate B historical queries, grouped by (plan, anchor) and
        executed as one batched dispatch per group.

        ``plan``/``indexed``/``partial_rows``/``windowed``/``layout``
        force the planner's choice uniformly (``indexed`` only where the
        engine carries the node-centric index); the default lets the
        cost model decide per query.  Returns a list of numpy values in
        query order (and the per-query ``PlanChoice`` list when
        ``return_choices``).

        ``mesh`` (default: the engine's construction-time mesh) with
        ``shard="force"`` runs every group as one multi-device program
        along the planner's axis; ``"auto"`` and ``"never"`` keep every
        group on one device (see ``_shard_mode``).  Sharded and
        single-device execution return bit-identical results; on a mesh
        of one device the ordinary path runs.  ``last_group_stats``
        names each group's mode.

        A watermarked engine (``t_served`` set by the serving layer)
        refuses queries past the watermark with ``WatermarkError``;
        ``enforce_watermark=False`` bypasses the check.
        """
        mesh = mesh if mesh is not None else self.mesh
        if self.t_served is not None and enforce_watermark:
            for q in queries:
                t_hi = q.t_k if q.t_l is None else max(q.t_k, q.t_l)
                if t_hi > self.t_served:
                    raise WatermarkError(
                        f"query time {t_hi} is past the serving "
                        f"watermark t_served={self.t_served}; swap the "
                        "ingest epoch (or pass stale='block' at the "
                        "serving layer) to advance it")
        if self.workload is not None:
            self.workload.record_queries(queries)
        from repro_torch.obs.trace import active_tracer
        tracer = active_tracer()
        trace_seq = tracer.seq if tracer is not None else None
        t_call = _clock.now()
        with trace_span("query", n=len(queries)) as top:
            with trace_span("plan", n=len(queries)):
                choices = [self._resolve(q, plan, indexed, partial_rows,
                                         windowed, layout)
                           for q in queries]
                groups: dict[_GroupKey, list[int]] = {}
                for i, (q, c) in enumerate(zip(queries, choices)):
                    groups.setdefault(self._group_key(q, c), []).append(i)
            top.set(groups=len(groups))
            self.last_group_stats = GroupStats()
            self._stats_active = True
            try:
                outs = []
                for key, idxs in groups.items():
                    with trace_span("dispatch", plan=key.plan,
                                    layout=key.layout,
                                    measure=key.measure, batch=len(idxs)):
                        outs.append((idxs, self._run_group(
                            key, [queries[i] for i in idxs], mesh=mesh,
                            shard=shard)))
            finally:
                self._stats_active = False
            with trace_span("measure", groups=len(outs)):
                fetched = [o.cpu().numpy() for _, o in outs]
            results: list = [None] * len(queries)
            for (idxs, _), arr in zip(outs, fetched):
                for j, i in enumerate(idxs):
                    q = queries[i]
                    if q.kind == "evolve":
                        # sweep rows past a query's own width repeat its
                        # last sample — slice off
                        t_l = q.t_k if q.t_l is None else q.t_l
                        bq = (int(t_l) - q.t_k) // max(int(q.stride),
                                                       1) + 1
                        results[i] = arr[j][:bq]
                    else:
                        results[i] = arr[j]
        seconds = _clock.now() - t_call
        self._m_calls.inc()
        self._m_queries.inc(len(queries))
        self._m_eval_seconds.observe(seconds)
        if self.slow_log is not None and self.slow_log.record(
                seconds,
                lambda: self._slow_entry(queries, seconds, trace_seq)):
            self._m_slow.inc()
        if return_choices:
            return results, choices
        return results

    def evaluate(self, q: Query, plan: str = "auto", **kw):
        """Single-query entry point: ``evaluate_many([q])[0]``."""
        return self.evaluate_many([q], plan, **kw)[0]
