"""The temporal graph store: current snapshot + interval delta — the
PyTorch mirror of ``repro.core.store`` (segmented or monolithic log,
optionally durable through ``repro_torch.persist``).

Implements the paper's storage model (§2.2) and update loop
(Algorithm 3): updates for the running time unit are accumulated in a
temporary delta, applied to the current snapshot at the unit boundary,
and appended to the interval delta.  The store is the host-side
component (ingest is inherently sequential): its log, legality checks
and slot registry stay numpy / python, and only the snapshots and the
per-segment deltas it hands to queries are device tensors.

Also owns: the persistent edge registry (slot ids), the
materialized-snapshot sequence + policy (§2.2), and the delta indexes
(§3.3.2).  The paper's invertibility discipline is enforced on ingest:
``remNode`` is preceded by ``remEdge`` for every live incident edge at
the same time unit (§2.1).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.delta import (ADD_EDGE, ADD_NODE, NOP, REM_EDGE,
                                    REM_NODE, T_PAD, Delta, pow2_capacity)
from repro_torch.core.engine import HistoricalQueryEngine
from repro_torch.core.graph import (DenseGraph, EdgeGraph, dense_to_edge,
                                    empty_dense, empty_edge)
from repro_torch.core.index import (NodeIndex, build_node_index_host,
                                    count_window_ops, gather_window)
from repro_torch.core.materialize import (MaterializationPolicy,
                                          MaterializedStore)
from repro_torch.core.plans import Query, evaluate
from repro_torch.core.reconstruct import reconstruct_dense, reconstruct_edge
from repro_torch.core.segments import (Segment, SegmentedDeltaView,
                                       build_merged_nodes)
from repro_torch.sharding.graph import divides, mesh_size, single_device


@dataclasses.dataclass
class Op:
    op: int
    u: int
    v: int
    t: int


class TemporalGraphStore:
    """Current snapshot SG_tcur + Δ[t0, tcur] (+ materialized snapshots)."""

    def __init__(self, n_cap: int, e_cap: int | None = None,
                 policy: MaterializationPolicy | None = None,
                 enforce_invertible: bool = True,
                 layout: str = "dense", segmented: bool = True,
                 segment_min_ops: int = 64,
                 segment_device_budget: int | None = None,
                 device="cuda"):
        """``layout="edge"`` keeps the current snapshot in edge-slot
        form only — O(E + N) state, no N² array anywhere in the store.
        Materialization policies need the dense layout.

        ``segmented=True`` (default) keeps the host log as a sequence
        of immutable ``Segment``s split at materialized-anchor and
        epoch-swap boundaries (``core.segments``): ingest appends to one
        open tail, an epoch swap seals + converts only that tail, and
        queries materialize only the segments overlapping their
        (anchor, t) window.  ``segmented=False`` is the monolithic
        baseline (one device log rebuilt from the full history) — the
        layout a durable root written with it recovers into.
        ``segment_min_ops`` is the minimum tail size worth sealing;
        ``segment_device_budget`` caps the device bytes sealed segments
        may occupy (cold ones are spilled to host and reloaded on
        demand; None = keep everything resident).  ``device`` holds
        every snapshot and delta (default ``"cuda"``, which raises
        without a card)."""
        if layout not in ("dense", "edge"):
            raise ValueError(f"unknown layout {layout!r}")
        if layout == "edge" and policy is not None:
            raise ValueError("materialization policies need the dense "
                             "layout")
        self.device = resolve_device(device)
        self.layout = layout
        self.n_cap = n_cap
        self.e_cap = e_cap or 8 * n_cap
        self.t0 = 0
        self.t_cur = 0
        self.segmented = bool(segmented)
        self.segment_min_ops = int(segment_min_ops)
        self.segment_device_budget = segment_device_budget
        self._segments: list[Segment] = []
        # merged-delta tree over the sealed segments, keyed
        # (leaf index, level) — grown at each seal_tail
        self._merged: dict[tuple[int, int], object] = {}
        self._t_sealed = 0            # time cut of the sealed prefix
        self._op_l: list[int] = []
        self._u_l: list[int] = []
        self._v_l: list[int] = []
        self._slot_l: list[int] = []
        self._t_l: list[int] = []
        # host mirrors of current state (for ingest-time legality checks)
        self._nodes = np.zeros((n_cap,), bool)
        self._adj_host: dict[tuple[int, int], bool] = {}
        # persistent edge-slot registry, maintained incrementally on
        # append: slot id -> canonical endpoints + current validity
        self._edge_slots: dict[tuple[int, int], int] = {}
        self._eu_l: list[int] = []
        self._ev_l: list[int] = []
        self._emask_l: list[bool] = []
        self._next_edge_slot = 0
        self.enforce_invertible = enforce_invertible
        if layout == "edge":
            self.current: DenseGraph | EdgeGraph = empty_edge(
                n_cap, 1, self.device)
        else:
            self.current = empty_dense(n_cap, self.device)
        self.materialized = MaterializedStore()
        self.policy = policy
        self._ops_since_mat = 0
        self._t_last_mat = 0
        self._delta_cache: Delta | None = None
        self._index_cache: NodeIndex | None = None
        self._engine_cache: HistoricalQueryEngine | None = None
        self._edge_cache: EdgeGraph | None = None
        self._tail_cache: dict | None = None
        self._host_cache: dict | None = None
        self._view_cache: SegmentedDeltaView | None = None
        # Durability hooks (repro_torch.persist.StorePersistence):
        # attached by persist.open_store — ingest/advance/seal then log
        # to the WAL and sealed segments are checkpointed to disk.  None
        # (the default) keeps the store process-resident.
        self.persist = None

    # ---------------------------------------------------------------- ingest

    def _canon(self, u: int, v: int) -> tuple[int, int]:
        return (u, v) if u <= v else (v, u)

    def _edge_slot(self, u: int, v: int) -> int:
        key = self._canon(u, v)
        if key not in self._edge_slots:
            self._edge_slots[key] = self._next_edge_slot
            self._next_edge_slot += 1
            self._eu_l.append(key[0])
            self._ev_l.append(key[1])
            self._emask_l.append(False)
        return self._edge_slots[key]

    def _append(self, op: int, u: int, v: int, t: int) -> None:
        if op in (ADD_NODE, REM_NODE):
            slot = u
        else:
            slot = self._edge_slot(u, v)
            self._emask_l[slot] = op == ADD_EDGE
        self._op_l.append(op)
        self._u_l.append(u)
        self._v_l.append(v)
        self._slot_l.append(slot)
        self._t_l.append(t)

    _COLS = ("op", "u", "v", "slot", "t")

    def _tail_host(self) -> dict:
        """The open tail as numpy columns (cached; immutable snapshots —
        appends build new ones)."""
        if self._tail_cache is None:
            self._tail_cache = {
                "op": np.asarray(self._op_l, np.int32),
                "u": np.asarray(self._u_l, np.int32),
                "v": np.asarray(self._v_l, np.int32),
                "slot": np.asarray(self._slot_l, np.int32),
                "t": np.asarray(self._t_l, np.int32),
            }
        return self._tail_cache

    def _host(self, col: str) -> np.ndarray:
        """Full-log host column: sealed segments + tail, concatenated
        (cached — stats/compat path; serving never needs it)."""
        if self._host_cache is None:
            tail = self._tail_host()
            self._host_cache = {
                c: (np.concatenate(
                    [getattr(s, c) for s in self._segments] + [tail[c]])
                    if self._segments else tail[c])
                for c in self._COLS}
        return self._host_cache[col]

    @property
    def _op(self) -> np.ndarray:
        return self._host("op")

    @property
    def _u(self) -> np.ndarray:
        return self._host("u")

    @property
    def _v(self) -> np.ndarray:
        return self._host("v")

    @property
    def _slot(self) -> np.ndarray:
        return self._host("slot")

    @property
    def _t(self) -> np.ndarray:
        return self._host("t")

    @property
    def log_len(self) -> int:
        """Total ops across sealed segments + the open tail."""
        return sum(s.n_ops for s in self._segments) + len(self._op_l)

    def _invalidate(self) -> None:
        self._delta_cache = None
        self._index_cache = None
        self._engine_cache = None
        self._edge_cache = None
        self._tail_cache = None
        self._host_cache = None
        self._view_cache = None

    def _apply_host(self, op: int, u: int, v: int) -> bool:
        """Apply to the host mirror; False for an illegal transition
        (already valid / already absent) — such ops are rejected so the
        log stays a genuine transition log."""
        if op == ADD_NODE:
            if self._nodes[u]:
                return False
            self._nodes[u] = True
        elif op == REM_NODE:
            if not self._nodes[u]:
                return False
            self._nodes[u] = False
        elif op == ADD_EDGE:
            key = self._canon(u, v)
            if u == v or self._adj_host.get(key) or not (
                    self._nodes[u] and self._nodes[v]):
                return False
            self._adj_host[key] = True
        elif op == REM_EDGE:
            key = self._canon(u, v)
            if not self._adj_host.get(key):
                return False
            self._adj_host[key] = False
        return True

    def ingest(self, ops: Iterable[Op | tuple]) -> int:
        """Record a batch of update operations (paper Algorithm 3 lines
        1–6).  Ops must be time-ordered and strictly past ``t_cur``
        (closed time units are immutable).  Returns #accepted."""
        accepted: list[Op] = []
        try:
            for o in ops:
                if not isinstance(o, Op):
                    o = Op(*o)
                if o.t <= self.t_cur:
                    raise ValueError(
                        f"op at t={o.t} is at or before "
                        f"t_cur={self.t_cur}; closed time units are "
                        "immutable (ops must be time-ordered and "
                        "strictly past t_cur)")
                if self._t_l and o.t < self._t_l[-1]:
                    raise ValueError(
                        f"ops must be time-ordered: got t={o.t} after "
                        f"t={self._t_l[-1]}")
                if o.op == REM_NODE and self.enforce_invertible:
                    # Paper §2.1: record remEdge for every live incident
                    # edge first, same time point, so the delta stays
                    # invertible.
                    for (a, b), live in list(self._adj_host.items()):
                        if live and (a == o.u or b == o.u):
                            if self._apply_host(REM_EDGE, a, b):
                                self._append(REM_EDGE, a, b, o.t)
                                accepted.append(Op(REM_EDGE, a, b, o.t))
                if self._apply_host(o.op, o.u, o.v):
                    self._append(o.op, o.u, o.v, o.t)
                    accepted.append(o)
        finally:
            # invalidate even when a mid-batch op raises: the accepted
            # prefix is already in the log and the host mirror.  The WAL
            # records exactly what was appended (expansions included),
            # so replay re-accepts it verbatim; a crash between the
            # mutation and the log write loses only ops this call never
            # acknowledged.
            if accepted:
                self._invalidate()
                if self.persist is not None:
                    self.persist.log_ops(accepted)
        return len(accepted)

    def advance_to(self, t_next: int) -> None:
        """Close the current time unit (Algorithm 3 lines 7–9): apply the
        temporary delta to SG_tcur, append it to the interval delta (the
        host log already holds it), and maybe materialize."""
        if t_next < self.t_cur:
            raise ValueError(f"cannot advance back to t={t_next} from "
                             f"t_cur={self.t_cur}")
        if self.persist is not None:
            self.persist.log_advance(t_next)
        tail_t = self._tail_host()["t"]
        new_ops = int(np.searchsorted(tail_t, t_next, side="right")
                      - np.searchsorted(tail_t, self.t_cur, side="right"))
        if self.segmented:
            # only the segments overlapping (t_cur, t_next] — the open
            # tail plus at most a boundary segment — are materialized
            delta = self.delta_view().window_delta(self.t_cur, t_next)
        else:
            delta = self.delta()
        if self.layout == "edge":
            # rebase the anchor onto the latest (append-only) registry
            # first, so ops on newly registered slots land in range
            anchor = self.current.with_registry_of(self.edge_graph())
            self.current = reconstruct_edge(anchor, delta, self.t_cur,
                                            t_next)
        else:
            self.current = reconstruct_dense(self.current, delta,
                                             self.t_cur, t_next)
        self.t_cur = t_next
        self._engine_cache = None
        self._ops_since_mat += new_ops
        if self.policy is not None:
            last = (self.materialized.snapshots[-1]
                    if self.materialized.snapshots else None)
            if self.policy.should_materialize(
                    t_now=t_next, t_last=self._t_last_mat,
                    ops_since=self._ops_since_mat, current=self.current,
                    last=last):
                self.materialized.add(t_next, self.current)
                self._ops_since_mat = 0
                self._t_last_mat = t_next
                # materialized anchors are segment boundaries
                self.seal_tail(t_next)

    # ------------------------------------------------------------- segments

    def seal_tail(self, t_seal: int | None = None, *,
                  force: bool = False) -> int:
        """Seal the open tail's ops with t ≤ ``t_seal`` (default
        ``t_cur``) into an immutable ``Segment``.  Tails smaller than
        ``segment_min_ops`` stay open unless ``force`` (a volatile
        snapshot segment represents them in ``delta_view``).  Returns
        #ops sealed (always 0 for a monolithic store)."""
        if not self.segmented:
            return 0
        t_seal = self.t_cur if t_seal is None else int(t_seal)
        if t_seal > self.t_cur:
            raise ValueError(f"cannot seal at t={t_seal} past "
                             f"t_cur={self.t_cur}: the unit is open")
        if t_seal <= self._t_sealed:
            return 0
        tail = self._tail_host()
        k = int(np.searchsorted(tail["t"], t_seal, side="right"))
        if k == 0 or (k < self.segment_min_ops and not force):
            return 0
        self._segments.append(Segment(
            tail["op"][:k].copy(), tail["u"][:k].copy(),
            tail["v"][:k].copy(), tail["slot"][:k].copy(),
            tail["t"][:k].copy(), device=self.device))
        self._op_l = self._op_l[k:]
        self._u_l = self._u_l[k:]
        self._v_l = self._v_l[k:]
        self._slot_l = self._slot_l[k:]
        self._t_l = self._t_l[k:]
        self._t_sealed = t_seal
        # grow the merged-delta tree: O(log S) new nodes per seal
        build_merged_nodes(self._segments, self._merged)
        if self.persist is not None:
            # sealed-segment write hook: the cut is WAL-logged, then the
            # immutable segment's compact arrays go to disk once
            self.persist.on_seal(self, self._segments[-1],
                                 len(self._segments) - 1, t_seal, k, force)
        # log content is unchanged — only the host partitioning moved
        self._tail_cache = None
        self._host_cache = None
        self._view_cache = None
        return k

    def delta_view(self) -> SegmentedDeltaView:
        """The segmented Δ[t0, tcur]: sealed segments plus (when the
        tail is non-empty) one volatile segment snapshotting the tail.
        The snapshot is immutable, so a frozen engine holding this view
        never observes later ingest."""
        if not self.segmented:
            raise ValueError("monolithic store has no segment view "
                             "(segmented=False)")
        if self._view_cache is None:
            segs = list(self._segments)
            if self._op_l:
                tail = self._tail_host()
                segs.append(Segment(tail["op"], tail["u"], tail["v"],
                                    tail["slot"], tail["t"], sealed=False,
                                    device=self.device))
            self._view_cache = SegmentedDeltaView(
                segs, n_cap=self.n_cap,
                merged=self._merged, device=self.device)
        return self._view_cache

    # ---------------------------------------------------------------- views

    def delta(self, capacity: int | None = None) -> Delta:
        """The full interval delta Δ[t0, tcur] as device tensors
        (cached) — the monolithic compatibility view."""
        if self._delta_cache is not None and capacity is None:
            return self._delta_cache
        n = self.log_len
        if capacity is not None and capacity < n:
            raise ValueError(f"capacity {capacity} < n_ops {n}")
        cap = capacity or pow2_capacity(n)
        if self.segmented:
            d = self.delta_view().full_delta(cap)
        else:
            pad = cap - n

            def col(x, fill):
                return torch.from_numpy(np.concatenate(
                    [x, np.full(pad, fill, np.int32)])).to(self.device)

            d = Delta(op=col(self._op, NOP), u=col(self._u, 0),
                      v=col(self._v, 0), slot=col(self._slot, 0),
                      t=col(self._t, T_PAD), n_ops=n)
        if capacity is None:
            self._delta_cache = d
        return d

    def op_times_host(self) -> np.ndarray:
        """Sorted host copy of the log timestamps (sorted by
        construction: ingest is append-only and time-ordered)."""
        return self._t

    def op_count_source(self):
        """The cheapest object answering "#ops between two times": the
        segment view (O(log S) per window) for segmented stores, the
        cached host timestamps otherwise."""
        return self.delta_view() if self.segmented else self.op_times_host()

    def node_index(self) -> NodeIndex:
        if self._index_cache is None:
            self._index_cache = build_node_index_host(self.delta(),
                                                      self.n_cap)
        return self._index_cache

    def edge_graph(self) -> EdgeGraph:
        """The ingested state in edge-slot layout: the persistent slot
        registry plus the host-mirror validity.  Cached; e_cap rounds to
        a power of two so shapes stay stable."""
        if self._edge_cache is not None:
            return self._edge_cache
        n = self._next_edge_slot
        e_cap = pow2_capacity(n)
        eu = np.zeros((e_cap,), np.int32)
        ev = np.zeros((e_cap,), np.int32)
        emask = np.zeros((e_cap,), bool)
        eu[:n] = self._eu_l
        ev[:n] = self._ev_l
        emask[:n] = self._emask_l
        dev = self.device
        self._edge_cache = EdgeGraph(
            nodes=torch.from_numpy(self._nodes.copy()).to(dev),
            eu=torch.from_numpy(eu).to(dev), ev=torch.from_numpy(ev).to(dev),
            emask=torch.from_numpy(emask).to(dev), n_edges_reg=n)
        return self._edge_cache

    def current_edge_snapshot(self) -> EdgeGraph:
        """SG_tcur in edge-slot layout, consistent with ``self.current``:
        derived from the dense current through the registry for dense
        stores, the (registry-rebased) current itself for edge ones."""
        reg = self.edge_graph()
        if isinstance(self.current, EdgeGraph):
            if (self.current.n_edges_reg < self._next_edge_slot
                    or self.current.e_cap < reg.e_cap):
                return self.current.with_registry_of(reg)
            return self.current
        return dense_to_edge(self.current, reg)

    # ---------------------------------------------------------------- query

    def snapshot_at(self, t: int, *, use_materialized: bool = True,
                    selection: str = "ops",
                    windowed: bool = False) -> DenseGraph | EdgeGraph:
        """Reconstruct SG_t (anchored at the best materialized snapshot
        if available, else at SG_tcur — Theorem 1).  Unwindowed calls
        route through the engine's per-anchor reconstruction LRU;
        ``windowed=True`` materializes only the anchor→t segments (a
        monolithic store slices its log by the temporal index).  An
        edge-layout store returns an ``EdgeGraph``."""
        view = self.delta_view() if self.segmented else self.delta()
        anchor_id = -1
        if use_materialized and self.materialized.times:
            selector = self.engine().selector
            cand = selector.select(t, view, method=selection)
            anchor_id = cand.anchor_id
            t_a, g_a = selector.get(anchor_id)
        else:
            t_a, g_a = self.t_cur, self.current
        if not windowed:
            return self.engine().reconstruct_cached(anchor_id, t,
                                                    layout=self.layout)
        if self.segmented:
            # the single LWW reconstruction masks exactly at the window
            # bounds, so fully-covered leaf runs may come from the tree
            delta = view.window_delta(min(t, t_a), max(t, t_a),
                                      merged=True)
        else:
            delta = view
            cap = pow2_capacity(
                count_window_ops(view, min(t, t_a), max(t, t_a)), 64)
            if cap < view.capacity:
                delta = gather_window(view, min(t, t_a), max(t, t_a), cap)
        if self.layout == "edge":
            return reconstruct_edge(self.current_edge_snapshot()
                                    if anchor_id == -1 else g_a,
                                    delta, t_a, t)
        return reconstruct_dense(g_a, delta, t_a, t)

    def engine(self, *, indexed: bool = False, node_cap: int = 1024,
               mesh=None) -> HistoricalQueryEngine:
        """The historical-query engine over the current store state
        (cached; invalidated by ingest/advance, by a change to the
        materialized-snapshot set, by a different ``node_cap`` or
        ``mesh``, or by asking for the node-centric index the cached
        engine lacks).  An engine built with an index keeps it for later
        unindexed calls — the planner simply has more statistics.

        ``mesh`` (a ``sharding.graph.GraphMesh``) makes the engine a
        multi-device serving engine: with ``shard="force"`` each query
        group runs as one sharded program (``core.distributed``).  ``mesh=None`` means "don't
        care": a cached mesh-bound engine is reused (its placements are
        costly and its answers bit-identical anyway) — only a
        *different* mesh rebuilds."""
        e = self._engine_cache
        if (e is None or (indexed and e.index is None)
                or e.node_cap != node_cap
                or (mesh is not None and e.mesh != mesh)
                or e.selector.times != self.materialized.times):
            keep_index = indexed or (e is not None and e.index is not None)
            keep_mesh = mesh if mesh is not None else (
                e.mesh if e is not None else None)
            e = HistoricalQueryEngine.from_store(
                self, indexed=keep_index, node_cap=node_cap, mesh=keep_mesh)
            self._engine_cache = e
        return e

    def place_on_mesh(self, mesh) -> HistoricalQueryEngine:
        """Eagerly place the store's device state for multi-device
        serving: the monolithic log replicated, the current snapshot
        replicated (batch-axis groups) and cut into row / slot blocks
        (two-phase groups, per layout), so the first queries pay no
        placement copies.  Returns the mesh-bound engine (also cached
        as ``engine()``)."""
        eng = self.engine(mesh=mesh)
        if not single_device(mesh):
            if eng.view is None:
                # a segmented engine places its per-group window deltas
                # as it runs them (the full log is never materialized)
                eng._replicated(mesh, "delta", eng.delta)
            if eng.current is not None:
                eng._replicated(mesh, "current", eng.current)
                if divides(self.n_cap, mesh_size(mesh)):
                    eng._row_sharded_anchor(mesh, -1)
            if eng.current_edge is not None:
                eng._replicated(mesh, "current_edge", eng.current_edge)
                if divides(eng.current_edge.e_cap, mesh_size(mesh)):
                    eng._slot_sharded_anchor(mesh, -1)
        return eng

    def freeze_serving_state(self, *, mesh=None, indexed: bool = False,
                             node_cap: int = 1024) -> HistoricalQueryEngine:
        """Build the frozen serving view of the current store state —
        the epoch-swap hook for ``repro_torch.serving``: seal the epoch's
        tail and convert ONLY it (the sealed history is already on the
        device from earlier freezes; a monolithic store converts its
        whole log), spill cold segments past the byte budget, rebase the
        edge snapshot onto the grown registry, and build the engine
        (with the node-centric index when ``indexed``; given a ``mesh``,
        with ``place_on_mesh``'s placements).  The engine is immutable
        with respect to later ``ingest`` calls."""
        if self.segmented:
            self.seal_tail(self.t_cur)
            self.delta_view().ensure_device(self.segment_device_budget)
        else:
            self.delta()
        if self.layout == "edge":
            self.current = self.current_edge_snapshot()
        eng = self.engine(indexed=indexed, node_cap=node_cap)
        if mesh is not None:
            eng = self.place_on_mesh(mesh)   # keeps the index, adds mesh
        return eng

    # ------------------------------------------------------------ durability

    def flush(self) -> None:
        """Checkpoint the durable state (no-op for a process-resident
        store): rotate the WAL behind a fresh manifest so recovery
        replays only what happened after this call.  The WAL itself is
        fsync'd per record — flush bounds recovery *time*, it is not
        needed for recovery *correctness*."""
        if self.persist is not None:
            self.persist.checkpoint(self)

    def close(self) -> None:
        """Flush and release the durability layer.  The store stays
        queryable (its state is in memory); later mutations would no
        longer be logged, so treat it as read-only after."""
        if self.persist is not None:
            self.persist.checkpoint(self)
            self.persist.close()

    def query(self, q: Query, plan: str = "auto", indexed: bool = False,
              **kw):
        """Single-query compat shim (prefer ``repro_torch.api.
        GraphSession`` or ``evaluate_many``)."""
        index = self.node_index() if indexed else None
        if plan == "auto":
            plan = self.engine().planner.choose(q, self.delta(),
                                                self.t_cur).plan
        cur = (self.current_edge_snapshot() if self.layout == "edge"
               else self.current)
        return evaluate(cur, self.delta(), self.t_cur, q, index=index,
                        plan=plan, **kw)

    def evaluate_many(self, queries, plan: str = "auto", *,
                      indexed: bool = False, mesh=None,
                      layout: str | None = None, **kw):
        """Batched multi-query serving through the engine's grouped
        executor (one device dispatch per (plan, anchor, layout) group;
        one *sharded* program per big group when ``mesh`` spans more
        than one device).  ``indexed`` builds the node-centric index and
        forces the indexed variants of delta-only / hybrid groups;
        ``layout`` forces dense/edge execution ("auto"/None lets the
        planner's N²-vs-E cost term decide)."""
        return self.engine(indexed=indexed, mesh=mesh).evaluate_many(
            queries, plan, indexed=True if indexed else None,
            layout=layout, **kw)

    def evolve(self, measure: str, t_lo: int, t_hi: int, *,
               stride: int = 1, v: int | None = None,
               scope: str | None = None, mesh=None, **kw) -> np.ndarray:
        """Time-sweep query: ``measure`` at every sample time
        ``t_lo, t_lo + stride, ..., ≤ t_hi`` as one sweep (reconstruct
        at ``t_lo`` once, then the incremental degree sweep kernel).
        Measures outside ``kernels.evolve_sweep.SWEEP_MEASURES`` fall
        back to independent point queries — same results."""
        from repro_torch.kernels.evolve_sweep import SWEEP_MEASURES
        scope = scope or ("node" if v is not None else "global")
        if measure in SWEEP_MEASURES:
            q = Query("evolve", scope, measure, t_k=int(t_lo),
                      t_l=int(t_hi), v=v, stride=int(stride))
            return self.evaluate_many([q], mesh=mesh, **kw)[0]
        ts = range(int(t_lo), int(t_hi) + 1, int(stride))
        qs = [Query("point", scope, measure, t_k=t, v=v) for t in ts]
        return np.asarray(self.evaluate_many(qs, mesh=mesh, **kw))

    # stats used by benchmarks (paper Table 3)
    def stats(self) -> dict:
        return {
            "inserted_nodes": int(np.sum(self._op == ADD_NODE)),
            "removed_nodes": int(np.sum(self._op == REM_NODE)),
            "inserted_edges": int(np.sum(self._op == ADD_EDGE)),
            "removed_edges": int(np.sum(self._op == REM_EDGE)),
            "total_ops": int(len(self._op)),
            "t_cur": self.t_cur,
            "live_nodes": int(np.sum(self._nodes)),
            "live_edges": int(sum(self._adj_host.values())),
        }
