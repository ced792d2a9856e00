"""Workload-driven materialization: where snapshots live, not just when.

The paper's policies (``core.materialize.MaterializationPolicy``) are
*cadence* rules — periodic, op-count, similarity — that decide **when**
to take the next snapshot but always take it at the ingest frontier.
Khurana & Deshpande (arXiv 1207.5777) show snapshot-retrieval cost is
dominated by **where** materialized snapshots sit relative to the query
workload; AeonG (arXiv 2304.12212) builds the same observation into its
serving path.  This module replaces the static cadence for live
serving:

* ``WorkloadStats`` — a query-time histogram the engine fills while it
  serves (``HistoricalQueryEngine.workload`` hook).  Epoch rollovers
  decay it, so the hot set tracks the workload as it drifts.

* ``WorkloadMaterializationPolicy`` — at each epoch swap, turns the
  histogram into a target anchor set under a device-byte budget:
  greedily pick the hottest query times that are at least
  ``min_gap_ops`` log operations away from every other anchor (ops
  distance is the reconstruction cost the ``AnchorSelector`` actually
  pays — Theorem 1), keep existing snapshots that already cover a
  target, materialize the uncovered ones, and evict anchors that are
  cold or over budget.  The anchors land in ``store.materialized``,
  which the ``AnchorSelector`` prices on the next engine build — so
  observed workload directly reshapes reconstruction cost.

* ``PeriodicMaterializationPolicy`` — the static cadence expressed in
  the same ``rebalance`` protocol, kept as the serving-layer baseline.

Everything here is host-side planning; the only device work is the
reconstruction of snapshots the policy decides to add.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
from typing import Sequence

import numpy as np


class WorkloadStats:
    """Query-time histogram accumulated per serving epoch.

    ``record_queries`` is the engine-facing hook
    (``HistoricalQueryEngine.workload``): every served query drops its
    time endpoints here.  Weights are floats because epoch rollovers
    decay them (``decay``) instead of resetting — a time that was hot
    two epochs ago still counts, just less.

    Bounded by construction (tests/test_obs.py): the histogram holds at
    most ``max_times`` distinct times — when an epoch's queries touch
    more, the lightest entries are pruned (their mass leaves ``total``
    too), so a scan workload cannot grow the dict without limit between
    rollovers.  ``queries_recorded`` decays at ``rollover`` along with
    the weights: it is an exponentially-aged activity level (what the
    policy would see as "recent traffic"), not a forever-monotonic
    count — the registry's ``engine_queries_total`` is the monotonic
    one.
    """

    def __init__(self, *, max_times: int = 4096):
        self.max_times = int(max_times)
        self._w: dict[int, float] = {}
        self.total = 0.0
        self.queries_recorded = 0.0
        self._lock = threading.Lock()

    def record(self, times, weight: float = 1.0) -> None:
        with self._lock:
            for t in times:
                t = int(t)
                self._w[t] = self._w.get(t, 0.0) + weight
                self.total += weight
            if len(self._w) > self.max_times:
                # prune the lightest ~1/8 in one pass (amortized: the
                # next few thousand inserts are bound-free) and keep
                # ``total`` consistent with the surviving mass
                drop = heapq.nsmallest(
                    len(self._w) - self.max_times * 7 // 8,
                    self._w.items(), key=lambda kv: (kv[1], kv[0]))
                for t, w in drop:
                    del self._w[t]
                    self.total -= w

    def record_queries(self, queries) -> None:
        """Engine hook: record t_k (and t_l for range queries).

        Sweep (``evolve``) queries record EVERY swept sample time, each
        at weight 1/B — one dashboard sweep carries one query's total
        mass, spread over its window, so sweep-heavy workloads pull
        anchors toward the swept region without a single wide sweep
        drowning out the point traffic."""
        ts = []
        for q in queries:
            if getattr(q, "kind", "") == "evolve" and q.t_l is not None:
                stride = max(int(getattr(q, "stride", 1)), 1)
                swept = range(int(q.t_k), int(q.t_l) + 1, stride)
                self.record(swept, weight=1.0 / max(len(swept), 1))
                continue
            ts.append(q.t_k)
            if q.t_l is not None:
                ts.append(q.t_l)
        self.record(ts)
        with self._lock:
            self.queries_recorded += len(queries)

    def histogram(self) -> dict[int, float]:
        with self._lock:
            return dict(self._w)

    def hot_times(self) -> list[tuple[int, float]]:
        """(time, weight) sorted by weight desc, time asc on ties —
        deterministic input to the greedy anchor placement."""
        with self._lock:
            return sorted(self._w.items(), key=lambda kv: (-kv[1], kv[0]))

    def mass_near(self, t: int, t_sorted: np.ndarray, gap_ops: int) -> float:
        """Total query weight within ``gap_ops`` log operations of
        ``t`` — the "is this anchor hot" integral."""
        total = 0.0
        with self._lock:
            items = list(self._w.items())
        for tq, w in items:
            if _ops_between(t_sorted, t, tq) <= gap_ops:
                total += w
        return total

    def rollover(self, decay: float) -> None:
        """Epoch boundary: decay every weight (and the activity level),
        drop negligible ones.  This is the anti-overflow contract: with
        a policy attached, every swap multiplies the whole histogram by
        ``decay < 1``, so long-running servers converge to a bounded
        steady state instead of accumulating forever."""
        with self._lock:
            self._w = {t: w * decay for t, w in self._w.items()
                       if w * decay > 1e-3}
            self.total = sum(self._w.values())
            self.queries_recorded *= decay


def _ops_between(t_sorted, t_a: int, t_b: int) -> int:
    """#log ops in the (t_lo, t_hi] window between two times — the
    AnchorSelector's exact cost proxy.  ``t_sorted`` is either a host
    timestamp array or a ``SegmentedDeltaView`` (per-segment op
    counts — the segmented store never concatenates its full
    timestamp column just to cost anchors); the counting rule itself
    is the planner's, shared via ``core.segments``."""
    from repro_torch.core.segments import window_ops_count
    lo, hi = (t_a, t_b) if t_a <= t_b else (t_b, t_a)
    return window_ops_count(t_sorted, lo, hi)


@dataclasses.dataclass
class RebalanceResult:
    """What one policy pass did to ``store.materialized``."""

    targets: list[int]
    added: list[int]
    evicted: list[int]
    kept: list[int]
    budget_snapshots: int


@dataclasses.dataclass
class WorkloadMaterializationPolicy:
    """Greedy hot-anchor placement under a device-byte budget.

    ``budget_bytes`` caps the materialized sequence's device footprint
    (snapshot size comes from the engine's ``_snapshot_bytes``);
    ``min_gap_ops`` is the minimum ops-distance between anchors —
    below it a second anchor saves less than it costs, because the
    ``AnchorSelector`` would reconstruct through ``min_gap_ops`` ops
    anyway.  ``decay`` ages the histogram at each rebalance so the
    anchor set follows workload drift.
    """

    budget_bytes: int = 256 << 20
    min_gap_ops: int = 128
    decay: float = 0.5
    max_adds_per_epoch: int = 4

    def plan(self, *, stats: WorkloadStats, existing: Sequence[int],
             t_sorted: np.ndarray, t_cur: int,
             bytes_per_snapshot: int) -> RebalanceResult:
        k_max = int(self.budget_bytes // max(int(bytes_per_snapshot), 1))
        existing = [int(t) for t in existing]
        if stats.total <= 0 or k_max == 0:
            # no observed workload: leave the anchor set alone (but
            # still enforce the budget on whatever is there)
            evict = sorted(existing)[:max(0, len(existing) - k_max)]
            return RebalanceResult(targets=[], added=[], evicted=evict,
                                   kept=[t for t in existing
                                         if t not in evict],
                                   budget_snapshots=k_max)

        # 1. Greedy target set: hottest times first, spaced at least
        #    min_gap_ops from each other and from the free anchor at
        #    t_cur (the current snapshot always competes — Theorem 1).
        targets: list[int] = []
        for t, _w in stats.hot_times():
            if len(targets) >= k_max:
                break
            if t > t_cur or t < 0:
                continue
            if _ops_between(t_sorted, t, t_cur) <= self.min_gap_ops:
                continue
            if any(_ops_between(t_sorted, t, s) <= self.min_gap_ops
                   for s in targets):
                continue
            targets.append(t)

        # 2. Existing anchors within the gap of a target cover it.
        kept, covered = [], set()
        for s in existing:
            near = [t for t in targets
                    if _ops_between(t_sorted, s, t) <= self.min_gap_ops]
            if near and len(kept) < k_max:
                kept.append(s)
                covered.update(near)

        # 3. Materialize the uncovered targets, hottest first, within
        #    budget and the per-epoch add cap (reconstruction work at
        #    swap time is bounded).
        room = min(k_max - len(kept), self.max_adds_per_epoch)
        added = [t for t in targets if t not in covered][:max(0, room)]

        # 4. Evict the cold remainder: anchors covering no target are
        #    dead weight under the budget; with observed workload they
        #    only survive if they still see query mass nearby.
        evicted = []
        for s in existing:
            if s in kept:
                continue
            cold = stats.mass_near(s, t_sorted, self.min_gap_ops) <= 0.0
            over_budget = len(kept) + len(added) >= k_max
            if cold or over_budget:
                evicted.append(s)
            else:
                kept.append(s)
        return RebalanceResult(targets=targets, added=added,
                               evicted=evicted, kept=kept,
                               budget_snapshots=k_max)

    def rebalance(self, store, stats: WorkloadStats) -> RebalanceResult:
        """Apply one policy pass to ``store.materialized`` (the epoch
        swap calls this off the serving critical path)."""
        from repro_torch.core.engine import _snapshot_bytes
        if getattr(store, "layout", "dense") != "dense":
            raise ValueError("materialization needs the dense layout "
                             "(snapshots are stored dense)")
        t_src = store.op_count_source()
        res = self.plan(stats=stats, existing=store.materialized.times,
                        t_sorted=t_src, t_cur=store.t_cur,
                        bytes_per_snapshot=_snapshot_bytes(store.current))
        for t in res.evicted:
            store.materialized.remove(t)
        for t in res.added:
            g = store.snapshot_at(t, use_materialized=True)
            store.materialized.add(t, g)
        stats.rollover(self.decay)
        return res


@dataclasses.dataclass
class PeriodicMaterializationPolicy:
    """The static cadence in serving clothes: an anchor every
    ``period`` time units behind the frontier, oldest evicted first
    under the same byte budget.  Exists as the baseline the
    workload-driven policy is benchmarked against."""

    period: int = 64
    budget_bytes: int = 256 << 20

    def rebalance(self, store, stats: WorkloadStats) -> RebalanceResult:
        from repro_torch.core.engine import _snapshot_bytes
        k_max = int(self.budget_bytes
                    // max(_snapshot_bytes(store.current), 1))
        existing = sorted(int(t) for t in store.materialized.times)
        last = max(existing, default=0)
        added = []
        t = last + self.period
        while t <= store.t_cur and len(added) < 8:
            g = store.snapshot_at(t, use_materialized=True)
            store.materialized.add(t, g)
            added.append(t)
            t += self.period
        evicted = []
        while len(store.materialized.times) > k_max:
            oldest = min(store.materialized.times)
            store.materialized.remove(oldest)
            evicted.append(oldest)
        return RebalanceResult(targets=added, added=added, evicted=evicted,
                               kept=[t for t in existing
                                     if t not in evicted],
                               budget_snapshots=k_max)
