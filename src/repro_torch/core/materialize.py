"""Materialized snapshots (paper §2.2): when to take them, which to use.

Selection (given the sequence S of materialized snapshots):
* time-based       — argmin |t_k − t_l| (cheap, wrong under bursty logs)
* operation-based  — argmin #ops(Δ between t_l and t_k); exact cost
  proxy, computed in O(log M) per candidate via the temporal index.

Materialization policies (when to take the next snapshot):
* periodic    — every P time units
* op-count    — after B ops have accumulated since the last snapshot
* similarity  — when Jaccard similarity of edge sets vs the last
  materialized snapshot drops below a threshold (the paper's point that
  op-count and similarity differ: self-reversing ops inflate the former)
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.delta import Delta
from repro_torch.core.graph import DenseGraph


@dataclasses.dataclass
class MaterializedStore:
    """Host-side sequence S = (SG_{t_1}, ..., SG_{t_m}, SG_{t_cur})."""

    times: list[int] = dataclasses.field(default_factory=list)
    snapshots: list[DenseGraph] = dataclasses.field(default_factory=list)

    def add(self, t: int, g: DenseGraph) -> None:
        self.times.append(int(t))
        self.snapshots.append(g)

    def remove(self, t: int) -> DenseGraph:
        """Evict the snapshot materialized at ``t`` (workload-driven
        policies retire cold anchors under a byte budget).  Anchor ids
        are positional, so any engine built against the old sequence
        must be rebuilt — ``TemporalGraphStore.engine()`` notices the
        times changed and does; the serving layer swaps engines
        wholesale at epoch boundaries."""
        i = self.times.index(int(t))
        self.times.pop(i)
        return self.snapshots.pop(i)

    def device_bytes(self) -> int:
        """Approximate device footprint of the materialized sequence
        (the workload policy's budget denominator)."""
        from repro_torch.core.engine import _snapshot_bytes
        return sum(_snapshot_bytes(g) for g in self.snapshots)

    def select(self, t_k: int, delta: Delta,
               method: Literal["time", "ops"] = "ops"):
        """Pick the anchor snapshot for reconstructing SG_{t_k}.

        Returns (t_anchor, snapshot).  ``method='time'`` is the paper's
        time-based selection; ``'ops'`` is operation-based (optimal #ops
        applied), priced with the temporal index.

        Deprecated as an entry point (``repro_torch.api.GraphSession`` — or
        the engine — picks anchors for every query automatically).
        Thin wrapper kept for compatibility: candidate costing lives in
        the engine's ``AnchorSelector`` (which additionally lets SG_tcur
        compete when given a current snapshot).
        """
        if not self.times:
            raise ValueError("no materialized snapshots")
        from repro_torch.core.engine import AnchorSelector
        selector = AnchorSelector(self.times, self.snapshots)
        cand = selector.select(t_k, delta, method)
        return selector.get(cand.anchor_id)


@dataclasses.dataclass
class MaterializationPolicy:
    """Decides whether to materialize after each update batch."""

    kind: Literal["periodic", "opcount", "similarity"] = "opcount"
    period: int = 100            # periodic: time units between snapshots
    op_budget: int = 5000        # opcount: ops since last snapshot
    min_similarity: float = 0.8  # similarity: Jaccard threshold

    def should_materialize(self, *, t_now: int, t_last: int,
                           ops_since: int, current: DenseGraph,
                           last: DenseGraph | None) -> bool:
        if self.kind == "periodic":
            return (t_now - t_last) >= self.period
        if self.kind == "opcount":
            return ops_since >= self.op_budget
        if last is None:
            return True
        return float(edge_jaccard(current, last)) < self.min_similarity


def edge_jaccard(a: DenseGraph, b: DenseGraph):
    inter = (a.adj & b.adj).sum(dtype=torch.int32)
    union = (a.adj | b.adj).sum(dtype=torch.int32)
    return torch.where(union > 0, inter / union.clamp(min=1),
                       torch.ones((), device=union.device))
