"""Historical-query plans (paper §3.2, Table 2) — the PyTorch mirror of
``repro.core.plans``.

Query taxonomy: {point, range-differential, range-aggregate} ×
{node-centric, global}.  Plans:

* two-phase  — reconstruct snapshot(s), then measure (all query types)
* delta-only — range-differential node-centric, straight off the log
* hybrid     — point / range-aggregate node-centric: one measure on
  SG_tcur + a corrective pass over the window's ops

The delta-only and hybrid kernels take a node and a time, or tensors of
Q nodes and times (the engine's batched form — a leading batch
dimension in place of ``vmap``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.delta import ADD_EDGE, NOP, REM_EDGE, Delta
from repro_torch.core.graph import DenseGraph, EdgeGraph
from repro_torch.core.index import NodeIndex, gather_node_ops, gather_window
from repro_torch.core.partial import partial_reconstruct, seed_mask
from repro_torch.core.queries import (EDGE_GLOBAL_MEASURES,
                                      EDGE_NODE_MEASURES, GLOBAL_MEASURES,
                                      NODE_MEASURES, edge_supported)
from repro_torch.core.reconstruct import (node_degree_series,
                                          reconstruct_dense,
                                          reconstruct_edge,
                                          reconstruct_sequential)

Aggregate = Literal["mean", "min", "max"]
I32 = torch.int32

_KINDS = ("point", "diff", "agg", "evolve")
_RANGE_KINDS = ("diff", "agg", "evolve")
_AGGS = ("mean", "min", "max")


@dataclasses.dataclass(frozen=True)
class Query:
    """A historical query (paper Table 1).

    THE validated construction path for every query in the system — the
    engine, the serving frontend and ``GraphSession`` consume it as-is,
    so a malformed query fails here with a clear ``ValueError``.
    ``scope`` may be omitted: it is inferred from ``v`` (node-centric
    iff a node is given).  Time-vs-watermark violations surface as
    ``WatermarkError`` (a ``ValueError``) at evaluation time.
    """

    kind: Literal["point", "diff", "agg", "evolve"] = "point"
    scope: Literal["node", "global"] | None = None
    measure: str = ""             # key into NODE_MEASURES / GLOBAL_MEASURES
    t_k: int = 0                  # point time, or range start
    t_l: int | None = None        # range end (diff/agg/evolve)
    v: int | None = None          # node (node-centric)
    agg: Aggregate = "mean"
    stride: int = 1               # evolve: sample every ``stride`` units

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown query kind {self.kind!r} "
                             f"(one of {_KINDS})")
        if self.scope is None:
            object.__setattr__(self, "scope",
                               "node" if self.v is not None else "global")
        if self.scope not in ("node", "global"):
            raise ValueError(f"unknown scope {self.scope!r} "
                             "(node | global)")
        known = (NODE_MEASURES if self.scope == "node"
                 else GLOBAL_MEASURES)
        if self.measure not in known and not edge_supported(self.measure,
                                                            self.scope):
            raise ValueError(
                f"unknown {self.scope}-scope measure {self.measure!r} "
                f"(known: {', '.join(sorted(known))})")
        if self.scope == "node" and self.v is None:
            raise ValueError(f"node-scope query {self.measure!r} needs "
                             "v=<node id>")
        if self.kind in _RANGE_KINDS:
            if self.t_l is None:
                raise ValueError(f"{self.kind!r} query needs a time range"
                                 " — pass t_l (range end) as well as t_k")
            if self.t_l < self.t_k:
                raise ValueError(f"empty time range: t_l={self.t_l} < "
                                 f"t_k={self.t_k}")
        if self.kind == "evolve":
            if self.stride <= 0:
                raise ValueError(f"evolve stride must be >= 1, got "
                                 f"{self.stride}")
        elif self.stride != 1:
            raise ValueError(f"stride is an evolve parameter "
                             f"({self.kind!r} query got stride="
                             f"{self.stride})")
        if self.kind == "agg" and self.agg not in _AGGS:
            raise ValueError(f"unknown aggregate {self.agg!r} "
                             f"(one of {_AGGS})")


def measure_named(g, measure: str, scope: str, v):
    """Measure dispatch over both snapshot layouts (the edge measures
    give the same integers and f32 finalizations as the dense ones)."""
    if isinstance(g, EdgeGraph):
        if scope == "node":
            return EDGE_NODE_MEASURES[measure](g, v)
        return EDGE_GLOBAL_MEASURES[measure](g)
    if scope == "node":
        return NODE_MEASURES[measure](g, v)
    return GLOBAL_MEASURES[measure](g)


def _measure(g, q: Query):
    return measure_named(g, q.measure, q.scope, q.v)


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis as left-to-right f32 adds: one summation
    order on every device, so a mean of non-integer f32 values (an agg
    of density or avg_degree) is the same bits on the CPU and the card —
    a reduction kernel's tree order would not be."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _aggregate(vals: torch.Tensor, agg: Aggregate):
    if agg == "mean":
        # explicit sum / width: bit-identical to the engine's masked
        # batched aggregation
        v = vals.to(torch.float32)
        return ordered_sum(v) / v.shape[0]
    return vals.min() if agg == "min" else vals.max()


# ---------------------------------------------------------------------------
# Two-phase plan (paper §3.2.1) — reconstruct, then evaluate
# ---------------------------------------------------------------------------


def two_phase(current, delta: Delta, t_cur, q: Query, *,
              partial_rows: bool = False, sequential: bool = False,
              passes: int = 2):
    """General plan, all query types, both snapshot layouts.

    ``sequential=True`` replays the paper's Algorithm 2 op-by-op (the
    faithful baseline); otherwise the vectorized LWW reconstruction.
    ``partial_rows=True`` enables partial reconstruction (§3.3.1) for
    node-centric queries.  An ``EdgeGraph`` runs the O(E) slot
    reconstruction (sequential / partial are dense-layout concepts).
    """
    is_edge = isinstance(current, EdgeGraph)
    if is_edge and (sequential or partial_rows):
        raise ValueError("sequential / partial variants need the dense "
                         "layout")

    def recon_from(g, t_base, t):
        if is_edge:
            return reconstruct_edge(g, delta, t_base, t)
        if sequential:
            return reconstruct_sequential(g, delta, t_base, t)
        return reconstruct_dense(g, delta, t_base, t)

    def recon(t):
        if not is_edge and not sequential and partial_rows \
                and q.scope == "node":
            return partial_reconstruct(
                current, delta, t_cur, t,
                seed_mask(current.n_cap, q.v, current.device),
                passes=passes)
        return recon_from(current, t_cur, t)

    if q.kind == "point":
        return _measure(recon(q.t_k), q)

    if q.kind == "diff":
        # SG_tl backward from current, then SG_tk from SG_tl — the
        # nearer snapshot is reused, as the paper's point-range plan does
        g_l = recon(q.t_l)
        g_k = recon_from(g_l, q.t_l, q.t_k)
        return torch.abs(_measure(g_l, q) - _measure(g_k, q))

    # aggregate: one snapshot per time unit in [t_k, t_l]
    vals = torch.stack([_measure(recon(t), q)
                        for t in range(q.t_k, q.t_l + 1)])
    return _aggregate(vals, q.agg)


# ---------------------------------------------------------------------------
# Delta-only plan (paper §3.2.2) — range-differential node-centric
# ---------------------------------------------------------------------------


def _signed_touch(delta: Delta, v, t_lo, t_hi) -> torch.Tensor:
    """Σ sign over the edge ops touching node v with t in (t_lo, t_hi]
    — i32 per (v, t_lo, t_hi), all three broadcastable tensors or ints."""
    dev = delta.device
    v = torch.as_tensor(v, dtype=I32).to(dev).unsqueeze(-1)
    lo = torch.as_tensor(t_lo, dtype=I32).to(dev).unsqueeze(-1)
    hi = torch.as_tensor(t_hi, dtype=I32).to(dev).unsqueeze(-1)
    win = ((delta.t > lo) & (delta.t <= hi) & (delta.op != NOP)
           & delta.valid_mask())
    touch = win & ((delta.u == v) | (delta.v == v))
    sign = torch.where(delta.op == ADD_EDGE, 1,
                       torch.where(delta.op == REM_EDGE, -1, 0)).to(I32)
    return (sign * touch.to(I32)).sum(-1, dtype=I32)


def delta_only_degree_diff(delta: Delta, v, t_k, t_l):
    """|Δdegree(v)| over [t_k, t_l] by counting add/rem edge ops that
    touch v — no snapshot access at all."""
    return torch.abs(_signed_touch(delta, v, t_k, t_l))


def delta_only_degree_diff_indexed(delta: Delta, index: NodeIndex, v,
                                   t_k, t_l, cap: int):
    """Same, via the node-centric index: O(deg_ops) gathers."""
    sub = gather_node_ops(delta, index, v, cap)
    return delta_only_degree_diff(sub, v, t_k, t_l)


# ---------------------------------------------------------------------------
# Hybrid plan (paper §3.2.3) — point / aggregate node-centric
# ---------------------------------------------------------------------------


def hybrid_point_degree(current, delta: Delta, v, t_k, t_cur):
    """degree(v) at t_k = degree on SG_tcur − net additions in
    (t_k, t_cur].  ``current`` may be either layout."""
    vv = torch.as_tensor(v, dtype=torch.int64).to(delta.device)
    deg_cur = current.degrees()[vv]
    return deg_cur - _signed_touch(delta, v, t_k, t_cur)


def hybrid_point_degree_indexed(current: DenseGraph, delta: Delta,
                                index: NodeIndex, v, t_k, t_cur, cap: int):
    sub = gather_node_ops(delta, index, v, cap)
    return hybrid_point_degree(current, sub, v, t_k, t_cur)


def masked_aggregate(vals: torch.Tensor, width, num_buckets: int,
                     agg: Aggregate):
    """Aggregate the first ``width`` of ``num_buckets`` bucketed values
    (the tail is padding); ``vals`` is [..., num_buckets] and ``width``
    broadcasts over the leading dims.  Shared by the scalar hybrid plan
    and the engine's batched executors: the exact f32 sum of integer
    values divided by the width, not a reciprocal-multiply mean."""
    dev = vals.device
    width = torch.as_tensor(width, dtype=I32).to(dev)
    keep = (torch.arange(num_buckets, dtype=I32, device=dev)
            < width.unsqueeze(-1))
    if agg == "mean":
        zero = torch.zeros((), dtype=vals.dtype, device=dev)
        s = ordered_sum(torch.where(keep, vals, zero).to(torch.float32))
        return s / width.to(torch.float32)
    big = torch.full((), 1 << 30, dtype=vals.dtype, device=dev)
    if agg == "min":
        return torch.where(keep, vals, big).min(-1).values
    return torch.where(keep, vals, -big).max(-1).values


def hybrid_agg_degree(current: DenseGraph, delta: Delta, v, t_k, t_l,
                      num_buckets: int, agg: Aggregate = "mean"):
    """Aggregate of degree(v) over [t_k, t_l]: measure once on SG_tcur,
    reverse-cumulative correction per time unit (one delta pass)."""
    series = node_degree_series(current.degree(v), delta, v, t_k,
                                num_buckets)
    return masked_aggregate(series, int(t_l) - int(t_k) + 1, num_buckets,
                            agg)


def hybrid_agg_degree_windowed(current: DenseGraph, delta: Delta, v, t_k,
                               t_l, t_cur, num_buckets: int,
                               window_cap: int, agg: Aggregate = "mean"):
    """Temporal-index variant: slice (t_k, t_cur] once, then correct
    (the anchor measure is on the *current* snapshot)."""
    sub = gather_window(delta, t_k, t_cur, window_cap)
    return hybrid_agg_degree(current, sub, v, t_k, t_l, num_buckets, agg)


# ---------------------------------------------------------------------------
# Plan selection (paper Table 2)
# ---------------------------------------------------------------------------

APPLICABLE = {
    ("point", "node"): ("two_phase", "hybrid"),
    ("point", "global"): ("two_phase",),
    ("diff", "node"): ("two_phase", "delta_only", "hybrid"),
    ("diff", "global"): ("two_phase",),
    ("agg", "node"): ("two_phase", "hybrid"),
    ("agg", "global"): ("two_phase",),
    # evolve executes on its own incremental sweep kernel; the planner
    # only chooses the anchor, so two_phase is the (sole) cost model.
    ("evolve", "node"): ("two_phase",),
    ("evolve", "global"): ("two_phase",),
}


def applicable_plans(q: Query) -> tuple[str, ...]:
    return APPLICABLE[(q.kind, q.scope)]


def evaluate(current, delta: Delta, t_cur, q: Query,
             index: NodeIndex | None = None, plan: str = "auto",
             node_cap: int = 1024, **kw):
    """Evaluate one query with the cheapest applicable plan (or a forced
    one).  Degree queries get the specialised delta-only/hybrid paths;
    everything else falls back to two-phase, as in Table 2.  Plan
    choice is delegated to the engine's cost-based ``Planner``; new code
    should go through ``repro_torch.api.GraphSession``."""
    plans = applicable_plans(q)
    if plan == "auto":
        from repro_torch.core.engine import AnchorSelector, Planner
        selector = AnchorSelector((), (), t_cur=t_cur, current=current,
                                  t_host=delta.t[:delta.n_ops].cpu().numpy())
        planner = Planner(selector, n_cap=current.n_cap, index=index)
        plan = planner.choose(q, delta, t_cur).plan
    if plan not in plans:
        raise ValueError(f"plan {plan} not applicable to {q}")

    if plan == "two_phase" or q.measure != "degree":
        return two_phase(current, delta, t_cur, q, **kw)
    if plan == "delta_only":
        if index is not None:
            return delta_only_degree_diff_indexed(delta, index, q.v, q.t_k,
                                                  q.t_l, node_cap)
        return delta_only_degree_diff(delta, q.v, q.t_k, q.t_l)
    # hybrid
    if q.kind == "point":
        if index is not None:
            return hybrid_point_degree_indexed(current, delta, index, q.v,
                                               q.t_k, t_cur, node_cap)
        return hybrid_point_degree(current, delta, q.v, q.t_k, t_cur)
    if q.kind == "diff":
        d_l = hybrid_point_degree(current, delta, q.v, q.t_l, t_cur)
        d_k = hybrid_point_degree(current, delta, q.v, q.t_k, t_cur)
        return torch.abs(d_l - d_k)
    num_buckets = int(q.t_l - q.t_k + 1)
    return hybrid_agg_degree(current, delta, q.v, q.t_k, q.t_l,
                             num_buckets, q.agg)
