"""``GraphSession`` — the one front door to the temporal graph system,
the PyTorch mirror of ``repro.api`` (single device)::

    from repro_torch.api import GraphSession

    with GraphSession.open("/data/graph", n_cap=1024) as s:  # "cuda"
        s.ingest([(ADD_NODE, 0, 0, 1), (ADD_NODE, 1, 1, 1),
                  (ADD_EDGE, 0, 1, 2)])
        s.query("degree", t=2, v=0)            # -> 1
        s.query_many([Query("point", "global", "num_edges", t_k=2)])
        s.sweep("avg_degree", t_lo=1, t_hi=2)  # evolve series
        s.snapshot_at(2)                       # DenseGraph/EdgeGraph
        s.flush()                              # durable checkpoint
    # kill -9 anywhere above: GraphSession.open(path) recovers
    # bit-exactly, on the card

* ``path=...`` makes the session durable (``repro_torch.persist``, the
  same on-disk format as ``repro.persist``): every acknowledged
  ``ingest`` is WAL'd first, every swap checkpoints the sealed segments
  + anchor manifest before the watermark moves, and ``open`` on an
  existing path crash-recovers (the pending ops that never made it
  into an epoch included).  ``path=None`` is the same system in memory.
* Queries route through the micro-batching frontend (exact result
  cache, duplicate coalescing) over the live store's watermark
  semantics.  The default ``stale="block"`` swaps synchronously when a
  query needs times newer than the frozen epoch.
* ``indexed=True`` (a ``LiveGraphStore`` keyword, with ``node_cap``)
  serves node-scope delta-only / hybrid queries through the
  node-centric index.
* ``publish_to`` makes a durable session a replication source;
  ``open_replica`` mirrors one into a ``ReadReplica`` on its own
  ``device`` and ``open_router`` fronts replicas with a watermark-aware
  ``QueryRouter`` (``repro_torch.replica``).
* ``mesh=`` (a ``sharding.graph.GraphMesh``) serves every frozen epoch
  as a multi-device engine: ``evaluate_many(..., shard="force")`` runs
  each query group sharded over the mesh's devices
  (``core.distributed``), bit-identical to one device; ``"auto"``
  keeps every group on one device.
  The store, the WAL and the roots do not depend on it.
* ``device`` defaults to ``"cuda"`` and raises without a card;
  ``device="cpu"`` runs the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.plans import Query
from repro_torch.core.store import Op, TemporalGraphStore
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.trace import (Tracer, active_tracer, install_tracer,
                                   uninstall_tracer)
from repro_torch.persist import open_store
from repro_torch.serving.frontend import MicroBatchFrontend
from repro_torch.serving.ingest import (LiveGraphStore, SwapRecord,
                                        WatermarkError)

__all__ = ["GraphSession", "Query", "Op", "WatermarkError"]


class GraphSession:
    """One handle over store + live serving + frontend (+ durability).

    Keywords: **identity** ``path`` (durable root; None = in memory),
    ``n_cap``/``e_cap``/``layout`` (graph shape; recovered from the
    manifest when reopening); **serving** ``policy`` (materialization),
    ``mesh`` (multi-device serving), ``stale`` (watermark behavior,
    default ``"block"``),
    ``max_batch``/``max_delay_ms``/``cache_entries`` (frontend
    coalescing + exact cache); **durability** ``fsync`` (per-record WAL
    sync, default True); ``device`` (default ``"cuda"``).  Remaining
    keywords (``indexed``, ``node_cap``, ...) pass through to
    ``LiveGraphStore``.
    """

    def __init__(self, *, path: str | None = None, n_cap: int | None = None,
                 e_cap: int | None = None, layout: str | None = None,
                 policy=None, mesh=None, stale: str = "block",
                 max_batch: int = 64, max_delay_ms: float = 0.0,
                 cache_entries: int = 4096, fsync: bool = True,
                 max_pending: int | None = None, overload: str = "raise",
                 shed_after_ms: float | None = None,
                 segment_min_ops: int | None = None,
                 segment_device_budget: int | None = None,
                 metrics=None, slow_query_ms: float | None = 250.0,
                 device="cuda", **live_kw):
        self.path = path
        self._metrics = (default_registry() if metrics is None
                         else metrics)
        self._tracer: Tracer | None = None
        self._publisher = None
        pending: list[Op] = []
        if path is not None:
            # ``policy`` here is the SERVING rebalance policy (it goes to
            # LiveGraphStore below); open_store's policy keyword is the
            # core MaterializationPolicy and stays unset
            rec = open_store(path, n_cap=n_cap, e_cap=e_cap, layout=layout,
                             fsync=fsync, segment_min_ops=segment_min_ops,
                             segment_device_budget=segment_device_budget,
                             metrics=self._metrics, device=device)
            store, pending = rec.store, rec.pending
        else:
            if n_cap is None:
                raise ValueError("an in-memory session needs n_cap")
            store_kw = {}
            if segment_min_ops is not None:
                store_kw["segment_min_ops"] = segment_min_ops
            store = TemporalGraphStore(
                n_cap, e_cap=e_cap, layout=layout or "dense",
                segment_device_budget=segment_device_budget, device=device,
                **store_kw)
        self.live = LiveGraphStore(store=store, policy=policy, mesh=mesh,
                                   pending=pending, metrics=self._metrics,
                                   slow_query_ms=slow_query_ms, **live_kw)
        self.frontend = MicroBatchFrontend(
            self.live, max_batch=max_batch, max_delay_ms=max_delay_ms,
            cache_entries=cache_entries, stale=stale,
            max_pending=max_pending, overload=overload,
            shed_after_ms=shed_after_ms, metrics=self._metrics)
        self._closed = False

    # ----------------------------------------------------------- lifecycle

    @classmethod
    def open(cls, path: str | None = None, **kw) -> "GraphSession":
        """Open a durable session at ``path`` (creating it with the
        given config, or crash-recovering whatever is there, on
        ``device``), or an in-memory one when ``path`` is None."""
        return cls(path=path, **kw)

    def flush(self) -> SwapRecord:
        """Absorb every pending op into a new served epoch and (for a
        durable session) checkpoint: on return, all acknowledged ingest
        is queryable AND replay-free on the next open."""
        return self.live.swap()

    def close(self) -> None:
        """Stop the frontend, checkpoint, release the WAL.  Safe to
        call twice; the session is unusable for writes afterwards."""
        if self._closed:
            return
        self.frontend.stop()             # no-op unless start()ed
        self.live.close()
        self._closed = True

    def __enter__(self) -> "GraphSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------------------------------------------- state

    @property
    def store(self) -> TemporalGraphStore:
        return self.live.store

    @property
    def device(self):
        return self.live.store.device

    @property
    def watermark(self) -> int:
        """Exactness frontier: queries at t ≤ watermark bit-match a
        from-scratch store (the serving contract)."""
        return self.live.t_served

    @property
    def t_cur(self) -> int:
        return self.live.store.t_cur

    # --------------------------------------------------------------- write

    def ingest(self, ops: Iterable[Op | tuple]) -> int:
        """Append time-annotated ops (``Op`` or ``(op, u, v, t)``
        tuples).  Durable sessions WAL the batch before acknowledging.
        They become queryable at the next ``flush``/swap — or
        transparently, since the default ``stale="block"`` swaps on
        demand when a query asks for newer times."""
        return self.live.append(ops)

    # --------------------------------------------------------------- read

    @staticmethod
    def _as_query(q: Query | None, measure: str | None, kw: dict) -> Query:
        if q is not None:
            if measure is not None or kw:
                raise ValueError("pass either a Query object or keyword "
                                 "fields, not both")
            return q
        if "t" in kw:                    # ergonomic alias for point time
            kw["t_k"] = kw.pop("t")
        return Query(measure=measure or "", **kw)

    def query(self, q: Query | str | None = None, /, **kw):
        """One historical query; returns a scalar (or an array for
        array-valued measures): ``query("degree", t=10, v=3)``,
        ``query("num_edges", kind="diff", t_k=5, t_l=9)`` or a
        ``Query``.  Duplicates within an epoch hit the exact cache."""
        if isinstance(q, str):
            q, kw = None, {"measure": q, **kw}
        query = self._as_query(q, kw.pop("measure", None), kw)
        fut = self.frontend.submit(query)
        self.frontend.flush()
        return fut.result()

    def query_many(self, queries: Sequence[Query]) -> list:
        """Batched queries: submitted together, so the engine groups
        them into the fewest dispatches and duplicates collapse."""
        futs = [self.frontend.submit(q) for q in queries]
        self.frontend.flush()
        return [f.result() for f in futs]

    def sweep(self, measure: str, t_lo: int, t_hi: int, *,
              stride: int = 1, v: int | None = None,
              scope: str | None = None) -> np.ndarray:
        """Evolution series: ``measure`` at t_lo, t_lo+stride, ... ≤
        t_hi as one sweep (``evolve``), bit-matching the equivalent
        point queries."""
        fut = self.frontend.submit_sweep(measure, t_lo, t_hi,
                                         stride=stride, v=v, scope=scope)
        self.frontend.flush()
        return np.asarray(fut.result())

    def snapshot_at(self, t: int):
        """The reconstructed graph SG_t (dense or edge layout per the
        store).  Respects the session's ``stale`` mode for t past the
        watermark: ``"block"`` swaps first, otherwise raises."""
        if t > self.live.t_served:
            if self.frontend.stale == "block":
                self.live.swap()
            if t > self.live.t_served:
                raise WatermarkError(
                    f"snapshot at t={t} is past the watermark "
                    f"t_served={self.live.t_served}")
        return self.store.snapshot_at(t)

    def stats(self) -> dict:
        """Store + serving counters (ingest lag, epoch, cache rates)."""
        return {**self.store.stats(), **self.live.ingest_lag(),
                "watermark": self.watermark,
                "cache_hits": self.frontend.stats.cache_hits,
                "cache_misses": self.frontend.stats.cache_misses}

    # -------------------------------------------------------- observability

    def metrics(self) -> dict:
        """JSON snapshot of the session's metrics registry."""
        return self._metrics.snapshot()

    def metrics_text(self) -> str:
        """Prometheus text exposition of the same registry."""
        return self._metrics.render_prometheus()

    @property
    def metrics_registry(self):
        return self._metrics

    def enable_tracing(self, capacity: int = 16384) -> Tracer:
        """Install a process-wide span tracer (bounded ring)."""
        if self._tracer is None:
            self._tracer = install_tracer(Tracer(capacity=capacity))
        return self._tracer

    def disable_tracing(self) -> None:
        if self._tracer is not None:
            uninstall_tracer(self._tracer)

    def dump_trace(self, path: str) -> str:
        """Write the recorded spans as Chrome ``trace_event`` JSON."""
        tracer = self._tracer or active_tracer()
        if tracer is None:
            raise ValueError("tracing was never enabled "
                             "(call enable_tracing() first)")
        return tracer.dump(path)

    def slow_queries(self) -> list[dict]:
        """Entries from the slow-query log (threshold
        ``slow_query_ms``)."""
        log = self.live.slow_log
        return log.entries() if log is not None else []

    # --------------------------------------------------------- replication

    def publish_to(self, publish_root: str):
        """Make this (durable) session a replication source: every
        epoch swap ships its checkpoint's manifest diff — new sealed
        segments, the current WAL, the manifest last — into
        ``publish_root``.  Returns the ``SegmentPublisher``; hand
        ``publisher.transport()`` (or just the directory) to
        ``GraphSession.open_replica`` on the read side."""
        if self.path is None:
            raise ValueError("an in-memory session has no checkpoint "
                             "artifacts to publish; open with path=...")
        from repro_torch.replica import SegmentPublisher
        pub = SegmentPublisher(self.path, publish_root).attach(self.live)
        pub.publish()                    # ship the current state eagerly
        self._publisher = pub
        return pub

    @classmethod
    def open_replica(cls, source, local_root: str, device="cuda", **kw):
        """Open a ``ReadReplica`` of a writer on ``device``: ``source``
        is a writer's publish/store directory (string) or any
        ``Transport``.  The replica mirrors into ``local_root``, serves
        at its own watermark, and keyword args (``fetch_timeout``,
        ``anchor_budget_bytes``, ``seed``, ``mesh``, ...) pass through.  Call
        ``.sync()`` per poll or ``.start(interval)`` for a background
        fetch loop."""
        from repro_torch.replica import LocalDirTransport, ReadReplica
        transport = (LocalDirTransport(source) if isinstance(source, str)
                     else source)
        replica = ReadReplica(transport, local_root, device=device, **kw)
        try:
            replica.sync()
        except Exception:
            # source unreachable at open: a replica with a local mirror
            # still serves its old watermark; a fresh one waits for the
            # first successful sync (stats carry the error)
            if replica.store is None:
                raise
        return replica

    @staticmethod
    def open_router(replicas: dict | None = None, **kw):
        """A watermark-aware ``QueryRouter``; ``replicas`` maps name ->
        target (``ReadReplica`` or anything with its serving surface)."""
        from repro_torch.replica import QueryRouter
        router = QueryRouter(**kw)
        for name, target in (replicas or {}).items():
            router.register(name, target)
        return router
