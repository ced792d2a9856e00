"""Micro-batching query frontend: coalesce, dedupe, cache, dispatch once.

The batched executor's whole advantage is amortization — one device
program per (plan, anchor, layout) group — but a live system receives
queries one at a time.  ``MicroBatchFrontend`` closes that gap:

* ``submit(q)`` returns a future immediately.  Requests queue until
  either ``max_batch`` of them are waiting or the oldest has aged past
  ``max_delay_ms``; the scheduler then drains the queue and dispatches
  ONE ``LiveGraphStore.evaluate_many`` (which reuses the engine's
  planner groups and ``layout`` pass-through unchanged).

* **Exact result cache** keyed ``(measure, args, t, layout)`` — the
  full query tuple plus the forced layout — and stamped with the live
  store's ``generation``, which every epoch swap bumps: watermark
  advance invalidates the whole cache in O(1).  Within an epoch the
  cache is exact by the serving contract (history at ``t ≤ t_served``
  is immutable and results are layout bit-stable), so hits skip
  the device entirely.  Duplicate queries *within* one batch collapse
  to a single evaluation the same way.

The frontend runs in two modes: synchronous (call ``flush()`` — or
let a full queue auto-drain — and collect futures; what the tests and
benchmarks use) and threaded (``start()`` spawns a scheduler thread
that drains on the deadline; ``stop()`` joins it).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future
from typing import Sequence

import numpy as np

from repro_torch.core.plans import Query
from repro_torch.obs import clock
from repro_torch.obs.metrics import (MetricsRegistry, NullRegistry,
                               default_registry)
from repro_torch.obs.trace import trace_span
from repro_torch.serving.ingest import LiveGraphStore, WatermarkError

__all__ = ["MicroBatchFrontend", "FrontendStats", "OverloadError",
           "query_cache_key"]


class OverloadError(RuntimeError):
    """The serving path is saturated: the request was rejected at
    admission (``max_pending`` bound) or shed at dispatch (aged past
    ``shed_after_ms``).  Callers should back off and retry — shedding
    early and explicitly beats queueing into timeout territory."""


def query_cache_key(q: Query, layout: str | None) -> tuple:
    """The exact-result-cache key: every semantic field of the query
    plus the requested execution layout.  Layout never changes a
    result bit (the engine's parity contract), but keying on it keeps
    cache entries interpretable per serving configuration."""
    return (q.kind, q.scope, q.measure, q.agg if q.kind == "agg" else "",
            int(q.t_k), None if q.t_l is None else int(q.t_l),
            None if q.v is None else int(q.v),
            int(getattr(q, "stride", 1)) if q.kind == "evolve" else 1,
            layout or "auto")


class FrontendStats:
    """Read-only view over a frontend's leaf metrics registry.

    Source-compatible with the old plain-int dataclass: reads like
    ``fe.stats.cache_hits`` resolve the live registry children.  All
    mutation happens at the instrumented call sites through atomic
    child operations — the view itself never writes, so there is no
    read-modify-write window to lose increments in.  Each frontend
    owns a fresh leaf registry, so these per-instance counts start at
    zero per frontend lifetime while the same increments aggregate
    into the parent (session/process) registry.

    ``sync`` (when given) runs before every read: the frontend's
    submit path accumulates its per-request counts as plain ints under
    the queue lock it already holds (registry child ops per submit
    would be measurable overhead on the serving hot path — the
    bench_obs_overhead contract) and folds them into the registry at
    every drain; the sync hook folds them on read too, so the view
    stays exact at all times.
    """

    _COUNTERS = {
        "submitted": ("frontend_submitted_total",
                      "queries submitted"),
        "served": ("frontend_served_total",
                   "requests resolved by a dispatch (shed included)"),
        "batches": ("frontend_batches_total",
                    "dispatches to the engine"),
        "cache_hits": ("frontend_cache_hits_total",
                       "exact-result cache hits"),
        "cache_misses": ("frontend_cache_misses_total",
                         "exact-result cache misses"),
        "coalesced_dupes": ("frontend_coalesced_dupes_total",
                            "duplicate queries collapsed in a batch"),
        "rejected": ("frontend_rejected_total",
                     "submissions bounced at the max_pending bound"),
        "shed": ("frontend_shed_total",
                 "requests dropped at dispatch: aged past "
                 "shed_after_ms"),
    }
    _GAUGES = {
        "max_batch_seen": ("frontend_max_batch_seen",
                           "largest batch dispatched"),
        "max_pending_seen": ("frontend_max_pending_seen",
                             "deepest queue observed"),
    }

    def __init__(self, registry, sync=None):
        children = {}
        for attr, (name, help_) in self._COUNTERS.items():
            children[attr] = registry.counter(name, help_)
        for attr, (name, help_) in self._GAUGES.items():
            children[attr] = registry.gauge(name, help_)
        self._children = children
        self._sync = sync

    def __getattr__(self, name):
        children = self.__dict__.get("_children")
        if children is not None and name in children:
            sync = self.__dict__.get("_sync")
            if sync is not None:
                sync()
            return children[name].value
        raise AttributeError(name)

    def batch_occupancy(self) -> float:
        batches = self.batches
        return self.served / batches if batches else 0.0


class MicroBatchFrontend:
    """Request queue + coalescing scheduler over a ``LiveGraphStore``."""

    def __init__(self, live: LiveGraphStore, *, max_batch: int = 64,
                 max_delay_ms: float = 2.0, cache_entries: int = 4096,
                 stale: str = "raise", layout: str | None = None,
                 max_pending: int | None = None, overload: str = "raise",
                 shed_after_ms: float | None = None, metrics=None,
                 **evaluate_kw):
        self.live = live
        self.max_batch = int(max_batch)
        self.max_delay_ms = float(max_delay_ms)
        self.cache_entries = int(cache_entries)
        self.stale = stale
        self.layout = layout
        # Backpressure.  ``max_pending`` bounds the queue: a submit
        # past it either raises ``OverloadError`` (overload="raise" —
        # the caller hears "slow down" immediately) or blocks until
        # the scheduler frees space (overload="block" — producers are
        # paced instead of refused; needs a running drain thread or a
        # concurrent flusher).  ``shed_after_ms`` is the dispatch-side
        # valve: a request that aged past it is shed with
        # ``OverloadError`` rather than evaluated — under sustained
        # overload, serving a request whose client already gave up
        # only steals device time from the ones still waiting.
        if overload not in ("raise", "block"):
            raise ValueError(f"unknown overload policy {overload!r}")
        self.max_pending = None if max_pending is None else int(max_pending)
        self.overload = overload
        self.shed_after_ms = (None if shed_after_ms is None
                              else float(shed_after_ms))
        self.evaluate_kw = evaluate_kw
        # per-instance leaf registry chained onto the session/process
        # parent: ``fe.stats`` counts THIS frontend, the parent sees
        # the aggregate.  A NullRegistry parent is adopted whole so
        # "metrics off" really is off end to end.
        parent = default_registry() if metrics is None else metrics
        self.metrics = (parent if isinstance(parent, NullRegistry)
                        else MetricsRegistry(parent=parent))
        self.stats = FrontendStats(self.metrics, sync=self._sync_stats)
        self._m = self.stats._children
        self._m_qdepth = self.metrics.gauge(
            "frontend_queue_depth", "requests waiting for dispatch")
        self._m_wait = self.metrics.histogram(
            "frontend_queue_wait_seconds",
            "submit-to-dispatch wait per request")
        self._cache: OrderedDict[tuple, tuple[int, object]] = OrderedDict()
        self._queue: list[tuple[Query, tuple, Future, float]] = []
        self._cv = threading.Condition()   # RLock-backed: sync nests
        # submit-path counts accumulate here as plain ints under
        # ``_cv`` and fold into the registry at every drain / stats
        # read — registry child ops per submit would tax the hot path
        self._pend_counts = {"submitted": 0, "cache_hits": 0,
                             "cache_misses": 0, "rejected": 0}
        self._pend_maxdepth = 0
        self._thread: threading.Thread | None = None
        self._running = False

    def _sync_stats(self) -> None:
        """Fold the submit path's pending plain-int counts into the
        registry (exactness on read; cheapness on write)."""
        with self._cv:
            for attr, n in self._pend_counts.items():
                if n:
                    self._m[attr].inc(n)
                    self._pend_counts[attr] = 0
            if self._pend_maxdepth:
                self._m["max_pending_seen"].set_max(self._pend_maxdepth)
                self._pend_maxdepth = 0
            self._m_qdepth.set(len(self._queue))

    # ----------------------------------------------------------- cache

    def _cache_get(self, key: tuple):
        """Hit iff present AND stamped with the current generation —
        every epoch swap bumps ``live.generation``, so watermark
        advance invalidates without walking the table."""
        entry = self._cache.get(key)
        if entry is None:
            return None
        gen, value = entry
        if gen != self.live.generation:
            del self._cache[key]        # stale epoch: drop lazily
            return None
        self._cache.move_to_end(key)
        return value

    def _cache_put(self, key: tuple, gen: int, value) -> None:
        if gen != self.live.generation:
            return                      # swapped mid-flight: don't poison
        self._cache[key] = (gen, value)
        while len(self._cache) > self.cache_entries:
            self._cache.popitem(last=False)

    # ---------------------------------------------------------- submit

    def submit(self, q: Query) -> Future:
        """Enqueue one query; resolve immediately on a cache hit.
        (``repro_torch.api.GraphSession.query``/``query_many`` wrap this with
        construction and lifecycle — prefer them in application
        code.)"""
        fut: Future = Future()
        key = query_cache_key(q, self.layout)
        with self._cv:
            pend = self._pend_counts
            pend["submitted"] += 1
            hit = self._cache_get(key)
            if hit is not None:
                pend["cache_hits"] += 1
                fut.set_result(hit)
                return fut
            pend["cache_misses"] += 1
            while (self.max_pending is not None
                   and len(self._queue) >= self.max_pending):
                if self.overload == "raise":
                    pend["rejected"] += 1
                    raise OverloadError(
                        f"{len(self._queue)} requests already pending "
                        f"(max_pending={self.max_pending})")
                self._cv.wait()          # paced: drain frees space
            self._queue.append((q, key, fut, clock.now()))
            if len(self._queue) > self._pend_maxdepth:
                self._pend_maxdepth = len(self._queue)
            self._cv.notify()
            full = len(self._queue) >= self.max_batch
        if full and self._thread is None:
            self._drain_one_batch()
        return fut

    def submit_sweep(self, measure: str, t_lo: int, t_hi: int, *,
                     stride: int = 1, v: int | None = None,
                     scope: str | None = None) -> Future:
        """Enqueue one time-sweep (``evolve``) request.

        Sweeps ride the same coalescing path as point queries: same
        deadline/batch-size drain, duplicate sweeps within a batch
        collapse to one evaluation, repeated sweeps within an epoch hit
        the exact-result cache (the full sample array is the cached
        value).  The engine groups co-batched sweeps sharing (measure,
        stride, anchor) into one sweep-kernel launch."""
        scope = scope or ("node" if v is not None else "global")
        return self.submit(Query("evolve", scope, measure, t_k=int(t_lo),
                                 t_l=int(t_hi), v=v, stride=int(stride)))

    def serve(self, queries: Sequence[Query]) -> list:
        """Synchronous convenience: submit everything, flush, gather."""
        futs = [self.submit(q) for q in queries]
        self.flush()
        return [f.result() for f in futs]

    # ------------------------------------------------------- scheduler

    def flush(self) -> int:
        """Drain every queued request now (≤ max_batch per dispatch)."""
        n = 0
        while True:
            served = self._drain_one_batch()
            if not served:
                return n
            n += served

    def _drain_one_batch(self) -> int:
        with self._cv:
            batch, self._queue = (self._queue[:self.max_batch],
                                  self._queue[self.max_batch:])
            self._sync_stats()           # fold submit-path counts
            self._cv.notify_all()        # wake blocked submitters
        if not batch:
            return 0
        now = clock.now()
        for entry in batch:
            self._m_wait.observe(now - entry[3])
        if self.shed_after_ms is not None:
            cutoff = now - self.shed_after_ms / 1e3
            kept = []
            for entry in batch:
                if entry[3] < cutoff:
                    self._m["shed"].inc()
                    entry[2].set_exception(OverloadError(
                        f"request shed after waiting past "
                        f"{self.shed_after_ms}ms"))
                else:
                    kept.append(entry)
            if not kept:
                return len(batch)
            n_shed, batch = len(batch) - len(kept), kept
        else:
            n_shed = 0
        gen = self.live.generation
        w = self.live.t_served
        if self.stale == "raise":
            # fail ONLY the past-watermark requests — one early query
            # must not poison the coalesced batch of servable ones
            servable = []
            for entry in batch:
                q = entry[0]
                t_hi = q.t_k if q.t_l is None else max(q.t_k, q.t_l)
                if t_hi > w:
                    entry[2].set_exception(WatermarkError(
                        f"query time {t_hi} is past the watermark "
                        f"t_served={w}"))
                else:
                    servable.append(entry)
            if not servable:
                return len(batch) + n_shed
        else:
            servable = batch
        # collapse duplicate keys: one evaluation, every future filled
        uniq: dict[tuple, list[Future]] = {}
        uniq_qs: list[Query] = []
        for q, key, fut, _ts in servable:
            if key not in uniq:
                uniq[key] = []
                uniq_qs.append(q)
            else:
                self._m["coalesced_dupes"].inc()
            uniq[key].append(fut)
        try:
            with trace_span("frontend.dispatch", batch=len(uniq_qs)):
                results = self.live.evaluate_many(
                    uniq_qs, stale=self.stale, layout=self.layout,
                    **self.evaluate_kw)
        except Exception as exc:            # noqa: BLE001 — fan out
            for futs in uniq.values():
                for f in futs:
                    f.set_exception(exc)
            return len(batch) + n_shed
        resolved = []
        for q, (key, futs), r in zip(uniq_qs, uniq.items(), results):
            value = np.asarray(r)
            value = value.item() if value.ndim == 0 else value
            t_hi = q.t_k if q.t_l is None else max(q.t_k, q.t_l)
            resolved.append((key, value, t_hi, futs))
        # cache writes go under the queue lock: submitters read the
        # OrderedDict under _cv, and dict reshaping during a lock-free
        # write is a real data race (graphlint: unlocked-mutation)
        with self._cv:
            for key, value, t_hi, _futs in resolved:
                if t_hi <= w:
                    # only exact (within-watermark) results cacheable
                    self._cache_put(key, gen, value)
        for _key, value, _t_hi, futs in resolved:
            for f in futs:
                f.set_result(value)
        self._m["batches"].inc()
        self._m["served"].inc(len(batch))
        self._m["max_batch_seen"].set_max(len(batch))
        return len(batch) + n_shed

    def _scheduler(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._queue:
                    self._cv.wait(timeout=0.1)
                if not self._running and not self._queue:
                    return
                oldest = self._queue[0][3]
                deadline = oldest + self.max_delay_ms / 1e3
                now = clock.now()
                ready = (len(self._queue) >= self.max_batch
                         or now >= deadline)
                if not ready:
                    self._cv.wait(timeout=deadline - now)
                    ready = bool(self._queue) and (
                        len(self._queue) >= self.max_batch
                        or clock.now() >= deadline)
            if ready:
                self._drain_one_batch()

    def start(self) -> "MicroBatchFrontend":
        """Spawn the deadline-draining scheduler thread."""
        if self._thread is None:
            self._running = True
            self._thread = threading.Thread(target=self._scheduler,
                                            name="frontend-scheduler",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the scheduler after draining what is queued."""
        th = self._thread
        if th is None:
            return
        with self._cv:
            self._running = False
            self._cv.notify_all()
        th.join(timeout=10)
        self._thread = None
        self.flush()
