"""Watermark-aware query routing across read replicas — the PyTorch
mirror of ``repro.replica.router`` (framework-free: it routes to
anything with the ``ReadReplica`` serving surface).

Replicas differ in exactly one semantic dimension: how much history
they can answer *exactly* — their watermark.  The router's job is to
(1) send every query batch to a replica whose watermark covers the
latest time the batch touches, (2) notice replicas dying (heartbeat
staleness, failed probes, failed evaluations) and route around them,
and (3) shed load when every covering replica is saturated instead of
queueing into timeout territory (same ``OverloadError`` contract as
the micro-batch frontend's admission bound).

A routed target is anything with the ``ReadReplica`` serving surface:
``evaluate_many(queries, ...)``, ``status() -> dict`` (carrying
``watermark`` and ``inflight``), and a ``watermark`` property.  The
writer's own ``LiveGraphStore`` can be registered too (wrapped), so a
router can front "writer + N replicas" and keep serving reads through
writer restarts.
"""
from __future__ import annotations

import threading
import time
from typing import Sequence

from repro_torch.core.engine import WatermarkError
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.trace import trace_span
from repro_torch.serving.frontend import OverloadError

__all__ = ["QueryRouter", "ReplicaDown", "ReplicaHealth",
           "OverloadError", "WatermarkError"]


class ReplicaDown(RuntimeError):
    """No registered replica is alive (or none answered)."""


class ReplicaHealth:
    """Router-side view of one replica: last heartbeat, freshness,
    load, and the error that took it down (if any)."""

    def __init__(self, name: str, target, registry=None):
        self.name = name
        self.target = target
        self.alive = True
        self.watermark = -1
        self.inflight = 0
        self.last_heartbeat = 0.0
        self.last_error = ""
        self.queries_routed = 0
        self.failures = 0
        reg = default_registry() if registry is None else registry
        self._g_inflight = reg.gauge("router_inflight",
                                     "router-tracked in-flight batches",
                                     replica=name)
        self._g_lag = reg.gauge(
            "router_replica_lag",
            "staleness behind the freshest known watermark",
            replica=name)

    def snapshot(self) -> dict:
        return {"name": self.name, "alive": self.alive,
                "watermark": self.watermark, "inflight": self.inflight,
                "queries_routed": self.queries_routed,
                "failures": self.failures, "last_error": self.last_error}


class QueryRouter:
    """Route query batches to covering, healthy, least-loaded replicas.

    ``heartbeat()`` polls every target's ``status()``; a target whose
    status call raises — or that has not produced a fresh heartbeat
    within ``heartbeat_timeout`` of the last poll — is marked down
    until a later heartbeat succeeds (a restarted replica rejoins the
    rotation automatically; no manual re-registration).  Evaluation
    failures fail the replica over immediately: the batch is retried
    on the next candidate in the same call, so a single ``kill -9``
    costs one in-flight retry, not an error surfaced to the client.

    ``max_inflight`` is the per-replica shed bound: candidates at or
    past it are skipped, and if *every* covering replica is saturated
    the call raises ``OverloadError`` — explicit backpressure, never
    an unbounded queue.
    """

    def __init__(self, *, max_inflight: int = 64,
                 heartbeat_timeout: float = 2.0, metrics=None):
        self.max_inflight = int(max_inflight)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.metrics = default_registry() if metrics is None else metrics
        self._m_queries = self.metrics.counter(
            "router_queries_total", "queries routed to a replica")
        self._m_failovers = self.metrics.counter(
            "router_failovers_total",
            "mid-call failovers to the next candidate")
        self._m_shed = self.metrics.counter(
            "router_shed_total",
            "batches shed: every covering replica saturated")
        self._replicas: dict[str, ReplicaHealth] = {}
        self._lock = threading.RLock()
        self._hb_thread: threading.Thread | None = None
        self._hb_stop = threading.Event()
        self.queries_routed = 0
        self.failovers = 0
        self.shed = 0

    # ---------------------------------------------------------- membership

    def register(self, name: str, target) -> None:
        with self._lock:
            h = ReplicaHealth(name, target, self.metrics)
            self._replicas[name] = h
        self._probe(h)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._replicas.pop(name, None)

    def replicas(self) -> list[dict]:
        with self._lock:
            return [h.snapshot() for h in self._replicas.values()]

    # ---------------------------------------------------------- heartbeats

    def _probe(self, h: ReplicaHealth) -> bool:
        try:
            st = h.target.status()
            h.watermark = int(st.get("watermark", -1))
            h.inflight = int(st.get("inflight", 0))
            h._g_inflight.set(h.inflight)
            h.last_heartbeat = time.monotonic()
            h.alive = True
            return True
        except Exception as exc:          # noqa: BLE001 — any failure
            h.alive = False               # mode counts as "down"
            h.last_error = f"{type(exc).__name__}: {exc}"
            return False

    def heartbeat(self) -> dict[str, bool]:
        """Poll every replica once; returns name -> alive.  Also the
        rejoin path: a down replica whose probe succeeds is healthy
        again immediately."""
        with self._lock:
            targets = list(self._replicas.values())
        now = time.monotonic()
        out = {}
        for h in targets:
            ok = self._probe(h)
            if ok and now - h.last_heartbeat > self.heartbeat_timeout:
                h.alive = False           # stale despite a late answer
                ok = False
            out[h.name] = ok
        top = max((h.watermark for h in targets if h.alive), default=-1)
        for h in targets:
            if h.alive:
                h._g_lag.set(max(top - h.watermark, 0))
        return out

    def start_heartbeats(self, interval: float = 0.1) -> "QueryRouter":
        if self._hb_thread is not None:
            return self

        def _loop():
            while not self._hb_stop.is_set():
                self.heartbeat()
                self._hb_stop.wait(interval)

        self._hb_thread = threading.Thread(
            target=_loop, name="router-heartbeat", daemon=True)
        self._hb_thread.start()
        return self

    def stop(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
            self._hb_thread = None
        self._hb_stop.clear()

    close = stop

    # ------------------------------------------------------------- routing

    @staticmethod
    def _t_need(queries: Sequence) -> int:
        return max((q.t_k if q.t_l is None else max(q.t_k, q.t_l))
                   for q in queries)

    def lag(self) -> dict[str, int]:
        """Per-replica staleness behind the freshest known watermark."""
        with self._lock:
            marks = {h.name: h.watermark
                     for h in self._replicas.values() if h.alive}
        top = max(marks.values(), default=-1)
        return {name: top - w for name, w in marks.items()}

    def evaluate_many(self, queries: Sequence, plan: str = "auto", **kw):
        """Route one batch.  Candidate order: healthy replicas whose
        watermark covers the batch, least loaded first (fewest queries
        routed so far, then freshest, break ties — equal-load replicas
        spread traffic).  A candidate that fails mid-call is marked down
        and the batch retries on the next — failover is part of the
        call, not an error the client sees."""
        if not queries:
            return []
        t_need = self._t_need(queries)
        with self._lock:
            healthy = [h for h in self._replicas.values() if h.alive]
            covering = [h for h in healthy if h.watermark >= t_need]
            ordered = sorted(
                covering,
                key=lambda h: (h.inflight, h.queries_routed, -h.watermark))
        if not self._replicas:
            raise ReplicaDown("no replicas registered")
        shedding = False
        for h in ordered:
            if h.inflight >= self.max_inflight:
                shedding = True
                continue
            try:
                h.inflight += 1
                h._g_inflight.set(h.inflight)
                with trace_span("route", replica=h.name,
                                n=len(queries)):
                    out = h.target.evaluate_many(queries, plan, **kw)
                h.queries_routed += len(queries)
                self.queries_routed += len(queries)
                self._m_queries.inc(len(queries))
                return out
            except WatermarkError:
                # its real watermark regressed vs our cached view —
                # not a death; refresh and try the next candidate
                self._probe(h)
                continue
            except Exception as exc:      # noqa: BLE001 — failover
                h.alive = False
                h.failures += 1
                h.last_error = f"{type(exc).__name__}: {exc}"
                self.failovers += 1
                self._m_failovers.inc()
                continue
            finally:
                h.inflight = max(h.inflight - 1, 0)
                h._g_inflight.set(h.inflight)
        if shedding:
            self.shed += 1
            self._m_shed.inc()
            raise OverloadError(
                f"every replica covering t={t_need} is at "
                f"max_inflight={self.max_inflight}")
        if not healthy:
            raise ReplicaDown("no live replicas (all heartbeats failed)")
        top = max((h.watermark for h in healthy), default=-1)
        raise WatermarkError(
            f"no live replica covers t={t_need} "
            f"(freshest watermark is {top})")

    def query(self, q, plan: str = "auto", **kw):
        return self.evaluate_many([q], plan, **kw)[0]

    def status(self) -> dict:
        """The router's own heartbeat surface (routers can stack)."""
        with self._lock:
            healthy = [h for h in self._replicas.values() if h.alive]
            return {
                "name": "router",
                "watermark": max((h.watermark for h in healthy),
                                 default=-1),
                "inflight": sum(h.inflight for h in healthy),
                "replicas": [h.snapshot()
                             for h in self._replicas.values()],
                "queries_routed": self.queries_routed,
                "failovers": self.failovers,
                "shed": self.shed,
            }
