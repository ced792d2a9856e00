"""Double-buffered live ingest: a frozen epoch serves, a pending log
fills — the PyTorch mirror of ``repro.serving.ingest`` (single
device, in memory or durable).

* **Pending buffer** (host): ``append`` lands writes in a plain python
  list — no device work, no effect on in-flight queries.

* **Frozen epoch** (device): queries run against an immutable
  ``HistoricalQueryEngine`` built by the last epoch swap.

* **Epoch swap** (``swap()``): drains the pending buffer, feeds it
  through ``TemporalGraphStore.ingest``/``advance_to``, lets the
  materialization policy rebalance the anchor set against the epoch's
  query histogram, builds the next frozen engine with
  ``store.freeze_serving_state`` (only the epoch's tail segment goes to
  the device), and flips the engine pointer.  ``swap_async`` runs it on
  a daemon thread while the old epoch keeps serving.

A store opened through ``repro_torch.persist.open_store`` (or
``GraphSession(path=...)``) makes the lifecycle durable: ``append``
WAL-logs each batch before buffering it, and a swap logs its drain
intent before ingesting and checkpoints before the engine pointer
flips, so a ``kill -9`` at any instant recovers bit-exactly.

**Watermark.** ``t_served`` defines exactness: every query with times
``t ≤ t_served`` is answered bit-identically to a from-scratch store
built from the full op log.  Queries beyond it raise
(``stale="raise"``), block on a synchronous swap (``"block"``), or are
served best-effort from the frozen state (``"serve"``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Sequence

from repro_torch.core.engine import HistoricalQueryEngine, WatermarkError
from repro_torch.core.plans import Query
from repro_torch.core.store import Op, TemporalGraphStore
from repro_torch.obs import clock
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.slowlog import SlowQueryLog
from repro_torch.obs.trace import trace_span
from repro_torch.serving.policy import WorkloadStats

__all__ = ["LiveGraphStore", "SwapRecord", "WatermarkError"]


@dataclasses.dataclass(frozen=True)
class SwapRecord:
    """One epoch swap, as observed by the serving layer."""

    epoch: int
    t_served: int
    ops_absorbed: int
    ops_rejected: int
    seconds: float
    anchors_added: tuple[int, ...] = ()
    anchors_evicted: tuple[int, ...] = ()


class LiveGraphStore:
    """A continuously-serving temporal graph store.

    ``policy`` follows the serving rebalance protocol
    (``serving.policy``): called at each swap with the store and the
    epoch's ``WorkloadStats``.  A swap seals the epoch's ops into an
    immutable ``Segment`` and moves ONLY that tail to the device —
    successive epochs share the sealed history's device tensors, so
    swap cost is O(ops since the last swap).  ``segment_device_budget``
    bounds the device bytes the sealed log may hold (cold segments are
    spilled at the swap and reloaded on demand).  ``indexed`` builds
    every frozen engine with the node-centric index (node-scope
    delta-only / hybrid queries on nodes with ≤ ``node_cap`` ops gather
    only their node's ops).  ``mesh`` makes every frozen epoch a
    multi-device engine (``place_on_mesh``'s placements are part of the
    freeze, off the serving path).

    ``pending`` seeds the buffer with ops recovered from a durable
    store's WAL (``Recovered.pending``) — already durable, so they are
    NOT logged again.
    """

    def __init__(self, n_cap: int = 0, *, e_cap: int | None = None,
                 layout: str = "dense", policy=None, mesh=None,
                 indexed: bool = False, node_cap: int = 1024,
                 segment_device_budget: int | None = None,
                 store: TemporalGraphStore | None = None,
                 pending: Sequence[Op] = (), metrics=None,
                 slow_query_ms: float | None = None, device="cuda"):
        if store is None:
            store = TemporalGraphStore(n_cap, e_cap=e_cap, layout=layout,
                                       device=device)
        if segment_device_budget is not None:
            if not store.segmented:
                raise ValueError(
                    "segment_device_budget needs a segmented store "
                    "(the monolithic log keeps the full history "
                    "device-resident)")
            store.segment_device_budget = int(segment_device_budget)
        if policy is not None and store.layout != "dense":
            raise ValueError("materialization policies need the dense "
                             "layout (snapshots are stored dense)")
        self.store = store
        self.policy = policy
        self.mesh = mesh
        self.indexed = indexed
        self.node_cap = node_cap
        self.workload = WorkloadStats()
        self.epoch = 0
        # result-cache invalidation token, bumped by every swap
        self.generation = 0
        self.swap_history: list[SwapRecord] = []
        # a recovered store may carry an open tail past t_cur (ingested
        # but not advanced at the crash) and a WAL-durable pending
        # buffer: appends stay ordered after everything already logged
        self._pending: list[Op] = [o for o in pending if o.t > store.t_cur]
        tail_last = store._t_l[-1] if store._t_l else store.t_cur
        self._t_append_last = max([store.t_cur, tail_last]
                                  + [o.t for o in self._pending])
        # the time unit the in-flight (or last) swap closes: appends
        # validate against it as well as the engine watermark
        self._t_closing = store.t_cur
        self._lock = threading.RLock()       # pending buffer + flip
        self._swap_lock = threading.Lock()   # one swap in flight
        # post-swap callbacks (fed the SwapRecord), run on the swap
        # thread AFTER the checkpoint and the engine flip
        self._swap_listeners: list = []
        self.listener_errors: list[BaseException] = []
        self.metrics = default_registry() if metrics is None else metrics
        self.slow_log = (SlowQueryLog(slow_query_ms)
                         if slow_query_ms is not None else None)
        reg = self.metrics
        self._m_appended = reg.counter("serving_appended_ops_total",
                                       "ops accepted into pending")
        self._m_pending = reg.gauge("serving_pending_ops",
                                    "ops buffered awaiting a swap")
        self._m_watermark = reg.gauge("serving_watermark",
                                      "t_served exactness watermark")
        self._m_t_behind = reg.gauge("serving_t_behind",
                                     "time units ingest leads serving")
        self._m_swaps = reg.counter("serving_swaps_total",
                                    "epoch swaps completed")
        self._m_swap_s = reg.histogram("serving_swap_seconds",
                                       "full epoch-swap duration")
        self._m_phase = {
            ph: reg.histogram("serving_swap_phase_seconds",
                              "epoch-swap phase durations", phase=ph)
            for ph in ("drain", "ingest", "rebalance", "seal",
                       "checkpoint", "flip", "publish")}
        self._m_listener_err = reg.counter(
            "serving_listener_errors_total",
            "swap listener callbacks that raised")
        self._engine = self._freeze()

    # ------------------------------------------------------------ write path

    def append(self, ops: Iterable[Op | tuple]) -> int:
        """Land a batch of time-annotated ops in the pending buffer.

        Ops must keep the stream time-ordered and strictly past the
        watermark (served history is immutable).  Legality against the
        graph state is the store's job at swap time.  The batch is
        validated whole, WAL-logged whole (durable stores — before the
        buffer append, so an acknowledged op survives any crash), then
        buffered whole.  Returns #ops buffered.
        """
        with self._lock:
            w = max(self._engine.t_served, self._t_closing)
            t_last = self._t_append_last
            batch: list[Op] = []
            for o in ops:
                if not isinstance(o, Op):
                    o = Op(*o)
                if o.t < t_last:
                    raise ValueError(
                        f"ops must be time-ordered: got t={o.t} after "
                        f"t={t_last}")
                if o.t <= w:
                    raise ValueError(
                        f"op at t={o.t} is at or before the watermark "
                        f"t_served={w}; served history is immutable")
                batch.append(o)
                t_last = o.t
            persist = self.store.persist
            if persist is not None and batch:
                persist.log_pending(batch)
            self._pending.extend(batch)
            self._t_append_last = t_last
            self._m_appended.inc(len(batch))
            self._m_pending.set(len(self._pending))
            if batch:
                self._m_t_behind.set(max(0, t_last - w))
            return len(batch)

    @property
    def pending_ops(self) -> int:
        return len(self._pending)

    @property
    def t_served(self) -> int:
        """The exactness watermark: the frozen epoch's time frontier,
        clamped below the earliest pending op."""
        with self._lock:
            w = self._engine.t_served
            if self._pending:
                w = min(w, self._pending[0].t - 1)
            return int(w)

    def ingest_lag(self) -> dict:
        """How far serving trails ingest: buffered ops and time units
        between the newest accepted op and the watermark."""
        with self._lock:
            return {
                "pending_ops": len(self._pending),
                "t_behind": max(0, self._t_append_last - self.t_served),
                "epoch": self.epoch,
            }

    # ------------------------------------------------------------ epoch swap

    def _freeze(self) -> HistoricalQueryEngine:
        eng = self.store.freeze_serving_state(
            mesh=self.mesh, indexed=self.indexed, node_cap=self.node_cap)
        eng.t_served = self.store.t_cur
        # the histogram is only consumed (and decayed) by a policy
        eng.workload = self.workload if self.policy is not None else None
        eng.bind_metrics(self.metrics)
        eng.slow_log = self.slow_log
        return eng

    def swap(self, t_next: int | None = None) -> SwapRecord:
        """One epoch swap: drain pending → ingest/advance → policy
        rebalance → freeze the next engine → flip.  Swapping CLOSES
        every pending time unit: the new watermark is the newest pending
        op's time, and later appends must use strictly later times."""
        with self._swap_lock, \
                trace_span("swap", epoch=self.epoch + 1) as sp:
            t0 = clock.now()

            def _phase_done(name: str, since: float) -> float:
                now = clock.now()
                self._m_phase[name].observe(now - since)
                return now

            persist = self.store.persist
            with trace_span("swap.drain"), self._lock:
                pending, self._pending = self._pending, []
                t_hi = max((o.t for o in pending),
                           default=self.store.t_cur)
                target = max(int(t_next) if t_next is not None else 0,
                             t_hi, self.store.t_cur)
                # from here on, concurrent appends must be past it
                self._t_closing = max(self._t_closing, target)
                if persist is not None:
                    # drain intent, logged while the lock still orders
                    # it against concurrent PENDING records: replay
                    # re-executes the ingest/advance below from the same
                    # pending prefix, so their own records are
                    # suppressed (this record subsumes them)
                    persist.log_drain(len(pending), target)
            t_ph = _phase_done("drain", t0)
            with trace_span("swap.ingest", ops=len(pending)):
                if persist is not None:
                    with persist.suspend_store_log():
                        n_acc = self.store.ingest(pending)
                        self.store.advance_to(target)
                else:
                    n_acc = self.store.ingest(pending)
                    self.store.advance_to(target)
            t_ph = _phase_done("ingest", t_ph)
            added: tuple[int, ...] = ()
            evicted: tuple[int, ...] = ()
            if self.policy is not None:
                with trace_span("swap.rebalance"):
                    res = self.policy.rebalance(self.store,
                                                self.workload)
                added = tuple(res.added)
                evicted = tuple(res.evicted)
            t_ph = _phase_done("rebalance", t_ph)
            # "seal" is the freeze: the epoch's tail becomes an
            # immutable segment + the next engine's device state
            with trace_span("swap.seal"):
                eng = self._freeze()
            t_ph = _phase_done("seal", t_ph)
            with self._lock:
                if persist is not None:
                    # the manifest (sealed segments + anchors + rotated
                    # WAL) is durable BEFORE the engine pointer flips:
                    # once a client can observe the new watermark, the
                    # state below it survives any crash
                    with trace_span("swap.checkpoint"):
                        persist.checkpoint(self.store,
                                           pending=self._pending)
                t_ph = _phase_done("checkpoint", t_ph)
                with trace_span("swap.flip"):
                    self._engine = eng
                    self.epoch += 1
                    self.generation += 1
                self._m_watermark.set(int(eng.t_served))
                self._m_pending.set(len(self._pending))
            t_ph = _phase_done("flip", t_ph)
            rec = SwapRecord(
                epoch=self.epoch, t_served=int(eng.t_served),
                ops_absorbed=n_acc, ops_rejected=len(pending) - n_acc,
                seconds=clock.now() - t0,
                anchors_added=added, anchors_evicted=evicted)
            self.swap_history.append(rec)
            with trace_span("swap.publish",
                            listeners=len(self._swap_listeners)):
                for fn in list(self._swap_listeners):
                    try:
                        fn(rec)
                    except Exception as exc:  # noqa: BLE001 — a failed
                        # listener must not take down serving; it runs
                        # again at the next swap
                        self.listener_errors.append(exc)
                        self._m_listener_err.inc()
            _phase_done("publish", t_ph)
            self._m_swaps.inc()
            self._m_swap_s.observe(clock.now() - t0)
            sp.set(ops=n_acc, t_served=int(eng.t_served))
            return rec

    def add_swap_listener(self, fn) -> None:
        """Register a post-swap callback ``fn(SwapRecord)``.  Runs on
        the swap thread after checkpoint + engine flip; exceptions are
        collected in ``listener_errors`` rather than raised."""
        with self._lock:
            self._swap_listeners.append(fn)

    def swap_async(self) -> threading.Thread:
        """Run one epoch swap on a daemon thread; the frozen epoch
        keeps serving until the flip."""
        th = threading.Thread(target=self.swap, name="epoch-swap",
                              daemon=True)
        th.start()
        return th

    def close(self) -> None:
        """Checkpoint (pending buffer included — it replays into the
        next session's buffer) and release the durability layer.
        No-op for a process-resident store."""
        persist = self.store.persist
        if persist is None:
            return
        with self._swap_lock:
            with self._lock:
                persist.checkpoint(self.store, pending=self._pending)
            persist.close()

    # ------------------------------------------------------------- read path

    @property
    def engine(self) -> HistoricalQueryEngine:
        """The frozen serving engine of the current epoch."""
        return self._engine

    def _late(self, queries: Sequence[Query], w: int) -> list[Query]:
        return [q for q in queries
                if (q.t_k if q.t_l is None else max(q.t_k, q.t_l)) > w]

    def evaluate_many(self, queries: Sequence[Query], plan: str = "auto",
                      *, stale: str = "raise", **kw):
        """Batched serving with watermark semantics (``stale`` is
        ``"raise"``, ``"block"`` or ``"serve"``); everything else is
        ``HistoricalQueryEngine.evaluate_many``."""
        if stale not in ("raise", "block", "serve"):
            raise ValueError(f"unknown stale mode {stale!r}")
        late = self._late(queries, self.t_served)
        if late and stale == "block":
            self.swap()
            late = self._late(queries, self.t_served)
        if late and stale != "serve":
            t_hi = max(q.t_k if q.t_l is None else max(q.t_k, q.t_l)
                       for q in late)
            raise WatermarkError(
                f"{len(late)} queries up to t={t_hi} are past the "
                f"watermark t_served={self.t_served}; swap the epoch or "
                "pass stale='block'/'serve'")
        eng = self._engine
        return eng.evaluate_many(queries, plan,
                                 enforce_watermark=not late, **kw)

    def query(self, q: Query, plan: str = "auto", **kw):
        return self.evaluate_many([q], plan, **kw)[0]
