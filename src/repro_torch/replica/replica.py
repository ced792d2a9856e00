"""Read replicas: the durable store's checkpoint stream, re-served — the
PyTorch mirror of ``repro.replica.replica``.  A replica's store lives on
its ``device`` (default ``"cuda"``): its open and every full rebuild are
crash recovery in read-only mode on that device, and it serves from a
frozen engine there.

A ``ReadReplica`` is ``open_store`` minus the write path.  It pulls
the writer's artifacts over a ``Transport`` (``replica.shipping``),
mirrors them into a local root, and serves historical queries from
the recovered state at its **own watermark** — the writer's ``t_cur``
as of the last checkpoint it has fully absorbed.  Because everything
at or below a watermark is immutable (the serving contract
``tests/test_serving.py`` pins), a replica needs no coordination
protocol: any answer it gives at ``t <= watermark`` is bit-identical
to the writer's, however stale its mirror is.

The sync loop is built to survive a hostile transport:

* every fetch has a **timeout** and failed fetches retry under
  **bounded exponential backoff with jitter** (seeded — chaos
  schedules replay deterministically);
* every fetched segment is **CRC-verified from bytes** against its
  manifest stamp *before* touching the local mirror; corrupt payloads
  are **quarantined** (kept for diagnosis under ``quarantine/``) and
  re-fetched;
* the local manifest is written **last**, so a ``kill -9`` mid-sync
  leaves the mirror a valid — merely older — store root that the
  restarted replica serves from immediately;
* a sync that exhausts its retries **degrades gracefully**: the
  replica keeps answering at its current watermark and tries again on
  the next poll tick.

Catch-up is incremental at two levels.  Within a WAL file the replica
keeps its consumed byte offset and decodes only new frames
(``wal.iter_frames``).  Across a rotation it exploits that the full op
log (sealed segments + open tail) is append-only: it ingests exactly
the suffix of ops it has not seen, re-applies the writer's seal cuts
(by the manifest's ``t_max`` boundaries — cuts are pure time
partitions), and cross-checks the resulting tail bit-for-bit against
the new WAL's base record, falling back to a full readonly rebuild on
any mismatch.  A replica that was dead for many epochs therefore
rejoins by fetching the manifest diff alone — never the history it
already holds.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
import time
from typing import Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.engine import WatermarkError
from repro_torch.obs import clock
from repro_torch.obs.metrics import (MetricsRegistry, NullRegistry,
                               default_registry)
from repro_torch.obs.trace import trace_span
from repro_torch.persist import manifest as mf
from repro_torch.persist import wal as walmod
from repro_torch.persist.recovery import _ops_from_rows, _replay, open_store
from repro_torch.replica.faults import InjectedFault
from repro_torch.replica.shipping import Transport

__all__ = ["ReadReplica", "ReplicaStats", "ReplicaSyncError",
           "WatermarkError"]

QUARANTINE_DIR = "quarantine"


class ReplicaSyncError(RuntimeError):
    """One sync pass failed after exhausting its retries.  The replica
    is still serving — at the watermark it already has."""


class _RestartSync(Exception):
    """Internal: the writer rotated mid-sync (the manifest-named WAL
    vanished under us) — refetch the manifest and go again."""


class ReplicaStats:
    """Lifetime counters for one replica (``status()`` exports them).

    A read-only view over the replica's leaf metrics registry — reads
    like ``replica.stats.syncs`` resolve live registry children, and
    the replica mutates through ``inc`` (an atomic child increment,
    never read-modify-write).  Per-instance counts start at zero per
    replica because each replica owns a fresh leaf registry; the same
    increments aggregate into the parent registry.
    """

    _COUNTERS = {
        "syncs": ("replica_syncs_total", "successful sync passes"),
        "sync_failures": ("replica_sync_failures_total",
                          "sync passes that exhausted retries"),
        "segments_fetched": ("replica_segments_fetched_total",
                             "segment files shipped over transport"),
        "segments_reused": ("replica_segments_reused_total",
                            "segment fetches skipped (mirror intact)"),
        "bytes_fetched": ("replica_bytes_fetched_total",
                          "artifact bytes pulled over transport"),
        "records_applied": ("replica_records_applied_total",
                            "WAL records applied to the mirror"),
        "full_rebuilds": ("replica_full_rebuilds_total",
                          "incremental applies that fell back to a "
                          "full readonly rebuild"),
        "quarantined": ("replica_quarantined_total",
                        "corrupt payloads quarantined"),
        "fetch_retries": ("replica_fetch_retries_total",
                          "artifact fetches retried"),
        "queries_served": ("replica_queries_served_total",
                           "queries answered by this replica"),
    }

    def __init__(self, registry):
        children = {}
        for attr, (name, help_) in self._COUNTERS.items():
            children[attr] = registry.counter(name, help_)
        self._children = children
        self._last_sync = registry.gauge(
            "replica_last_sync_seconds",
            "duration of the last completed sync pass")
        self.last_error = ""

    def inc(self, attr: str, n: int = 1) -> None:
        self._children[attr].inc(n)

    def __getattr__(self, name):
        children = self.__dict__.get("_children")
        if children is not None and name in children:
            return children[name].value
        raise AttributeError(name)

    @property
    def last_sync_seconds(self) -> float:
        return self._last_sync.value

    @last_sync_seconds.setter
    def last_sync_seconds(self, v: float) -> None:
        self._last_sync.set(float(v))

    def asdict(self) -> dict:
        out = {attr: c.value for attr, c in self._children.items()}
        out["last_sync_seconds"] = self.last_sync_seconds
        out["last_error"] = self.last_error
        return out


class ReadReplica:
    """Serve historical queries from a synced mirror of a writer root.

    ``transport`` fetches the writer's artifacts; ``local_root`` is
    this replica's own durable mirror (restart = readonly open of it,
    no transport needed to come back up at the old watermark).

    ``anchor_budget_bytes`` turns on replica-local hot-anchor
    materialization: the replica records its *own* query histogram and
    runs ``WorkloadMaterializationPolicy`` against it after every
    apply, so each replica's snapshot set follows the traffic *it*
    sees, under *its* byte budget — anchors are a serving accelerant,
    not replicated state.

    ``device`` holds the replica's store and engine (default
    ``"cuda"``, which raises without a card); ``mesh`` makes each of its
    frozen engines a multi-device one, as ``LiveGraphStore(mesh=)``.
    """

    def __init__(self, transport: Transport, local_root: str, *,
                 name: str = "replica",
                 fetch_timeout: float = 5.0,
                 max_retries: int = 6,
                 backoff_base: float = 0.02,
                 backoff_max: float = 1.0,
                 anchor_budget_bytes: int | None = None,
                 anchor_min_gap_ops: int = 128,
                 mesh=None, indexed: bool = False, node_cap: int = 1024,
                 seed: int = 0, metrics=None, device="cuda"):
        self.transport = transport
        self.root = local_root
        self.name = name
        self.fetch_timeout = float(fetch_timeout)
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.indexed = indexed
        self.node_cap = int(node_cap)
        # per-instance leaf registry chained onto the session/process
        # parent (see obs.metrics module docstring)
        parent = default_registry() if metrics is None else metrics
        self.metrics = (parent if isinstance(parent, NullRegistry)
                        else MetricsRegistry(parent=parent))
        self.stats = ReplicaStats(self.metrics)
        self._m_outcome = {
            mode: self.metrics.counter("replica_sync_outcome_total",
                                       "sync passes by apply mode",
                                       mode=mode)
            for mode in ("initial", "rebuild", "incremental", "rotate",
                         "noop")}
        self._m_sync_s = self.metrics.histogram(
            "replica_sync_seconds", "sync pass duration")
        self._m_watermark = self.metrics.gauge(
            "replica_watermark", "this replica's exactness frontier")
        self._rng = random.Random(seed)
        os.makedirs(os.path.join(local_root, mf.SEGMENT_DIR), exist_ok=True)
        os.makedirs(os.path.join(local_root, QUARANTINE_DIR), exist_ok=True)

        self.store = None
        self._engine = None
        self._pending: list = []
        self._manifest: dict | None = None
        self._wal_seq = 0
        self._wal_off = 0                 # consumed bytes of current WAL
        self._seg_ok: set[str] = set()    # locally verified segment files
        self._lock = threading.RLock()    # engine flip + serving
        self._sync_lock = threading.Lock()
        self._inflight = 0
        self._stop = threading.Event()
        self._poll_thread: threading.Thread | None = None

        self.policy = None
        self.workload = None
        if anchor_budget_bytes is not None:
            from repro_torch.serving.policy import (
                WorkloadMaterializationPolicy, WorkloadStats)
            self.policy = WorkloadMaterializationPolicy(
                budget_bytes=int(anchor_budget_bytes),
                min_gap_ops=int(anchor_min_gap_ops))
            self.workload = WorkloadStats()

        # a restarted replica comes back up from its own mirror first:
        # serving resumes at the pre-crash watermark before the
        # transport is ever touched (it may be down too)
        if mf.read_manifest(local_root) is not None:
            self._apply_rebuild(mf.read_manifest(local_root),
                                self._read_local_wal(), initial=True)

    # ------------------------------------------------------------ fetching

    def _backoff(self, attempt: int) -> float:
        span = min(self.backoff_max, self.backoff_base * (2 ** attempt))
        return span * (0.5 + self._rng.random() / 2)

    def _fetch(self, relpath: str) -> bytes:
        """One artifact, with per-fetch timeout and bounded exponential
        backoff + jitter.  ``FileNotFoundError`` propagates immediately
        (it is a *signal* — for WALs, that the writer rotated);
        transport faults retry."""
        last: Exception | None = None
        for attempt in range(self.max_retries):
            try:
                data = self.transport.fetch(relpath,
                                            timeout=self.fetch_timeout)
                self.stats.inc("bytes_fetched", len(data))
                return data
            except FileNotFoundError:
                raise
            except (InjectedFault, OSError, TimeoutError) as exc:
                last = exc
                self.stats.inc("fetch_retries")
                time.sleep(self._backoff(attempt))
        raise ReplicaSyncError(
            f"{self.name}: fetch of {relpath!r} failed after "
            f"{self.max_retries} attempts: {last}") from last

    def _quarantine(self, relpath: str, data: bytes) -> None:
        qdir = os.path.join(self.root, QUARANTINE_DIR)
        base = os.path.basename(relpath)
        n = self.stats.quarantined
        with open(os.path.join(qdir, f"{base}.{n:04d}"), "wb") as fh:
            fh.write(data)
        self.stats.inc("quarantined")

    def _fetch_segment(self, entry: dict) -> None:
        """Fetch + CRC-verify one sealed segment into the mirror.  A
        corrupt payload is quarantined and re-fetched — segments are
        immutable, so a clean copy always exists at the source."""
        rel, crc = entry["file"], entry.get("crc32")
        for attempt in range(self.max_retries):
            data = self._fetch(rel)
            try:
                mf.segment_block_from_bytes(data, ctx=rel, expected_crc=crc)
            except mf.SegmentCorruptError:
                self._quarantine(rel, data)
                time.sleep(self._backoff(attempt))
                continue
            mf.atomic_write_bytes(os.path.join(self.root, rel), data)
            self._seg_ok.add(rel)
            self.stats.inc("segments_fetched")
            return
        raise ReplicaSyncError(
            f"{self.name}: segment {rel!r} still corrupt after "
            f"{self.max_retries} fetches")

    def _ensure_segment(self, entry: dict) -> None:
        """Diff step: ship nothing the mirror already holds intact."""
        rel = entry["file"]
        if rel in self._seg_ok:
            self.stats.inc("segments_reused")
            return
        path = os.path.join(self.root, rel)
        if os.path.exists(path):
            try:
                crc = entry.get("crc32")
                if crc is None or mf.segment_file_crc(path) == int(crc):
                    self._seg_ok.add(rel)
                    self.stats.inc("segments_reused")
                    return
            except Exception:
                pass                      # unreadable local file: refetch
            os.replace(path, os.path.join(
                self.root, QUARANTINE_DIR,
                os.path.basename(rel) + f".{self.stats.quarantined:04d}"))
            self.stats.inc("quarantined")
        self._fetch_segment(entry)

    def _read_local_wal(self) -> bytes:
        man = mf.read_manifest(self.root)
        path = os.path.join(self.root, mf.wal_name(int(man["wal_seq"])))
        if not os.path.exists(path):
            return b""
        with open(path, "rb") as fh:
            return fh.read()

    # ---------------------------------------------------------------- sync

    def sync(self) -> dict:
        """One full sync pass: manifest diff -> segments -> WAL ->
        local manifest -> apply.  Raises ``ReplicaSyncError`` on
        exhaustion (the poll loop catches it; direct callers decide)."""
        with self._sync_lock, trace_span("replica.sync",
                                         replica=self.name) as sp:
            t0 = clock.now()
            try:
                for _ in range(4):        # writer may rotate under us
                    try:
                        rec = self._sync_once()
                        break
                    except _RestartSync:
                        continue
                else:
                    raise ReplicaSyncError(
                        f"{self.name}: writer kept rotating mid-sync")
            except Exception as exc:
                self.stats.inc("sync_failures")
                self.stats.last_error = f"{type(exc).__name__}: {exc}"
                if isinstance(exc, ReplicaSyncError):
                    raise
                # normalize: callers of sync() see exactly one failure
                # type however the transport or a poisoned artifact
                # chose to blow up
                raise ReplicaSyncError(
                    f"{self.name}: sync failed: "
                    f"{type(exc).__name__}: {exc}") from exc
            self.stats.inc("syncs")
            seconds = clock.now() - t0
            self.stats.last_sync_seconds = seconds
            self._m_sync_s.observe(seconds)
            outcome = self._m_outcome.get(rec.get("mode"))
            if outcome is not None:
                outcome.inc()
            sp.set(mode=rec.get("mode"),
                   applied=rec.get("records_applied"))
            self.stats.last_error = ""
            rec["seconds"] = seconds
            return rec

    def _fetch_manifest(self) -> dict:
        """The manifest, parsed.  A fetch that yields unparseable JSON
        (bit-flipped in flight, torn read) retries like any other
        failed transfer — the source copy is atomic and intact."""
        last: Exception | None = None
        for attempt in range(self.max_retries):
            raw = self._fetch(mf.MANIFEST)
            try:
                return json.loads(raw)
            except ValueError as exc:
                last = exc
                self.stats.inc("fetch_retries")
                time.sleep(self._backoff(attempt))
        raise ReplicaSyncError(
            f"{self.name}: manifest unparseable after "
            f"{self.max_retries} fetches: {last}") from last

    def _sync_once(self) -> dict:
        manifest = self._fetch_manifest()
        if self._manifest is not None and manifest == self._manifest:
            return self._sync_wal_growth(manifest)

        for entry in manifest["segments"]:
            self._ensure_segment(entry)
        wal_rel = mf.wal_name(int(manifest["wal_seq"]))
        try:
            walbuf = self._fetch(wal_rel)
        except FileNotFoundError:
            raise _RestartSync from None
        mf.atomic_write_bytes(os.path.join(self.root, wal_rel), walbuf)
        # local manifest LAST: the mirror is a valid store root at
        # every instant — kill -9 here and the restart serves the old
        # checkpoint (or this one, if the rename landed)
        mf.write_manifest(self.root, {k: v for k, v in manifest.items()
                                      if k != "version"})
        for name in os.listdir(self.root):
            if name.startswith("wal_") and name != wal_rel:
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass
        return self._apply(manifest, walbuf)

    def _sync_wal_growth(self, manifest: dict) -> dict:
        """Manifest unchanged: only the WAL can have grown.  Fetch it,
        mirror it, replay the new frames."""
        wal_rel = mf.wal_name(int(manifest["wal_seq"]))
        try:
            walbuf = self._fetch(wal_rel)
        except FileNotFoundError:
            raise _RestartSync from None
        if len(walbuf) <= self._wal_off and self.store is not None:
            return self._rec("noop", 0)
        mf.atomic_write_bytes(os.path.join(self.root, wal_rel), walbuf)
        return self._apply(manifest, walbuf)

    # --------------------------------------------------------------- apply

    def _rec(self, mode: str, applied: int) -> dict:
        return {"mode": mode, "records_applied": applied,
                "wal_seq": self._wal_seq, "watermark": self.watermark}

    def _apply(self, manifest: dict, walbuf: bytes) -> dict:
        if self.store is None:
            return self._apply_rebuild(manifest, walbuf, initial=True)
        if int(manifest["wal_seq"]) == self._wal_seq:
            if len(walbuf) < self._wal_off:
                # same seq but *shorter* log: the source was reset —
                # nothing incremental is trustworthy
                return self._apply_rebuild(manifest, walbuf)
            return self._apply_incremental(manifest, walbuf)
        try:
            return self._apply_rotation(manifest, walbuf)
        except _RebuildNeeded:
            return self._apply_rebuild(manifest, walbuf)

    def _finish_apply(self, manifest: dict, walbuf: bytes, store,
                      pending: list, mode: str, applied: int) -> dict:
        _, off = walmod.scan_bytes(walbuf)
        if self.policy is not None and store.layout == "dense":
            self.policy.rebalance(store, self.workload)
        eng = store.freeze_serving_state(
            mesh=self.mesh, indexed=self.indexed, node_cap=self.node_cap)
        eng.t_served = store.t_cur
        eng.workload = self.workload
        with self._lock:
            self.store = store
            self._pending = pending
            self._manifest = manifest
            self._wal_seq = int(manifest["wal_seq"])
            self._wal_off = off
            self._engine = eng
        self.stats.inc("records_applied", applied)
        self._m_watermark.set(int(store.t_cur))
        return self._rec(mode, applied)

    def _apply_rebuild(self, manifest: dict, walbuf: bytes,
                       initial: bool = False) -> dict:
        """Ground truth: a full readonly recovery of the local mirror.
        Also the fallback when an incremental path cannot prove it
        reproduced the writer's state."""
        rec = open_store(self.root, readonly=True, device=self.device)
        for entry in manifest["segments"]:
            self._seg_ok.add(entry["file"])
        if not initial:
            self.stats.inc("full_rebuilds")
        n = max(len(list(walmod.iter_frames(walbuf))) - 1, 0)
        return self._finish_apply(manifest, walbuf, rec.store, rec.pending,
                                  "initial" if initial else "rebuild", n)

    def _apply_incremental(self, manifest: dict, walbuf: bytes) -> dict:
        """Same WAL file, new frames: decode from the consumed offset
        and feed them through the store's public mutation API — the
        identical replay recovery itself uses."""
        records = [walmod.decode(p)
                   for p, _ in walmod.iter_frames(walbuf, self._wal_off)]
        _replay(self.store, records, self._pending)
        return self._finish_apply(manifest, walbuf, self.store,
                                  self._pending, "incremental",
                                  len(records))

    def _apply_rotation(self, manifest: dict, walbuf: bytes) -> dict:
        """The WAL rotated (one or MANY checkpoints ago — a replica
        dead for hours catches up the same way).  The full op log is
        append-only, so the new state differs from ours by a suffix:

        1. ingest the ops we have not seen (segments + new base tail,
           sliced past our ``log_len``) — accepted rows replay
           idempotently through ``ingest``;
        2. advance to the base record's ``t_cur``;
        3. re-apply the writer's seal cuts at the manifest's ``t_max``
           boundaries (cuts are pure time partitions of a
           time-ordered log, so order of application is irrelevant);
        4. verify the rebuilt open tail matches the base record
           bit-for-bit (slots included — slot assignment is
           first-touch deterministic), then replay the post-base
           frames as usual.

        Any step that cannot prove equivalence raises and the caller
        falls back to the full rebuild."""
        payloads, _ = walmod.scan_bytes(walbuf)
        records = [walmod.decode(p) for p in payloads]
        if not records or records[0][0] != walmod.REC_TAIL:
            raise _RebuildNeeded("new WAL has no intact base record")
        base = records[0][1]
        store = self.store

        suffix, total = self._log_suffix(manifest, base, store.log_len)
        if total < store.log_len:
            raise _RebuildNeeded("writer log shorter than replica log")
        n = store.ingest(_ops_from_rows(suffix))
        if n != len(suffix):
            raise _RebuildNeeded(f"{len(suffix) - n} suffix ops rejected")
        store.advance_to(int(base["t_cur"]))
        for entry in manifest["segments"][len(store._segments):]:
            store.seal_tail(int(entry["t_max"]), force=True)
        store._ops_since_mat = int(base["ops_since_mat"])
        store._t_last_mat = int(base["t_last_mat"])

        if len(store._segments) != len(manifest["segments"]):
            raise _RebuildNeeded("seal cuts did not reproduce")
        tail = store._tail_host()
        for c in ("op", "u", "v", "slot", "t"):
            if not np.array_equal(np.asarray(tail[c], np.int64),
                                  np.asarray(base["cols"][c], np.int64)):
                raise _RebuildNeeded(f"tail column {c!r} diverged")
        if store.t_cur != int(base["t_cur"]):
            raise _RebuildNeeded("t_cur diverged")

        pending: list = []                # base WAL re-logs the buffer
        _replay(store, records[1:], pending)
        return self._finish_apply(manifest, walbuf, store, pending,
                                  "rotate", len(records) - 1 + len(suffix))

    def _log_suffix(self, manifest: dict, base: dict,
                    start: int) -> tuple[np.ndarray, int]:
        """(op, u, v, t) rows of the writer's full op log past index
        ``start``, read from the (already mirrored) segment files plus
        the base record's tail.  Returns (rows, writer_log_len)."""
        chunks, idx = [], 0
        for entry in manifest["segments"]:
            n = int(entry["n_ops"])
            if idx + n > start:
                cols = mf.load_segment_file(
                    os.path.join(self.root, entry["file"]),
                    expected_crc=entry.get("crc32"))
                lo = max(start - idx, 0)
                chunks.append(np.stack(
                    [np.asarray(cols[c][lo:], np.int64)
                     for c in ("op", "u", "v", "t")], axis=1))
            idx += n
        cols = base["cols"]
        n = len(cols["op"])
        if idx + n > start:
            lo = max(start - idx, 0)
            chunks.append(np.stack(
                [np.asarray(cols[c][lo:], np.int64)
                 for c in ("op", "u", "v", "t")], axis=1))
        idx += n
        rows = (np.concatenate(chunks) if chunks
                else np.empty((0, 4), np.int64))
        return rows, idx

    # ------------------------------------------------------------- polling

    def start(self, interval: float = 0.05) -> "ReadReplica":
        """Background fetch loop: sync every ``interval`` seconds; a
        failed pass degrades to serving the current watermark and
        retries on the next tick."""
        if self._poll_thread is not None:
            return self

        def _loop():
            while not self._stop.is_set():
                try:
                    self.sync()
                except Exception:
                    pass                  # recorded in stats; keep serving
                self._stop.wait(interval)

        self._poll_thread = threading.Thread(
            target=_loop, name=f"{self.name}-sync", daemon=True)
        self._poll_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
            self._poll_thread = None
        self._stop.clear()

    close = stop

    # ------------------------------------------------------------- serving

    @property
    def watermark(self) -> int:
        """Exactness frontier: queries at ``t <= watermark`` answer
        bit-identically to the writer (and to a from-scratch store)."""
        with self._lock:
            return int(self._engine.t_served) if self._engine else -1

    def evaluate_many(self, queries: Sequence, plan: str = "auto", **kw):
        """Batched serving at this replica's watermark.  Queries past
        it raise ``WatermarkError`` — the caller (usually the router)
        picks a fresher replica or waits; this replica never serves
        history it cannot prove exact."""
        with self._lock:
            eng = self._engine
            if eng is None:
                raise ReplicaSyncError(
                    f"{self.name}: no state synced yet")
            self._inflight += 1
        try:
            w = int(eng.t_served)
            late = [q for q in queries
                    if (q.t_k if q.t_l is None else max(q.t_k, q.t_l)) > w]
            if late:
                raise WatermarkError(
                    f"{self.name}: {len(late)} queries past replica "
                    f"watermark t={w}")
            out = eng.evaluate_many(queries, plan, **kw)
            self.stats.inc("queries_served", len(queries))
            return out
        finally:
            with self._lock:
                self._inflight -= 1

    def query(self, q, plan: str = "auto", **kw):
        return self.evaluate_many([q], plan, **kw)[0]

    def refresh_anchors(self) -> None:
        """Re-run the local anchor policy against the query histogram
        accumulated since the last apply and refreeze serving.  Every
        apply does this implicitly; call it directly to adapt anchors
        while the writer is quiet (no new checkpoints to absorb)."""
        if self.policy is None or self.store is None:
            return
        with self._sync_lock:
            if self.store.layout == "dense":
                self.policy.rebalance(self.store, self.workload)
            eng = self.store.freeze_serving_state(
                mesh=self.mesh, indexed=self.indexed,
                node_cap=self.node_cap)
            eng.t_served = self.store.t_cur
            eng.workload = self.workload
            with self._lock:
                self._engine = eng

    @property
    def inflight(self) -> int:
        return self._inflight

    def status(self) -> dict:
        """Heartbeat payload for the router: identity, freshness,
        load, health counters."""
        return {
            "name": self.name,
            "watermark": self.watermark,
            "wal_seq": self._wal_seq,
            "inflight": self._inflight,
            "pending_ops": len(self._pending),
            "stats": self.stats.asdict(),
        }


class _RebuildNeeded(Exception):
    """Internal: an incremental apply could not prove equivalence."""
