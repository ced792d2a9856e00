"""Durability glue + crash recovery for ``TemporalGraphStore`` — the
PyTorch mirror of ``repro.persist.recovery``: the same records, the same
manifest, the same segment files, so a root written by either package
opens in the other.

``StorePersistence`` is the object a durable store carries as
``store.persist``: the store's ingest/advance/seal paths call its
``log_*``/``on_seal`` hooks (no-ops while ``replaying``), the serving
layer logs pending/drain events through it, and ``checkpoint`` rotates
the WAL behind an atomically renamed manifest.

``open_store`` is the recovery entry point.  On a fresh root it
creates the store and the initial (manifest, WAL) pair; on an existing
root it rebuilds the exact pre-crash store:

1. manifest -> config, sealed-segment files (mmap'd — cold history is
   paged in on demand), anchor times, current WAL.
2. WAL base record (``REC_TAIL``) -> open-tail columns + cursors;
   then one vectorized host pass over segments+tail rebuilds the host
   mirror and the edge-slot registry (``_rebuild_host_state``), and
   ``current`` plus every materialized anchor are reconstructed from
   the empty graph over the full delta on the store's device — the LWW
   reconstruction kernels on a card (``_rebuild_device_state``) —
   exact by the same LWW property every query relies on (Theorem 1
   with the empty anchor), so recovered query results are
   bit-identical to a from-scratch store's.
3. the remaining records replay through the store's own public
   ``ingest``/``advance_to``/``seal_tail`` (all deterministic given
   identical state), and pending/drain records rebuild the serving
   buffer, which the caller hands back to ``LiveGraphStore``.

Replay is idempotent with respect to the policy question: if the same
materialization policy is attached, replayed advances re-materialize
and re-seal exactly as the original run did and the following seal
records no-op; with no policy, the seal records make the identical
cuts themselves.  Either way the segment files written before the
crash match the segments replay produces, byte for byte.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable

import numpy as np
import torch

from repro_torch.core.delta import ADD_EDGE, ADD_NODE, REM_NODE
from repro_torch.core.graph import empty_dense
from repro_torch.core.reconstruct import reconstruct_dense, reconstruct_edge
from repro_torch.core.segments import Segment, build_merged_nodes
from repro_torch.core.store import Op, TemporalGraphStore
from repro_torch.obs import clock
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.trace import trace_span
from repro_torch.persist import manifest as mf
from repro_torch.persist import wal as walmod
from repro_torch.persist.wal import WriteAheadLog


@dataclasses.dataclass
class Recovered:
    """What ``open_store`` hands back: the rebuilt store (persistence
    attached and live) plus the serving-layer pending ops that were
    WAL-durable but not yet drained at the crash — feed them to
    ``LiveGraphStore(store=..., pending=...)``."""

    store: object
    pending: list


class StorePersistence:
    """WAL + manifest lifecycle for one durable store root."""

    def __init__(self, root: str, *, fsync: bool = True, metrics=None):
        self.root = root
        self.fsync = bool(fsync)
        self.metrics = default_registry() if metrics is None else metrics
        self._m_ckpt = self.metrics.counter(
            "persist_checkpoints_total", "WAL rotations completed")
        self._m_ckpt_s = self.metrics.histogram(
            "persist_checkpoint_seconds",
            "checkpoint duration (base record + manifest rename)")
        self.replaying = False
        self.closed = False
        # the epoch swap drains pending ops through ingest/advance_to;
        # its REC_DRAIN record subsumes both, so their own records are
        # suppressed for the duration (seal records are NOT — replay
        # without the policy attached still needs the cuts)
        self._suspend_store_log = False
        self.wal_seq = 1
        self.wal: WriteAheadLog | None = None
        # CRC32 stamp per segment index, recorded at the (single) write
        # of each immutable file and carried into every manifest — the
        # fetch/open side re-verifies content against it
        self._seg_crcs: dict[int, int] = {}
        os.makedirs(os.path.join(root, mf.SEGMENT_DIR), exist_ok=True)

    # ------------------------------------------------------------- plumbing
    def _wal_path(self, seq: int) -> str:
        return os.path.join(self.root, mf.wal_name(seq))

    def _clean_stray_wals(self) -> None:
        """Delete WAL files other than the manifest-named one: an older
        seq survives a crash between the manifest rename and the old
        log's unlink (its content is subsumed by the new base record);
        a newer seq survives a crash *before* the rename (its content
        was derived from state the current WAL still replays to)."""
        keep = mf.wal_name(self.wal_seq)
        for name in os.listdir(self.root):
            if name.startswith("wal_") and name != keep:
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass
            elif name.endswith(".tmp"):
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass
        seg_dir = os.path.join(self.root, mf.SEGMENT_DIR)
        for name in os.listdir(seg_dir):
            if name.endswith(".tmp"):    # crashed mid-atomic-write
                try:
                    os.remove(os.path.join(seg_dir, name))
                except OSError:
                    pass

    # ---------------------------------------------------------- WAL hooks
    def log_ops(self, ops: Iterable) -> None:
        if not (self.replaying or self._suspend_store_log or self.closed):
            self.wal.log_ops(ops)

    def log_advance(self, t: int) -> None:
        if not (self.replaying or self._suspend_store_log or self.closed):
            self.wal.log_advance(t)

    def log_pending(self, ops: Iterable) -> None:
        if not (self.replaying or self.closed):
            self.wal.log_pending(ops)

    def log_drain(self, n: int, target: int) -> None:
        if not (self.replaying or self.closed):
            self.wal.log_drain(n, target)

    def suspend_store_log(self):
        """Context manager for the swap's drained ingest/advance."""
        persist = self

        class _Suspend:
            def __enter__(self):
                persist._suspend_store_log = True

            def __exit__(self, *exc):
                persist._suspend_store_log = False

        return _Suspend()

    def on_seal(self, store, segment, index: int, t_seal: int, k: int,
                force: bool) -> None:
        """Sealed-segment write hook: WAL the cut first, then persist
        the segment's compact host arrays once (atomic, immutable
        thereafter).  The record-before-file order matters: a file may
        only exist once the log pins the cut that produced it, so the
        write-if-missing check can trust any file it finds (a crash
        between the two leaves a record without a file, and replaying
        that record regenerates the identical segment and writes it
        here).  The reverse order could strand a stale orphan file that
        a post-recovery seal with a *different* cut would then adopt."""
        if self.closed:
            return
        if not self.replaying:
            self.wal.log_seal(t_seal, k, force)
        path = os.path.join(self.root, mf.segment_name(index))
        if not os.path.exists(path):
            self._seg_crcs[index] = segment.save(path)

    # ------------------------------------------------------------ rotation
    def _manifest_dict(self, store, wal_seq: int) -> dict:
        segments = []
        for i, s in enumerate(store._segments):
            path = os.path.join(self.root, mf.segment_name(i))
            if not os.path.exists(path):      # pre-attach segments
                self._seg_crcs[i] = s.save(path)
            if i not in self._seg_crcs:       # e.g. replay found the file
                self._seg_crcs[i] = mf.segment_file_crc(path)
            segments.append({"file": mf.segment_name(i),
                             "n_ops": int(s.n_ops),
                             "t_min": int(s.t_min), "t_max": int(s.t_max),
                             "crc32": int(self._seg_crcs[i])})
        return {
            "config": {"n_cap": int(store.n_cap), "e_cap": int(store.e_cap),
                       "layout": store.layout,
                       "segmented": bool(store.segmented),
                       "segment_min_ops": int(store.segment_min_ops),
                       "enforce_invertible": bool(store.enforce_invertible)},
            "t_sealed": int(store._t_sealed),
            "segments": segments,
            "anchors": [int(t) for t in store.materialized.times],
            "wal_seq": int(wal_seq),
        }

    def checkpoint(self, store, pending: Iterable = ()) -> None:
        """Rotate the WAL behind a fresh manifest: (1) write the next
        WAL with a base record capturing the open tail + the serving
        pending buffer, fsync'd; (2) atomically rename the manifest to
        point at it; (3) drop the old WAL.  A crash between any two
        steps leaves a consistent (manifest, WAL) pair — recovery
        ignores WAL files the manifest doesn't name."""
        if self.closed:
            return
        t0 = clock.now()
        with trace_span("persist.checkpoint", seq=self.wal_seq + 1):
            next_seq = self.wal_seq + 1
            new_wal = WriteAheadLog(self._wal_path(next_seq),
                                    fsync=self.fsync, repair=False,
                                    metrics=self.metrics)
            tail = store._tail_host()
            new_wal.append(walmod.encode_tail(
                store.t_cur, store._ops_since_mat, store._t_last_mat,
                tail))
            pending = list(pending)
            if pending:
                new_wal.log_pending(pending)
            mf.write_manifest(self.root,
                              self._manifest_dict(store, next_seq))
            old, self.wal, self.wal_seq = self.wal, new_wal, next_seq
            if old is not None:
                old.close(sync=False)    # it is deleted on the next line
                try:
                    os.remove(old.path)
                except OSError:
                    pass
        self._m_ckpt.inc()
        self._m_ckpt_s.observe(clock.now() - t0)

    def close(self) -> None:
        if self.wal is not None:
            self.wal.close()
        self.closed = True


# ------------------------------------------------------------------ rebuild

def _last_index_per(key: np.ndarray, size: int) -> np.ndarray:
    """Index of the last occurrence of each key value (or -1)."""
    out = np.full(size, -1, np.int64)
    if key.size:
        np.maximum.at(out, key, np.arange(key.size, dtype=np.int64))
    return out


def _rebuild_host_state(store) -> None:
    """One vectorized pass over segments + tail -> host mirror and slot
    registry.

    The log IS the state: node liveness is the last node-op per id,
    edge validity the last edge-op per slot, and the registry's
    canonical endpoints the first op that touched the slot."""
    ops, u, v, slot = store._op, store._u, store._v, store._slot

    node_sel = (ops == ADD_NODE) | (ops == REM_NODE)
    n_idx, n_op = u[node_sel], ops[node_sel]
    last = _last_index_per(n_idx, store.n_cap)
    nodes = np.zeros(store.n_cap, bool)
    seen = last >= 0
    nodes[seen] = n_op[last[seen]] == ADD_NODE
    store._nodes = nodes

    edge_sel = ~node_sel
    e_slot, e_op = slot[edge_sel], ops[edge_sel]
    e_u, e_v = u[edge_sel], v[edge_sel]
    n_slots = int(e_slot.max()) + 1 if e_slot.size else 0
    first = np.full(n_slots, np.iinfo(np.int64).max, np.int64)
    if e_slot.size:
        np.minimum.at(first, e_slot,
                      np.arange(e_slot.size, dtype=np.int64))
    # slots are assigned densely in first-touch order, so every slot
    # below the max has a first occurrence
    eu = np.minimum(e_u[first], e_v[first]).astype(np.int64)
    ev = np.maximum(e_u[first], e_v[first]).astype(np.int64)
    e_last = _last_index_per(e_slot, n_slots)
    emask = e_op[e_last] == ADD_EDGE
    store._eu_l = [int(x) for x in eu]
    store._ev_l = [int(x) for x in ev]
    store._emask_l = [bool(x) for x in emask]
    store._next_edge_slot = n_slots
    store._edge_slots = {(int(a), int(b)): i
                         for i, (a, b) in enumerate(zip(eu, ev))}
    store._adj_host = {(int(a), int(b)): bool(m)
                       for a, b, m in zip(eu, ev, emask)}
    store._invalidate()


def _rebuild_device_state(store, anchor_times: Iterable[int]) -> None:
    """``current`` and the materialized anchors, each the LWW
    reconstruction from the empty graph over (0, t] of the full log, on
    the store's device (the dense / edge-slot LWW kernels on a card) —
    the exactness property the whole query engine is built on, which is
    what makes recovered results bit-identical rather than merely
    similar."""
    if not (store.log_len and store.t_cur > 0):
        return
    delta = store.delta()
    if store.layout == "edge":
        reg = store.edge_graph()
        empty = dataclasses.replace(
            reg, nodes=torch.zeros_like(reg.nodes),
            emask=torch.zeros_like(reg.emask))
        store.current = reconstruct_edge(empty, delta, 0, store.t_cur)
    else:
        empty = empty_dense(store.n_cap, store.device)
        store.current = reconstruct_dense(empty, delta, 0, store.t_cur)
        for t_a in sorted(int(t) for t in anchor_times):
            store.materialized.add(
                t_a, reconstruct_dense(empty, delta, 0, t_a))
    if store.device.type == "cuda":
        # a kernel fault surfaces here, inside recovery, not at some
        # later call that happens to wait on the card
        torch.cuda.synchronize(store.device)


def _ops_from_rows(rows: np.ndarray) -> list:
    return [Op(int(o), int(a), int(b), int(t)) for o, a, b, t in rows]


def _replay(store, records, pending: list) -> None:
    """Feed post-checkpoint WAL records through the store's public
    mutation API.  Every step is deterministic given identical state
    (ingest's legality filtering included), so divergence can only
    mean a corrupted-but-CRC-valid log — fail loudly."""
    counts: dict[int, int] = {}
    for rtype, rec in records:
        counts[rtype] = counts.get(rtype, 0) + 1
        if rtype == walmod.REC_OPS:
            batch = _ops_from_rows(rec["rows"])
            n = store.ingest(batch)
            if n != len(batch):
                raise RuntimeError(
                    f"WAL replay diverged: {len(batch) - n} logged ops "
                    "rejected on replay")
        elif rtype == walmod.REC_ADVANCE:
            store.advance_to(int(rec["t"]))
        elif rtype == walmod.REC_SEAL:
            store.seal_tail(int(rec["t"]), force=rec["force"])
        elif rtype == walmod.REC_PENDING:
            pending.extend(_ops_from_rows(rec["rows"]))
        elif rtype == walmod.REC_DRAIN:
            batch, target = pending[:rec["n"]], int(rec["target"])
            del pending[:rec["n"]]
            store.ingest(batch)          # legality re-derived, as at runtime
            store.advance_to(target)
        elif rtype == walmod.REC_TAIL:
            raise RuntimeError("WAL has a base record past the first "
                               "position — rotation wrote a corrupt log")
    reg = default_registry()
    for rtype, n in counts.items():
        reg.counter("persist_recovery_records_total",
                    "WAL records replayed during recovery",
                    type=walmod.REC_NAMES[rtype]).inc(n)


def open_store(root: str, *, n_cap: int | None = None,
               e_cap: int | None = None, layout: str | None = None,
               policy=None, segment_min_ops: int | None = None,
               segment_device_budget: int | None = None,
               enforce_invertible: bool | None = None,
               fsync: bool = True, verify: bool = False,
               readonly: bool = False, metrics=None,
               device="cuda") -> Recovered:
    """Open (or create) a durable store root.

    Fresh root: builds a ``TemporalGraphStore`` from the keyword
    config (``n_cap`` required), attaches persistence, and writes the
    initial (manifest, WAL) pair.  Existing root: the manifest's
    config wins (explicit ``n_cap``/``layout`` arguments are checked
    against it — catching an accidental open of somebody else's root —
    and the rest are ignored); ``policy`` and
    ``segment_device_budget`` are runtime attachments, never persisted.

    Segment files whose manifest entry carries a ``crc32`` stamp are
    re-verified against it at open — a bit-flipped block raises
    ``SegmentCorruptError`` instead of serving silently wrong history.
    ``verify=True`` additionally cross-checks each file's (n_ops,
    t_min, t_max) against its manifest entry; the WAL is CRC-framed
    per record regardless.

    ``readonly=True`` is the replica open: it recovers the exact state
    the artifacts describe (manifest -> segments -> WAL-prefix replay,
    torn tails tolerated) but attaches NO persistence — the WAL is
    never repaired, truncated, or reopened for append, no stray-file
    cleanup runs, and the returned store has ``persist=None`` so its
    mutation paths log nothing.  The root may be another process's
    live directory or a replica's local mirror of one.

    ``device`` holds the store (default ``"cuda"``, which raises
    without a card): sealed segments go there as explicit copies of
    their mmap'd columns, and the rebuild of ``current`` and the
    anchors runs there — never on the CPU with a copy over.
    """
    manifest = mf.read_manifest(root) if os.path.isdir(root) else None
    if manifest is None:
        if readonly:
            raise ValueError(f"{root!r} has no manifest — a readonly "
                             "open cannot create a store")
        if n_cap is None:
            raise ValueError(f"{root!r} has no manifest and no n_cap was "
                             "given to create a fresh store")
        os.makedirs(root, exist_ok=True)
        store = TemporalGraphStore(
            n_cap, e_cap=e_cap, policy=policy,
            enforce_invertible=(True if enforce_invertible is None
                                else enforce_invertible),
            layout=layout or "dense",
            segment_min_ops=(64 if segment_min_ops is None
                             else segment_min_ops),
            segment_device_budget=segment_device_budget, device=device)
        persist = StorePersistence(root, fsync=fsync, metrics=metrics)
        persist.wal = WriteAheadLog(persist._wal_path(1), fsync=fsync,
                                    repair=False, metrics=persist.metrics)
        persist.wal.append(walmod.encode_tail(0, 0, 0, store._tail_host()))
        mf.write_manifest(root, persist._manifest_dict(store, 1))
        store.persist = persist
        return Recovered(store=store, pending=[])

    with trace_span("recovery"):
        return _recover(root, manifest, n_cap=n_cap, e_cap=e_cap,
                        layout=layout, policy=policy,
                        segment_device_budget=segment_device_budget,
                        fsync=fsync, verify=verify, readonly=readonly,
                        metrics=metrics, device=device)


def _recover(root: str, manifest: dict, *, n_cap, e_cap, layout, policy,
             segment_device_budget, fsync: bool, verify: bool,
             readonly: bool, metrics, device) -> Recovered:
    """``open_store`` on an existing root: manifest -> segments -> WAL
    base record -> host and device rebuild -> replay of the rest of the
    WAL.  Each step is a ``recovery.*`` trace span."""
    cfg = manifest["config"]
    for name, given in (("n_cap", n_cap), ("layout", layout),
                        ("e_cap", e_cap)):
        if given is not None and given != cfg[name]:
            raise ValueError(f"{root}: manifest has {name}={cfg[name]!r}, "
                             f"open asked for {given!r}")
    store = TemporalGraphStore(
        cfg["n_cap"], e_cap=cfg["e_cap"], policy=policy,
        enforce_invertible=cfg["enforce_invertible"], layout=cfg["layout"],
        segmented=cfg["segmented"], segment_min_ops=cfg["segment_min_ops"],
        segment_device_budget=segment_device_budget, device=device)

    with trace_span("recovery.segments", n=len(manifest["segments"])):
        for entry in manifest["segments"]:
            seg = Segment.load(os.path.join(root, entry["file"]),
                               expected_crc=entry.get("crc32"),
                               device=store.device)
            if verify and (seg.n_ops != entry["n_ops"]
                           or seg.t_min != entry["t_min"]
                           or seg.t_max != entry["t_max"]):
                raise ValueError(f"{entry['file']}: content does not "
                                 "match its manifest entry")
            store._segments.append(seg)
    store._t_sealed = int(manifest["t_sealed"])
    with trace_span("recovery.tree"):
        build_merged_nodes(store._segments, store._merged)

    wal_seq = int(manifest["wal_seq"])
    wal_path = os.path.join(root, mf.wal_name(wal_seq))
    with trace_span("recovery.wal_read"):
        records = list(walmod.read_records(wal_path)) \
            if os.path.exists(wal_path) else []
    if not records or records[0][0] != walmod.REC_TAIL:
        raise RuntimeError(f"{wal_path}: missing or torn base record — "
                           "the manifest names a WAL that never became "
                           "durable")
    base = records[0][1]
    store._op_l = [int(x) for x in base["cols"]["op"]]
    store._u_l = [int(x) for x in base["cols"]["u"]]
    store._v_l = [int(x) for x in base["cols"]["v"]]
    store._slot_l = [int(x) for x in base["cols"]["slot"]]
    store._t_l = [int(x) for x in base["cols"]["t"]]
    store.t_cur = int(base["t_cur"])
    store._ops_since_mat = int(base["ops_since_mat"])
    store._t_last_mat = int(base["t_last_mat"])

    with trace_span("recovery.host_rebuild"):
        _rebuild_host_state(store)
    with trace_span("recovery.card_rebuild"):
        _rebuild_device_state(store, manifest["anchors"])

    pending: list = []
    if readonly:
        # no persistence attached: replay through the public mutation
        # API exactly as below (store.persist is None, so nothing
        # logs), leave the artifacts byte-untouched
        with trace_span("recovery.replay", records=len(records) - 1):
            _replay(store, records[1:], pending)
        return Recovered(store=store, pending=pending)

    persist = StorePersistence(root, fsync=fsync, metrics=metrics)
    persist.wal_seq = wal_seq
    for i, entry in enumerate(manifest["segments"]):
        if entry.get("crc32") is not None:
            persist._seg_crcs[i] = int(entry["crc32"])
    persist.replaying = True
    try:
        store.persist = persist
        with trace_span("recovery.replay", records=len(records) - 1):
            _replay(store, records[1:], pending)
    finally:
        persist.replaying = False
    # reopen the WAL for appends (truncating any torn tail the scan
    # stopped at) only now, so a failed replay never modifies the log
    persist.wal = WriteAheadLog(wal_path, fsync=fsync, repair=True,
                                metrics=persist.metrics)
    persist._clean_stray_wals()
    return Recovered(store=store, pending=pending)
