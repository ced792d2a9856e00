"""Segment shipping: pluggable byte transport + writer-side publisher —
the PyTorch mirror of ``repro.replica.shipping`` (framework-free: it
moves the artifacts of ``repro_torch.persist``, which are byte-identical
to ``repro.persist``'s).

The durable store's checkpoint artifacts are already the perfect
replication unit — the manifest is renamed atomically, sealed segments
are immutable and CRC-stamped, the WAL is CRC-framed per record — so
"replication protocol" reduces to *moving bytes* plus the verification
the replica does anyway.  ``Transport`` is that byte-moving seam:

* ``LocalDirTransport`` — fetch = read a file under a root directory
  (same host / NFS).  What the tests and benchmarks use.
* ``FaultyTransport``  — wraps any transport with the shared fault
  injector (``replica.faults``): dropped, delayed, torn, bit-flipped
  fetches, for chaos hardening.
* an RPC transport only needs ``fetch(relpath, timeout=) -> bytes``
  — the replica's retry/verify/quarantine loop is transport-agnostic.

``SegmentPublisher`` is the writer-side push half: subscribed to
``LiveGraphStore`` epoch swaps (``add_swap_listener``), it mirrors the
store root into a publish directory shipping ONLY the manifest diff —
segments never shipped before, the current WAL, the manifest last
(atomic), stale WALs removed after the flip.  A reader of the publish
root therefore always sees a complete, self-consistent checkpoint, and
keeps seeing the last one even while the writer is dead.  Pull-based
topologies can skip the publisher entirely and point replicas straight
at the store root.
"""
from __future__ import annotations

import dataclasses
import os

from repro_torch.obs import clock
from repro_torch.obs.metrics import BYTE_BUCKETS, default_registry
from repro_torch.obs.trace import trace_span
from repro_torch.replica.faults import FaultInjector, TransportError

__all__ = ["Transport", "LocalDirTransport", "FaultyTransport",
           "SegmentPublisher", "ShipRecord", "TransportError"]


class Transport:
    """Byte-fetch interface a replica syncs over.

    ``fetch`` returns the complete current content of ``relpath`` or
    raises: ``FileNotFoundError`` for a name that does not exist (the
    replica treats a vanished WAL as "writer rotated — refetch the
    manifest"), ``TransportError`` for a transfer that failed.
    Implementations must honor ``timeout`` (seconds) as an upper bound
    on the blocking time of one fetch.
    """

    def fetch(self, relpath: str, *, timeout: float | None = None) -> bytes:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class LocalDirTransport(Transport):
    """Fetch = read a file under ``root`` (same host or shared fs).
    Reads are not synchronized with the writer, which is exactly the
    point: immutable segments read identically forever, the manifest
    is atomic (rename), and a WAL read mid-append yields a clean
    prefix the CRC framing terminates — every artifact is safe to
    fetch racily by construction."""

    def __init__(self, root: str):
        self.root = root

    def fetch(self, relpath: str, *, timeout: float | None = None) -> bytes:
        with open(os.path.join(self.root, relpath), "rb") as fh:
            return fh.read()

    def describe(self) -> str:
        return f"local-dir:{self.root}"


class FaultyTransport(Transport):
    """Chaos wrapper: consult the injector on every fetch.  Faults are
    applied to the fetched bytes (``torn``/``bit_flip``) or the fetch
    itself (``drop``/``delay``/``eio``) at injection point
    ``"fetch"``; per-file points ``"fetch:<relpath>"`` fire first so a
    schedule can target one artifact."""

    def __init__(self, inner: Transport, injector: FaultInjector):
        self.inner = inner
        self.injector = injector

    def fetch(self, relpath: str, *, timeout: float | None = None) -> bytes:
        data = self.inner.fetch(relpath, timeout=timeout)
        data = self.injector.corrupt(f"fetch:{relpath}", data,
                                     timeout=timeout)
        return self.injector.corrupt("fetch", data, timeout=timeout)

    def describe(self) -> str:
        return f"faulty({self.inner.describe()})"


# --------------------------------------------------------------- publisher

@dataclasses.dataclass(frozen=True)
class ShipRecord:
    """One publish pass: what moved for this epoch."""

    epoch: int
    wal_seq: int
    segments_shipped: int
    bytes_shipped: int
    seconds: float


class SegmentPublisher:
    """Mirror a durable store root into a publish directory, diff-only.

    ``publish()`` ships exactly what the current manifest names and the
    previous publish did not: new sealed segment files (verified
    against their CRC stamps before shipping — corruption stops at the
    writer), the manifest-named WAL (whole-file copy; it is small, a
    base record plus the epoch's pending tail), then the manifest
    itself via atomic rename.  Ordering gives readers the same
    guarantee the writer's own checkpoint gives: a published manifest
    only ever names files that are already complete in the publish
    root.

    ``attach(live)`` subscribes to epoch swaps so every checkpoint is
    published as soon as it exists; ``transport()`` is the matching
    replica-side handle.
    """

    def __init__(self, source_root: str, publish_root: str):
        self.source = source_root
        self.publish_root = publish_root
        self.history: list[ShipRecord] = []
        self._shipped: set[str] = set()
        os.makedirs(os.path.join(publish_root, "segments"), exist_ok=True)
        # a restarted writer resumes diff shipping where the last one
        # stopped: segments the publish root's manifest already names
        # are immutable and were verified when shipped
        from repro_torch.persist.manifest import read_manifest
        prior = read_manifest(publish_root)
        if prior is not None:
            self._shipped.update(e["file"] for e in prior["segments"])

    def transport(self) -> LocalDirTransport:
        return LocalDirTransport(self.publish_root)

    def attach(self, live) -> "SegmentPublisher":
        live.add_swap_listener(lambda rec: self.publish(epoch=rec.epoch))
        return self

    def _ship_file(self, relpath: str, data: bytes) -> int:
        from repro_torch.persist.manifest import atomic_write_bytes
        atomic_write_bytes(os.path.join(self.publish_root, relpath), data)
        return len(data)

    def publish(self, epoch: int = -1) -> ShipRecord | None:
        """One diff-ship pass; returns what moved (None when the source
        has no manifest yet)."""
        from repro_torch.persist import manifest as mf
        t0 = clock.now()
        manifest = mf.read_manifest(self.source)
        if manifest is None:
            return None
        shipped_bytes = 0
        new_segments = 0
        with trace_span("publish.segments"):
            for entry in manifest["segments"]:
                rel = entry["file"]
                if rel in self._shipped:
                    continue
                data = open(os.path.join(self.source, rel), "rb").read()
                # verify before shipping: a corrupt source block must
                # not propagate to every replica
                mf.segment_block_from_bytes(
                    data, ctx=rel, expected_crc=entry.get("crc32"))
                shipped_bytes += self._ship_file(rel, data)
                self._shipped.add(rel)
                new_segments += 1
        wal_rel = mf.wal_name(int(manifest["wal_seq"]))
        wal_src = os.path.join(self.source, wal_rel)
        if os.path.exists(wal_src):
            shipped_bytes += self._ship_file(
                wal_rel, open(wal_src, "rb").read())
        # manifest LAST: readers of the publish root never see a
        # manifest naming files that are not yet complete there
        mf.write_manifest(self.publish_root,
                          {k: v for k, v in manifest.items()
                           if k != "version"})
        for name in os.listdir(self.publish_root):
            if name.startswith("wal_") and name != wal_rel:
                try:
                    os.remove(os.path.join(self.publish_root, name))
                except OSError:
                    pass
        seconds = clock.now() - t0
        rec = ShipRecord(epoch=epoch, wal_seq=int(manifest["wal_seq"]),
                         segments_shipped=new_segments,
                         bytes_shipped=shipped_bytes,
                         seconds=seconds)
        self.history.append(rec)
        reg = default_registry()
        reg.counter("publish_passes_total",
                    "diff-ship passes completed").inc()
        reg.counter("publish_segments_total",
                    "segment files shipped to the publish root"
                    ).inc(new_segments)
        reg.histogram("publish_bytes", "bytes moved per publish pass",
                      buckets=BYTE_BUCKETS).observe(shipped_bytes)
        reg.histogram("publish_seconds",
                      "publish pass duration").observe(seconds)
        return rec
