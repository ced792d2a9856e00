"""CRC-framed, fsync'd write-ahead log for the open tail segment — a
copy of ``repro.persist.wal`` (imports rewritten), so both packages
write and read the same record bytes.

The durability contract of the segmented store splits cleanly in two:
sealed segments are immutable and checkpointed as compact arrays
(``persist.manifest``), while everything newer — the open tail, the
serving layer's pending buffer, advance/seal events — lives only in
process memory.  This module makes that volatile half replayable: every
mutation event is appended here as one framed record *before* the
caller acknowledges it, so a ``kill -9`` at any byte loses only work
that was never acknowledged.

Framing.  A log file starts with an 8-byte magic, then records:

    [u32 length][u32 crc32(payload)][payload]

``payload[0]`` is the record type; the rest is type-specific (packed
little-endian scalars + raw ``int32`` columns — same host-array core
that ``checkpoint/io.py`` serializes, minus the npz envelope, because
records must be appendable and individually checksummed).  A torn tail
(partial write at the crash point) or a corrupt CRC terminates replay
at the last intact record; ``WriteAheadLog`` opened in repair mode
truncates the garbage so post-recovery appends extend a clean log.

Record types and their replay semantics (``persist.recovery``):

* ``REC_TAIL`` — rotation base record: the open-tail columns plus the
  store's scalar cursor state at checkpoint time.  Always the first
  record of a WAL file.
* ``REC_OPS`` — ops *accepted* by ``TemporalGraphStore.ingest``
  (including the remNode -> remEdge expansions); replayed through
  ``ingest`` they are accepted verbatim.
* ``REC_ADVANCE`` — ``advance_to(t)``.
* ``REC_SEAL`` — ``seal_tail(t, force=...)``; replay tolerates the
  no-op case where a replayed advance (with the same policy attached)
  already made the identical cut.
* ``REC_PENDING`` — ops appended to a serving-layer pending buffer
  (``LiveGraphStore.append`` logs them BEFORE buffering).
* ``REC_DRAIN`` — an epoch swap's drain intent, written before the
  swap feeds the first ``n`` pending ops through ``ingest``/
  ``advance_to`` (whose own records are suppressed — the drain record
  subsumes them).  Replay re-executes the drain deterministically, so
  a crash mid-swap recovers either side of the flip bit-exactly.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Iterable, Iterator

import numpy as np

from repro_torch.obs import clock
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.trace import trace_span

MAGIC = b"GDWAL001"
_HEADER = struct.Struct("<II")          # length, crc32
_MAX_RECORD = 1 << 30                   # sanity bound on a length field

REC_OPS = 1
REC_ADVANCE = 2
REC_SEAL = 3
REC_PENDING = 4
REC_DRAIN = 5
REC_TAIL = 6

REC_NAMES = {REC_OPS: "ops", REC_ADVANCE: "advance", REC_SEAL: "seal",
             REC_PENDING: "pending", REC_DRAIN: "drain", REC_TAIL: "tail"}


# --------------------------------------------------------------- encoding

def _encode_op_rows(ops) -> bytes:
    """(op, u, v, t) rows as u32 count + raw int32 columns."""
    arr = np.asarray([(o.op, o.u, o.v, o.t) for o in ops], np.int32)
    arr = arr.reshape(-1, 4)            # empty batch -> (0, 4)
    return struct.pack("<I", arr.shape[0]) + arr.tobytes()


def _decode_op_rows(buf: bytes, off: int) -> tuple[np.ndarray, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    arr = np.frombuffer(buf, np.int32, count=4 * n, offset=off)
    return arr.reshape(n, 4), off + 16 * n


def encode_ops(rtype: int, ops) -> bytes:
    return bytes([rtype]) + _encode_op_rows(ops)


def encode_advance(t: int) -> bytes:
    return bytes([REC_ADVANCE]) + struct.pack("<q", int(t))


def encode_seal(t_seal: int, k: int, force: bool) -> bytes:
    return bytes([REC_SEAL]) + struct.pack("<qIB", int(t_seal), int(k),
                                           int(bool(force)))


def encode_drain(n: int, target: int) -> bytes:
    return bytes([REC_DRAIN]) + struct.pack("<Iq", int(n), int(target))


def encode_tail(t_cur: int, ops_since_mat: int, t_last_mat: int,
                cols: dict[str, np.ndarray]) -> bytes:
    """Rotation base record: scalar cursors + the open-tail columns
    (op, u, v, slot, t) as one (5, n) int32 block."""
    n = len(cols["op"])
    block = np.stack([np.asarray(cols[c], np.int32)
                      for c in ("op", "u", "v", "slot", "t")])
    return (bytes([REC_TAIL])
            + struct.pack("<qqqI", int(t_cur), int(ops_since_mat),
                          int(t_last_mat), n)
            + block.tobytes())


def decode(payload: bytes):
    """payload -> (rtype, fields-dict).  Raises on malformed payloads
    (a CRC-intact record can still be from a future format version)."""
    rtype = payload[0]
    if rtype in (REC_OPS, REC_PENDING):
        rows, _ = _decode_op_rows(payload, 1)
        return rtype, {"rows": rows}
    if rtype == REC_ADVANCE:
        (t,) = struct.unpack_from("<q", payload, 1)
        return rtype, {"t": t}
    if rtype == REC_SEAL:
        t, k, force = struct.unpack_from("<qIB", payload, 1)
        return rtype, {"t": t, "k": k, "force": bool(force)}
    if rtype == REC_DRAIN:
        n, target = struct.unpack_from("<Iq", payload, 1)
        return rtype, {"n": n, "target": target}
    if rtype == REC_TAIL:
        t_cur, osm, tlm, n = struct.unpack_from("<qqqI", payload, 1)
        off = 1 + struct.calcsize("<qqqI")
        block = np.frombuffer(payload, np.int32, count=5 * n,
                              offset=off).reshape(5, n)
        cols = dict(zip(("op", "u", "v", "slot", "t"), block))
        return rtype, {"t_cur": t_cur, "ops_since_mat": osm,
                       "t_last_mat": tlm, "cols": cols}
    raise ValueError(f"unknown WAL record type {rtype}")


# ----------------------------------------------------------------- reading

def iter_frames(buf: bytes, start: int | None = None
                ) -> Iterator[tuple[bytes, int]]:
    """Yield (payload, end_offset) for every intact frame of a WAL
    byte buffer, starting at byte offset ``start`` (default: right
    after the magic; ``start`` must sit on a frame boundary).  Stops at
    the first torn or corrupt frame.  This is the incremental consumer
    used by read replicas: re-fetch the (append-only) log bytes, keep
    the consumed offset, decode only what is new."""
    if buf[:len(MAGIC)] != MAGIC:
        return
    off = len(MAGIC) if start is None else max(int(start), len(MAGIC))
    while off + _HEADER.size <= len(buf):
        length, crc = _HEADER.unpack_from(buf, off)
        end = off + _HEADER.size + length
        if length > _MAX_RECORD or end > len(buf):
            return                       # torn tail
        payload = buf[off + _HEADER.size:end]
        if zlib.crc32(payload) != crc:
            return                       # corrupt record: stop here
        yield payload, end
        off = end


def scan_bytes(buf: bytes) -> tuple[list[bytes], int]:
    """Every intact record payload of a WAL byte buffer, plus the
    offset of the first byte past the last intact record."""
    out: list[bytes] = []
    off = len(MAGIC) if buf[:len(MAGIC)] == MAGIC else 0
    for payload, end in iter_frames(buf):
        out.append(payload)
        off = end
    return out, off


def scan(path: str) -> tuple[list[bytes], int]:
    """Read every intact record payload; returns (payloads, n_valid_bytes).

    Replay stops at the first torn or corrupt record — a crash mid-
    ``append`` leaves exactly one partial record at the tail, and
    everything before it was fsync'd whole.  ``n_valid_bytes`` is the
    offset repair should truncate to."""
    with open(path, "rb") as fh:
        buf = fh.read()
    return scan_bytes(buf)


def read_records(path: str) -> Iterator[tuple[int, dict]]:
    """Decoded (rtype, fields) for every intact record."""
    payloads, _ = scan(path)
    for p in payloads:
        yield decode(p)


# ----------------------------------------------------------------- writing

class WriteAheadLog:
    """Append-only framed log.  ``append`` is atomic under an internal
    lock (serving appends PENDING records from request threads while
    the swap thread logs drain/seal events) and, with ``fsync=True``
    (the default), durable before it returns."""

    def __init__(self, path: str, *, fsync: bool = True,
                 repair: bool = True, metrics=None):
        self.path = path
        self.fsync = bool(fsync)
        self._lock = threading.Lock()
        reg = default_registry() if metrics is None else metrics
        self._m_appends = {
            rt: reg.counter("wal_appends_total",
                            "WAL records appended", type=name)
            for rt, name in REC_NAMES.items()}
        self._m_bytes = reg.counter("wal_bytes_total",
                                    "WAL bytes written (frames incl. "
                                    "headers)")
        self._m_fsync = reg.histogram("wal_fsync_seconds",
                                      "flush+fsync latency per append")
        exists = os.path.exists(path)
        if exists and repair:
            _, valid = scan(path)
            if valid < os.path.getsize(path):
                with open(path, "r+b") as fh:
                    fh.truncate(max(valid, 0))
        self._fh = open(path, "ab")
        if self._fh.tell() == 0:
            # no fsync yet: a magic-only log holds no promises, and the
            # first append's fsync covers the whole fd anyway (rotation
            # would otherwise pay a wasted sync per checkpoint)
            self._fh.write(MAGIC)
            self._fh.flush()

    def _flush(self) -> None:
        t0 = clock.now()
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self._m_fsync.observe(clock.now() - t0)

    def append(self, payload: bytes) -> None:
        with trace_span("wal.append", type=REC_NAMES.get(payload[0]),
                        bytes=len(payload)):
            with self._lock:
                self._fh.write(_HEADER.pack(len(payload),
                                            zlib.crc32(payload)))
                self._fh.write(payload)
                self._flush()
            m = self._m_appends.get(payload[0])
            if m is not None:
                m.inc()
            self._m_bytes.inc(_HEADER.size + len(payload))

    def sync(self) -> None:
        with self._lock:
            self._flush()

    def close(self, sync: bool = True) -> None:
        """``sync=False`` skips the final fsync — for a log that is
        about to be deleted (checkpoint rotation), syncing it first is
        a pure waste of a disk round-trip."""
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                if self.fsync and sync:
                    os.fsync(self._fh.fileno())
                self._fh.close()

    # convenience encoders ------------------------------------------------
    def log_ops(self, ops: Iterable) -> None:
        self.append(encode_ops(REC_OPS, ops))

    def log_pending(self, ops: Iterable) -> None:
        self.append(encode_ops(REC_PENDING, ops))

    def log_advance(self, t: int) -> None:
        self.append(encode_advance(t))

    def log_seal(self, t_seal: int, k: int, force: bool) -> None:
        self.append(encode_seal(t_seal, k, force))

    def log_drain(self, n: int, target: int) -> None:
        self.append(encode_drain(n, target))
