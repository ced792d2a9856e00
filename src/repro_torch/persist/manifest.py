"""Anchor manifest + sealed-segment files: the checkpointed half — a
copy of ``repro.persist.manifest``, so both packages write and read the
same bytes.

On-disk layout of a durable store root::

    root/
      MANIFEST.json          # atomic (tmp + rename): config, segment
                             # list, anchor times, current WAL seq
      wal_00000001.log       # the replayable tail (persist.wal)
      segments/seg_000000.npy  # one (5, n_ops) int32 block per sealed
                               # segment: op / u / v / slot / t rows

Sealed segments are immutable, so their files are written exactly once
(atomically, at ``seal_tail`` time) and thereafter only *referenced* by
successive manifests — a checkpoint costs one small JSON rename, never
a data rewrite.  This is the same snapshot-plus-chain shape as
``repro``'s ``checkpoint/deltastore.py`` (manifest names the chain,
files hold the arrays); segments use a bare ``.npy`` rather than its
npz envelope so recovery can ``np.load(..., mmap_mode="r")`` them —
``Segment`` keeps the read-only mmap rows as its host columns, and its
device ``Delta`` is an explicit copy (``Segment.delta``), so nothing
ever writes through the mapping.

Crash ordering (see ``StorePersistence.checkpoint``): the new WAL is
written and fsync'd first, the manifest rename flips second, the old
WAL is deleted last.  Any prefix of that sequence recovers: a manifest
always names a WAL that exists and whose base record matches it.
"""
from __future__ import annotations

import io
import json
import os
import zlib

import numpy as np

MANIFEST = "MANIFEST.json"
SEGMENT_DIR = "segments"
VERSION = 1


class SegmentCorruptError(ValueError):
    """A segment block that fails shape, dtype, or CRC32 validation."""

CONFIG_KEYS = ("n_cap", "e_cap", "layout", "segmented", "segment_min_ops",
               "enforce_invertible")


def wal_name(seq: int) -> str:
    return f"wal_{seq:08d}.log"


def segment_name(index: int) -> str:
    return os.path.join(SEGMENT_DIR, f"seg_{index:06d}.npy")


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return                           # platform without dir fds
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """tmp + fsync + rename (+ directory fsync): the file is either the
    old content or the complete new content, never a torn middle."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def segment_block_crc(block: np.ndarray) -> int:
    """CRC32 of a (5, n) int32 segment block's raw bytes — the stamp
    recorded per segment entry in the manifest."""
    return zlib.crc32(np.ascontiguousarray(block, np.int32).tobytes())


def save_segment_file(path: str, cols: dict[str, np.ndarray]) -> int:
    """Write one sealed segment's columns as a (5, n) int32 ``.npy``
    block, atomically.  Returns the crc32 of the block bytes (recorded
    in the manifest for integrity checks)."""
    block = np.stack([np.ascontiguousarray(cols[c], np.int32)
                      for c in ("op", "u", "v", "slot", "t")])
    buf = io.BytesIO()
    np.save(buf, block)
    atomic_write_bytes(path, buf.getvalue())
    return segment_block_crc(block)


def _check_block(block: np.ndarray, ctx: str,
                 expected_crc: int | None) -> np.ndarray:
    if block.ndim != 2 or block.shape[0] != 5 or block.dtype != np.int32:
        raise SegmentCorruptError(
            f"{ctx}: not a (5, n) int32 segment block "
            f"(got {block.dtype}{block.shape})")
    if expected_crc is not None:
        got = segment_block_crc(block)
        if got != int(expected_crc):
            raise SegmentCorruptError(
                f"{ctx}: crc32 mismatch (stamped {int(expected_crc)}, "
                f"content {got}) — the block is corrupt")
    return block


def load_segment_file(path: str, *, mmap: bool = True,
                      expected_crc: int | None = None
                      ) -> dict[str, np.ndarray]:
    """Columns of a sealed segment, mmap-backed by default — rows of
    the C-ordered (5, n) block are themselves contiguous int32, so
    ``Segment`` adopts them without copying and only touched pages are
    ever read.

    ``expected_crc`` re-checks the manifest's CRC32 stamp against the
    content (reading every page through the mmap once — recovery's
    rebuild pass touches them all anyway); a mismatch raises
    ``SegmentCorruptError`` instead of serving silently wrong history.
    """
    block = np.load(path, mmap_mode="r" if mmap else None)
    _check_block(block, path, expected_crc)
    return dict(zip(("op", "u", "v", "slot", "t"), block))


def segment_block_from_bytes(data: bytes, *, ctx: str = "<bytes>",
                             expected_crc: int | None = None) -> np.ndarray:
    """Parse + validate a fetched segment payload WITHOUT touching the
    filesystem — the replica's fetch path verifies bytes before they
    are ever written locally.  Raises ``SegmentCorruptError`` on a
    torn/corrupt payload (np.load failures included)."""
    try:
        block = np.load(io.BytesIO(data))
    except Exception as exc:             # torn npy header / short body
        raise SegmentCorruptError(f"{ctx}: unreadable segment payload "
                                  f"({exc})") from exc
    return _check_block(block, ctx, expected_crc)


def segment_file_crc(path: str) -> int:
    """CRC32 stamp recomputed from a segment file on disk."""
    return segment_block_crc(np.load(path, mmap_mode="r"))


def write_manifest(root: str, manifest: dict) -> None:
    manifest = dict(manifest, version=VERSION)
    atomic_write_bytes(os.path.join(root, MANIFEST),
                       (json.dumps(manifest, indent=1, sort_keys=True)
                        + "\n").encode())


def read_manifest(root: str) -> dict | None:
    path = os.path.join(root, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        manifest = json.load(fh)
    if manifest.get("version") != VERSION:
        raise ValueError(f"{path}: unsupported manifest version "
                         f"{manifest.get('version')!r}")
    return manifest
