"""Durability layer: WAL'd open tail + checkpointed sealed segments —
the PyTorch mirror of ``repro.persist``, byte for byte on disk.

``open_store(root)`` opens (or creates) a durable store root and is
the crash-recovery entry point; ``StorePersistence`` is the hook
object a durable store carries as ``store.persist``.  See
``persist.wal`` for the record framing and ``persist.manifest`` for
the on-disk layout.  Most callers want neither directly —
``repro_torch.api.GraphSession(path=...)`` wires the whole stack.
"""
from repro_torch.persist.manifest import (SegmentCorruptError,
                                          load_segment_file, read_manifest,
                                          save_segment_file,
                                          segment_block_from_bytes,
                                          segment_file_crc, segment_name,
                                          wal_name, write_manifest)
from repro_torch.persist.recovery import (Recovered, StorePersistence,
                                          open_store)
from repro_torch.persist.wal import (REC_ADVANCE, REC_DRAIN, REC_OPS,
                                     REC_PENDING, REC_SEAL, REC_TAIL,
                                     WriteAheadLog, iter_frames,
                                     read_records, scan, scan_bytes)

__all__ = [
    "open_store", "Recovered", "StorePersistence", "WriteAheadLog",
    "read_records", "scan", "scan_bytes", "iter_frames",
    "read_manifest", "write_manifest", "save_segment_file",
    "load_segment_file", "segment_file_crc", "segment_block_from_bytes",
    "SegmentCorruptError", "wal_name", "segment_name",
    "REC_OPS", "REC_ADVANCE", "REC_SEAL", "REC_PENDING", "REC_DRAIN",
    "REC_TAIL",
]
