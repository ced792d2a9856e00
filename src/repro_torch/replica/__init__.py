"""Replicated serving: one writer ships sealed segments, N read replicas —
the PyTorch mirror of ``repro.replica``.

The paper's storage model makes this topology almost coordination-free:
history at or below a watermark is immutable, so a read replica needs
nothing but the writer's checkpoint artifacts — the atomic manifest,
the CRC-stamped sealed segments, and the CRC-framed WAL — transferred
over any byte transport.  The modules:

* ``faults``   — shared fault-injection layer (torn/bit-flip/drop/
  delay/EIO) used by the chaos tests.
* ``shipping`` — pluggable ``Transport`` (local-dir now, RPC-shaped
  interface) + ``SegmentPublisher`` (writer-side manifest-diff
  shipping on every epoch swap).
* ``replica``  — ``ReadReplica``: crash-recovery's read-only open plus
  an incremental fetch loop with timeouts, bounded backoff, CRC
  re-verification, quarantine, and local hot-anchor materialization.
* ``router``   — watermark-aware ``QueryRouter`` over a replica fleet:
  health via heartbeats, failover on death, shed on overload.

Imports are lazy, as in the reference, so ``replica.faults`` imports
neither torch nor the serving stack.
"""
from repro_torch.replica.faults import (FaultInjector, FaultRule,
                                        InjectedFault, TransportError)

__all__ = [
    "FaultInjector", "FaultRule", "InjectedFault", "TransportError",
    "Transport", "LocalDirTransport", "FaultyTransport",
    "SegmentPublisher", "ShipRecord",
    "ReadReplica", "ReplicaStats", "ReplicaSyncError",
    "QueryRouter", "ReplicaDown", "ReplicaHealth",
]

_LAZY = {
    "Transport": "repro_torch.replica.shipping",
    "LocalDirTransport": "repro_torch.replica.shipping",
    "FaultyTransport": "repro_torch.replica.shipping",
    "SegmentPublisher": "repro_torch.replica.shipping",
    "ShipRecord": "repro_torch.replica.shipping",
    "ReadReplica": "repro_torch.replica.replica",
    "ReplicaStats": "repro_torch.replica.replica",
    "ReplicaSyncError": "repro_torch.replica.replica",
    "QueryRouter": "repro_torch.replica.router",
    "ReplicaDown": "repro_torch.replica.router",
    "ReplicaHealth": "repro_torch.replica.router",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
