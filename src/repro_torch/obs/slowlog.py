"""Slow-query log: threshold-triggered span dumps with plan attribution.

The engine times every ``evaluate_many`` call; a call slower than
``threshold_ms`` lands one entry here carrying the *full plan
attribution* — per-group (plan, layout, shard mode, batch size), the
call's reconstruction-cache traffic, and (when a tracer is installed)
the spans recorded during the call, so a slow production query explains
itself without re-running anything.

The log is a bounded ring (oldest entries fall off) and recording is
two comparisons on the fast path — a fast call never builds an entry.
"""
from __future__ import annotations

import threading
from collections import deque

__all__ = ["SlowQueryLog"]


class SlowQueryLog:
    """Bounded ring of slow-call records.

    ``threshold_ms`` gates recording; ``record`` takes a zero-arg entry
    builder so the (comparatively expensive) attribution dict is only
    materialized for calls that actually crossed the threshold.
    """

    def __init__(self, threshold_ms: float = 250.0, capacity: int = 64):
        self.threshold_ms = float(threshold_ms)
        self.capacity = int(capacity)
        self._entries: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.recorded = 0

    def should_record(self, seconds: float) -> bool:
        return seconds * 1e3 >= self.threshold_ms

    def record(self, seconds: float, entry_fn) -> bool:
        """Record iff ``seconds`` crosses the threshold; ``entry_fn()``
        builds the attribution payload lazily.  Returns whether an
        entry landed."""
        if not self.should_record(seconds):
            return False
        entry = dict(entry_fn())
        entry["seconds"] = float(seconds)
        with self._lock:
            self.recorded += 1
            self._entries.append(entry)
        return True

    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
