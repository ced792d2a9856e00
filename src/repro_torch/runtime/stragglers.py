"""Straggler mitigation bookkeeping — ``repro/runtime/stragglers.py``
copied (plain Python).

In an SPMD step there is no per-worker skipping — the mitigation levers
at 1000+ nodes are (a) deadline-based microbatch shedding: if the host
loop observes step latency above a deadline, reduce the microbatch
count for subsequent steps (gradient accumulation is elastic — the
effective batch shrinks, the optimizer scales loss by actual
microbatches); (b) flagging persistently slow pods for exclusion at the
next elastic restart (``runtime/elastic.py`` in the JAX
package; not ported yet).

On one host we implement the *policy* (latency EWMA + deadline + shed /
restore decisions) and test it with synthetic latencies; the decisions
feed TrainConfig.microbatches between steps; the shed factor must
divide the batch.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerPolicy:
    deadline_ms: float          # per-step budget
    ewma: float = 0.2
    min_microbatches: int = 1
    restore_after: int = 20     # healthy steps before restoring

    def __post_init__(self):
        self._lat = None
        self._healthy = 0

    def observe(self, step_ms: float, microbatches: int) -> int:
        """Feed one step latency; returns the microbatch count to use
        next step."""
        self._lat = (step_ms if self._lat is None
                     else (1 - self.ewma) * self._lat
                     + self.ewma * step_ms)
        if self._lat > self.deadline_ms and \
                microbatches > self.min_microbatches:
            self._healthy = 0
            return max(self.min_microbatches, microbatches // 2)
        if self._lat <= 0.8 * self.deadline_ms:
            self._healthy += 1
            if self._healthy >= self.restore_after:
                self._healthy = 0
                return microbatches * 2
        return microbatches
