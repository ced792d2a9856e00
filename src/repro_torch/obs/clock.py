"""The one sanctioned monotonic clock for instrumentation.

Every timing measurement in ``src/repro`` goes through ``now()`` (or,
better, through ``obs.trace.trace_span`` / ``obs.metrics.timed``, which
use it).  ``scripts/ci_lint.py`` rejects bare ``time.perf_counter()``
calls outside this package: scattering raw clock reads is how the
pre-obs codebase grew three incompatible ad-hoc stats surfaces, and
funneling through one symbol keeps all timing swappable (tests can
monkeypatch ``clock.now``) and greppable.

Scheduling deadlines (frontend drain deadlines, backoff sleeps) use the
same clock — they are comparisons against instrumented timestamps, so
mixing clock sources would skew shed/deadline decisions.
"""
from __future__ import annotations

import time

#: Monotonic, high-resolution, cheap.  An alias (not a wrapper def) so
#: ``now()`` costs exactly one C call on the ingest hot path.
now = time.perf_counter

__all__ = ["now"]
