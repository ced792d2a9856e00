"""Structured tracing: bounded span ring buffer, Chrome trace export.

``trace_span(name, **attrs)`` is the only API instrumented code uses.
Its cost contract is the whole design:

* **No tracer installed** (the default): ``trace_span`` returns one
  shared no-op singleton — a module-global ``None`` check plus a
  constant return, no allocation, no clock read.  Tracing that is off
  costs a dict lookup per span site, nothing more
  (tests/test_obs.py pins the singleton identity).
* **Tracer installed**: spans record (name, start, duration, thread,
  attrs) into a bounded ``deque`` ring — old events fall off the back,
  a long-running session never grows without bound.

Export is the Chrome ``trace_event`` JSON format (complete ``"X"``
events carrying ``ts``/``dur`` in microseconds): load the dump in
``chrome://tracing`` / Perfetto and one query renders as a nested
timeline of plan → anchor-select → window-delta materialize → device
dispatch → measure; one epoch swap as drain → WAL append/fsync → seal
→ checkpoint → engine flip → publish.  Nesting needs no explicit
parent ids — same-thread events nest by time containment, which the
with-statement discipline guarantees.

One process-wide tracer slot (not per-session): spans fire on frontend
scheduler threads, swap threads and replica sync loops that have no
session handle, and Chrome's timeline is per (pid, tid) anyway.
``GraphSession.enable_tracing`` installs, ``dump_trace`` exports.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque

from repro_torch.obs import clock

__all__ = ["Tracer", "trace_span", "install_tracer", "uninstall_tracer",
           "active_tracer", "NULL_SPAN"]

_INSTALLED: "Tracer | None" = None


class _NullSpan:
    """The disabled-tracing span: a shared, stateless no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._t0 = clock.now()
        return self

    def set(self, **attrs):
        """Attach attributes discovered mid-span (group counts, cache
        hits, ...)."""
        self.attrs.update(attrs)

    def __exit__(self, exc_type, exc, tb):
        t1 = clock.now()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._record(self.name, self._t0, t1 - self._t0,
                             self.attrs)
        return False


def trace_span(name: str, /, **attrs):
    """A context manager timing one named phase.  Free when no tracer
    is installed (returns the shared ``NULL_SPAN``)."""
    t = _INSTALLED
    if t is None:
        return NULL_SPAN
    return _Span(t, name, attrs)


def install_tracer(tracer: "Tracer") -> "Tracer":
    """Make ``tracer`` the process-wide span sink (replacing any
    previous one)."""
    global _INSTALLED
    _INSTALLED = tracer
    return tracer


def uninstall_tracer(tracer: "Tracer | None" = None) -> None:
    """Remove the active sink.  With ``tracer`` given, only if it IS
    the active one — lets two scopes disable independently without one
    clobbering the other's tracer."""
    global _INSTALLED
    if tracer is None or _INSTALLED is tracer:
        _INSTALLED = None


def active_tracer() -> "Tracer | None":
    return _INSTALLED


class Tracer:
    """Bounded in-memory span ring with Chrome ``trace_event`` export.

    ``capacity`` bounds memory: each completed span is one small dict;
    when the ring is full the oldest falls off.  ``seq`` increments per
    recorded span so consumers (the slow-query log) can slice "what
    happened since" without copying the ring.
    """

    def __init__(self, capacity: int = 16384):
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._t0 = clock.now()
        self.seq = 0

    def _record(self, name: str, t0: float, dur: float,
                attrs: dict) -> None:
        ev = {
            "name": name,
            "ph": "X",
            "cat": "repro",
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "ts": (t0 - self._t0) * 1e6,     # µs, Chrome's unit
            "dur": dur * 1e6,
            "args": attrs,
        }
        with self._lock:
            self.seq += 1
            ev["seq"] = self.seq
            self._events.append(ev)

    # ------------------------------------------------------------- reading

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def events_since(self, seq: int) -> list[dict]:
        """Spans recorded after sequence number ``seq`` (oldest may be
        gone if the ring wrapped)."""
        with self._lock:
            return [e for e in self._events if e["seq"] > seq]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # ------------------------------------------------------------- export

    def chrome_trace(self) -> dict:
        """The ``chrome://tracing`` / Perfetto JSON object."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.chrome_trace(), fh)
        os.replace(tmp, path)
        return path
