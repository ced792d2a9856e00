"""Shared fault-injection layer for chaos testing — ``repro.replica.faults``
copied (it imports nothing but the standard library), so one seed gives
the same fault schedule in both packages.

The replication layer needs the whole zoo of storage/transport
failures a production system must survive: torn writes, bit flips
that slip past nothing (CRCs catch them), partial transfers, delayed
and dropped fetches, EIO on open.  This module is its injector:

* ``FaultRule`` — one scheduled fault: *where* (a named injection
  point), *when* (the nth invocation, specific invocation values,
  every-k, or a seeded probability), and *what* (a ``kind`` plus
  kind-specific parameters).
* ``FaultInjector`` — counts invocations per point, decides which rule
  (if any) fires, and applies byte-level corruptions
  deterministically (seeded RNG, so a failing chaos run replays).

Injection points are plain strings; the conventions used in this repo:

=================  ========================================================
point              fired by
=================  ========================================================
``"fetch"``        ``shipping.FaultyTransport`` on every ``fetch``
``"open"``         ``faulty_open`` wrappers around file opens
=================  ========================================================

Fault kinds and their parameters:

=============  =========================================================
kind           effect (and parameters)
=============  =========================================================
``raise``      raise ``InjectedFault`` (``exc`` overrides the class)
``eio``        raise ``OSError(EIO)``
``drop``       raise ``TransportError`` — the fetch never completes
``delay``      sleep ``delay_s`` seconds, then proceed (a transport
               honoring a caller timeout raises instead of sleeping
               past it)
``torn``       truncate the payload at ``frac`` (default 0.5) — a
               partial transfer / torn write
``bit_flip``   XOR one byte (position ``offset``, or seeded-random)
=============  =========================================================

Rules fire independently per point; one-shot rules (``nth``/``at``)
are consumed, recurring rules (``every``/``prob``) persist.  All
decisions draw from one seeded ``random.Random`` so a chaos schedule
is a pure function of (seed, invocation sequence).
"""
from __future__ import annotations

import dataclasses
import errno
import time
from random import Random
from typing import Iterable

__all__ = ["InjectedFault", "TransportError", "FaultRule", "FaultInjector"]


class InjectedFault(RuntimeError):
    """Base class for every injected failure."""


class TransportError(InjectedFault):
    """A transfer that never completed (dropped fetch, timeout)."""


@dataclasses.dataclass
class FaultRule:
    """One scheduled fault.  Triggers (combine with OR; leave all unset
    for "never"): ``nth`` — the nth invocation of the point (1-based,
    one-shot); ``at`` — fire when the invocation's ``value`` argument is
    in this set (each value one-shot); ``every`` — every k-th
    invocation; ``prob`` — independently with this probability."""

    point: str
    kind: str = "raise"
    nth: int | None = None
    at: tuple = ()
    every: int | None = None
    prob: float = 0.0
    # kind-specific parameters
    delay_s: float = 0.0
    frac: float = 0.5
    offset: int | None = None
    exc: type | None = None

    def __post_init__(self):
        self._at_pending = set(self.at)

    def matches(self, count: int, value, rng: Random) -> bool:
        if self.nth is not None and count == self.nth:
            return True
        if value is not None and value in self._at_pending:
            self._at_pending.discard(value)
            return True
        if self.every and count % self.every == 0:
            return True
        if self.prob and rng.random() < self.prob:
            return True
        return False

    @property
    def exhausted(self) -> bool:
        """One-shot rules are removed once they can never fire again."""
        recurring = bool(self.every) or self.prob > 0
        return not recurring and self.nth is None and not self._at_pending


class FaultInjector:
    """Counts invocations per injection point and fires matching rules.

    ``check(point)`` is the raise-only fast path (no payload);
    ``corrupt(point, data)`` is the byte-transforming path (transports,
    file writes) — it may also raise, sleep, or return mangled bytes
    per the fired rule.  Thread-compatible for the use here: counters
    are per-point ints under the GIL and rules fire independently.
    """

    def __init__(self, rules: Iterable[FaultRule] = (), *, seed: int = 0):
        self.rules: list[FaultRule] = list(rules)
        self.rng = Random(seed)
        self.counts: dict[str, int] = {}
        self.fired: list[tuple[str, str, int]] = []   # (point, kind, count)

    def add(self, point: str, kind: str = "raise", **kw) -> FaultRule:
        rule = FaultRule(point=point, kind=kind, **kw)
        self.rules.append(rule)
        return rule

    def clear(self, point: str | None = None) -> None:
        """Drop every rule (or every rule at one point) — chaos tests
        use this to heal a component and watch it rejoin."""
        self.rules = [r for r in self.rules
                      if point is not None and r.point != point]

    # ------------------------------------------------------------ firing

    def _fire(self, point: str, value=None) -> FaultRule | None:
        count = self.counts.get(point, 0) + 1
        self.counts[point] = count
        hit = None
        for rule in self.rules:
            if rule.point == point and rule.matches(count, value, self.rng):
                hit = rule
                break
        if hit is not None and hit.nth == count:
            hit.nth = None               # consumed
        self.rules = [r for r in self.rules if not r.exhausted]
        if hit is not None:
            self.fired.append((point, hit.kind, count))
        return hit

    def check(self, point: str, value=None) -> None:
        """Raise-only injection point: fires ``raise``/``eio``/``drop``
        rules; byte/delay kinds are ignored here."""
        rule = self._fire(point, value)
        if rule is None:
            return
        if rule.kind == "eio":
            raise OSError(errno.EIO, f"injected EIO at {point}")
        if rule.kind == "drop":
            raise TransportError(f"injected drop at {point}")
        if rule.kind == "raise":
            exc = rule.exc or InjectedFault
            raise exc(f"injected failure at {point} "
                      f"(invocation {self.counts[point]})")

    def corrupt(self, point: str, data: bytes, *,
                timeout: float | None = None) -> bytes:
        """Byte-path injection: returns ``data`` (possibly mangled) or
        raises.  ``timeout`` models a caller-side fetch deadline: a
        ``delay`` rule longer than it raises ``TransportError`` after
        sleeping only the timeout (the caller gave up)."""
        rule = self._fire(point)
        if rule is None:
            return data
        if rule.kind == "eio":
            raise OSError(errno.EIO, f"injected EIO at {point}")
        if rule.kind == "drop":
            raise TransportError(f"injected drop at {point}")
        if rule.kind == "raise":
            exc = rule.exc or InjectedFault
            raise exc(f"injected failure at {point}")
        if rule.kind == "delay":
            if timeout is not None and rule.delay_s > timeout:
                time.sleep(timeout)
                raise TransportError(
                    f"injected delay {rule.delay_s:.3f}s exceeded the "
                    f"{timeout:.3f}s fetch timeout at {point}")
            time.sleep(rule.delay_s)
            return data
        if rule.kind == "torn":
            cut = max(0, min(len(data), int(len(data) * rule.frac)))
            return data[:cut]
        if rule.kind == "bit_flip":
            if not data:
                return data
            i = (rule.offset if rule.offset is not None
                 else self.rng.randrange(len(data)))
            i = min(i, len(data) - 1)
            return data[:i] + bytes([data[i] ^ 0x40]) + data[i + 1:]
        raise ValueError(f"unknown fault kind {rule.kind!r}")
