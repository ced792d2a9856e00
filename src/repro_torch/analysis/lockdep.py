"""Runtime lock-order sanitizer (the dynamic half of graphlint).

The static ``lock-discipline`` pass proves ordering over the lock
graph it can see; this module validates the orders that actually
happen at runtime.  When enabled, ``threading.Lock``/``RLock`` are
replaced with thin wrappers that record, per thread, the chain of
locks currently held and fold every observed *held → acquiring* pair
into a global order graph keyed by lock *class* (the source location
that created the lock — all locks born at one ``threading.Lock()``
call site are instances of one class, mirroring how Linux lockdep
groups locks).  The moment an acquisition would close a cycle in that
graph — thread 1 took A then B, thread 2 now holds B and asks for A —
``LockOrderError`` is raised *before* the inner acquire, so the test
fails deterministically instead of deadlocking intermittently.

Opt in per process::

    from repro_torch.analysis import lockdep
    lockdep.enable()          # patch threading.Lock / threading.RLock
    ...
    lockdep.disable()         # restore + clear the order graph

The test suite's ``pytest --lockdep`` / ``GRAPHLINT_LOCKDEP=1`` switch
(``tests/conftest.py``) enables the reference's copy of this module;
tests of this copy enable it themselves.

Notes on fidelity:

* RLock re-entry is not an edge (same-class self-acquire while the
  same instance is already held by this thread is legal re-entry).
* A non-reentrant Lock re-acquired by its holder is an immediate
  self-deadlock; reported as a one-node cycle.
* Same-class nesting of *distinct* instances (e.g. two registry
  entries created at one call site, locked pairwise) is tolerated: a
  self-edge on a class is only an error for same-instance Lock
  re-entry, since instance-level order can be consistent (by address,
  by id) even when class-level order is trivially cyclic.
* ``threading.Condition()`` with no argument builds its RLock via the
  patched factory and works unchanged: the wrapper exposes
  ``acquire/release/locked/__enter__/__exit__`` plus the
  ``_is_owned/_acquire_restore/_release_save`` trio Condition uses,
  with ``wait()``'s release-reacquire kept visible to the bookkeeping
  (held chains stay truthful across a wait).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Set, Tuple

__all__ = [
    "LockOrderError", "enable", "disable", "enabled", "reset",
    "order_graph", "TrackedLock",
]

# the *real* primitives, captured at import before any patching
_RealLock = threading.Lock
_RealRLock = threading.RLock

# site key -> ordinal, so lock-class names are stable and readable
_SiteKey = Tuple[str, int]


class LockOrderError(RuntimeError):
    """An acquisition would create a cycle in the observed lock order."""


class _State:
    """Global sanitizer state (order graph + patch bookkeeping)."""

    def __init__(self) -> None:
        # guards the order graph; a real lock, never tracked
        self.graph_lock = _RealLock()
        # class -> class edges; value maps successor -> witness string
        self.order: Dict[str, Dict[str, str]] = {}
        self.enabled = False
        self.local = threading.local()

    def held(self) -> list:
        chain = getattr(self.local, "chain", None)
        if chain is None:
            chain = self.local.chain = []
        return chain


_STATE = _State()


def _site_name(depth_hint: int = 2) -> str:
    """Lock class = the source line that constructed it."""
    import sys
    f = sys._getframe(depth_hint)
    # walk out of this module so the class names a caller line
    here = os.path.dirname(os.path.abspath(__file__))
    while f is not None and os.path.dirname(
            os.path.abspath(f.f_code.co_filename)) == here:
        f = f.f_back
    if f is None:  # pragma: no cover - interpreter-internal creation
        return "<unknown>"
    fn = os.path.relpath(f.f_code.co_filename, os.getcwd()) \
        if f.f_code.co_filename.startswith(os.getcwd()) \
        else os.path.basename(f.f_code.co_filename)
    return f"{fn}:{f.f_lineno}"


def _path_exists(order: Dict[str, Dict[str, str]],
                 src: str, dst: str) -> Optional[list]:
    """DFS: return a class path src -> ... -> dst if one exists."""
    stack = [(src, [src])]
    seen: Set[str] = set()
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in order.get(node, ()):  # noqa: PERF102 - need keys
            stack.append((nxt, path + [nxt]))
    return None


class TrackedLock:
    """Drop-in ``threading.Lock``/``RLock`` with order tracking."""

    __slots__ = ("_inner", "_reentrant", "_cls", "_owner", "_count")

    def __init__(self, reentrant: bool, cls: Optional[str] = None):
        self._inner = _RealRLock() if reentrant else _RealLock()
        self._reentrant = reentrant
        self._cls = cls if cls is not None else _site_name()
        self._owner: Optional[int] = None
        self._count = 0

    # ------------------------------------------------------------- core
    def _check_before_acquire(self, blocking: bool = True) -> None:
        st = _STATE
        if not st.enabled:
            return
        me = threading.get_ident()
        chain = st.held()
        if self._owner == me:
            if self._reentrant:
                return  # legal re-entry, no new edge
            if blocking:
                raise LockOrderError(
                    f"self-deadlock: thread re-acquiring non-"
                    f"reentrant Lock [{self._cls}] it already holds")
            return  # try-acquire just fails, it can't deadlock
        if not chain:
            return
        with st.graph_lock:
            for held in chain:
                if held is self:
                    continue
                a, b = held._cls, self._cls
                if a == b:
                    # distinct same-class instances: instance-level
                    # order may be consistent; don't edge the class
                    # onto itself (would always cycle)
                    continue
                back = _path_exists(st.order, b, a)
                if back is not None and blocking:
                    first = st.order.get(b, {}).get(
                        back[1] if len(back) > 1 else a, "?")
                    raise LockOrderError(
                        "lock-order inversion: acquiring "
                        f"[{b}] while holding [{a}], but the reverse "
                        f"order {' -> '.join(back)} was already "
                        f"observed (first at {first})")
                st.order.setdefault(a, {}).setdefault(
                    b, f"thread {me}")

    def _note_acquired(self) -> None:
        me = threading.get_ident()
        if self._owner == me:
            self._count += 1
            return
        self._owner = me
        self._count = 1
        if _STATE.enabled:
            _STATE.held().append(self)

    def _note_released(self) -> None:
        self._count -= 1
        if self._count > 0:
            return
        self._owner = None
        self._count = 0
        chain = _STATE.held()
        if self in chain:
            chain.remove(self)

    # -------------------------------------------------- Lock interface
    def acquire(self, blocking: bool = True, timeout: float = -1):
        self._check_before_acquire(blocking)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self) -> None:
        self._note_released()
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._owner is not None

    # --------------------------------- Condition(RLock) compatibility
    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self):
        """Condition.wait(): drop the lock wholesale, report depth."""
        count = self._count
        self._count = 1  # force _note_released to fully drop
        self._note_released()
        for _ in range(count):
            self._inner.release()
        return count

    def _acquire_restore(self, count: int) -> None:
        for _ in range(count):
            self._inner.acquire()
        self._note_acquired()
        self._count = count

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        kind = "RLock" if self._reentrant else "Lock"
        return f"<TrackedLock {kind} [{self._cls}] owner={self._owner}>"


def _make_lock() -> TrackedLock:
    return TrackedLock(reentrant=False)


def _make_rlock() -> TrackedLock:
    return TrackedLock(reentrant=True)


def enable() -> None:
    """Patch ``threading.Lock``/``RLock`` and start tracking."""
    if _STATE.enabled:
        return
    reset()
    threading.Lock = _make_lock  # type: ignore[misc,assignment]
    threading.RLock = _make_rlock  # type: ignore[misc,assignment]
    _STATE.enabled = True


def disable() -> None:
    """Restore the real primitives and clear the order graph."""
    threading.Lock = _RealLock  # type: ignore[misc]
    threading.RLock = _RealRLock  # type: ignore[misc]
    _STATE.enabled = False
    reset()


def enabled() -> bool:
    return _STATE.enabled


def reset() -> None:
    """Forget every observed edge (between tests)."""
    with _STATE.graph_lock:
        _STATE.order.clear()
    _STATE.local = threading.local()


def order_graph() -> Dict[str, Dict[str, str]]:
    """Snapshot of the observed order graph (class -> successors)."""
    with _STATE.graph_lock:
        return {k: dict(v) for k, v in _STATE.order.items()}
