"""Segmented interval delta log: O(epoch-ops) epoch swaps.

The paper keeps ONE monolithic interval delta Δ[t0, tcur]; our device
log used to mirror that, so every serving epoch swap rebuilt the whole
device log from the full host history — O(total history) host→device
conversion per swap, a scalability cliff under continuous ingest.  This
module partitions the log at materialized-anchor and epoch-swap
boundaries instead, which is exactly the paper's "materialize
intermediate snapshots + partial reconstruction" combination applied to
*storage*: DeltaGraph partitions its event lists hierarchically the
same way (Khurana & Deshpande), and AeonG splits current vs historical
storage along the identical hot/cold line.

* ``Segment`` — an immutable, sealed chunk of the host log covering a
  half-open time window (ops strictly time-disjoint from every other
  segment).  Holds compact host (numpy) arrays, per-segment op-count /
  node-count statistics (the planner's per-segment costing), and a
  lazily built pow2-capacity device ``Delta`` that can be *spilled*
  back to host-only under a residency budget and reloaded on demand.

* ``SegmentedDeltaView`` — an ordered sequence of segments behaving
  like one logical Δ[t0, tcur] for planning (``window_ops``,
  ``capacity``, ``node_ops`` — all host-side, O(log S) per window) and
  for execution (``window_delta`` materializes ONE compact device Delta
  from exactly the segments overlapping an (anchor, t) window,
  concatenating already-resident per-segment device arrays; results
  are bit-identical to the monolithic log because in-window ops keep
  their relative order and every kernel masks by time window anyway).

An epoch swap then seals + converts ONLY the open tail segment — swap
cost drops from O(total history) to O(ops since the last swap) — while
successive frozen epochs share the sealed segments' device arrays by
reference.

* ``MergedNode`` / ``build_merged_nodes`` — the hierarchical
  merged-delta tree (DeltaGraph's eventlist hierarchy): interior nodes
  at pow2 leaf spans, each holding an LWW-collapsed merge of its
  children's ops.  Collapse keeps, per key — the canonical edge slot
  for edge ops, the node id for node ops — only the FIRST and LAST op
  inside the node's span, in original log order: for any query window
  that fully covers the span, forward reconstruction is decided by the
  key's last in-window op and backward reconstruction by its first
  (``reconstruct._lww_decide``), and both survive the collapse exactly;
  every dropped interior op is superseded in both directions.  A window
  that only *partially* covers a node must not use it (a dropped
  interior op could be the window's first/last for its key), so
  ``window_delta(..., merged=True)`` substitutes tree nodes only inside
  the caller-declared fully-covered subrange and keeps boundary leaves
  as leaves — O(log S) tree nodes instead of O(S) leaf segments, and
  strictly fewer ops wherever history churns (≥ 3 ops on one key).
  Merged nodes are NOT valid for the sign-sum kernels (hybrid /
  delta-only net counting) — dropping a superseded ADD/REM pair changes
  a net — which is why the merged path is opt-in per call site.
"""
from __future__ import annotations

import itertools
import threading
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.delta import (ADD_EDGE, NOP, REM_EDGE, T_PAD, Delta,
                              empty_delta, pow2_capacity as _pow2)
from repro_torch.obs.metrics import default_registry

_UID = itertools.count(1)
_CLOCK = itertools.count(1)


def window_ops_count(times, t_lo, t_hi) -> int:
    """#ops with t in (t_lo, t_hi] — THE host-side window counting
    rule, over either a sorted host timestamp array (binary searches)
    or anything exposing ``.window_ops`` (a ``SegmentedDeltaView``).
    Shared by the engine's planner and the serving materialization
    policy so both cost windows identically."""
    window_ops = getattr(times, "window_ops", None)
    if window_ops is not None:
        return int(window_ops(t_lo, t_hi))
    i0 = np.searchsorted(times, t_lo, side="right")
    i1 = np.searchsorted(times, t_hi, side="right")
    return int(i1 - i0)


class Segment:
    """One immutable chunk of the host delta log.

    ``op/u/v/slot/t`` are compact host arrays (no padding); ``t`` is
    non-decreasing and strictly disjoint from every other segment's
    time range (the store seals by time cut, so ops with the boundary
    timestamp always land on one side).  The device ``Delta`` is built
    lazily at pow2 capacity, can be spilled (host arrays stay), and is
    rebuilt on the next access — the residency policy's unit.
    """

    __slots__ = ("uid", "sealed", "device", "op", "u", "v", "slot", "t",
                 "n_ops", "t_min", "t_max", "_delta", "_node_counts",
                 "_touch", "_spilled")

    def __init__(self, op, u, v, slot, t, *, sealed: bool = True,
                 device="cuda"):
        self.uid = next(_UID)
        self.sealed = sealed
        self.device = torch.device(device)
        self.op = np.ascontiguousarray(op, np.int32)
        self.u = np.ascontiguousarray(u, np.int32)
        self.v = np.ascontiguousarray(v, np.int32)
        self.slot = np.ascontiguousarray(slot, np.int32)
        self.t = np.ascontiguousarray(t, np.int32)
        self.n_ops = int(self.op.shape[0])
        if self.n_ops == 0:
            raise ValueError("segments hold at least one op")
        self.t_min = int(self.t[0])
        self.t_max = int(self.t[-1])
        self._delta: Delta | None = None
        self._spilled = False
        self._node_counts: np.ndarray | None = None
        # creation counts as a touch: a freshly sealed (never yet
        # queried) segment must not be the residency pass's first
        # spill victim — it is the newest, hottest data
        self._touch = next(_CLOCK)

    # ----------------------------------------------------------- serialize

    _COLS = ("op", "u", "v", "slot", "t")

    def host_columns(self) -> dict[str, np.ndarray]:
        """The compact host columns, for serialization
        (``persist.manifest.save_segment_file`` writes them as one
        (5, n) int32 block)."""
        return {c: getattr(self, c) for c in self._COLS}

    def save(self, path: str) -> int:
        """Persist this segment atomically; returns the block crc32."""
        from repro_torch.persist.manifest import save_segment_file
        return save_segment_file(path, self.host_columns())

    @classmethod
    def load(cls, path: str, *, mmap: bool = True,
             expected_crc: int | None = None,
             device="cuda") -> "Segment":
        """Rehydrate a sealed segment from disk.  With ``mmap`` (the
        default) the host columns are read-only mmap-backed views —
        construction reads only the header and boundary pages.  The
        device ``Delta`` is always an explicit copy (``delta`` pads or
        copies before ``.to(device)``), never a tensor sharing the
        mapping.  ``expected_crc`` re-checks the manifest's CRC32 stamp
        against the block content before the segment is trusted."""
        from repro_torch.persist.manifest import load_segment_file
        cols = load_segment_file(path, mmap=mmap, expected_crc=expected_crc)
        return cls(cols["op"], cols["u"], cols["v"], cols["slot"],
                   cols["t"], device=device)

    # ------------------------------------------------------------- stats

    @property
    def capacity(self) -> int:
        return _pow2(self.n_ops)

    def window_ops(self, t_lo, t_hi) -> int:
        """#ops of this segment with t in (t_lo, t_hi] (binary search —
        the per-segment temporal index)."""
        i0 = np.searchsorted(self.t, t_lo, side="right")
        i1 = np.searchsorted(self.t, t_hi, side="right")
        return int(i1 - i0)

    def ops_at_or_before(self, t) -> int:
        return int(np.searchsorted(self.t, t, side="right"))

    def node_counts(self, n_cap: int) -> np.ndarray:
        """Per-node op counts (edge ops under both endpoints, node ops
        once — the ``NodeIndex`` counting rule), the segment's
        node-centric index statistic.  Lazy, cached, host-side."""
        if self._node_counts is None or self._node_counts.shape[0] < n_cap:
            is_edge = (self.op == ADD_EDGE) | (self.op == REM_EDGE)
            c = np.bincount(np.clip(self.u, 0, n_cap - 1),
                            minlength=n_cap)
            c = c + np.bincount(np.clip(self.v[is_edge], 0, n_cap - 1),
                                minlength=n_cap)
            self._node_counts = c.astype(np.int64)
        return self._node_counts

    # --------------------------------------------------------- residency

    @property
    def is_resident(self) -> bool:
        return self._delta is not None

    def device_bytes(self) -> int:
        """Device footprint of the (resident) pow2 Delta: five i32
        columns plus the scalar."""
        return 5 * 4 * self.capacity + 4

    @property
    def delta(self) -> Delta:
        """The segment's device Delta (pow2 capacity), built on first
        access and after a spill — reload-on-demand (``.to(device)``
        of the host columns; a spill is the inverse, dropping the
        device copy).  Reads/returns a
        local so a residency pass spilling concurrently (the swap
        thread) can never make an in-flight access observe None."""
        self._touch = next(_CLOCK)
        d = self._delta
        if d is None:
            if self._spilled:
                # reload-on-demand after a residency spill (first-ever
                # build is construction cost, not residency traffic)
                reg = default_registry()
                reg.counter("segments_reloads_total",
                            "spilled segments rebuilt on access").inc()
                reg.counter("segments_reload_bytes_total",
                            "device bytes rebuilt after spills"
                            ).inc(self.device_bytes())
                self._spilled = False
            cap = self.capacity
            pad = cap - self.n_ops

            def col(x, fill):
                host = (np.concatenate([x, np.full((pad,), fill, np.int32)])
                        if pad else np.array(x))
                return torch.from_numpy(host).to(self.device)

            d = Delta(op=col(self.op, NOP), u=col(self.u, 0),
                      v=col(self.v, 0), slot=col(self.slot, 0),
                      t=col(self.t, T_PAD), n_ops=self.n_ops)
            self._delta = d
        return d

    def spill(self) -> None:
        """Drop the device arrays (host arrays remain); the next
        ``delta`` access rebuilds them."""
        if self._delta is None:
            return
        self._delta = None
        self._spilled = True
        reg = default_registry()
        reg.counter("segments_spills_total",
                    "resident segments evicted to host").inc()
        reg.counter("segments_spill_bytes_total",
                    "device bytes released by spills"
                    ).inc(self.device_bytes())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Segment(uid={self.uid}, ops={self.n_ops}, "
                f"t=({self.t_min}..{self.t_max}), "
                f"resident={self.is_resident})")


def _lww_keep(op: np.ndarray, slot: np.ndarray) -> np.ndarray:
    """Sorted indices of the ops an LWW collapse keeps: the FIRST and
    LAST op per key.  The key is the canonical edge slot for edge ops
    and the node id for node ops (the store writes ``slot = u`` for
    node ops, so ``slot`` keys both, disambiguated by the op family) —
    exactly the cell each op lands on in either layout's LWW scatter."""
    is_edge = ((op == ADD_EDGE) | (op == REM_EDGE)).astype(np.int64)
    key = slot.astype(np.int64) * 2 + is_edge
    _, first = np.unique(key, return_index=True)
    _, last = np.unique(key[::-1], return_index=True)
    last = key.shape[0] - 1 - last
    return np.union1d(first, last)


class MergedNode(Segment):
    """One interior node of the merged-delta tree: the LWW-collapsed
    merge of an aligned pow2 run of sealed leaf segments.

    Covers leaves ``[lo, lo + 2**level)`` of the sealed sequence.  Ops
    keep their original relative order, so for windows fully covering
    the node's time span the materialized delta reconstructs
    bit-identically to the leaf concatenation (the collapse only drops
    ops superseded in BOTH reconstruction directions).  Inherits the
    leaf's residency machinery — lazy device build, ``spill()``,
    ``device_bytes`` — so the ``segment_device_budget`` pass treats
    tree nodes exactly like cold leaves.
    """

    __slots__ = ("lo", "level", "span")

    def __init__(self, op, u, v, slot, t, *, lo: int, level: int,
                 device="cuda"):
        super().__init__(op, u, v, slot, t, sealed=True, device=device)
        self.lo = int(lo)
        self.level = int(level)
        self.span = 1 << self.level

    @classmethod
    def merge(cls, a: Segment, b: Segment, *, lo: int,
              level: int) -> "MergedNode":
        """Collapse the concatenation of two children (leaves or
        lower-level nodes).  First/last-per-key collapse is
        associative — a child's kept first/last ops contain the
        concatenation's — so building from already-collapsed children
        equals collapsing the raw leaf run, at O(child ops) cost
        (each op takes part in ≤ log S merges over its lifetime)."""
        cols = {f: np.concatenate([getattr(a, f), getattr(b, f)])
                for f in ("op", "u", "v", "slot", "t")}
        keep = _lww_keep(cols["op"], cols["slot"])
        return cls(cols["op"][keep], cols["u"][keep], cols["v"][keep],
                   cols["slot"][keep], cols["t"][keep], lo=lo, level=level,
                   device=a.device)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"MergedNode(uid={self.uid}, leaves=[{self.lo}, "
                f"{self.lo + self.span}), ops={self.n_ops}, "
                f"t=({self.t_min}..{self.t_max}), "
                f"resident={self.is_resident})")


def build_merged_nodes(segments, merged: dict) -> list[tuple[int, int]]:
    """Complete the merged-delta tree over a sealed segment sequence.

    ``merged`` maps ``(lo, level)`` → ``MergedNode`` covering leaves
    ``[lo, lo + 2**level)``; this fills in every aligned block the
    (append-only) sequence has completed, bottom-up so each node merges
    two already-collapsed children.  Called at ``seal_tail`` — the
    sequence only grows, so each call builds at most O(log S) new
    nodes and total build work is O(ops · log S) amortized over the
    store's lifetime.  Returns the (lo, level) pairs built."""
    n = len(segments)
    built: list[tuple[int, int]] = []
    level = 1
    while (1 << level) <= n:
        span = 1 << level
        for lo in range(0, n - span + 1, span):
            if (lo, level) in merged:
                continue
            if level == 1:
                a, b = segments[lo], segments[lo + 1]
            else:
                a = merged.get((lo, level - 1))
                b = merged.get((lo + span // 2, level - 1))
                if a is None or b is None:  # pragma: no cover
                    continue
            merged[(lo, level)] = MergedNode.merge(a, b, lo=lo,
                                                   level=level)
            built.append((lo, level))
        level += 1
    return built


class SegmentedDeltaView:
    """Δ[t0, tcur] as an ordered sequence of time-disjoint segments.

    Planning-side it quacks like the host timestamp copy the engine
    used to keep (``window_ops``, ``capacity``, ``node_ops``), but at
    O(log S + log seg) per window via per-segment statistics instead of
    one O(M) array.  Execution-side, ``window_delta`` materializes one
    compact device ``Delta`` from exactly the segments overlapping a
    query window; materializations are cached per view (successive
    serving epochs share the per-segment device arrays by reference —
    segments are immutable — while each epoch's view keeps its own
    window cache, so an in-flight swap never mutates state a frozen
    epoch is serving from).
    """

    def __init__(self, segments, *, n_cap: int = 0,
                 window_cache_cap: int = 8, merged: dict | None = None,
                 device="cuda"):
        self.segments: tuple[Segment, ...] = tuple(segments)
        self.device = torch.device(device)
        # merged-delta tree nodes, keyed (leaf index, level) — leaf
        # indices refer to positions in ``segments``.  Snapshotted at
        # construction (the store's dict keeps growing with later
        # seals; a frozen epoch's view must not see them appear).
        self.merged: dict[tuple[int, int], MergedNode] = dict(merged or {})
        self.n_cap = int(n_cap)
        self._cache: "OrderedDict" = OrderedDict()
        self._cache_cap = int(window_cache_cap)
        # full-log materializations keyed by capacity, OUTSIDE the
        # window LRU: indexed groups fetch the full delta per dispatch
        # and window churn must not evict it into an O(history)
        # re-concat (the view is immutable, so no invalidation needed)
        self._full: dict[int, Delta] = {}
        # concurrent readers (serving threads) and the residency pass
        # (swap thread) share this view's cache state
        self._lock = threading.Lock()
        self._tmin = np.asarray([s.t_min for s in self.segments], np.int64)
        self._tmax = np.asarray([s.t_max for s in self.segments], np.int64)
        self._cum = np.concatenate(
            [[0], np.cumsum([s.n_ops for s in self.segments])]).astype(
                np.int64)
        self._node_ops_sum: np.ndarray | None = None

    # ------------------------------------------------------------ planning

    @property
    def n_ops(self) -> int:
        return int(self._cum[-1])

    @property
    def capacity(self) -> int:
        """The monolithic log's device capacity, virtually: what
        ``store.delta()`` would pad to.  The planner's windowed threshold
        reads this."""
        return _pow2(self.n_ops)

    def ops_at_or_before(self, t) -> int:
        """#ops with timestamp ≤ t: two boundary binary searches (the
        segments are strictly time-disjoint and time-ordered)."""
        j = int(np.searchsorted(self._tmax, t, side="right"))
        n = int(self._cum[j])
        if j < len(self.segments) and self.segments[j].t_min <= t:
            n += self.segments[j].ops_at_or_before(t)
        return n

    def window_ops(self, t_lo, t_hi) -> int:
        """#ops with t in (t_lo, t_hi] — the temporal-index count the
        AnchorSelector/Planner charge reconstruction with."""
        return self.ops_at_or_before(t_hi) - self.ops_at_or_before(t_lo)

    def node_ops(self, v) -> int | None:
        """#ops touching node v — the per-segment node-count
        statistics summed once over the (immutable) view and cached,
        so the planner's per-query lookups are O(1) regardless of
        segment count (the segmented stand-in for the node-centric
        index's row extents)."""
        if not self.n_cap or v is None or not (0 <= int(v) < self.n_cap):
            return None
        c = self._node_ops_sum
        if c is None:
            with self._lock:
                c = self._node_ops_sum
                if c is None:
                    c = np.zeros((self.n_cap,), np.int64)
                    for s in self.segments:
                        c = c + s.node_counts(self.n_cap)
                    self._node_ops_sum = c
        return int(c[int(v)])

    def window_range(self, t_lo, t_hi=None) -> tuple[int, int]:
        """[i0, i1) segment-index range overlapping (t_lo, t_hi]
        (``t_hi=None`` → through the end of the log)."""
        i0 = int(np.searchsorted(self._tmax, t_lo, side="right"))
        i1 = (len(self.segments) if t_hi is None
              else int(np.searchsorted(self._tmin, t_hi, side="right")))
        return i0, max(i0, i1)

    # ----------------------------------------------------------- execution

    def _tree_cover(self, i0: int, i1: int, safe_lo, safe_hi):
        """Cover the leaf run [i0, i1) with the largest merged nodes
        whose time span lies fully inside (safe_lo, safe_hi]; leaves
        elsewhere.  Greedy left-to-right over aligned pow2 blocks —
        the canonical segment-tree decomposition, O(log S) items for a
        fully-safe run."""
        out: list[Segment] = []
        i = i0
        while i < i1:
            best: MergedNode | None = None
            level = 1
            while True:
                span = 1 << level
                if i % span or i + span > i1:
                    break
                node = self.merged.get((i, level))
                # a node's t_min is its first leaf's (shared by every
                # level at this position) and t_max grows with level,
                # so the first span/time violation is final
                if node is None or not (safe_lo < node.t_min
                                        and node.t_max <= safe_hi):
                    break
                best = node
                level += 1
            if best is not None:
                out.append(best)
                i += best.span
            else:
                out.append(self.segments[i])
                i += 1
        return tuple(out)

    def window_cover(self, t_lo, t_hi=None, *, merged: bool = False,
                     merged_lo=None, merged_hi=None):
        """The segment/node selection ``window_delta`` materializes for
        (t_lo, t_hi] — exposed so benches/tests can count the ops a
        covering actually scatters.  ``merged=True`` substitutes tree
        nodes for leaf runs whose time span is fully inside
        (``merged_lo``, ``merged_hi``] (defaulting to the window
        itself); see the module docstring for why partial coverage
        must keep leaves."""
        i0, i1 = self.window_range(t_lo, t_hi)
        if not merged or not self.merged or i1 - i0 < 2:
            return self.segments[i0:i1]
        s_lo = t_lo if merged_lo is None else merged_lo
        if merged_hi is not None:
            s_hi = merged_hi
        elif t_hi is not None:
            s_hi = t_hi
        else:
            s_hi = self._tmax[-1] if len(self.segments) else t_lo
        return self._tree_cover(i0, i1, int(s_lo), int(s_hi))

    def _materialize(self, sel: tuple[Segment, ...], cap: int) -> Delta:
        n = sum(s.n_ops for s in sel)
        if not sel:
            return empty_delta(cap, self.device)
        if len(sel) == 1 and cap == sel[0].capacity:
            return sel[0].delta
        pad = cap - n

        def cat(field, fill):
            parts = [getattr(s.delta, field)[:s.n_ops] for s in sel]
            if pad:
                parts.append(torch.full((pad,), fill, dtype=torch.int32,
                                        device=self.device))
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        return Delta(op=cat("op", NOP), u=cat("u", 0), v=cat("v", 0),
                     slot=cat("slot", 0), t=cat("t", T_PAD),
                     n_ops=n)

    def _cached(self, sel: tuple[Segment, ...], cap: int) -> Delta:
        # serving through a cached window still counts as touching its
        # segments — otherwise the residency LRU would spill the very
        # segments every request reads (and purge their hot window)
        for s in sel:
            s._touch = next(_CLOCK)
        # (min uid, max uid) brackets every selected item — merged
        # nodes carry later uids than their leaves, so the bracket is
        # what _purge_windows_of tests; the full uid tuple keeps
        # distinct coverings of the same range distinct
        key = ((min(s.uid for s in sel), max(s.uid for s in sel),
                tuple(s.uid for s in sel), cap) if sel
               else ("empty", cap))
        with self._lock:
            d = self._cache.get(key)
            if d is not None:
                self._cache.move_to_end(key)
                return d
        d = self._materialize(sel, cap)
        with self._lock:
            self._cache[key] = d
            while len(self._cache) > self._cache_cap:
                self._cache.popitem(last=False)
        return d

    def window_delta(self, t_lo, t_hi=None, *, pad_min: int = 64,
                     merged: bool = False, merged_lo=None,
                     merged_hi=None) -> Delta:
        """ONE compact device Delta holding every op with t in
        (t_lo, t_hi] — possibly more (whole overlapping segments are
        taken), never fewer.  Kernels mask by time window, and relative
        op order is preserved, so reconstruction/measure results are
        bit-identical to running against the monolithic log.  Capacity is
        a power of two (floor ``pad_min``).

        ``merged=True`` opts in to the merged-delta tree: leaf runs
        whose time span lies fully inside (``merged_lo``,
        ``merged_hi``] — defaulting to the window itself — are served
        by O(log S) collapsed interior nodes instead of O(S) leaves.
        ONLY safe for LWW reconstruction consumers whose time masks
        fully cover that subrange (the collapse drops interior ops, so
        sign-sum consumers and partially-covering masks must stay on
        the leaf path)."""
        sel = self.window_cover(t_lo, t_hi, merged=merged,
                                merged_lo=merged_lo, merged_hi=merged_hi)
        cap = _pow2(sum(s.n_ops for s in sel), pad_min)
        return self._cached(sel, cap)

    def full_delta(self, capacity: int | None = None) -> Delta:
        """The whole log as one device Delta — the monolithic
        compatibility view (node-index consumers, ``store.delta()``).
        Op positions match the monolithic log exactly.  Cached per
        capacity for the view's lifetime (never evicted by window
        churn; callers opting into the full log opt into its
        residency)."""
        cap = max(1, capacity if capacity is not None else self.capacity)
        if cap < self.n_ops:
            raise ValueError(f"capacity {cap} < n_ops {self.n_ops}")
        with self._lock:
            d = self._full.get(cap)
        if d is None:
            d = self._materialize(self.segments, cap)
            with self._lock:
                self._full[cap] = d
        return d

    # ----------------------------------------------------------- residency

    def device_bytes(self) -> int:
        return sum(s.device_bytes()
                   for s in (*self.segments, *self.merged.values())
                   if s.is_resident)

    def _purge_windows_of(self, uids: set) -> None:
        """Drop cached window materializations that contain any of the
        given segments/nodes — a spill must release EVERY device
        reference to the spilled arrays, or the residency budget is
        fiction.  A key's (min, max) uid pair brackets everything its
        window concatenated; purging on the bracket is conservative
        (a tree-covered window may be dropped for a leaf it serves
        through a merged node) but never leaks a reference."""
        with self._lock:
            for key in list(self._cache):
                if key[0] == "empty":
                    continue
                u0, u1 = key[0], key[1]
                if any(u0 <= u <= u1 for u in uids):
                    del self._cache[key]

    def ensure_device(self, budget: int | None = None, *,
                      hot: int = 2) -> int:
        """Epoch-swap residency pass: convert the ``hot`` newest
        segments — the freshly sealed epoch plus, when future-dated
        ops left one, the volatile tail snapshot (O(epoch ops) either
        way) — leave older segments in whatever residency state
        queries drove them to, and spill the least-recently-touched
        resident segments down to the byte ``budget`` (None =
        unlimited).  Returns resident bytes (cached multi-segment
        window concatenations of still-resident segments are derived
        copies on top of this, bounded by the window-cache entry
        cap)."""
        for s in self.segments[-hot:]:
            s.delta  # noqa: B018 — property access builds the device log
        if budget is not None:
            keep = set(s.uid for s in self.segments[-hot:])
            # merged tree nodes are residency citizens like cold
            # leaves: they build device arrays lazily on first cover
            # use, count against the budget, and spill by LRU touch
            resident = sorted(
                (s for s in (*self.segments, *self.merged.values())
                 if s.is_resident),
                key=lambda s: s._touch)
            total = sum(s.device_bytes() for s in resident)
            spilled = set()
            for s in resident:
                if total <= budget:
                    break
                if s.uid in keep:
                    continue
                s.spill()
                spilled.add(s.uid)
                total -= s.device_bytes()
            if spilled:
                self._purge_windows_of(spilled)
        resident_bytes = self.device_bytes()
        default_registry().gauge(
            "segments_resident_bytes",
            "device bytes held by resident segments").set(resident_bytes)
        return resident_bytes
