"""Thread-safe metrics registry: counters, gauges, log-bucket histograms.

The registry is the single accounting surface for the whole stack —
engine group dispatch, reconstruction-cache traffic, segment residency,
serving watermarks, WAL fsyncs, checkpoints, replica sync, routing.
Design constraints, in order:

1. **Hot-path cheap.**  Instrumented components resolve their metric
   children ONCE (at construction) and then pay one lock acquire plus
   one add per event.  Family/label resolution (two dict lookups) is
   reserved for per-group / per-sync frequency call sites.
2. **No lost increments.**  Every child value carries its own
   ``threading.Lock``; ``inc``/``observe``/``set`` are atomic under it.
   The ingest thread, the frontend scheduler, the swap thread and a
   replica sync loop can hammer one counter concurrently and the total
   is exact (tests/test_obs.py pins this).
3. **Zero dependencies.**  Prometheus text exposition and the JSON
   snapshot are rendered by hand; nothing here imports outside the
   standard library.

Registries chain: ``MetricsRegistry(parent=...)`` propagates counter
increments and histogram observations (and gauge writes, last-writer-
wins) to the same-named child of the parent.  That is how per-instance
stats views stay exact — each ``MicroBatchFrontend`` / ``ReadReplica``
gets a private leaf registry whose children also feed the session- or
process-level aggregate, so ``replica.stats.syncs`` is *this* replica's
count while ``graphtop`` watches the fleet total.

**Reset semantics** (the overflow story): counters are monotonic for
the lifetime of their registry, nothing more.  Per-epoch engine
counters reset because every epoch swap builds a fresh engine; per-
instance views reset because each instance owns a fresh leaf registry;
the process-global default registry is monotonic until ``reset()`` —
Python integers never overflow, so the only real hazard is *unbounded
label sets*, which the instrumentation avoids by keeping label values
from small closed vocabularies (plan names, layouts, phases, record
types — never query times or node ids).
"""
from __future__ import annotations

import bisect
import json
import threading
from repro_torch.obs import clock
from repro_torch.obs.trace import trace_span

__all__ = [
    "MetricsRegistry", "NullRegistry", "default_registry",
    "LATENCY_BUCKETS", "BYTE_BUCKETS", "COUNT_BUCKETS", "timed",
]

# Fixed log-spaced bucket ladders.  Fixed (not adaptive) so histograms
# merge across registries/processes by simple bucket-wise addition.
#: seconds: 1 µs .. ~67 s in powers of two, + overflow
LATENCY_BUCKETS = tuple(1e-6 * (1 << i) for i in range(27))
#: bytes: 64 B .. 4 GB in powers of four, + overflow
BYTE_BUCKETS = tuple(64 * (4 ** i) for i in range(14))
#: dimensionless counts (batch sizes, record counts): 1 .. 64k pow2
COUNT_BUCKETS = tuple(float(1 << i) for i in range(17))


def _label_key(labels: dict) -> str:
    """Canonical flat key: 'a=x,b=y' sorted by label name ('' = bare)."""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


class _Counter:
    """Monotonic counter child.  ``value`` only ever grows (use a gauge
    for anything that can fall); ``inc`` propagates to the same-named
    parent child so leaf registries aggregate upward."""

    __slots__ = ("value", "_lock", "_parent")
    kind = "counter"

    def __init__(self, parent=None):
        self.value = 0
        self._lock = threading.Lock()
        self._parent = parent

    def inc(self, n: int | float = 1) -> None:
        with self._lock:
            self.value += n
        if self._parent is not None:
            self._parent.inc(n)


class _Gauge:
    """Point-in-time value.  ``set`` (and ``set_max``, the high-water
    helper behind ``max_batch_seen``-style stats) propagate last-writer-
    wins to the parent."""

    __slots__ = ("value", "_lock", "_parent")
    kind = "gauge"

    def __init__(self, parent=None):
        self.value = 0
        self._lock = threading.Lock()
        self._parent = parent

    def set(self, v) -> None:
        with self._lock:
            self.value = v
        if self._parent is not None:
            self._parent.set(v)

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n
            v = self.value
        if self._parent is not None:
            self._parent.set(v)

    def dec(self, n=1) -> None:
        self.inc(-n)

    def set_max(self, v) -> None:
        with self._lock:
            if v > self.value:
                self.value = v
            v = self.value
        if self._parent is not None:
            self._parent.set_max(v)


class _Histogram:
    """Fixed log-bucket histogram child: per-bucket counts (plus one
    overflow slot), running sum/count/min/max."""

    __slots__ = ("buckets", "counts", "sum", "count", "min", "max",
                 "_lock", "_parent")
    kind = "histogram"

    def __init__(self, buckets, parent=None):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()
        self._parent = parent

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
        if self._parent is not None:
            self._parent.observe(v)

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the bucket the
        q-th observation falls in) — what graphtop prints as p50/p95."""
        with self._lock:
            total, counts = self.count, list(self.counts)
        if total == 0:
            return 0.0
        rank = q * total
        acc = 0
        for i, n in enumerate(counts):
            acc += n
            if acc >= rank and n:
                return (self.buckets[i] if i < len(self.buckets)
                        else float("inf"))
        return float("inf")

    def state(self) -> dict:
        with self._lock:
            return {"count": self.count, "sum": self.sum,
                    "min": self.min if self.count else 0.0,
                    "max": self.max if self.count else 0.0,
                    "buckets": list(self.counts)}


class _NullChild:
    """Shared no-op child: every mutator is a pass.  What the overhead
    benchmark binds to measure the instrumentation floor."""

    __slots__ = ()
    kind = "null"
    value = 0
    count = 0
    sum = 0.0

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def set_max(self, v):
        pass

    def observe(self, v):
        pass

    def quantile(self, q):
        return 0.0

    def state(self):
        return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                "buckets": []}


_NULL_CHILD = _NullChild()


class _Family:
    """One named metric: kind + help + labeled children."""

    __slots__ = ("name", "kind", "help", "buckets", "_children", "_lock")

    def __init__(self, name: str, kind: str, help_: str, buckets=None):
        self.name = name
        self.kind = kind
        self.help = help_
        self.buckets = buckets
        self._children: dict[str, object] = {}
        self._lock = threading.Lock()

    def child(self, labels: dict, parent_child=None):
        key = _label_key(labels)
        with self._lock:
            c = self._children.get(key)
            if c is None:
                if self.kind == "counter":
                    c = _Counter(parent_child)
                elif self.kind == "gauge":
                    c = _Gauge(parent_child)
                else:
                    c = _Histogram(self.buckets, parent_child)
                self._children[key] = c
            return c


class MetricsRegistry:
    """Counters, gauges and histograms under one namespace.

    ``parent`` chains registries (see module docstring).  All three
    accessors are create-or-get: the first call fixes the metric's kind
    and help string, later calls with the same name return the same
    family (a kind mismatch raises — one name, one meaning).
    """

    def __init__(self, parent: "MetricsRegistry | None" = None):
        self.parent = parent
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ creation

    def _family(self, name: str, kind: str, help_: str,
                buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help_, buckets)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"not {kind}")
            return fam

    def counter(self, name: str, help: str = "", **labels) -> _Counter:
        fam = self._family(name, "counter", help)
        pc = (self.parent.counter(name, help, **labels)
              if self.parent is not None else None)
        return fam.child(labels, pc)

    def gauge(self, name: str, help: str = "", **labels) -> _Gauge:
        fam = self._family(name, "gauge", help)
        pc = (self.parent.gauge(name, help, **labels)
              if self.parent is not None else None)
        return fam.child(labels, pc)

    def histogram(self, name: str, help: str = "", *,
                  buckets=LATENCY_BUCKETS, **labels) -> _Histogram:
        fam = self._family(name, "histogram", help, tuple(buckets))
        pc = (self.parent.histogram(name, help, buckets=buckets, **labels)
              if self.parent is not None else None)
        return fam.child(labels, pc)

    # ------------------------------------------------------------- reading

    def get(self, name: str, **labels):
        """Current value of one series (counter/gauge: number;
        histogram: state dict) or None if never touched."""
        fam = self._families.get(name)
        if fam is None:
            return None
        c = fam._children.get(_label_key(labels))
        if c is None:
            return None
        return c.state() if fam.kind == "histogram" else c.value

    def snapshot(self) -> dict:
        """JSON-able dump: ``{"counters"|"gauges"|"histograms":
        {name: {label_key: value-or-state}}}`` — the payload behind
        ``GraphSession.metrics()`` and graphtop."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            with fam._lock:
                children = dict(fam._children)
            if fam.kind == "histogram":
                out["histograms"][fam.name] = {
                    k: dict(c.state(),
                            buckets=[[b, n] for b, n in
                                     zip(list(fam.buckets) + ["+Inf"],
                                         c.state()["buckets"])])
                    for k, c in children.items()}
            else:
                out[fam.kind + "s"][fam.name] = {
                    k: c.value for k, c in children.items()}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4): HELP/TYPE headers,
        cumulative ``_bucket{le=...}`` plus ``_sum``/``_count`` for
        histograms."""
        lines: list[str] = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            with fam._lock:
                children = dict(fam._children)
            if not children:
                continue
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, c in sorted(children.items()):
                pairs = ([p.split("=", 1) for p in key.split(",")]
                         if key else [])
                base = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
                if fam.kind == "histogram":
                    st = c.state()
                    acc = 0
                    for b, n in zip(list(fam.buckets) + ["+Inf"],
                                    st["buckets"]):
                        acc += n
                        le = b if b == "+Inf" else repr(float(b))
                        lbl = (base + "," if base else "") + f'le="{le}"'
                        lines.append(
                            f"{fam.name}_bucket{{{lbl}}} {acc}")
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{fam.name}_sum{suffix} {st['sum']}")
                    lines.append(f"{fam.name}_count{suffix} {st['count']}")
                else:
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{fam.name}{suffix} {c.value}")
        return "\n".join(lines) + ("\n" if lines else "")

    def dump_json(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.snapshot(), fh)
        import os
        os.replace(tmp, path)
        return path

    # ------------------------------------------------------------ lifecycle

    def reset(self) -> None:
        """Drop every family.  Held child references keep working but
        are orphaned (their writes no longer appear in snapshots) —
        intended for test isolation and tool restarts, not for live
        components."""
        with self._lock:
            self._families.clear()


class NullRegistry(MetricsRegistry):
    """A registry whose children do nothing: ``metrics off`` for the
    overhead benchmark and for callers that want the instrumented code
    paths with zero accounting cost.  Snapshots are empty."""

    def __init__(self):
        super().__init__(parent=None)

    def counter(self, name, help="", **labels):
        return _NULL_CHILD

    def gauge(self, name, help="", **labels):
        return _NULL_CHILD

    def histogram(self, name, help="", *, buckets=LATENCY_BUCKETS,
                  **labels):
        return _NULL_CHILD


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry: what every component binds to when
    no explicit registry is passed down (and what graphtop watches)."""
    return _DEFAULT


class timed:
    """Time a block into a histogram child AND (when a tracer is
    installed) emit a trace span of the same name — the standard way to
    instrument a phase so wall-clock analysis and aggregate latency
    stay in sync:

        with timed(self._m_fsync, "wal.fsync"):
            os.fsync(fd)
    """

    __slots__ = ("_hist", "_name", "_attrs", "_span", "_t0", "seconds")

    def __init__(self, hist, name: str, **attrs):
        self._hist = hist
        self._name = name
        self._attrs = attrs
        self.seconds = 0.0

    def __enter__(self):
        self._span = trace_span(self._name, **self._attrs)
        self._span.__enter__()
        self._t0 = clock.now()
        return self

    def __exit__(self, *exc):
        self.seconds = clock.now() - self._t0
        if self._hist is not None:
            self._hist.observe(self.seconds)
        return self._span.__exit__(*exc)
