"""``repro_torch.obs`` — zero-dependency observability for the whole stack.

Three pieces, one import surface:

* ``metrics`` — thread-safe ``MetricsRegistry`` (counters, gauges,
  log-bucket histograms) with Prometheus text exposition and a JSON
  snapshot; a process-global default plus chainable per-session /
  per-component instances.
* ``trace`` — ``trace_span`` context managers into a bounded ring
  buffer with Chrome ``trace_event`` export; free when disabled.
* ``slowlog`` — threshold-triggered slow-query records with full plan
  attribution.

See README "Observability" for the metrics catalog and quickstarts.
"""
from repro_torch.obs import clock
from repro_torch.obs.metrics import (BYTE_BUCKETS, COUNT_BUCKETS,
                               LATENCY_BUCKETS, MetricsRegistry,
                               NullRegistry, default_registry, timed)
from repro_torch.obs.slowlog import SlowQueryLog
from repro_torch.obs.trace import (NULL_SPAN, Tracer, active_tracer,
                             install_tracer, trace_span,
                             uninstall_tracer)

__all__ = [
    "clock", "MetricsRegistry", "NullRegistry", "default_registry",
    "LATENCY_BUCKETS", "BYTE_BUCKETS", "COUNT_BUCKETS", "timed",
    "Tracer", "trace_span", "install_tracer", "uninstall_tracer",
    "active_tracer", "NULL_SPAN", "SlowQueryLog",
]
