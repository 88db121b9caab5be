"""``repro_torch.obs`` — runtime observability: tracing and metrics.

Two dependency-free pieces threaded through the runtime layers:

* :mod:`repro_torch.obs.trace` — nestable spans and instant events on an
  injected clock, per worker/stream, exportable as Chrome trace-event
  JSON (open in Perfetto) or a plain-text timeline.  :data:`NULL_TRACER`
  makes capture zero-cost when disabled.
* :mod:`repro_torch.obs.metrics` — named counters/gauges/histograms with
  labeled children, snapshot/diff/merge, and a swappable process-global
  default registry.
"""

from .metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    set_default_registry,
    use_registry,
)
from .trace import CHROME_REQUIRED_KEYS, NULL_TRACER, NullTracer, Tracer

__all__ = [
    "CHROME_REQUIRED_KEYS", "Counter", "DEFAULT_BUCKETS", "Gauge",
    "Histogram", "MetricsRegistry", "NULL_TRACER", "NullTracer", "Tracer",
    "default_registry", "set_default_registry", "use_registry",
]
