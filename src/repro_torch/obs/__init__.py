"""``repro_torch.obs`` — runtime observability: tracing, metrics, overlap
analysis and trace validation.

Four dependency-free pieces threaded through the runtime layers:

* :mod:`repro_torch.obs.trace` — nestable spans and instant events on an
  injected clock, per worker/stream, exportable as Chrome trace-event
  JSON (open in Perfetto) or a plain-text timeline.  :data:`NULL_TRACER`
  makes capture zero-cost when disabled.
* :mod:`repro_torch.obs.metrics` — named counters/gauges/histograms with
  labeled children, snapshot/diff/merge, and a swappable process-global
  default registry.
* :mod:`repro_torch.obs.overlap` — derives the paper's compute/transfer
  overlap efficiency figure from a trace instead of hand-maintaining it.
* :mod:`repro_torch.obs.validate` — checks an exported trace against the
  subset of the Chrome trace-event schema that Perfetto requires.
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
from .overlap import DeviceOverlap, OverlapReport, analyze
from .trace import CHROME_REQUIRED_KEYS, NULL_TRACER, NullTracer, Tracer
from .validate import validate_chrome_trace

__all__ = [
    "CHROME_REQUIRED_KEYS", "Counter", "DEFAULT_BUCKETS", "DeviceOverlap",
    "Gauge", "Histogram", "MetricsRegistry", "NULL_TRACER", "NullTracer",
    "OverlapReport", "Tracer", "analyze", "default_registry",
    "set_default_registry", "use_registry", "validate_chrome_trace",
]
