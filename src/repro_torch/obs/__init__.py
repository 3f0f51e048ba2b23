"""Fleet telemetry subsystem: metrics registry, request tracing, exporters.

See DESIGN.md §9.  The disabled defaults (:data:`NULL`,
:data:`NULL_TRACER`) make instrumentation zero-cost and keep stream
digests byte-identical telemetry on vs off.
"""

from repro_torch.obs.metric import (Counter, Gauge, Histogram, MetricsRegistry,
                              NullRegistry, NULL)
from repro_torch.obs.trace import NullTracer, Tracer, NULL_TRACER, TERMINAL
from repro_torch.obs.export import dump_all, parse_prometheus, to_prometheus

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "NULL", "Tracer", "NullTracer", "NULL_TRACER", "TERMINAL",
    "dump_all", "parse_prometheus", "to_prometheus",
]
