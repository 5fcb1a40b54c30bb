"""repro_torch.obs — unified telemetry across AMU → pager → engine.

Zero-dependency observability riding the one shared
:class:`~repro_torch.serve.config.VirtualClock`:

  * :class:`Tracer` — structured spans/instants/counter samples for
    every AMU transfer, pager action, page residency transition, and
    engine request lifecycle event (default-off-cheap: one branch),
  * :class:`MetricsRegistry` — counters, gauges, and log-bucketed
    :class:`Histogram` percentiles (p50/p95/p99/max); the subsystem
    ``stats`` Counters are now :class:`CounterView` windows onto it,
  * exporters — Chrome-trace/Perfetto JSON timelines
    (:func:`write_chrome_trace`) and flat metrics JSON
    (:func:`write_metrics`), the payloads behind
    ``launch/serve --trace-out/--metrics-out``.

``tools/trace_report.py`` consumes the timeline standalone: schema
validation, per-QoS queueing-delay breakdown, and an SLO attainment
report recomputed from trace events alone.
"""

from .metrics import CounterView, Histogram, MetricsRegistry
from .tracer import NULL_TRACER, Tracer
from .export import to_chrome_trace, write_chrome_trace, write_metrics

__all__ = [
    "CounterView", "Histogram", "MetricsRegistry",
    "NULL_TRACER", "Tracer",
    "to_chrome_trace", "write_chrome_trace", "write_metrics",
]
