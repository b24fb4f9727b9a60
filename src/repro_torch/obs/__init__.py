"""Engine-wide observability: metrics + span tracing (DESIGN.md §16).

One :class:`Observability` object bundles a
:class:`~repro_torch.obs.metrics.MetricsRegistry` and a
:class:`~repro_torch.obs.trace.SpanTracer`.  Instrumented code takes an
``obs`` handle and uses it unconditionally::

    obs.counter("engine_steps_total").inc()
    with obs.span("engine.step"):
        ...

When observability is off the handle is :data:`NOOP` — a process-global
disabled instance whose registry/tracer are shared null objects, so the
instrumented line above costs two trivial method calls and nothing else.
Hot paths that must also skip ``time.perf_counter()`` calls guard on
``obs.enabled``.
"""
from __future__ import annotations

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               NULL_METRIC, NULL_REGISTRY, log_buckets)
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, SpanTracer
from repro_torch.obs.report import TOP_LEVEL_SPANS, aggregate, coverage, \
    format_table


class Observability:
    """Metrics registry + span tracer behind one enable switch."""

    def __init__(self, enabled: bool = True, max_spans: int = 1 << 16):
        self.enabled = enabled
        if enabled:
            self.metrics = MetricsRegistry()
            self.tracer = SpanTracer(capacity=max_spans)
        else:
            self.metrics = NULL_REGISTRY
            self.tracer = NULL_TRACER

    # convenience pass-throughs so call sites read `obs.counter(...)`
    def counter(self, name: str, help: str = ""):
        return self.metrics.counter(name, help)

    def gauge(self, name: str, help: str = ""):
        return self.metrics.gauge(name, help)

    def histogram(self, name: str, help: str = "", buckets=None):
        return self.metrics.histogram(name, help, buckets=buckets)

    def span(self, name: str):
        return self.tracer.span(name)

    def snapshot(self) -> dict:
        """JSON-serializable state: all metrics + tracer occupancy."""
        return {
            "enabled": self.enabled,
            "metrics": self.metrics.snapshot(),
            "spans": {"recorded": self.tracer.total_recorded,
                      "dropped": self.tracer.dropped,
                      "capacity": self.tracer.capacity},
        }


#: process-global disabled instance — the default ``obs`` everywhere
NOOP = Observability(enabled=False)

__all__ = [
    "Observability", "NOOP",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "log_buckets",
    "NULL_METRIC", "NULL_REGISTRY",
    "SpanTracer", "NULL_TRACER", "NULL_SPAN",
    "TOP_LEVEL_SPANS", "aggregate", "coverage", "format_table",
]
