"""``repro_torch.obs`` — spans and metrics behind one module-level switch.

Counterpart of ``repro.obs`` (spans + metrics; joule attribution, exporters
and the flight recorder wait for the observability slice).  Instrumented
sites read ``obs.TRACER`` / ``obs.METRICS`` (no-op singletons) and guard on
``.enabled``, so the serving hot path pays one attribute check per edge
when tracing is off.  ``enable()`` swaps live instances in for the whole
process.
"""
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, QUANTILES, Counter,
                                     Gauge, Histogram, MetricsRegistry,
                                     NullMetrics)
from repro_torch.obs.span import FLEET_ROW, NullTracer, Span, Tracer

__all__ = [
    "DEFAULT_BUCKETS", "QUANTILES", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "NullMetrics",
    "FLEET_ROW", "NullTracer", "Span", "Tracer",
    "TRACER", "METRICS", "set_tracer", "set_metrics", "enable", "disable",
]

#: module-level instruments every call site reads (``obs.TRACER`` /
#: ``obs.METRICS``); no-ops until ``enable()``/``set_*`` swap them
TRACER = NullTracer()
METRICS = NullMetrics()


def set_tracer(tracer) -> "Tracer":
    global TRACER
    TRACER = tracer if tracer is not None else NullTracer()
    return TRACER


def set_metrics(metrics) -> "MetricsRegistry":
    global METRICS
    METRICS = metrics if metrics is not None else NullMetrics()
    return METRICS


def enable(clock=None, maxlen: int = 200_000):
    """Turn tracing + metrics on process-wide; returns the live pair."""
    kw = {"maxlen": maxlen} if clock is None else {"clock": clock,
                                                  "maxlen": maxlen}
    return set_tracer(Tracer(**kw)), set_metrics(MetricsRegistry())


def disable() -> None:
    """Back to the no-op instruments."""
    set_tracer(None)
    set_metrics(None)
