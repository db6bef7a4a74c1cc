"""``repro_torch.obs`` — zero-dependency observability for the fleet.

Counterpart of ``repro.obs``.  Three layers over one module-level switch:

  * **spans** (``repro_torch.obs.span``) — nestable timed windows on
    per-node timelines, emitted at every lifecycle edge (admission,
    routing, queue-wait/prefill/decode, governor flush/migrate, power
    gate/wake/probation/canary);
  * **metrics** (``repro_torch.obs.metrics``) — counters, gauges and
    mergeable fixed-bucket histograms (``queue_wait_s``,
    ``decode_ws_per_token``, ...), exported as Prometheus text + JSON;
  * **joule attribution** (``repro_torch.obs.attribution``) — the join
    pass mapping ledger ``(node, tenant, phase)`` cells onto overlapping
    spans so every span carries ``attributed_ws`` and the trace sums to
    ``ledger.total_ws`` per node.

Everything is off by default: instrumented sites read ``obs.TRACER`` /
``obs.METRICS`` (no-op singletons) and guard on ``.enabled``, so the
serving hot path pays one attribute check per edge when tracing is off.
``enable()`` swaps live instances in for the whole process; exporters
(``write_chrome_trace``, ``write_spans_jsonl``) render what they
collected, in the reference's formats.  The flight recorder
(``repro_torch.obs.flight``: head sampling, time-series snapshots and the
engine self-profiler) rides the vectorized fleet engines; call sites read
``obs.FLIGHT`` and ``set_flight`` installs a live one.
"""
from repro_torch.obs.attribution import (AttributionResult,  # noqa: F401
                                         SampledAttribution,
                                         attribute_joules,
                                         attribute_joules_sampled)
from repro_torch.obs.export import (chrome_trace_events,  # noqa: F401
                                    read_chrome_trace, read_spans_jsonl,
                                    write_chrome_trace, write_spans_jsonl)
from repro_torch.obs.flight import (SNAPSHOT_FIELDS,  # noqa: F401
                                    FlightRecorder, NullFlight,
                                    PhaseProfiler, read_flight_jsonl)
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, QUANTILES, Counter,
                                     Gauge, Histogram, MetricsRegistry,
                                     NullMetrics)
from repro_torch.obs.span import FLEET_ROW, NullTracer, Span, Tracer

__all__ = [
    "AttributionResult", "SampledAttribution", "attribute_joules",
    "attribute_joules_sampled",
    "chrome_trace_events", "read_chrome_trace", "read_spans_jsonl",
    "write_chrome_trace", "write_spans_jsonl",
    "SNAPSHOT_FIELDS", "FlightRecorder", "NullFlight", "PhaseProfiler",
    "read_flight_jsonl",
    "DEFAULT_BUCKETS", "QUANTILES", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "NullMetrics",
    "FLEET_ROW", "NullTracer", "Span", "Tracer",
    "TRACER", "METRICS", "FLIGHT", "set_tracer", "set_metrics",
    "set_flight", "enable", "disable",
]

#: module-level instruments every call site reads (``obs.TRACER`` /
#: ``obs.METRICS`` / ``obs.FLIGHT``); no-ops until ``enable()``/``set_*``
#: swap them
TRACER = NullTracer()
METRICS = NullMetrics()
FLIGHT = NullFlight()


def set_tracer(tracer) -> "Tracer":
    global TRACER
    TRACER = tracer if tracer is not None else NullTracer()
    return TRACER


def set_metrics(metrics) -> "MetricsRegistry":
    global METRICS
    METRICS = metrics if metrics is not None else NullMetrics()
    return METRICS


def set_flight(flight) -> "FlightRecorder":
    """Install a live ``FlightRecorder`` (sampling + snapshots); ``None``
    restores the no-op."""
    global FLIGHT
    FLIGHT = flight if flight is not None else NullFlight()
    return FLIGHT


def enable(clock=None, maxlen: int = 200_000):
    """Turn tracing + metrics on process-wide; returns the live pair."""
    kw = {"maxlen": maxlen} if clock is None else {"clock": clock,
                                                  "maxlen": maxlen}
    return set_tracer(Tracer(**kw)), set_metrics(MetricsRegistry())


def disable() -> None:
    """Back to the no-op instruments (instrumentation cost: one attribute
    check per edge)."""
    set_tracer(None)
    set_metrics(None)
    set_flight(None)
