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

The port adds a fourth, for the card (``repro_torch.obs.device``):

  * **device ranges** — named, nestable CUDA-event pairs around the
    program's own stretches of device work (``decode.step``,
    ``train.backward``, ``weights.cast``, ...), recorded into a CUDA
    graph's capture as event nodes so that every replay times them.

Everything is off by default: instrumented sites read ``obs.TRACER`` /
``obs.METRICS`` / ``obs.RANGES`` (no-op singletons) and guard on
``.enabled``, so the serving hot path pays one attribute check per edge
when tracing is off, and a graph captured with ranges off holds no event
node.  A captured graph records what its capture counted and ranged
(``recorded``) and hands it on at each replay (``replaying``).
``enable()`` swaps live instances in for the whole process; exporters
(``write_chrome_trace``, ``write_spans_jsonl``) render what they
collected, in the reference's formats.  The flight recorder
(``repro_torch.obs.flight``: head sampling, time-series snapshots and the
engine self-profiler) rides the vectorized fleet engines; call sites read
``obs.FLIGHT`` and ``set_flight`` installs a live one.
"""
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

from repro_torch.obs.attribution import (AttributionResult,  # noqa: F401
                                         SampledAttribution,
                                         attribute_joules,
                                         attribute_joules_sampled)
from repro_torch.obs.device import (DeviceRanges, NullRanges,  # noqa: F401
                                    format_table)
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
    "DeviceRanges", "NullRanges", "format_table",
    "chrome_trace_events", "read_chrome_trace", "read_spans_jsonl",
    "write_chrome_trace", "write_spans_jsonl",
    "SNAPSHOT_FIELDS", "FlightRecorder", "NullFlight", "PhaseProfiler",
    "read_flight_jsonl",
    "DEFAULT_BUCKETS", "QUANTILES", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "NullMetrics",
    "FLEET_ROW", "NullTracer", "Span", "Tracer",
    "TRACER", "METRICS", "FLIGHT", "RANGES", "set_tracer", "set_metrics",
    "set_flight", "set_ranges", "enable", "enable_ranges", "disable",
    "device_range", "Recorded", "recorded", "replaying", "to_profiler_ns",
]

#: module-level instruments every call site reads (``obs.TRACER`` /
#: ``obs.METRICS`` / ``obs.FLIGHT`` / ``obs.RANGES``); no-ops until
#: ``enable()``/``enable_ranges()``/``set_*`` swap them
TRACER = NullTracer()
METRICS = NullMetrics()
FLIGHT = NullFlight()
RANGES = NullRanges()
_NO_RANGE = nullcontext()


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


def set_ranges(ranges) -> "DeviceRanges":
    """Install a live ``DeviceRanges``; ``None`` restores the no-op."""
    global RANGES
    RANGES = ranges if ranges is not None else NullRanges()
    return RANGES


def enable_ranges(clock=None) -> "DeviceRanges":
    """Turn device ranges on process-wide: CUDA events, or with ``clock``
    that host clock's readings.  A graph records the ranges of its
    capture only if they are on while it is captured."""
    return set_ranges(DeviceRanges(clock=clock))


def device_range(name: str, on: bool = True):
    """The device range ``name`` around a ``with`` body when ranges are
    on and ``on`` holds; else a shared no-op context."""
    rg = RANGES
    return rg.range(name) if on and rg.enabled else _NO_RANGE


class Recorded(NamedTuple):
    """What a CUDA graph's capture counted and ranged: each replay adds
    ``counts`` (counter name -> increment) to ``METRICS`` and hands
    ``ranges`` (the capture's top-level device ranges) to ``RANGES``."""
    counts: dict
    ranges: list


@contextmanager
def recorded():
    """Around a CUDA graph's capture, as
    ``kernels._build.recorded_launches``: yields a ``Recorded`` that, once
    the block ends, holds the increments the capture made to ``METRICS``'
    counters (each put back afterwards: a capture runs nothing) and the
    device ranges it recorded."""
    mx = METRICS
    before = mx.counter_values()
    rec = Recorded({}, [])
    try:
        with RANGES.capturing() as ranges:
            yield rec
    finally:
        rec.ranges.extend(ranges)
        for name, v in mx.counter_values().items():
            v0 = before.get(name, 0.0)
            if v != v0:
                rec.counts[name] = v - v0
                mx.counter(name).value = v0


def replaying(rec: "Recorded") -> None:
    """Just before one replay of a graph whose capture recorded ``rec``
    is launched: add its counts and hand on its ranges."""
    mx = METRICS
    if mx.enabled:
        for name, n in rec.counts.items():
            mx.counter(name).add(n)
    if rec.ranges:
        RANGES.replaying(rec.ranges)


def to_profiler_ns(t: float) -> int:
    """``t`` on ``TRACER``'s clock as a time on ``torch.profiler``'s
    timeline (``Tracer.to_profiler_ns``)."""
    return TRACER.to_profiler_ns(t)


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
    set_ranges(None)
