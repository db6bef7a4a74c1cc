"""Metrics registry — counters, gauges, fixed-bucket histograms.

Copy of ``repro.obs.metrics`` (jax-free in the reference, copied so the
port imports nothing of ``repro``); its Prometheus text is byte for byte
the reference's for the same observations.

The histogram is the load-bearing piece: fixed log-spaced bucket bounds
(so two histograms with the same bounds *merge* exactly — associative
and commutative, the property the fleet needs to fold per-node
registries into one), with Prometheus-style linear-interpolation
quantiles (p50/p95/p99) that are monotone in ``q`` by construction.

Exports render as Prometheus text exposition (``*_bucket{le=...}`` +
``*_sum``/``*_count`` plus precomputed ``{quantile="..."}`` lines, so a
human can grep p99 without a PromQL engine) and as JSON.

Call sites go through the module-level ``repro_torch.obs.METRICS`` (a
``NullMetrics`` by default) guarded by ``.enabled``.
"""
from __future__ import annotations

from bisect import bisect_left
from pathlib import Path
from typing import Optional

import numpy as np

#: default bounds: sub-millisecond ticks up to multi-minute windows
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 120.0)

QUANTILES = (0.5, 0.95, 0.99)


def _fmt(v: float) -> str:
    return f"{float(v):.10g}"


class Counter:
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v

    def add(self, n) -> None:
        """Batched ``inc``: fold a whole window's worth of events in one
        call (``n`` may be an int, float, or numpy scalar)."""
        self.inc(float(n))

    def to_dict(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Fixed-bound histogram with mergeable counts and interpolated
    quantiles.  ``le`` is inclusive (Prometheus semantics); the last
    implicit bucket is +Inf."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets=DEFAULT_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b1 <= b0 for b0, b1 in zip(bounds, bounds[1:])):
            raise ValueError("histogram bounds must be ascending and "
                             "non-empty")
        self.name = name
        self.help = help
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last slot = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def observe_many(self, values) -> None:
        """Batched ``observe``: one call per array instead of one per
        element.  Bit-identical to the looped version — bucket counts
        come from the same ``bisect_left`` cut (vectorized via
        ``searchsorted``) and the running ``sum`` accumulates in the
        same left-to-right order, so merged histograms compare equal
        down to the float bits.  Accepts any sequence."""
        arr = np.asarray(values, dtype=float)
        if arr.size == 0:
            return
        idx = np.searchsorted(self.bounds, arr, side="left")
        for i, c in enumerate(np.bincount(idx, minlength=len(self.counts))):
            if c:
                self.counts[i] += int(c)
        s = self.sum                # sequential adds match observe() bits
        for v in arr.tolist():
            s += v
        self.sum = s
        self.count += int(arr.size)

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` in (exact: same bounds required)."""
        if other.bounds != self.bounds:
            raise ValueError(f"cannot merge histograms with different "
                             f"bounds: {self.name} vs {other.name}")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        return self

    @classmethod
    def merged(cls, a: "Histogram", b: "Histogram") -> "Histogram":
        out = cls(a.name, help=a.help, buckets=a.bounds)
        out.merge(a)
        return out.merge(b)

    def quantile(self, q: float) -> float:
        """Prometheus-style estimate: linear interpolation inside the
        bucket holding rank ``q * count``; the +Inf bucket clamps to the
        last finite bound.  Monotone in ``q``."""
        if self.count == 0:
            return 0.0
        rank = min(max(q, 0.0), 1.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c >= rank:
                if i == len(self.bounds):
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else min(0.0, self.bounds[0])
                hi = self.bounds[i]
                return lo + (hi - lo) * ((rank - cum) / c)
            cum += c
        return self.bounds[-1]

    def to_dict(self) -> dict:
        return {"kind": self.kind, "count": self.count, "sum": self.sum,
                "buckets": {_fmt(b): c
                            for b, c in zip(self.bounds, self.counts)},
                "inf": self.counts[-1],
                "quantiles": {_fmt(q): self.quantile(q)
                              for q in QUANTILES}}


class MetricsRegistry:
    """Named metrics, get-or-create; one registry per traced run."""

    enabled = True

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help=help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, not a "
                            f"{cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self._get(Histogram, name, help,
                         buckets=buckets or DEFAULT_BUCKETS)

    def counter_values(self) -> dict:
        """name -> value of every counter."""
        return {n: m.value for n, m in self._metrics.items()
                if m.kind == "counter"}

    def to_prometheus(self) -> str:
        lines = []
        for m in self._metrics.values():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if m.kind == "histogram":
                cum = 0
                for bound, c in zip(m.bounds, m.counts):
                    cum += c
                    lines.append(f'{m.name}_bucket{{le="{_fmt(bound)}"}} '
                                 f'{cum}')
                lines.append(f'{m.name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{m.name}_sum {_fmt(m.sum)}")
                lines.append(f"{m.name}_count {m.count}")
                for q in QUANTILES:
                    lines.append(f'{m.name}{{quantile="{_fmt(q)}"}} '
                                 f"{_fmt(m.quantile(q))}")
            else:
                lines.append(f"{m.name} {_fmt(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> dict:
        return {name: m.to_dict() for name, m in sorted(self._metrics.items())}

    def write_prometheus(self, path) -> str:
        Path(path).write_text(self.to_prometheus())
        return str(path)


class _NullMetric:
    def inc(self, v: float = 1.0) -> None:
        pass

    def add(self, n) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def observe_many(self, values) -> None:
        pass


_NULL_METRIC = _NullMetric()


class NullMetrics:
    """Default registry: no-op metrics (sites guard on ``.enabled``)."""

    enabled = False

    def counter(self, name: str, help: str = "") -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str, help: str = "") -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[tuple] = None) -> _NullMetric:
        return _NULL_METRIC

    def counter_values(self) -> dict:
        return {}

    def to_prometheus(self) -> str:
        return ""

    def to_json(self) -> dict:
        return {}

    def write_prometheus(self, path) -> str:
        Path(path).write_text("")
        return str(path)
