"""Flight recorder — low-overhead observability for the big rungs.

Copy of ``repro.obs.flight``: the sampling hash picks the same rids.

The span/metric stack records one Python call per event, which the
10^7-arrival rungs cannot afford.  The flight recorder is the always-on
alternative the vectorized engines keep enabled at scale:

  * **head sampling** — a deterministic hash of the request id picks a
    representative slice (``sample_rate``) of requests that get full
    ``serve.request`` span trees at finalize, while the per-arrival
    route/submit instants are suppressed so the fused dispatch path
    stays fused.  The same rid samples the same way on every engine,
    shard count, and platform (splitmix64, no RNG state);
  * **time-series snapshots** — every ``snapshot_every`` fleet steps the
    engine records one ``{t, active_nodes, aggregate_watts,
    queue_depth, cumulative_ws, arrivals_in_window}`` row, giving the
    repo its watts-over-time curve (the shape Fig. 5 of the source
    paper plots) as a JSONL flight log;
  * **self-profiling** — ``PhaseProfiler`` buckets engine wall clock
    into dispatch / route / book / step / plan / flush counters so the
    Amdahl dispatch-floor analysis in ``docs/fleet_scale.md`` is
    measured, not asserted.

Like the tracer/metrics singletons, call sites read ``obs.FLIGHT`` (a
``NullFlight`` by default) and guard on ``.enabled``.  The module is
dependency-free at import time; numpy is only pulled in for the
vectorized sample mask.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

#: snapshot row schema (the flight-log contract trace_report renders)
SNAPSHOT_FIELDS = ("t", "active_nodes", "aggregate_watts", "queue_depth",
                   "cumulative_ws", "arrivals_in_window")

_MASK64 = (1 << 64) - 1
_SPLIT_GAMMA = 0x9E3779B97F4A7C15
_SPLIT_M1 = 0xBF58476D1CE4E5B9
_SPLIT_M2 = 0x94D049BB133111EB


def _hash64(x: int) -> int:
    """splitmix64 finalizer — a stateless, platform-stable 64-bit mix."""
    z = (x + _SPLIT_GAMMA) & _MASK64
    z = ((z ^ (z >> 30)) * _SPLIT_M1) & _MASK64
    z = ((z ^ (z >> 27)) * _SPLIT_M2) & _MASK64
    return z ^ (z >> 31)


class PhaseProfiler:
    """Per-phase wall-clock counters (seconds + call counts).

    Engines accumulate ``perf_counter`` deltas under phase names
    (``dispatch``, ``route``, ``book``, ``step``, ``plan``, ``flush``,
    plus per-shard variants like ``flush.shard3``) and export the dict
    in ``summary()["profile"]``.
    """

    __slots__ = ("seconds", "counts")

    def __init__(self):
        self.seconds: dict = {}
        self.counts: dict = {}

    def add(self, phase: str, dt: float, n: int = 1) -> None:
        self.seconds[phase] = self.seconds.get(phase, 0.0) + dt
        self.counts[phase] = self.counts.get(phase, 0) + n

    def merge(self, other: "PhaseProfiler") -> "PhaseProfiler":
        for phase, dt in other.seconds.items():
            self.add(phase, dt, other.counts.get(phase, 0))
        return self

    def to_dict(self) -> dict:
        return {"phases": {p: {"seconds": round(s, 6),
                               "count": self.counts.get(p, 0)}
                           for p, s in sorted(self.seconds.items())}}


class FlightRecorder:
    """Live flight recorder: sampling decisions + snapshot rows.

    ``sample_rate`` is the head-sampling fraction in [0, 1]; 1.0 means
    every request (and per-arrival tracing stays untouched).
    ``snapshot_every`` is a fleet-step cadence (the engines' simulated
    time unit); 0 disables snapshots.
    """

    enabled = True

    def __init__(self, sample_rate: float = 1.0, snapshot_every: int = 0,
                 log_path=None):
        rate = float(sample_rate)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0, 1], got {rate}")
        self.sample_rate = rate
        self.snapshot_every = int(snapshot_every)
        self.log_path = log_path
        #: hash threshold: rid sampled iff splitmix64(rid) < threshold
        self._threshold = (1 << 64) if rate >= 1.0 else int(rate * 2.0**64)
        self.snapshots: list = []
        self.sampled_spans = 0          # request-tree spans emitted
        #: per-request energy envelope the engine notes at finalize so
        #: the sampled scale-up can report a sound error bound offline
        self.population: Optional[dict] = None

    @property
    def sampling(self) -> bool:
        """Whether head sampling is thinning the trace (< every rid).
        The engines suppress per-arrival instants only in this mode."""
        return self.sample_rate < 1.0

    def sampled(self, rid: int) -> bool:
        return _hash64(int(rid) & _MASK64) < self._threshold

    def sample_mask(self, rids):
        """Vectorized ``sampled`` over an int array (numpy, uint64)."""
        import numpy as np
        if self._threshold > _MASK64:
            return np.ones(np.shape(rids), dtype=bool)
        z = (np.asarray(rids).astype(np.uint64)
             + np.uint64(_SPLIT_GAMMA))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(_SPLIT_M1)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(_SPLIT_M2)
        z = z ^ (z >> np.uint64(31))
        return z < np.uint64(self._threshold)

    def note_population(self, count: int, min_ws: float,
                        max_ws: float) -> None:
        self.population = {"count": int(count), "min_ws": float(min_ws),
                           "max_ws": float(max_ws)}

    def record(self, row: dict) -> None:
        self.snapshots.append(row)

    def write_jsonl(self, path=None) -> str:
        path = Path(path if path is not None else self.log_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as fh:
            for row in self.snapshots:
                fh.write(json.dumps(row, sort_keys=True) + "\n")
        return str(path)


class NullFlight:
    """Default: flight recording off (sites guard on ``.enabled``)."""

    enabled = False
    sampling = False
    sample_rate = 1.0
    snapshot_every = 0
    snapshots: tuple = ()
    sampled_spans = 0
    population = None

    def sampled(self, rid: int) -> bool:
        return True

    def sample_mask(self, rids):
        import numpy as np
        return np.ones(np.shape(rids), dtype=bool)

    def note_population(self, count, min_ws, max_ws) -> None:
        pass

    def record(self, row: dict) -> None:
        pass

    def write_jsonl(self, path=None) -> str:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("")
        return str(path)


def read_flight_jsonl(path) -> list:
    """Read a flight log back, tolerating a truncated tail: blank or
    malformed lines (a run killed mid-write) are skipped, not raised —
    the report CLI must render whatever made it to disk."""
    rows = []
    p = Path(path)
    if not p.exists():
        return rows
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(row, dict):
            rows.append(row)
    return rows
