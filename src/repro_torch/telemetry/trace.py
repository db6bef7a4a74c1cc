"""Sampled power trace — the paper's IPMI log, as a data structure.

Copy of ``repro.telemetry.trace`` (jax-free in the reference, copied so the
port imports nothing of ``repro``).

The paper's power meter is a fixed-interval watt sampler whose output is
integrated into Watt*seconds per run (Fig. 5).  ``PowerTrace`` is that log:
a bounded ring buffer of ``(t, watts)`` samples with

  * trapezoidal Watt*second integration over any window,
  * phase markers (``with trace.phase("prefill"): ...`` or explicit
    ``mark_phase``) so energy can be attributed to program phases,
  * peak / percentile / average statistics.

``to_jsonl``/``from_jsonl`` keep the reference's line format, so a trace
written by either package reads in the other.

Samples evicted from the ring keep contributing to the *total* energy and
duration (the integral of the dropped prefix is accumulated), so a bounded
trace still reports the true Watt*seconds of an unbounded run; only
per-window queries over the evicted past return nothing.

In the port, ``DecodeEnergyMeter`` keeps one of these on its cumulative
busy-time timeline; its ``integrate()`` equals the meter ledger's total.
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, Optional


@dataclass(frozen=True)
class PhaseSpan:
    """One closed phase window.  depth 0 is outermost; nested phases carry
    increasing depth so a span tree can be reconstructed."""
    name: str
    t0: float
    t1: float
    depth: int = 0

    @property
    def seconds(self) -> float:
        return max(self.t1 - self.t0, 0.0)

    def contains(self, other: "PhaseSpan") -> bool:
        return self.t0 <= other.t0 and other.t1 <= self.t1


class PowerTrace:
    """Ring buffer of power samples with phase-attributed energy accounting."""

    def __init__(self, maxlen: int = 65536,
                 clock: Optional[Callable[[], float]] = None,
                 meta: Optional[dict] = None):
        self.maxlen = int(maxlen)
        self.samples: deque[tuple[float, float]] = deque()
        self.spans: list[PhaseSpan] = []
        self.meta: dict = dict(meta or {})
        self.clock: Callable[[], float] = clock or time.perf_counter
        self._open: list[str] = []
        # integral of samples evicted from the ring (keeps totals honest)
        self.evicted_ws = 0.0
        self.evicted_seconds = 0.0

    # -- sampling ------------------------------------------------------------

    def add(self, t: float, watts: float) -> None:
        if self.samples and t < self.samples[-1][0]:
            raise ValueError(f"non-monotonic sample t={t} after "
                             f"t={self.samples[-1][0]}")
        self.samples.append((float(t), float(watts)))
        while len(self.samples) > self.maxlen:
            t0, w0 = self.samples.popleft()
            t1, w1 = self.samples[0]
            dt = max(t1 - t0, 0.0)
            self.evicted_ws += 0.5 * (w0 + w1) * dt
            self.evicted_seconds += dt

    def __len__(self) -> int:
        return len(self.samples)

    # -- phase markers -------------------------------------------------------

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Mark a phase window using the trace's clock; phases may nest."""
        t0 = self.clock()
        depth = len(self._open)
        self._open.append(name)
        try:
            yield
        finally:
            self._open.pop()
            self.spans.append(PhaseSpan(name, t0, self.clock(), depth))

    def mark_phase(self, name: str, t0: float, t1: float,
                   depth: int = 0) -> PhaseSpan:
        """Explicit phase window for synthesized / replayed traces."""
        span = PhaseSpan(name, float(t0), float(t1), depth)
        self.spans.append(span)
        return span

    def phase_names(self) -> list[str]:
        seen: list[str] = []
        for s in self.spans:
            if s.name not in seen:
                seen.append(s.name)
        return seen

    # -- integration & stats -------------------------------------------------

    def energy_ws(self, t0: Optional[float] = None,
                  t1: Optional[float] = None) -> float:
        """Trapezoidal Watt*seconds over [t0, t1] (full trace when omitted;
        a full-trace query includes the evicted prefix)."""
        full = t0 is None and t1 is None
        if len(self.samples) < 2:
            return self.evicted_ws if full else 0.0
        lo_t = self.samples[0][0] if t0 is None else t0
        hi_t = self.samples[-1][0] if t1 is None else t1
        e = 0.0
        it = iter(self.samples)
        ta, wa = next(it)
        for tb, wb in it:
            if tb <= lo_t or ta >= hi_t:
                ta, wa = tb, wb
                continue
            lo, hi = max(ta, lo_t), min(tb, hi_t)
            if hi > lo and tb > ta:
                wlo = wa + (wb - wa) * (lo - ta) / (tb - ta)
                whi = wa + (wb - wa) * (hi - ta) / (tb - ta)
                e += 0.5 * (wlo + whi) * (hi - lo)
            ta, wa = tb, wb
        return e + (self.evicted_ws if full else 0.0)

    def integrate(self, t0: Optional[float] = None,
                  t1: Optional[float] = None) -> float:
        """Alias of ``energy_ws`` — the measurement-rung vocabulary: a
        rung's ``Measurement.energy_j`` is defined as the integral of its
        trace, so backends and their invariant tests call this by name."""
        return self.energy_ws(t0, t1)

    @property
    def duration(self) -> float:
        if not self.samples:
            return self.evicted_seconds
        return (self.samples[-1][0] - self.samples[0][0]) \
            + self.evicted_seconds

    def avg_watts(self, t0: Optional[float] = None,
                  t1: Optional[float] = None) -> float:
        if t0 is None and t1 is None:
            dt = self.duration
        else:
            lo = self.samples[0][0] if t0 is None else t0
            hi = self.samples[-1][0] if t1 is None else t1
            dt = max(hi - lo, 0.0)
        e = self.energy_ws(t0, t1)
        return e / dt if dt > 0 else 0.0

    def peak_watts(self, t0: Optional[float] = None,
                   t1: Optional[float] = None) -> float:
        ws = [w for t, w in self.samples
              if (t0 is None or t >= t0) and (t1 is None or t <= t1)]
        return max(ws) if ws else 0.0

    def percentile_watts(self, q: float) -> float:
        """q in [0, 100]; nearest-rank over the retained samples."""
        if not self.samples:
            return 0.0
        ws = sorted(w for _, w in self.samples)
        idx = min(int(round(q / 100.0 * (len(ws) - 1))), len(ws) - 1)
        return ws[max(idx, 0)]

    # -- phase-attributed energy ---------------------------------------------

    def phase_energy(self, name: str) -> float:
        return sum(self.energy_ws(s.t0, s.t1) for s in self.spans
                   if s.name == name)

    def phase_seconds(self, name: str) -> float:
        return sum(s.seconds for s in self.spans if s.name == name)

    def phase_stats(self, name: str) -> dict:
        ws = self.phase_energy(name)
        secs = self.phase_seconds(name)
        peak = max((self.peak_watts(s.t0, s.t1) for s in self.spans
                    if s.name == name), default=0.0)
        return {"name": name, "ws": ws, "seconds": secs,
                "avg_w": ws / secs if secs > 0 else 0.0, "peak_w": peak}

    # -- persistence ---------------------------------------------------------

    def to_jsonl(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            f.write(json.dumps({"kind": "meta", "maxlen": self.maxlen,
                                "evicted_ws": self.evicted_ws,
                                "evicted_seconds": self.evicted_seconds,
                                "meta": self.meta}) + "\n")
            for t, w in self.samples:
                f.write(json.dumps({"kind": "sample", "t": t, "w": w}) + "\n")
            for s in self.spans:
                f.write(json.dumps({"kind": "phase", "name": s.name,
                                    "t0": s.t0, "t1": s.t1,
                                    "depth": s.depth}) + "\n")
        return path

    @classmethod
    def from_jsonl(cls, path: str | Path) -> "PowerTrace":
        trace = cls()
        for line in Path(path).read_text().splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            kind = rec.get("kind")
            if kind == "meta":
                trace.maxlen = rec.get("maxlen", trace.maxlen)
                trace.evicted_ws = rec.get("evicted_ws", 0.0)
                trace.evicted_seconds = rec.get("evicted_seconds", 0.0)
                trace.meta = rec.get("meta", {})
            elif kind == "sample":
                trace.samples.append((rec["t"], rec["w"]))
            elif kind == "phase":
                trace.spans.append(PhaseSpan(rec["name"], rec["t0"],
                                             rec["t1"], rec.get("depth", 0)))
        return trace

    def summary(self) -> dict:
        return {"samples": len(self.samples), "seconds": self.duration,
                "ws": self.energy_ws(), "avg_w": self.avg_watts(),
                "peak_w": self.peak_watts(),
                "p95_w": self.percentile_watts(95.0),
                "phases": {n: self.phase_stats(n)
                           for n in self.phase_names()}}
