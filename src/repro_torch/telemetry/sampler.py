"""IPMI-style fixed-interval power sampling over pluggable sources.

Copy of ``repro.telemetry.sampler``; the port adds one source of its own,
``telemetry.nvml.NvmlSource``, the card's measured draw.

The paper reads whole-node watts from IPMI at a fixed interval during each
verification trial.  ``PowerSampler`` is that loop; a ``PowerSource`` is
whatever answers "watts right now":

  * ``ModeledSource``   — a DVFS envelope driven by a utilization signal
                          (the container has no IPMI, so instantaneous draw
                          is derived from the same roofline counters the
                          verifier uses);
  * ``ReplaySource``    — sample-and-hold playback of a recorded trace,
                          for re-analysis of persisted JSONL logs;
  * ``ConstantSource``  — a fixed operating point (the paper's Fig. 5
                          method uses one measured wattage per run);
  * ``NvmlSource``      — (``telemetry.nvml``) the card's own energy
                          counter, the port's counterpart of IPMI.

Two sampling modes: ``run`` walks a *virtual* timeline (used when the
workload itself is modeled), ``sample_during`` polls in a background thread
while a real callable executes (used for host-measured runs like MRI-Q's
CPU baseline).
"""
from __future__ import annotations

import threading
import time
from bisect import bisect_right
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional, Protocol

from repro_torch.telemetry.dvfs import (  # noqa: F401  (re-export)
    ModeledSource, PhaseUtilization, PowerEnvelope)
from repro_torch.telemetry.trace import PowerTrace


class PowerSource(Protocol):
    def watts(self, t: float) -> float: ...


@dataclass(frozen=True)
class ConstantSource:
    w: float

    def watts(self, t: float) -> float:
        return self.w


@dataclass
class ReplaySource:
    """Sample-and-hold playback of ``(t, w)`` samples (e.g. a saved trace)."""
    samples: list = field(default_factory=list)

    def __post_init__(self) -> None:
        self.samples = sorted((float(t), float(w)) for t, w in self.samples)
        self._times = [t for t, _ in self.samples]

    @classmethod
    def from_trace(cls, trace: PowerTrace) -> "ReplaySource":
        return cls(list(trace.samples))

    @classmethod
    def from_jsonl(cls, path: str | Path) -> "ReplaySource":
        return cls.from_trace(PowerTrace.from_jsonl(path))

    def watts(self, t: float) -> float:
        if not self.samples:
            return 0.0
        i = bisect_right(self._times, t) - 1
        return self.samples[max(i, 0)][1]


@dataclass
class PowerSampler:
    """Poll a source at a fixed interval into a ``PowerTrace``."""
    source: PowerSource
    interval: float = 0.05          # the paper's IPMI poll cadence analogue
    maxlen: int = 65536

    def run(self, duration: float, t0: float = 0.0,
            trace: Optional[PowerTrace] = None) -> PowerTrace:
        """Virtual-timeline sampling: walk [t0, t0+duration] at `interval`.

        The trace's clock follows the virtual time, so ``trace.phase`` used
        by a co-simulated workload marks windows on the same timeline.
        """
        now = t0
        if trace is None:       # an empty caller trace is still a trace
            trace = PowerTrace(maxlen=self.maxlen)
        trace.clock = lambda: now
        end = t0 + duration
        while now < end:
            trace.add(now, self.source.watts(now))
            now = min(now + self.interval, end)
        trace.add(end, self.source.watts(end))
        return trace

    def sample_during(self, fn: Callable, *args, **kwargs
                      ) -> tuple[object, PowerTrace]:
        """Wall-clock sampling: poll in a daemon thread while fn runs."""
        start = time.perf_counter()
        clock = lambda: time.perf_counter() - start  # noqa: E731
        trace = PowerTrace(maxlen=self.maxlen, clock=clock)
        stop = threading.Event()

        # only the poll thread touches the trace while it is alive; the
        # main thread adds its boundary samples before start / after join
        def poll() -> None:
            while not stop.is_set():
                t = clock()
                trace.add(t, self.source.watts(t))
                stop.wait(self.interval)

        trace.add(clock(), self.source.watts(0.0))
        thread = threading.Thread(target=poll, daemon=True)
        thread.start()
        try:
            result = fn(*args, **kwargs)
        finally:
            stop.set()
            thread.join()
            t = clock()
            trace.add(t, self.source.watts(t))
        return result, trace


class TickClock:
    """Deterministic virtual timer: every call advances one fixed tick.

    Inject wherever a wall clock would jitter a measurement — e.g.
    ``ServeLoop(clock=TickClock(dt))``: the loop brackets each metered
    window with two clock calls, so every window spans exactly ``dt``
    virtual seconds regardless of host noise (benchmarks and the
    drift-injection tests both depend on that determinism).
    """

    def __init__(self, dt: float):
        self.now = 0.0
        self.dt = float(dt)

    def __call__(self) -> float:
        self.now += self.dt
        return self.now


# ---------------------------------------------------------------------------
# Synthesized traces — the analytic verifier rung has no wall clock to
# sample, so its trace is constructed from the roofline decomposition.
# ---------------------------------------------------------------------------

def synthesize_phase_trace(phases: list[tuple[str, float, float]],
                           static_watts: float,
                           samples_per_phase: int = 16,
                           t0: float = 0.0,
                           meta: Optional[dict] = None) -> PowerTrace:
    """Build a phase-marked trace from ``(name, seconds, dynamic_joules)``.

    Each phase draws ``static_watts + dynamic_joules/seconds`` flat across
    its window; duplicate boundary samples make the step change exact under
    trapezoidal integration, so ``trace.energy_ws()`` equals
    ``sum(dynamic_joules) + total_seconds * static_watts`` to float
    precision.  Zero-duration phases fold their dynamic energy into the
    longest phase (an overlapped collective still costs its ICI joules).
    """
    live = [(n, dt, dj) for n, dt, dj in phases if dt > 0.0]
    if not live:
        raise ValueError("synthesize_phase_trace needs one phase with dt>0")
    orphan = sum(dj for _, dt, dj in phases if dt <= 0.0)
    if orphan:
        i = max(range(len(live)), key=lambda j: live[j][1])
        n, dt, dj = live[i]
        live[i] = (n, dt, dj + orphan)

    total = sum(dt for _, dt, _ in live)
    trace = PowerTrace(maxlen=max((samples_per_phase + 2) * len(live) + 4,
                                  64),
                       meta=meta)
    now = t0
    for name, dt, dyn in live:
        w = static_watts + dyn / dt
        t_end = now + dt
        trace.mark_phase(name, now, t_end, depth=1)
        step = dt / samples_per_phase
        trace.add(now, w)
        for k in range(1, samples_per_phase):
            trace.add(now + k * step, w)
        trace.add(t_end, w)                 # duplicate at boundary: dt=0
        now = t_end
    trace.mark_phase("step", t0, t0 + total, depth=0)
    return trace


# ---------------------------------------------------------------------------
# Measured traces — the compiled rung has a wall clock: the dry-run
# subprocess emits per-stage timestamps + measured utilization, and the
# parent samples those through the envelope into a real trace.
# ---------------------------------------------------------------------------

def sample_stage_trace(stages, envelope: PowerEnvelope,
                       chips: int = 1, interval: float = 0.05,
                       maxlen: int = 65536,
                       meta: Optional[dict] = None,
                       stage_envelopes: Optional[dict] = None) -> PowerTrace:
    """Phase-marked trace sampled over measured wall-clock stage windows.

    ``stages`` is the compiled-rung sidecar: ``[{"name", "t0", "t1",
    "util"}, ...]`` on the trial's wall clock.  A ``PowerSampler`` walks
    each stage window at ``interval`` against the envelope driven by the
    *measured* utilization (``PhaseUtilization``), with duplicate boundary
    samples at every stage edge so the step change between stages
    integrates exactly.  Unlike ``synthesize_phase_trace`` the watts here
    are not back-solved from an energy estimate — they are the envelope
    evaluated at what the trial actually measured.

    Stages draw different hardware: lowering/compilation is CPU-bound on
    the verification host, while an execution stage would drive the
    accelerator point.  ``stage_envelopes`` maps a stage name to the
    envelope its window samples through; unmapped stages use
    ``envelope``.  The trace's ``meta["envelopes"]`` records which
    envelope each stage actually sampled.
    """
    util = PhaseUtilization(stages)
    trace = PowerTrace(maxlen=maxlen, meta=meta)
    t0 = util.t0
    sampled_envs: dict = {}
    for span in util.spans:
        if span.seconds <= 0:
            continue
        env = (stage_envelopes or {}).get(span.name, envelope)
        sampled_envs.setdefault(span.name, env.name)
        source = ModeledSource(env, utilization=util, chips=chips)
        sampler = PowerSampler(source, interval=interval, maxlen=maxlen)
        # one run() per stage: both edges get samples, so the inter-stage
        # step is exact under trapezoidal integration
        sampler.run(span.seconds, t0=span.t0, trace=trace)
        trace.mark_phase(span.name, span.t0, span.t1, depth=1)
    trace.mark_phase("trial", t0, util.t1, depth=0)
    trace.meta.setdefault("utilization", util.per_phase())
    trace.meta.setdefault("envelopes", sampled_envs)
    trace.meta.setdefault("sampled", "wall_clock_stages")
    return trace
