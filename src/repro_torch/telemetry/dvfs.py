"""Power-state modeling — idle/active/boost envelopes per hardware spec.

Copy of ``repro.telemetry.dvfs``, kept op for op so Watt*second bills match
the reference to float-sum noise.

A closed-form power model treats static power as a constant; real
devices don't: an idle chip clock-gates toward a floor, a loaded chip draws
its active envelope, and a chip past the boost threshold briefly exceeds it
(DVFS).  ``PowerEnvelope`` captures those three states so a sampler can turn
a utilization signal into instantaneous watts.

The utilization signal itself comes in two flavours:

  * schedule-derived — a constant (or the serving loop's slots-occupied
    fraction), the only option when nothing real was measured;
  * measured — ``PhaseUtilization``, a piecewise-constant signal built from
    the per-stage ``(name, t0, t1, util)`` records a compiled-rung trial
    emits.  It is a plain callable of time, so it drops into
    ``ModeledSource``/``DecodeEnergyMeter`` wherever a schedule-derived
    constant used to sit.

``envelope_for`` derives the envelope from a ``HardwareSpec``'s energy
constants: the active point is the idle floor plus the dynamic power of a
roofline-balanced chip (compute at peak FLOP/s while streaming HBM at full
bandwidth).  ``node_envelope`` takes the paper's measured whole-node
points instead.  ``PowerEnvelope.source`` turns an envelope plus any
utilization signal (measured or schedule-derived) into a ``ModeledSource``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Union

if TYPE_CHECKING:      # duck-typed at runtime: keeps telemetry import-light
    from repro_torch.core.power import HardwareSpec, NodeSpec


@dataclass(frozen=True)
class PowerEnvelope:
    """Idle/active/boost operating points with linear interpolation.

    ``watts(util)`` maps utilization in [0, 1] to instantaneous draw:
    idle -> active linearly, then a boost bump above ``boost_util`` (the
    DVFS opportunistic region).  ``gated_idle`` is the clock-gated floor a
    chip falls to when utilization stays under ``gate_util`` — this is what
    makes static power state-dependent rather than constant.
    """
    name: str
    p_idle: float                  # W at rest (the old constant p_static)
    p_active: float                # W at full roofline utilization
    p_boost: float                 # W ceiling in the DVFS boost region
    boost_util: float = 0.90       # utilization where boost engages
    gate_util: float = 0.02        # below this the chip clock-gates
    gate_fraction: float = 0.75    # gated floor = gate_fraction * p_idle

    def __post_init__(self) -> None:
        if not self.p_idle <= self.p_active <= self.p_boost:
            raise ValueError(f"envelope must order idle<=active<=boost, got "
                             f"{self.p_idle}/{self.p_active}/{self.p_boost}")

    @property
    def gated_idle(self) -> float:
        return self.gate_fraction * self.p_idle

    def state(self, util: float) -> str:
        util = min(max(util, 0.0), 1.0)
        if util < self.gate_util:
            return "idle"
        return "boost" if util > self.boost_util else "active"

    def static_watts(self, util: float) -> float:
        """State-dependent replacement for the constant p_static."""
        return self.gated_idle if self.state(util) == "idle" else self.p_idle

    def watts(self, util: float) -> float:
        """Instantaneous draw at a given utilization."""
        util = min(max(util, 0.0), 1.0)
        if util < self.gate_util:
            # gated floor, ramping back to p_idle at the gate threshold
            return self.gated_idle + (self.p_idle - self.gated_idle) \
                * util / max(self.gate_util, 1e-12)
        w = self.p_idle + (self.p_active - self.p_idle) * util
        if util > self.boost_util:
            w += (self.p_boost - self.p_active) \
                * (util - self.boost_util) / (1.0 - self.boost_util)
        return w

    def source(self, utilization: Union[float, Callable[[float], float]]
               = 1.0, chips: int = 1) -> "ModeledSource":
        """A ``PowerSource`` over this envelope.  ``utilization`` is either
        the schedule-derived constant or a measured signal such as
        ``PhaseUtilization``."""
        return ModeledSource(self, utilization=utilization, chips=chips)


@dataclass(frozen=True)
class UtilizationSpan:
    """One measured stage window: utilization is clamped into [0, 1] so a
    mis-measured counter (or a >1 CPU ratio from multi-threaded lowering)
    can never drive the envelope outside its operating points."""
    name: str
    t0: float
    t1: float
    util: float

    def __post_init__(self) -> None:
        object.__setattr__(self, "util",
                           min(max(float(self.util), 0.0), 1.0))

    @property
    def seconds(self) -> float:
        return max(self.t1 - self.t0, 0.0)


class PhaseUtilization:
    """Measured per-phase utilization as a piecewise-constant signal.

    Built from the stage records a compiled-rung dry-run emits
    (``[{"name", "t0", "t1", "util"}, ...]`` or ``(name, t0, t1, util)``
    tuples).  Calling it with a time returns the utilization of the stage
    covering that instant (0.0 outside every stage — the machine is idle
    between trials), so it slots in wherever a schedule-derived constant
    used to: ``ModeledSource(env, utilization=PhaseUtilization(stages))``.
    """

    def __init__(self, stages):
        spans = []
        for s in stages:
            if isinstance(s, dict):
                spans.append(UtilizationSpan(s["name"], float(s["t0"]),
                                             float(s["t1"]),
                                             float(s.get("util", 0.0))))
            else:
                name, t0, t1, util = s
                spans.append(UtilizationSpan(name, float(t0), float(t1),
                                             float(util)))
        self.spans = sorted(spans, key=lambda s: (s.t0, s.t1))
        if not self.spans:
            raise ValueError("PhaseUtilization needs at least one stage")

    @property
    def t0(self) -> float:
        return self.spans[0].t0

    @property
    def t1(self) -> float:
        return max(s.t1 for s in self.spans)

    def __call__(self, t: float) -> float:
        for s in self.spans:
            if s.t0 <= t <= s.t1:
                return s.util
        return 0.0

    def per_phase(self) -> dict:
        """name -> measured utilization (seconds-weighted when a stage name
        repeats)."""
        acc: dict = {}
        for s in self.spans:
            u, dt = acc.get(s.name, (0.0, 0.0))
            acc[s.name] = (u + s.util * max(s.seconds, 1e-12),
                           dt + max(s.seconds, 1e-12))
        return {n: u / dt for n, (u, dt) in acc.items()}


class LiveUtilization(PhaseUtilization):
    """An append-only ``PhaseUtilization`` fed by a live loop.

    Starts empty and grows as the producer measures: ``ServeLoop`` records
    each step's *real* slot-occupancy window here (on the meter's
    cumulative timeline) right before booking the step's energy, so the
    envelope is driven by what the slots actually did rather than by a
    schedule-derived constant passed alongside the observation.  The same
    object doubles as the loop's occupancy log: ``per_phase()`` renders
    the measured utilization per phase after the run.

    Memory stays bounded for long-running loops: only the newest
    ``maxlen`` spans are kept addressable by time (the meter only ever
    probes the freshest window), while evicted spans fold into a
    per-phase ``(util x dt, dt)`` accumulator so ``per_phase()`` remains
    exact over the whole history.
    """

    def __init__(self, maxlen: int = 4096) -> None:
        self.spans: list[UtilizationSpan] = []
        self.maxlen = maxlen
        self._folded: dict = {}         # name -> (sum util*dt, sum dt)

    def record(self, name: str, t0: float, t1: float,
               util: float) -> UtilizationSpan:
        span = UtilizationSpan(name, float(t0), float(t1), float(util))
        self.spans.append(span)
        if len(self.spans) > self.maxlen:
            old = self.spans.pop(0)
            u, dt = self._folded.get(old.name, (0.0, 0.0))
            self._folded[old.name] = (u + old.util * max(old.seconds, 1e-12),
                                      dt + max(old.seconds, 1e-12))
        return span

    def __call__(self, t: float) -> float:
        # live consumers (the meter) always probe the freshest window
        for s in reversed(self.spans):
            if s.t0 <= t <= s.t1:
                return s.util
        return 0.0

    def per_phase(self) -> dict:
        acc = dict(self._folded)
        for s in self.spans:
            u, dt = acc.get(s.name, (0.0, 0.0))
            acc[s.name] = (u + s.util * max(s.seconds, 1e-12),
                           dt + max(s.seconds, 1e-12))
        return {n: u / dt for n, (u, dt) in acc.items()}


@dataclass
class ModeledSource:
    """Envelope x utilization -> instantaneous watts (per node of `chips`).

    ``utilization`` is either a schedule-derived constant in [0, 1] or a
    callable of time — e.g. a ``PhaseUtilization`` built from measured
    compiled-rung stage counters, or a phase schedule that returns compute
    utilization during the compute phase and near-idle during transfers.
    """
    envelope: PowerEnvelope
    utilization: Union[float, Callable[[float], float]] = 1.0
    chips: int = 1

    def watts(self, t: float) -> float:
        u = self.utilization(t) if callable(self.utilization) \
            else self.utilization
        return self.envelope.watts(u) * self.chips


def envelope_for(hw: HardwareSpec, boost_headroom: float = 0.12
                 ) -> PowerEnvelope:
    """Derive idle/active/boost from a chip's roofline energy constants,
    at the rates its time terms use."""
    p_dyn = hw.flops_rate * hw.e_flop + hw.bytes_rate * hw.e_hbm
    p_active = hw.p_static + p_dyn
    return PowerEnvelope(name=hw.name, p_idle=hw.p_static, p_active=p_active,
                         p_boost=p_active * (1.0 + boost_headroom))


def node_envelope(node: NodeSpec, accelerated: bool = False,
                  boost_headroom: float = 0.05) -> PowerEnvelope:
    """Whole-node envelope from the paper's measured operating points
    (R740+Arria10: 105 W idle, 121 W CPU-active, 111 W accelerator-active)."""
    p_active = node.p_accel_active if accelerated else node.p_cpu_active
    return PowerEnvelope(name=f"{node.name}:"
                         f"{'accel' if accelerated else 'cpu'}",
                         p_idle=node.p_idle, p_active=p_active,
                         p_boost=p_active * (1.0 + boost_headroom))
