"""Per-phase energy ledger + the serving loop's live meter.

Subset of ``repro.telemetry.energy`` that ``ServeLoop`` needs, copied op for
op so a port run and a reference run of the same windows bill the same
Watt*seconds to float-sum noise:

  * ``EnergyLedger`` books every observation into a ``(node, tenant,
    phase)`` cell; ``rollup(by="node"|"tenant"|"phase")`` renders the same
    joules as a fleet view, an energy bill or a phase profile, and each cut
    sums to ``total_ws``;
  * ``DecodeEnergyMeter`` turns a measured window (seconds + slot
    utilization) into Watt*seconds through a DVFS envelope, appends it to
    its trace on a cumulative busy-time timeline and books it.

``per_phase`` feeds ``telemetry.report.render_ledger``.  Fleet-plane
pieces of the reference (``absorb``/``merge``, persistence, step drift,
``drain_delta``, ``WsBudget``) wait for the fleet slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.telemetry.dvfs import PowerEnvelope
from repro_torch.telemetry.trace import PowerTrace

DEFAULT_NODE = "node0"
DEFAULT_TENANT = "default"
#: billing label for energy no request caused — idle floor watts.  Booked
#: like any tenant so every rollup still sums to ``total_ws``, but kept out
#: of real tenants' bills.
INFRA_TENANT = "fleet"
#: ledger phase of a powered-but-unloaded window (the envelope floor)
IDLE_PHASE = "idle"


@dataclass
class PhaseEnergy:
    ws: float = 0.0
    seconds: float = 0.0
    count: int = 0
    peak_w: float = 0.0

    @property
    def avg_watts(self) -> float:
        return self.ws / self.seconds if self.seconds > 0 else 0.0

    def fold(self, ws: float, seconds: float, count: int = 1,
             peak_w: float = 0.0) -> None:
        self.ws += ws
        self.seconds += seconds
        self.count += count
        self.peak_w = max(self.peak_w, peak_w)


@dataclass
class EnergyLedger:
    """Aggregates Watt*seconds by (node, tenant, phase)."""
    phases: dict = field(default_factory=dict)      # name -> PhaseEnergy
    nodes: dict = field(default_factory=dict)       # node -> total ws
    cells: dict = field(default_factory=dict)       # (node,tenant,phase) ->

    def add(self, phase: str, ws: float, seconds: float,
            peak_w: float = 0.0, node: str = DEFAULT_NODE,
            tenant: str = DEFAULT_TENANT, count: int = 1) -> None:
        pe = self.phases.setdefault(phase, PhaseEnergy())
        pe.fold(ws, seconds, count=count, peak_w=peak_w)
        self.nodes[node] = self.nodes.get(node, 0.0) + ws
        cell = self.cells.setdefault((node, tenant, phase), PhaseEnergy())
        cell.fold(ws, seconds, count=count, peak_w=peak_w)

    def add_split(self, phase: str, ws: float, seconds: float,
                  tenants: list, peak_w: float = 0.0,
                  node: str = DEFAULT_NODE) -> None:
        """One metered observation whose energy splits evenly across the
        tenants that shared it.  The phase books a single observation
        (count=1); each tenant's cell books its share and counts the
        observation it participated in."""
        pe = self.phases.setdefault(phase, PhaseEnergy())
        pe.fold(ws, seconds, count=1, peak_w=peak_w)
        self.nodes[node] = self.nodes.get(node, 0.0) + ws
        n = len(tenants)
        for tenant in tenants:
            cell = self.cells.setdefault((node, tenant, phase),
                                         PhaseEnergy())
            cell.fold(ws / n, seconds / n, count=1, peak_w=peak_w)

    @property
    def total_ws(self) -> float:
        return sum(p.ws for p in self.phases.values())

    @property
    def total_seconds(self) -> float:
        return sum(p.seconds for p in self.phases.values())

    def per_phase(self) -> dict:
        return {n: {"ws": p.ws, "seconds": p.seconds, "count": p.count,
                    "avg_w": p.avg_watts, "peak_w": p.peak_w}
                for n, p in self.phases.items()}

    def rollup(self, by: str = "node") -> dict:
        """Aggregate the cells along one dimension: ``label ->
        PhaseEnergy``, summing to the ledger totals whichever dimension is
        chosen."""
        idx = {"node": 0, "tenant": 1, "phase": 2}
        if by not in idx:
            raise ValueError(f"rollup by must be node|tenant|phase, got "
                             f"{by!r}")
        out: dict = {}
        for key, cell in self.cells.items():
            pe = out.setdefault(key[idx[by]], PhaseEnergy())
            pe.fold(cell.ws, cell.seconds, count=cell.count,
                    peak_w=cell.peak_w)
        return out


@dataclass
class DecodeEnergyMeter:
    """Live per-step energy for the serving loop.

    ``observe`` converts one window's seconds + slot utilization into
    Watt*seconds via the DVFS envelope, appends a flat segment to the trace
    on a cumulative busy-time timeline (duplicate boundary samples keep
    trapezoidal integration exact), and books it into the ledger.  The
    caller divides the returned Ws across the requests that shared the
    batch; ``tenants`` books each share into its tenant cell.

    ``utilization`` replaces the schedule-derived ``util`` argument with a
    measured signal (any callable of the meter's timeline, e.g. the loop's
    ``LiveUtilization``); ``source`` overrides the envelope entirely with
    ``source.watts(t)``.
    """
    envelope: PowerEnvelope
    chips: int = 1
    source: Optional[object] = None     # PowerSource overriding the envelope
    # measured utilization signal overriding the schedule-derived util
    utilization: Optional[Callable[[float], float]] = None
    node: str = DEFAULT_NODE
    trace: PowerTrace = field(default_factory=PowerTrace)
    ledger: EnergyLedger = field(default_factory=EnergyLedger)
    _now: float = 0.0

    @property
    def now(self) -> float:
        """The meter's cumulative busy-time timeline (seconds observed so
        far) — the time base of its trace, utilization signal and
        source."""
        return self._now

    def watts_at(self, t: float, util: float = 1.0) -> float:
        if self.source is not None:
            return self.source.watts(t) * self.chips
        if self.utilization is not None:
            util = min(max(float(self.utilization(t)), 0.0), 1.0)
        return self.envelope.watts(util) * self.chips

    def observe(self, seconds: float, util: float = 1.0,
                phase: str = "decode",
                tenants: Optional[list[str]] = None,
                watts: Optional[float] = None) -> float:
        """Book one measured window.  ``watts`` overrides the derived
        draw entirely (source and utilization signal both bypassed)."""
        seconds = max(float(seconds), 0.0)
        w = max(float(watts), 0.0) if watts is not None \
            else self.watts_at(self._now + 0.5 * seconds, util)
        ws = w * seconds
        if seconds > 0:
            t1 = self._now + seconds
            self.trace.add(self._now, w)
            self.trace.add(t1, w)
            self.trace.mark_phase(phase, self._now, t1)
            self._now = t1
        if tenants:
            self.ledger.add_split(phase, ws, seconds, tenants, peak_w=w,
                                  node=self.node)
        else:
            self.ledger.add(phase, ws, seconds, peak_w=w, node=self.node)
        return ws
