"""Per-phase energy ledger — Watt*seconds aggregated across traces/nodes.

Copy of ``repro.telemetry.energy``, op for op, so a port run and a
reference run of the same windows bill the same Watt*seconds to float-sum
noise, and a ledger persisted by either package reads in the other
(``to_json`` writes the reference's format).

The paper's bottom line is an energy number per run; at fleet scale that
number must aggregate across cards, nodes, tenants and program phases
while staying comparable between plans.  ``EnergyLedger`` is that
accumulator:

  * ``add`` / ``absorb`` fold phase-attributed Watt*seconds in (a trace's
    spans map 1:1 onto ledger phases; ``scale`` multiplies per-chip traces
    up to slice totals),
  * every booking lands in a ``(node, tenant, phase)`` cell, so
    ``rollup(by="node"|"tenant"|"phase")`` renders the same joules as a
    fleet view, an energy bill, or a phase profile — and the three rollups
    all sum to ``total_ws``,
  * ``merge`` folds another ledger in (per-node ledgers roll up into one
    fleet ledger), and ``to_json``/``from_json`` persist the cells so an
    offline reporter can re-render them,
  * per-step recording with a rolling window supports the Step-7 monitor:
    ``drift_ratio`` compares the latest step's energy against the rolling
    median, which is what triggers an in-operation re-search (energy drift
    catches a throttled or failing card even when step *time* still
    looks healthy).

``drain_delta`` is the flush primitive the governor and the fleet
scheduler share; ``WsBudget`` is a tenant's Watt*second allowance read
off the same ledger.  ``DecodeEnergyMeter`` is the serving-side client:
it turns measured step durations + slot utilization into a live trace and
per-request energy attribution.  Give it a ``source`` to drive watts from
a replayed or measured ``PowerSource`` instead of the DVFS envelope — that
is how a recorded brown-out (or an injected drift tail) flows through the
serving loop into the governor.
"""
from __future__ import annotations

import json
import statistics
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from repro_torch.telemetry.dvfs import PowerEnvelope
from repro_torch.telemetry.trace import PowerTrace

DEFAULT_NODE = "node0"
DEFAULT_TENANT = "default"
#: billing label for energy no request caused — idle floor watts, power
#: state transitions (boot/warmup).  Booked like any tenant so every
#: rollup still sums to ``total_ws``, but kept out of real tenants' bills.
INFRA_TENANT = "fleet"
#: ledger phases the fleet power planner books (``repro_torch.fleet.power``):
#: a powered-but-unloaded window draws the envelope floor (``idle``), a
#: gate/wake transition draws its modeled boot energy (``transition``).
IDLE_PHASE = "idle"
TRANSITION_PHASE = "transition"


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

    def to_dict(self) -> dict:
        return {"ws": self.ws, "seconds": self.seconds, "count": self.count,
                "avg_w": self.avg_watts, "peak_w": self.peak_w}


@dataclass
class EnergyLedger:
    """Aggregates Watt*seconds by (node, tenant, phase) + rolling drift."""
    window: int = 16
    phases: dict = field(default_factory=dict)      # name -> PhaseEnergy
    nodes: dict = field(default_factory=dict)       # node -> total ws
    cells: dict = field(default_factory=dict)       # (node,tenant,phase) ->
    steps: list = field(default_factory=list)       # rolling (seconds, ws)

    # -- aggregation ---------------------------------------------------------

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

    def absorb(self, trace: PowerTrace, scale: float = 1.0,
               node: str = DEFAULT_NODE,
               tenant: str = DEFAULT_TENANT) -> None:
        """Fold a trace's phases in; ``scale`` lifts per-chip traces to
        slice totals (ws and peak both scale with chips).  Only *leaf*
        spans are booked — umbrella spans (e.g. the synthesized traces'
        whole-run "step") contain the leaves and would double-count the
        same joules."""
        spans = trace.spans

        def covered(s):
            for o in spans:
                if o is s or not s.contains(o):
                    continue
                if not o.contains(s):          # s strictly contains o
                    return True
                if o.depth > s.depth:          # same window, deeper marker
                    return True
            return False

        leaves = [s for s in spans if not covered(s)]
        for s in leaves:
            ws = trace.energy_ws(s.t0, s.t1) * scale
            self.add(s.name, ws, s.seconds,
                     peak_w=trace.peak_watts(s.t0, s.t1) * scale,
                     node=node, tenant=tenant)

    def merge(self, other: "EnergyLedger") -> None:
        """Fold another ledger's cells in (fleet rollup across pods).

        Step windows are *not* merged — drift is a per-monitor signal, not
        an additive one."""
        for (node, tenant, phase), cell in other.cells.items():
            pe = self.phases.setdefault(phase, PhaseEnergy())
            pe.fold(cell.ws, cell.seconds, count=cell.count,
                    peak_w=cell.peak_w)
            self.nodes[node] = self.nodes.get(node, 0.0) + cell.ws
            mine = self.cells.setdefault((node, tenant, phase),
                                         PhaseEnergy())
            mine.fold(cell.ws, cell.seconds, count=cell.count,
                      peak_w=cell.peak_w)

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

    # -- rollups (node / tenant / phase views of the same joules) ------------

    def rollup(self, by: str = "node") -> dict:
        """Aggregate the cells along one dimension.

        Returns ``label -> PhaseEnergy``; whichever dimension is chosen,
        ws and seconds sum to the ledger totals (same joules, different
        cut).  ``count`` sums cell bookings, which can exceed the phase
        observation count when observations were split across tenants."""
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

    def tenants(self) -> list[str]:
        seen: list[str] = []
        for _, tenant, _ in self.cells:
            if tenant not in seen:
                seen.append(tenant)
        return seen

    # -- persistence (jax-free: the offline reporter re-renders these) -------

    def to_json(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        recs = [{"node": n, "tenant": t, "phase": p, "ws": c.ws,
                 "seconds": c.seconds, "count": c.count, "peak_w": c.peak_w}
                for (n, t, p), c in sorted(self.cells.items())]
        path.write_text(json.dumps({"window": self.window, "cells": recs},
                                   indent=2) + "\n")
        return path

    @classmethod
    def from_json(cls, path: str | Path) -> "EnergyLedger":
        doc = json.loads(Path(path).read_text())
        led = cls(window=doc.get("window", 16))
        for r in doc.get("cells", []):
            pe = PhaseEnergy(ws=r["ws"], seconds=r["seconds"],
                             count=r.get("count", 1),
                             peak_w=r.get("peak_w", 0.0))
            led.cells[(r["node"], r["tenant"], r["phase"])] = pe
            lp = led.phases.setdefault(r["phase"], PhaseEnergy())
            lp.fold(pe.ws, pe.seconds, count=pe.count, peak_w=pe.peak_w)
            led.nodes[r["node"]] = led.nodes.get(r["node"], 0.0) + pe.ws
        return led

    # -- step drift (Step-7 in-operation monitor) ----------------------------

    def record_step(self, seconds: float, ws: float) -> None:
        self.steps.append((float(seconds), float(ws)))
        if len(self.steps) > self.window:
            self.steps.pop(0)

    def median_step_ws(self) -> Optional[float]:
        return statistics.median(ws for _, ws in self.steps) \
            if self.steps else None

    def median_step_seconds(self) -> Optional[float]:
        return statistics.median(s for s, _ in self.steps) \
            if self.steps else None

    def drift_ratio(self, ws: float) -> Optional[float]:
        """Latest step energy vs the rolling median (None until warm)."""
        med = self.median_step_ws()
        if med is None or med <= 0:
            return None
        return ws / med

    def reset_steps(self) -> None:
        self.steps.clear()

    def summary(self) -> str:
        parts = [f"{n}={p.ws:.1f}Ws/{p.seconds:.3f}s"
                 for n, p in sorted(self.phases.items())]
        return f"total={self.total_ws:.1f}Ws [" + " ".join(parts) + "]"


def drain_delta(src: EnergyLedger, into: EnergyLedger, snapshot: dict,
                node: str, phases: tuple = ()) -> tuple[float, float]:
    """Book the per-cell delta of ``src`` since ``snapshot`` into ``into``.

    This is the one flush primitive every fleet-plane consumer shares: the
    per-node ``PowerGovernor`` and the ``FleetScheduler`` both periodically
    drain a meter's ledger into their own, and both need the same
    guarantees — deltas only (re-flushing without new energy books
    nothing), tenant/phase cells carried through unchanged, and the node
    dimension re-labelled to ``node``.  ``snapshot`` maps cell keys to the
    ``(ws, seconds, count)`` high-water marks of the previous drain and is
    updated in place.

    Returns the drained window's ``(ws, seconds)`` summed over ``phases``
    (every phase when the tuple is empty) — the drift-monitor signal.
    """
    window_ws = window_s = 0.0
    for key, cell in src.cells.items():
        ws0, s0, c0 = snapshot.get(key, (0.0, 0.0, 0))
        d_ws, d_s, d_c = cell.ws - ws0, cell.seconds - s0, cell.count - c0
        if d_c <= 0 and d_ws == 0.0:
            continue
        _, tenant, phase = key
        into.add(phase, d_ws, d_s, peak_w=cell.peak_w, node=node,
                 tenant=tenant, count=max(d_c, 1))
        snapshot[key] = (cell.ws, cell.seconds, cell.count)
        if not phases or phase in phases:
            window_ws += d_ws
            window_s += d_s
    return window_ws, window_s


@dataclass
class WsBudget:
    """Per-tenant Watt*second allowance over a rolling step window.

    The admission side of the fleet plane: a tenant may book at most
    ``budget_ws`` into the ledger per ``window_steps`` scheduler steps
    (``0`` makes it one whole-run budget).  Spend is read straight off the
    ledger's tenant rollup — whatever books energy (live meters, merged
    per-node ledgers, replays) is what bills — so admission control and
    the energy bill can never disagree.

    ``roll`` advances the window; once a window closes, its spend is
    forgiven and the tenant is admitted again — exhaustion inside a window
    is *throttling*, not a permanent ban.
    """
    budget_ws: float
    window_steps: int = 0
    _window_start: int = 0
    _baseline_ws: float = 0.0

    @staticmethod
    def tenant_ws(ledger: EnergyLedger, tenant: str) -> float:
        pe = ledger.rollup("tenant").get(tenant)
        return pe.ws if pe is not None else 0.0

    def roll(self, step: int, ledger: EnergyLedger, tenant: str) -> None:
        """Advance the window when ``step`` crossed its boundary."""
        if self.window_steps <= 0 or step - self._window_start \
                < self.window_steps:
            return
        n = (step - self._window_start) // self.window_steps
        self._window_start += n * self.window_steps
        self._baseline_ws = self.tenant_ws(ledger, tenant)

    def spent_ws(self, ledger: EnergyLedger, tenant: str) -> float:
        return self.tenant_ws(ledger, tenant) - self._baseline_ws

    def remaining_ws(self, ledger: EnergyLedger, tenant: str) -> float:
        return self.budget_ws - self.spent_ws(ledger, tenant)

    def exhausted(self, ledger: EnergyLedger, tenant: str) -> bool:
        return self.remaining_ws(ledger, tenant) <= 0.0


@dataclass
class DecodeEnergyMeter:
    """Live per-step decode energy for the serving loop.

    ``observe`` converts one decode step's wall seconds + slot utilization
    into Watt*seconds via the DVFS envelope, appends a flat segment to the
    trace on a cumulative decode timeline (duplicate boundary samples keep
    trapezoidal integration exact), and books it into the ledger.  The
    caller divides the returned Ws across the requests that shared the
    batch; pass ``tenants`` (one label per participating request) to book
    each request's share into its tenant cell.

    ``utilization`` replaces the schedule-derived ``util`` argument with a
    *measured* signal (any callable of the meter's cumulative timeline,
    e.g. the serving loop's ``LiveUtilization``): when set, ``watts_at``
    evaluates the envelope at what was measured, not at what the slot
    schedule implies.  ``source`` overrides the envelope entirely:
    instantaneous watts come from ``source.watts(t)`` on the meter's
    cumulative timeline.  A ``ReplaySource`` there replays a recorded node
    trace through the serving loop — including any drift tail the
    recording (or a test) carries.
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

    def predict_watts(self, util: float, dt_ahead: float = 0.0) -> float:
        """What-if draw a little ahead of the timeline at a hypothetical
        utilization — the router's routing signal.  Bypasses the measured
        ``utilization`` signal (which cannot know about work that has not
        been routed yet) but honours a ``source`` override, so a node
        replaying a drift tail predicts its *drifted* watts."""
        if self.source is not None:
            return self.source.watts(self._now + dt_ahead) * self.chips
        return self.envelope.watts(min(max(util, 0.0), 1.0)) * self.chips

    def observe(self, seconds: float, util: float = 1.0,
                phase: str = "decode",
                tenants: Optional[list[str]] = None,
                watts: Optional[float] = None) -> float:
        """Book one measured window.  ``watts`` overrides the derived
        draw entirely (source and utilization signal both bypassed) —
        the fleet power planner uses it to book a gated node's parked
        draw and a wake transition's boot energy, which no envelope
        point represents."""
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
