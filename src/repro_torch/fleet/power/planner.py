"""Consolidate-and-gate placement — which nodes stay powered at all.

The fleet's Step-5 at fleet scale: each planning window the
``FleetPowerPlanner`` forecasts the sustained load (``ArrivalForecaster``,
EWMA + M/M/c), then picks the *minimal* node set that meets the
queue-depth SLO at the lowest forecast Watt*seconds — active nodes cost
their envelope point at the forecast utilization, gated nodes cost their
parked draw, and waking a gated node costs its modeled boot energy.  The
chosen placement diffs against the current power states into pending
``PlacementEvent``s, applied only at checkpoint boundaries — exactly like
plan and load migrations, so serving never sees a mid-flight flip.

Re-admission is probe-based (``NodePowerState``): a gated node the
planner wakes — or a node a fleet migration drained — re-enters through
PROBATION, where the router hands it exactly one *canary* request; the
canary finishing promotes it to ACTIVE.

``mode="always_on"`` runs the same accounting (idle floors booked, same
forecasts logged) but never gates — the baseline arm of a Ws A/B.

Counterpart of ``repro.fleet.power.planner``.  The Erlang-C sweep runs on
numpy, the reference's bit-exact backend, or with ``backend="torch"`` as
stock torch ops on a device (``fleet.torch_backend``; the card unless
``device`` names the CPU).  A torch backend that cannot reach its device
raises: nothing falls back to numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.power.forecast import ArrivalForecaster
from repro_torch.fleet.power.states import (ACTIVE, GATED, PARKED, PROBATION,
                                      WAKING, NodePowerState,
                                      PowerStatePolicy)

MODES = ("gate", "always_on")


@dataclass(frozen=True)
class PowerPlanPolicy:
    mode: str = "gate"              # "gate" | "always_on" (baseline arm)
    slo_queue_depth: float = 4.0    # expected queued requests the SLO allows
    plan_every: int = 8             # fleet steps between planning windows
    horizon_steps: float = 64.0     # window the Ws forecast prices
    min_active: int = 1             # never gate below this many nodes
    min_active_steps: int = 16      # a (re)admitted node is not re-gated
    #                                 before serving this long (hysteresis)
    service_steps: float = 0.0      # steps/request prior (0 = learn from
    #                                 finished requests, fallback 16)
    states: PowerStatePolicy = field(default_factory=PowerStatePolicy)

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got "
                             f"{self.mode!r}")
        if self.plan_every < 1:
            raise ValueError("plan_every must be >= 1 step")
        if self.min_active < 1:
            raise ValueError("min_active must be >= 1 node")


@dataclass(frozen=True)
class PlacementEvent:
    """One power-placement decision — the placement sibling of the
    load-level ``FleetEvent`` and the plan-level ``GovernorEvent``.

    ``gate``/``wake`` apply at checkpoint boundaries; ``probe`` (entering
    probation), ``admit`` (canary passed) and ``regate`` (canary timed
    out) are the probe policy's own transitions."""
    step: int
    detected_step: int
    node: str
    action: str                     # gate|wake|probe|admit|regate
    rate: float = 0.0               # forecast arrival rate at decision
    queue_depth_est: float = 0.0    # forecast Lq for the chosen set
    active_target: int = 0          # nodes the chosen placement keeps on
    moved_rids: tuple = ()          # load drained off a gated node
    reason: str = ""

    def to_dict(self) -> dict:
        return {"step": self.step, "detected_step": self.detected_step,
                "node": self.node, "action": self.action,
                "rate": self.rate,
                "queue_depth_est": self.queue_depth_est,
                "active_target": self.active_target,
                "moved_rids": list(self.moved_rids),
                "reason": self.reason}


@dataclass
class _PendingPlacement:
    detected_step: int
    node: str
    action: str                     # "gate" | "wake"
    rate: float
    queue_depth_est: float
    active_target: int


class FleetPowerPlanner:
    """Owns one ``NodePowerState`` per node and the placement loop.

    Bound to a ``FleetScheduler`` (``sched.planner = planner`` wires it);
    the scheduler calls ``observe_arrival`` on every submit, ``tick``
    once per fleet step, and ``checkpoint`` at checkpoint boundaries.
    """

    def __init__(self, policy: Optional[PowerPlanPolicy] = None,
                 forecaster: Optional[ArrivalForecaster] = None,
                 backend: str = "numpy", device: DeviceLike = None):
        if backend not in ("numpy", "torch"):
            raise ValueError("backend must be 'numpy' or 'torch', got "
                             f"{backend!r}")
        self.backend_requested = backend
        self.backend = backend
        self.device = resolve_device(device) if backend == "torch" \
            else None
        self.policy = policy or PowerPlanPolicy()
        self.forecaster = forecaster or ArrivalForecaster()
        self.events: list[PlacementEvent] = []
        self.max_queue_depth = 0        # worst observed queued backlog
        self._sched = None
        self._machines: dict[str, NodePowerState] = {}
        self._pending: dict[str, _PendingPlacement] = {}

    # -- wiring --------------------------------------------------------------

    def bind(self, sched) -> None:
        self._sched = sched
        for node in sched.nodes:
            self._machines[node.name] = NodePowerState(
                node, policy=self.policy.states)

    def machine(self, node) -> NodePowerState:
        return self._machines[getattr(node, "name", node)]

    @property
    def states(self) -> dict:
        return {name: m.state for name, m in self._machines.items()}

    # -- routing hooks -------------------------------------------------------

    def observe_arrival(self, step: int) -> None:
        self.forecaster.observe(step)

    def routable(self, node) -> bool:
        return self.machine(node).routable

    def canary_target(self, candidates) -> Optional[object]:
        """The probation node (if any) still owed its canary request."""
        for node in candidates:
            m = self.machine(node)
            if m.state == PROBATION and m.canary is None:
                return node
        return None

    def note_canary(self, node, req, step: int) -> None:
        self.machine(node).assign_canary(req, step)

    # -- the forecast-driven placement choice --------------------------------

    def _service_steps(self) -> float:
        if self.policy.service_steps > 0:
            return self.policy.service_steps
        done = [len(r.out) for n in self._sched.nodes
                for r in n.loop.finished[-32:] if r.out]
        if done:
            recent = done[-32:]
            return max(sum(recent) / len(recent), 1.0)
        return 16.0

    def _ranked(self) -> list:
        """Nodes cheapest-to-power first (idle floor, then name), with
        currently-powered nodes preferred on ties so the plan is stable."""
        order = {ACTIVE: 0, PROBATION: 0, WAKING: 0, PARKED: 1, GATED: 2}

        def key(node):
            m = self.machine(node)
            return (m.floor_watts, order.get(m.state, 3), node.name)
        return sorted(self._sched.nodes, key=key)

    def _backlog(self) -> int:
        return sum(n.queued for n in self._sched.nodes)

    def plan(self, step: int) -> None:
        """One planning window: choose the minimal node set meeting the
        SLO at lowest forecast Ws, and park the diff as pending
        gate/wake placements for the next checkpoint.

        ``_ranked`` orders nodes cheapest-floor first, so the first k
        that meets the SLO *is* the lowest-Ws SLO-meeting set (each
        further node only adds its idle floor).  The forecast Lq prices
        sustained load over the horizon; the live backlog beyond the
        set's slots prices the burst already here."""
        pol = self.policy
        ranked = self._ranked()
        service = self._service_steps()
        rate = self.forecaster.rate(now=step)
        backlog = self._backlog() + sum(n.occupied for n in ranked)
        k, lq = len(ranked), 0.0        # nothing meets the SLO: all hands
        if pol.min_active <= len(ranked):
            # one Erlang-C sweep prices every candidate prefix; the
            # first count meeting the SLO is the reference scalar
            # loop's break point (expected_queue_depth_many is
            # bit-identical per element to the scalar call)
            slots_cum = np.cumsum([n.slots for n in ranked])
            cand = np.arange(pol.min_active, len(ranked) + 1)
            slots_c = slots_cum[cand - 1]
            lqs = self._lq_sweep(slots_c, service, step,
                                 pol.horizon_steps)
            hits = np.flatnonzero(
                np.maximum(lqs, backlog - slots_c)
                <= pol.slo_queue_depth)
            if hits.size:
                k = int(cand[hits[0]])
                lq = float(lqs[hits[0]])
            else:
                lq = float(lqs[-1])     # the all-hands forecast
        keep = {n.name for n in ranked[:k]}
        tr = obs.TRACER
        if tr.enabled:
            tr.instant("power.plan",
                       tags={"step": step, "rate": rate, "lq": lq,
                             "active_target": k, "backlog": backlog})
        # a newer plan rescinds pending placements it now contradicts —
        # a burst arriving between the plan that parked a gate and the
        # checkpoint that would apply it must cancel the gate, not pay
        # boot + warmup + canary to undo it a window later
        for name in list(self._pending):
            p = self._pending[name]
            if (p.action == "gate") == (name in keep):
                del self._pending[name]
        for node in ranked:
            m = self.machine(node)
            wanted = node.name in keep
            if wanted and m.state == GATED:
                self._park_pending(step, node, "wake", rate, lq, k)
            elif (not wanted and pol.mode == "gate"
                  and m.state in (ACTIVE, PROBATION)
                  and step - m.since_step >= pol.min_active_steps
                  and self._gate_pays(m)):
                self._park_pending(step, node, "gate", rate, lq, k)

    def _lq_sweep(self, slots_c, service: float, step: int,
                  horizon: float):
        """Expected queue depth for every candidate slot count — the torch
        sweep on ``self.device`` when ``backend="torch"``, the numpy sweep
        otherwise."""
        if self.backend == "torch":
            from repro_torch.fleet.torch_backend import \
                expected_queue_depth_many_torch
            return expected_queue_depth_many_torch(
                slots_c, service, self.forecaster.rate(now=step), horizon,
                device=self.device)
        return self.forecaster.expected_queue_depth_many(
            slots_c, service, now=step, horizon=horizon)

    def _gate_pays(self, m: NodePowerState) -> bool:
        """Gating is worth it only when the floor-vs-parked savings over
        one horizon beat the boot energy the next wake will pay — the
        transition cost priced into the placement, not just the draw."""
        saved_w = m.floor_watts - m.parked_watts
        horizon_s = m._step_seconds() * self.policy.horizon_steps
        return saved_w * horizon_s > self.policy.states.boot_energy_ws

    def _park_pending(self, step: int, node, action: str, rate: float,
                      lq: float, k: int) -> None:
        if node.name in self._pending:
            return
        self._pending[node.name] = _PendingPlacement(
            detected_step=step, node=node.name, action=action, rate=rate,
            queue_depth_est=lq, active_target=k)

    @property
    def pending(self) -> list:
        return list(self._pending.values())

    # -- scheduler hooks -----------------------------------------------------

    def tick(self, step: int) -> None:
        """Once per fleet step: book non-serving draws, run the probe
        policy, track the SLO signal, and re-plan every ``plan_every``."""
        self.max_queue_depth = max(self.max_queue_depth, self._backlog())
        for node in self._sched.nodes:
            m = self.machine(node)
            if node.parked and m.state == ACTIVE:
                m.note_parked(step)     # a migration parked it, not us
            action = m.tick(step)
            if action == "regate":
                action = self._apply_regate(step, node, m)
            if action is not None:
                self.events.append(PlacementEvent(
                    step=step, detected_step=step, node=node.name,
                    action=action, rate=self.forecaster.rate(now=step),
                    reason=f"probe policy ({m.state})"))
                mx = obs.METRICS
                if mx.enabled:
                    mx.counter("placement_events_total",
                               "gate/wake/probe/admit/regate decisions"
                               ).inc()
        mx = obs.METRICS
        if mx.enabled:
            mx.gauge("active_nodes", "routable (ACTIVE) nodes").set(
                sum(1 for m in self._machines.values() if m.routable))
        if step % self.policy.plan_every == 0:
            self.plan(step)

    def _apply_regate(self, step: int, node, m: NodePowerState):
        """A timed-out canary gates its node back — but its queue and
        slots (the canary included) must move, exactly like the
        checkpoint gate path.  With no other unparked node the regate
        is declined (the machine restarted the canary window): serving
        beats the probe protocol."""
        if not any(n is not node and not n.parked
                   for n in self._sched.nodes):
            return None
        node.loop.park()
        moved = node.drain()
        for req in moved:
            self._sched.route(req, exclude=node).submit(req)
        m.gate(step)
        return "regate"

    def checkpoint(self, step: int) -> list:
        """Apply every pending placement: gates drain + park exactly like
        migrations, wakes start the boot transition.  Returns the
        ``PlacementEvent``s applied."""
        if not self._pending:
            return []
        parked, self._pending = self._pending, {}
        applied = []
        for p in parked.values():
            node = self._sched.node(p.node)
            m = self.machine(node)
            if p.action == "gate":
                if m.state not in (ACTIVE, PROBATION):
                    continue
                active_after = [n for n in self._sched.nodes
                                if n is not node and self.routable(n)
                                and not n.parked]
                if len(active_after) < self.policy.min_active:
                    continue            # never gate the last active node
                node.loop.park()
                moved = node.drain()
                for req in moved:
                    dst = self._sched.route(req, exclude=node)
                    dst.submit(req)
                m.gate(step)
                applied.append(PlacementEvent(
                    step=step, detected_step=p.detected_step,
                    node=p.node, action="gate", rate=p.rate,
                    queue_depth_est=p.queue_depth_est,
                    active_target=p.active_target,
                    moved_rids=tuple(r.rid for r in moved),
                    reason="consolidate: forecast met by fewer nodes"))
            elif p.action == "wake":
                if m.state != GATED:
                    continue
                m.wake(step)
                applied.append(PlacementEvent(
                    step=step, detected_step=p.detected_step,
                    node=p.node, action="wake", rate=p.rate,
                    queue_depth_est=p.queue_depth_est,
                    active_target=p.active_target,
                    reason="forecast demand exceeds the active set"))
        self.events.extend(applied)
        if applied:
            mx = obs.METRICS
            if mx.enabled:
                mx.counter("placement_events_total",
                           "gate/wake/probe/admit/regate decisions"
                           ).inc(len(applied))
        return applied

    # -- reporting -----------------------------------------------------------

    def summary(self) -> dict:
        return {"mode": self.policy.mode,
                "backend_requested": self.backend_requested,
                "backend_effective": self.backend,
                "slo_queue_depth": self.policy.slo_queue_depth,
                "max_queue_depth": self.max_queue_depth,
                "states": dict(self.states),
                "forecast": self.forecaster.summary(),
                "events": [e.to_dict() for e in self.events]}
