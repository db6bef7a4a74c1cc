"""``FleetScheduler`` — energy-aware routing, migration and admission.

The fleet plane above the per-node governors: where ``PowerGovernor``
migrates *plans* within one node when its energy drifts, the scheduler
moves *load* between nodes and decides who may submit at all.  Three
policies run on the merged fleet ``EnergyLedger``:

  * **routing** — every admitted request goes to the node with the lowest
    predicted marginal Ws/token (``Node.marginal_ws_per_token``: envelope
    point x real slot occupancy, honouring drifted sources).  A
    ``round_robin`` router is kept as the energy-blind baseline;
  * **cross-node migration** — each node's flush window feeds a per-node
    drift monitor (same rolling-median signal as the governor's); when a
    node drifts past ``degrade_factor`` the drain parks as *pending* and
    is applied at the next checkpoint boundary: the node is parked, its
    queue and active slots are evicted as resumable requests and
    re-routed to healthy nodes, and one ``FleetEvent`` records the move —
    the load-level sibling of the plan-level ``GovernorEvent``;
  * **admission** — an ``AdmissionController`` bills each tenant's
    submits against its ``WsBudget`` window read off the fleet ledger;
    throttled submits book zero Ws.

A fourth, optional policy layer is *placement*
(``repro_torch.fleet.power``):
attach a ``FleetPowerPlanner`` and the scheduler also decides which nodes
are powered at all — powered-but-unloaded nodes book floor-watts ``idle``
energy every step (the envelope integral the paper's verdict counts),
gated nodes drop to a parked near-zero draw, and gate/wake
``PlacementEvent``s apply at the same checkpoint boundaries as
migrations.  Probation nodes re-admit through a single canary request the
router hands them.

Flushes use the same ``drain_delta`` primitive as the governor, so the
merged fleet ledger's ``total_ws`` equals the sum of the node meters'
totals at every run end — per-node, per-tenant and per-phase cuts of the
same joules.  Counterpart of ``repro.fleet.scheduler``; the scheduler
moves numbers, only the loops it steps touch the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch import obs
from repro_torch.fleet.admission import AdmissionController
from repro_torch.fleet.node import Node
from repro_torch.serve.engine import Request
from repro_torch.telemetry.energy import EnergyLedger, drain_delta

ROUTERS = ("energy", "round_robin")

#: routing fan-out is small-integer-valued: give its histogram bounds
#: that resolve single-node candidate sets
_CANDIDATE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


def normalize_arrivals(arrivals: Optional[list],
                       arrival_every: int = 1) -> list:
    """Normalize a ``run()`` arrival script to a due-sorted
    ``[(due_step, Request), ...]`` list.

    Two input shapes are accepted, never mixed:

      * bare ``Request``s — paced one per ``arrival_every`` fleet steps,
        so the i-th request is due at step ``i * max(arrival_every, 1)``
        (exactly the cadence the paced dispatch loop used to produce);
      * ``(due_step, Request)`` pairs — submitted at the first fleet
        step >= ``due_step``.  The list is stably sorted by due step, so
        same-step arrivals keep their submission order and an unsorted
        script cannot head-block later-but-earlier-due requests.

    A mixed list raises: the two shapes imply different pacing semantics
    and silently switching between them per-element was a bug.
    """
    if not arrivals:
        return []
    timed = [isinstance(a, tuple) for a in arrivals]
    if all(timed):
        pairs = list(arrivals)
    elif not any(timed):
        pace = max(arrival_every, 1)
        pairs = [(i * pace, req) for i, req in enumerate(arrivals)]
    else:
        raise ValueError(
            "mixed arrival semantics: pass either bare Requests (paced by "
            "arrival_every) or (due_step, Request) pairs, not both")
    pairs.sort(key=lambda p: p[0])
    return pairs


@dataclass(frozen=True)
class FleetPolicy:
    flush_every: int = 8        # fleet steps between meter flushes
    checkpoint_every: int = 16  # fleet steps between checkpoint boundaries
    degrade_factor: float = 1.5  # window-Ws drift that marks a node sick
    drift_window: int = 8       # rolling flush windows per node monitor
    drift_phases: tuple = ("decode",)   # phases feeding the drift signal
    cooldown_steps: int = 10_000        # per-node steps between drains
    router: str = "energy"      # "energy" | "round_robin"
    migrate_on_drift: bool = True       # drain sick nodes at checkpoints
    park_drained: bool = True   # a drained node stops taking traffic

    def __post_init__(self) -> None:
        if self.flush_every < 1 or self.checkpoint_every < 1:
            raise ValueError("fleet cadences must be >= 1 step")
        if self.router not in ROUTERS:
            raise ValueError(f"router must be one of {ROUTERS}, got "
                             f"{self.router!r}")


@dataclass(frozen=True)
class FleetEvent:
    """One cross-node load migration at a checkpoint boundary — the fleet
    sibling of the plan-level ``GovernorEvent``."""
    step: int                   # fleet step of the checkpoint that applied it
    detected_step: int          # fleet step whose flush tripped the drift
    node: str                   # the drained node
    targets: tuple              # healthy nodes the load moved to
    moved_rids: tuple           # requests (queued + evicted slots) moved
    drift_ratio: float
    window_ws: float
    median_ws: float
    kind: str = "drain"

    def to_dict(self) -> dict:
        return {"step": self.step, "detected_step": self.detected_step,
                "node": self.node, "targets": list(self.targets),
                "moved_rids": list(self.moved_rids),
                "drift_ratio": self.drift_ratio,
                "window_ws": self.window_ws, "median_ws": self.median_ws,
                "kind": self.kind}


@dataclass
class _PendingDrain:
    detected_step: int
    node: str
    drift_ratio: float
    window_ws: float
    median_ws: float


@dataclass
class FleetScheduler:
    """Owns N ``Node``s and runs the three fleet policies over them."""
    nodes: list
    policy: FleetPolicy = field(default_factory=FleetPolicy)
    admission: Optional[AdmissionController] = None
    planner: Optional[object] = None    # fleet.power.FleetPowerPlanner
    ledger: EnergyLedger = field(default_factory=EnergyLedger)
    events: list = field(default_factory=list)      # FleetEvent log
    steps: int = 0

    def __post_init__(self) -> None:
        names = [n.name for n in self.nodes]
        if not names:
            raise ValueError("a fleet needs at least one node")
        if len(set(names)) != len(names):
            raise ValueError(f"node names must be unique, got {names}")
        self._by_name = {n.name: n for n in self.nodes}
        self._snapshots: dict = {n: {} for n in names}
        # drained-but-not-yet-judged window per node: booking energy into
        # the fleet ledger (any flush) and judging drift (governed flushes
        # only) are decoupled, so an off-cadence drain — e.g. the
        # admission-time flush in ``submit`` — never shrinks the window
        # the next governed flush judges
        self._window_acc = {n: (0.0, 0.0) for n in names}
        self._drift = {n: EnergyLedger(window=self.policy.drift_window)
                       for n in names}
        self._pending: dict = {}            # node name -> _PendingDrain
        self._cooldown_until = {n: 0 for n in names}
        self._rr = 0
        if self.planner is not None:
            self.planner.bind(self)

    def node(self, name: str) -> Node:
        return self._by_name[name]

    def healthy(self) -> list:
        return [n for n in self.nodes if not n.parked]

    @property
    def has_work(self) -> bool:
        return any(n.has_work for n in self.nodes)

    # -- policy 1: energy-aware routing --------------------------------------

    def route(self, req: Request, exclude: Optional[Node] = None) -> Node:
        """Pick the destination node for one request (no admission check —
        ``submit`` is the admission-controlled entry).  ``exclude`` bars
        one node from candidacy — the checkpoint drain uses it so a
        drained-but-unparked node cannot be handed its own load back.

        With a power planner attached, a probation node still owed its
        canary takes the request (the probe that re-admits it), and
        other non-ACTIVE nodes are not candidates — unless no ACTIVE
        node is left at all, in which case the warm probation nodes
        take the load (serving beats the probe protocol: a drain or a
        burst must never crash on an all-probation fleet)."""
        candidates = [n for n in self.healthy() if n is not exclude]
        chosen = None
        if self.planner is not None and candidates:
            canary = self.planner.canary_target(candidates)
            if canary is not None:
                self.planner.note_canary(canary, req, self.steps)
                chosen = canary
            else:
                candidates = [n for n in candidates
                              if self.planner.routable(n)] or candidates
        if not candidates:
            raise RuntimeError("no healthy node to route to (all parked)")
        if chosen is None:
            if self.policy.router == "round_robin":
                chosen = candidates[self._rr % len(candidates)]
                self._rr += 1
            else:
                # clamp non-finite predictions (a drifted/NaN source) to
                # +inf: NaN compares False against everything, which would
                # make the min ordering arbitrary — a broken node must
                # lose ties deterministically instead
                def cost(n):
                    m = n.marginal_ws_per_token()
                    return m if math.isfinite(m) else float("inf")
                chosen = min(candidates,
                             key=lambda n: (cost(n), n.load, n.name))
        tr = obs.TRACER
        if tr.enabled:
            tr.instant("fleet.route",
                       tags={"rid": req.rid, "tenant": req.tenant,
                             "node": chosen.name, "step": self.steps,
                             "candidates": len(candidates)})
        mx = obs.METRICS
        if mx.enabled:
            mx.histogram("routing_candidates", "nodes eligible per route",
                         buckets=_CANDIDATE_BUCKETS
                         ).observe(len(candidates))
        return chosen

    # -- policy 3: tenant admission ------------------------------------------

    def submit(self, req: Request) -> Optional[Node]:
        """Admission-checked submit; returns the node the request was
        routed to, or None when the tenant's budget window rejected it
        (zero Ws booked — the request never reaches a loop).

        The admit check reads *current* spend: the node meters are
        drained into the fleet ledger first (``flush(govern=False)``), so
        a tenant cannot overshoot its budget by however much energy the
        flush cadence had not yet booked."""
        if self.planner is not None:
            self.planner.observe_arrival(self.steps)
        mx = obs.METRICS
        if mx.enabled:
            mx.counter("arrivals_total", "submits offered to the fleet"
                       ).inc()
        tr = obs.TRACER
        if self.admission is not None:
            self.flush(govern=False)
            if not self.admission.admit(req, self.steps, self.ledger):
                if tr.enabled:
                    tr.instant("fleet.submit",
                               tags={"rid": req.rid, "tenant": req.tenant,
                                     "step": self.steps,
                                     "admitted": False})
                return None
        node = self.route(req)
        node.submit(req)
        if tr.enabled:
            tr.instant("fleet.submit",
                       tags={"rid": req.rid, "tenant": req.tenant,
                             "step": self.steps, "admitted": True,
                             "node": node.name})
        return node

    # -- measurement ingestion -----------------------------------------------

    def flush(self, govern: bool = True) -> None:
        """Drain every node meter's un-flushed energy into the fleet
        ledger; with ``govern`` each node's accumulated window also feeds
        its drift monitor and may park a pending drain.  ``govern=False``
        books without judging — the run-end drain and the admission-time
        drain both use it, completing the ledger (totals match the meters
        exactly) while the drained energy stays accumulated for the next
        governed flush's window."""
        tr = obs.TRACER
        if tr.enabled:
            tr.instant("fleet.flush",
                       tags={"step": self.steps, "govern": govern})
        for node in self.nodes:
            d_ws, d_s = drain_delta(
                node.meter.ledger, self.ledger, self._snapshots[node.name],
                node.name, phases=self.policy.drift_phases)
            acc_ws, acc_s = self._window_acc[node.name]
            window_ws, window_s = acc_ws + d_ws, acc_s + d_s
            if not govern:
                self._window_acc[node.name] = (window_ws, window_s)
                continue
            self._window_acc[node.name] = (0.0, 0.0)
            if window_ws <= 0 and window_s <= 0:
                continue
            drift = self._drift[node.name]
            ratio = drift.drift_ratio(window_ws)
            drift.record_step(window_s, window_ws)
            if (not self.policy.migrate_on_drift or ratio is None
                    or ratio <= self.policy.degrade_factor
                    or node.parked
                    or self.steps < self._cooldown_until[node.name]
                    or node.name in self._pending):
                continue
            self._pending[node.name] = _PendingDrain(
                detected_step=self.steps, node=node.name,
                drift_ratio=ratio, window_ws=window_ws,
                median_ws=drift.median_step_ws() or 0.0)

    @property
    def pending(self) -> Optional[_PendingDrain]:
        """The most recently parked pending drain (None when empty)."""
        if not self._pending:
            return None
        return next(reversed(list(self._pending.values())))

    # -- policy 2: cross-node migration at checkpoint boundaries -------------

    def checkpoint(self) -> list:
        """Apply every pending drain: park the sick node, evict its queue
        and slots, re-route the load to healthy nodes, emit one
        ``FleetEvent`` per drained node.  A drain with nowhere to go
        (no other healthy node) is dropped — serving beats purity.

        Pending power placements (gate/wake) apply at the same boundary
        — their ``PlacementEvent``s live on ``planner.events``."""
        if self.planner is not None:
            self.planner.checkpoint(self.steps)
        if not self._pending:
            return []
        parked, self._pending = self._pending, {}
        applied = []
        for p in parked.values():
            node = self.node(p.node)
            if not any(h is not node for h in self.healthy()):
                continue                    # nowhere to drain to
            if self.policy.park_drained:
                node.loop.park()
            moved = node.drain()
            targets = []
            for req in moved:
                # healthy nodes only — and never the node being drained,
                # which with park_drained=False is otherwise a candidate
                dst = self.route(req, exclude=node)
                dst.submit(req)
                targets.append(dst.name)
            ev = FleetEvent(step=self.steps, detected_step=p.detected_step,
                            node=p.node,
                            targets=tuple(sorted(set(targets))),
                            moved_rids=tuple(r.rid for r in moved),
                            drift_ratio=p.drift_ratio,
                            window_ws=p.window_ws, median_ws=p.median_ws)
            self.events.append(ev)
            applied.append(ev)
            tr = obs.TRACER
            if tr.enabled:
                tr.instant("fleet.migrate", node=p.node,
                           t=node.meter.now,
                           tags={"step": self.steps, "moved": len(moved),
                                 "targets": ",".join(ev.targets)})
            mx = obs.METRICS
            if mx.enabled:
                mx.counter("fleet_migrations_total",
                           "drift drains applied at checkpoints").inc()
            self._cooldown_until[p.node] = \
                self.steps + self.policy.cooldown_steps
        return applied

    # -- the serving loop ----------------------------------------------------

    def step(self) -> list:
        """One fleet step: every node with work decodes once, then the
        flush / checkpoint cadences apply.  Returns the ``FleetEvent``s
        this step's checkpoint emitted (usually []).

        With a power planner attached, powered-but-unloaded nodes step
        too — booking their floor-watts ``idle`` window — and the
        planner's tick books gated/parked draws and runs the probe
        policy, so the fleet ledger carries the whole envelope integral,
        not just the busy spans."""
        self.steps += 1
        tr = obs.TRACER
        sp = tr.begin("fleet.step", tags={"step": self.steps}) \
            if tr.enabled else None
        mx = obs.METRICS
        if mx.enabled:
            mx.counter("fleet_steps_total", "fleet scheduler steps").inc()
        for node in self.nodes:
            if node.has_work:
                node.loop.step()
            elif self.planner is not None and not node.parked:
                node.loop.step()        # idle tick: floor watts booked
        if self.planner is not None:
            self.planner.tick(self.steps)
        if self.steps % self.policy.flush_every == 0:
            self.flush()
        events = []
        if self.steps % self.policy.checkpoint_every == 0:
            events = self.checkpoint()
        if sp is not None:
            sp.finish(tr.clock())
        return events

    def run(self, max_steps: int = 10_000, arrivals: Optional[list] = None,
            arrival_every: int = 1) -> list:
        """Serve until every node is idle; returns the requests finished
        during this run (across all nodes), and leaves the fleet ledger
        complete — its ``total_ws`` equals the sum of the node meters'.

        ``arrivals`` paces a request stream through admission *during*
        serving — one submit every ``arrival_every`` fleet steps — which
        is what makes budget throttling observable (a tenant's spend is
        zero until its traffic runs).  Rejected arrivals are dropped with
        zero Ws booked; the caller reads ``admission.rejections``.

        An arrival may also be a ``(due_step, Request)`` pair: it is
        submitted at the first fleet step >= ``due_step``, which is how
        a bursty/diurnal script leaves real *troughs* — the fleet keeps
        stepping (booking idle floors, letting the power planner gate)
        while no request is due.  ``normalize_arrivals`` turns both
        shapes into one due-sorted stream at entry (mixed lists raise),
        and dispatch walks it with a cursor — O(1) per arrival, where
        ``list.pop(0)`` made million-arrival scripts quadratic."""
        queue = normalize_arrivals(arrivals, arrival_every)
        n0 = {n.name: len(n.loop.finished) for n in self.nodes}
        idx = 0
        for _ in range(max_steps):
            if idx >= len(queue) and not self.has_work:
                break
            while idx < len(queue) and queue[idx][0] <= self.steps:
                self.submit(queue[idx][1])
                idx += 1
            self.step()
        self.flush(govern=False)            # complete the fleet ledger
        # the partial tail window is booked but never judged: a later
        # run() must not fold it into its first drift window
        self._window_acc = {n.name: (0.0, 0.0) for n in self.nodes}
        finished = []
        for node in self.nodes:
            finished.extend(node.loop.finished[n0[node.name]:])
        finished.sort(key=lambda r: r.rid)
        return finished

    # -- reporting -----------------------------------------------------------

    def summary(self) -> dict:
        doc = {"steps": self.steps,
               "total_ws": self.ledger.total_ws,
               "router": self.policy.router,
               "nodes": [n.to_dict() for n in self.nodes],
               "events": [e.to_dict() for e in self.events]}
        if self.admission is not None:
            doc["admission"] = self.admission.summary(self.ledger)
        if self.planner is not None:
            doc["placement"] = self.planner.summary()
        return doc
