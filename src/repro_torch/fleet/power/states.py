"""Node power states — what a node draws when it is not serving.

The paper's Watt*second verdict counts idle draw: a powered node with no
work still burns the DVFS floor, so at fleet scale the biggest low-traffic
lever is which nodes are powered at all.  ``NodePowerState`` is the
per-node machine the consolidation planner drives:

    ACTIVE ──gate──> GATED ──wake──> WAKING ──(warmup)──> PROBATION
      ^                                                       │
      └────────────────── canary finished ────────────────────┘

  * **ACTIVE** — routable.  An unloaded active node books floor-watts
    ``idle`` energy through its own loop (``ServeLoop._idle_step``);
  * **PARKED** — drained by a fleet migration (the node was parked by
    ``FleetScheduler.checkpoint``, not by this planner).  Still powered:
    each planner tick books the envelope's gated floor as ``idle``.
    After ``cooldown_steps`` the probe policy moves it to PROBATION —
    drained nodes no longer stay parked for the rest of the run;
  * **GATED** — powered down to a parked, near-zero draw: each tick
    books ``gate_watts`` (never more than the envelope floor) as
    ``idle``;
  * **WAKING** — paying the modeled boot: ``boot_energy_ws`` is booked
    as a ``transition`` phase spanning ``warmup_steps``, during which
    the node is not routable;
  * **PROBATION** — powered and warm, but trusted with exactly one
    *canary* request.  The canary finishing promotes the node to ACTIVE;
    a canary that never finishes (timeout) re-gates it.

Every booking goes through the node's own ``DecodeEnergyMeter`` under the
infra tenant, so the fleet ledger's ``rollup(by=phase)`` — now including
``idle`` and ``transition`` — still sums exactly to ``total_ws``, and the
merged fleet ledger still equals the sum of the node meters.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch import obs
from repro_torch.telemetry.energy import (IDLE_PHASE, INFRA_TENANT,
                                    TRANSITION_PHASE)

ACTIVE = "active"
PARKED = "parked"
GATED = "gated"
WAKING = "waking"
PROBATION = "probation"

STATES = (ACTIVE, PARKED, GATED, WAKING, PROBATION)


@dataclass(frozen=True)
class PowerStatePolicy:
    """Transition costs and probe cadence of the node power machine."""
    gate_watts: float = 3.0         # parked near-zero draw (W per node)
    boot_energy_ws: float = 4.0     # modeled boot cost of one wake
    warmup_steps: int = 4           # steps a woken node stays unroutable
    cooldown_steps: int = 16        # steps before a parked node is probed
    canary_timeout_steps: int = 256  # unfinished canary -> re-gate

    def __post_init__(self) -> None:
        if self.gate_watts < 0 or self.boot_energy_ws < 0:
            raise ValueError("power-state costs must be >= 0")
        if self.warmup_steps < 0 or self.cooldown_steps < 0:
            raise ValueError("power-state cadences must be >= 0")


@dataclass
class NodePowerState:
    """One node's power state + the meter bookings its transitions cost."""
    node: object                    # fleet.Node (duck-typed)
    policy: PowerStatePolicy = field(default_factory=PowerStatePolicy)
    state: str = ACTIVE
    since_step: int = 0
    wake_done_step: int = 0
    canary: Optional[object] = None     # the probation Request
    canary_step: int = 0
    # open observability spans on the node meter's timeline (period
    # spans: gated/parked stretches, probation windows, canary children)
    _span: Optional[object] = field(default=None, repr=False)
    _canary_span: Optional[object] = field(default=None, repr=False)

    # -- draws ---------------------------------------------------------------

    @property
    def floor_watts(self) -> float:
        """The envelope's clock-gated idle floor — what a powered,
        unloaded node draws (per node of ``chips`` chips)."""
        meter = self.node.meter
        return meter.envelope.gated_idle * meter.chips

    @property
    def parked_watts(self) -> float:
        """GATED draw: the configured parked wattage, never above the
        idle floor (a gate that draws more than idle gates nothing)."""
        return min(self.policy.gate_watts, self.floor_watts)

    @property
    def routable(self) -> bool:
        return self.state == ACTIVE

    def _book(self, seconds: float, watts: float, phase: str) -> float:
        if seconds <= 0:
            return 0.0
        return self.node.meter.observe(seconds, phase=phase, watts=watts,
                                       tenants=[INFRA_TENANT])

    # -- observability spans (meter-timeline period spans) -------------------

    def _close_span(self, outcome: str = "") -> None:
        if self._span is not None:
            if outcome:
                self._span.tags["outcome"] = outcome
            self._span.finish(self.node.meter.now)
            self._span = None

    def _close_canary(self, outcome: str) -> None:
        if self._canary_span is not None:
            self._canary_span.tags["outcome"] = outcome
            self._canary_span.finish(self.node.meter.now)
            self._canary_span = None

    def _extend_span(self, name: str, seconds: float, ws: float) -> None:
        """Lazily open (then grow) the period span covering this state's
        per-tick bookings; ``ws`` feeds the joule-attribution weight."""
        tr = obs.TRACER
        if not tr.enabled:
            return
        now = self.node.meter.now
        if self._span is None or self._span.name != name:
            self._close_span()
            self._span = tr.begin(
                name, node=self.node.name, t0=max(now - seconds, 0.0),
                tags={"phase": IDLE_PHASE, "tenant": INFRA_TENANT,
                      "ws": 0.0, "step": self.since_step})
        self._span.extend(now, ws=ws)

    # -- transitions (the planner applies these at checkpoints) --------------

    def gate(self, step: int) -> None:
        """Drop to the parked draw.  The caller has already drained the
        node's load and parked its loop (exactly like a migration)."""
        self.state = GATED
        self.since_step = step
        self.canary = None
        self._close_canary("regate")
        self._close_span("gated")

    def note_parked(self, step: int) -> None:
        """A fleet migration parked this node outside the planner: track
        it so the probe policy can re-admit it after cooldown."""
        if self.state == ACTIVE:
            self.state = PARKED
            self.since_step = step

    def wake(self, step: int) -> float:
        """GATED/PARKED -> WAKING: book the boot energy as one
        ``transition`` window spanning the warmup, then the node waits
        ``warmup_steps`` before probation.  Returns the Ws booked."""
        self.state = WAKING
        self.since_step = step
        self.wake_done_step = step + self.policy.warmup_steps
        self._close_span("wake")
        warmup_s = max(self.policy.warmup_steps, 1) * self._step_seconds()
        t0 = self.node.meter.now
        booked = self._book(warmup_s, self.policy.boot_energy_ws / warmup_s,
                            TRANSITION_PHASE)
        tr = obs.TRACER
        if tr.enabled:
            tr.begin("power.wake", node=self.node.name, t0=t0,
                     tags={"phase": TRANSITION_PHASE,
                           "tenant": INFRA_TENANT, "ws": booked,
                           "step": step}).finish(self.node.meter.now)
        return booked

    def begin_probation(self, step: int) -> None:
        self.state = PROBATION
        self.since_step = step
        self.canary = None
        self._close_span("probe")
        tr = obs.TRACER
        if tr.enabled:
            self._span = tr.begin("power.probation", node=self.node.name,
                                  t0=self.node.meter.now,
                                  tags={"step": step})
        self.node.loop.unpark()

    def admit(self, step: int) -> None:
        """Canary finished: the node is trusted with real traffic."""
        self.state = ACTIVE
        self.since_step = step
        self.canary = None
        self._close_canary("done")
        self._close_span("admit")

    def assign_canary(self, req, step: int) -> None:
        self.canary = req
        self.canary_step = step
        tr = obs.TRACER
        if tr.enabled:
            self._close_canary("superseded")
            self._canary_span = tr.begin(
                "power.canary", node=self.node.name,
                t0=self.node.meter.now, parent=self._span,
                tags={"rid": getattr(req, "rid", None), "step": step})

    # -- per-step accounting + probe policy ----------------------------------

    def _step_seconds(self) -> float:
        return max(self.node.recent_step_seconds(), 1e-9)

    def tick(self, step: int) -> Optional[str]:
        """One planner tick: book this step's non-serving draw and run
        the time-based transitions.  Returns the probe action taken
        (``"probe"`` / ``"admit"`` / ``"regate"``) or None."""
        dt = self._step_seconds()
        if self.state == GATED:
            ws = self._book(dt, self.parked_watts, IDLE_PHASE)
            self._extend_span("power.gated", dt, ws)
        elif self.state == PARKED:
            ws = self._book(dt, self.floor_watts, IDLE_PHASE)
            self._extend_span("power.parked", dt, ws)
            if step - self.since_step >= self.policy.cooldown_steps:
                self.begin_probation(step)
                return "probe"
        elif self.state == WAKING:
            # boot energy was booked up front; warmup elapsing makes the
            # node probe-able
            if step >= self.wake_done_step:
                self.begin_probation(step)
                return "probe"
        elif self.state == PROBATION and self.canary is not None:
            if getattr(self.canary, "done", False):
                self.admit(step)
                return "admit"
            if step - self.canary_step >= self.policy.canary_timeout_steps:
                # signal only: the planner applies the regate (it must
                # drain + re-route the canary and any load this node
                # holds — the machine cannot move requests).  Restart
                # the window so a declined regate does not re-fire
                # every tick.
                self.canary_step = step
                return "regate"
        return None

    def to_dict(self) -> dict:
        return {"node": self.node.name, "state": self.state,
                "since_step": self.since_step,
                "parked_watts": self.parked_watts,
                "floor_watts": self.floor_watts}
