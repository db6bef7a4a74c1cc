"""Power governor — the serving side of Step-7 in-operation reconfiguration.

Counterpart of ``repro.telemetry.governor``.  ``ServeLoop`` books
per-request Watt*seconds into a ``DecodeEnergyMeter``; ``PowerGovernor``
reads them, so serving-power drift can trigger a re-search:

    ServeLoop --(meter flush every N steps)--> fleet EnergyLedger
        --(per-node drift window)--> Reconfigurator.observe
        --(new plan, deferred)--> plan migration at a checkpoint boundary

  * ``flush`` drains the *delta* of a node's meter ledger since the last
    flush into the shared fleet ledger (the (node, tenant, phase) cells
    carry per-tenant billing through unchanged) and feeds the window's
    energy into that node's own ``Reconfigurator`` — each node keeps its
    own rolling median, so a throttling node trips on its own history, not
    on the fleet average;
  * a triggered re-search does NOT swap the plan mid-flight: the new plan
    parks as *pending* until the next checkpoint boundary, where
    ``checkpoint`` emits a ``GovernorEvent`` and updates ``plan`` — the
    caller rebuilds its model there, a checkpointed plan migration;
  * before applying, a pending migration can be *re-verified on a higher
    measurement rung* (``verify_rung``, normally ``"measured"`` — a real
    trial on the card, its energy read from the card's NVML counter): the
    pending plan and the incumbent are both measured on that rung, and
    the migration is applied only when the real trial confirms the
    analytic estimate's preference
    (``repro_torch.core.backends.confirms_preference``).  A rejected
    migration still emits a ``GovernorEvent`` — with ``applied=False``
    and the reason — so the fleet log shows what the estimate promised
    and the measurement vetoed;
  * ``tick`` is the single hook a serving loop calls once per decode step;
    it applies both cadences (``flush_every``, ``checkpoint_every``).

The governor moves numbers, not tensors: only the re-verification trials
touch the device.  A governor that re-verifies on the measured rung checks
at construction that its rung's device exists (no card and no
``device="cpu"`` raises); it never degrades to the analytic rung.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.telemetry.energy import (DEFAULT_NODE, DecodeEnergyMeter,
                                          EnergyLedger, drain_delta)


@dataclass(frozen=True)
class GovernorPolicy:
    flush_every: int = 8        # serve steps between meter flushes
    checkpoint_every: int = 16  # serve steps between checkpoint boundaries
    # phases whose energy feeds the drift monitor (the fleet ledger books
    # every phase regardless).  Steady-state decode is the drift signal;
    # prefill bursts are workload — a newly admitted request's prefill
    # must not read as a power anomaly.  () watches every phase.
    drift_phases: tuple = ("decode",)

    def __post_init__(self) -> None:
        if self.flush_every < 1 or self.checkpoint_every < 1:
            raise ValueError("governor cadences must be >= 1 step")


@dataclass(frozen=True)
class GovernorEvent:
    """One plan-migration decision at a checkpoint boundary.

    ``applied=True`` is a swap; ``applied=False`` records a migration the
    higher measurement rung vetoed (``verify_rung`` + ``reject_reason``
    say which rung and why)."""
    step: int                   # serve step of the checkpoint that judged it
    detected_step: int          # serve step whose flush tripped the drift
    node: str
    drift_ratio: float
    window_ws: float
    median_ws: float
    old_plan: str
    new_plan: str
    applied: bool = True
    verify_rung: str = ""       # rung that re-verified ("" = not re-verified)
    reject_reason: str = ""

    def to_dict(self) -> dict:
        return {"step": self.step, "detected_step": self.detected_step,
                "node": self.node, "drift_ratio": self.drift_ratio,
                "window_ws": self.window_ws, "median_ws": self.median_ws,
                "old_plan": self.old_plan, "new_plan": self.new_plan,
                "applied": self.applied, "verify_rung": self.verify_rung,
                "reject_reason": self.reject_reason}


@dataclass
class _Pending:
    detected_step: int
    node: str
    drift_ratio: float
    window_ws: float
    median_ws: float
    plan: object


class PowerGovernor:
    """Watches per-node serving energy and migrates the plan on drift.

    Wraps a ``repro_torch.core.adapt.Reconfigurator``: the given instance
    governs its first node, and additional nodes get monitors cloned from
    it via ``Reconfigurator.for_node`` (same policy/search config, fresh
    rolling window).  ``ledger`` is the shared fleet ledger every flush
    rolls into.

    ``verify_rung`` names the measurement rung that must confirm a pending
    migration before the checkpoint applies it (``"measured"`` for the
    real trial on the card, ``"replay"`` on machines holding recordings,
    ``None`` to trust the analytic estimate).  The re-verifying verifier
    is built here, from the reconfigurator's ``make_verifier``; on the
    measured rung its backend's device is resolved at once, so a governor
    without a card (and without a backend on ``device="cpu"``) raises
    when it is built, not at its first checkpoint.
    """

    def __init__(self, reconfigurator, plan=None,
                 policy: Optional[GovernorPolicy] = None,
                 ledger: Optional[EnergyLedger] = None,
                 verify_rung: Optional[str] = None):
        self.policy = policy or GovernorPolicy()
        self.ledger = ledger if ledger is not None else EnergyLedger()
        self.plan = plan if plan is not None else reconfigurator.cfg.plan
        self.verify_rung = verify_rung
        self.events: list[GovernorEvent] = []
        # serving flush windows are not verifier-comparable step seconds:
        # the re-search must select on fitness, not a median-derived
        # latency bound in the wrong unit domain
        reconfigurator.derive_requirement = False
        self._proto = reconfigurator
        self._monitors: dict = {}          # node -> Reconfigurator
        self._snapshots: dict = {}         # node -> {cell: (ws, s, count)}
        self._pending: dict = {}           # node -> _Pending
        self._verifier = None              # re-verification cache holder
        if verify_rung is not None:
            from repro_torch.core.backends import BACKENDS
            if verify_rung not in BACKENDS:
                raise ValueError(f"unknown verify rung {verify_rung!r}; "
                                 f"registered: {sorted(BACKENDS)}")
            self._verifier = reconfigurator.make_verifier()
            if verify_rung == "measured":
                resolve_device(getattr(
                    self._verifier.backend(verify_rung), "device", None))

    # -- monitors ------------------------------------------------------------

    def monitor(self, node: str):
        """The node's own Reconfigurator (the prototype serves the node it
        was built for; other nodes get clones with their own history)."""
        if node not in self._monitors:
            self._monitors[node] = self._proto \
                if self._proto.node == node else self._proto.for_node(node)
        return self._monitors[node]

    # -- measurement ingestion -----------------------------------------------

    def flush(self, meter: DecodeEnergyMeter, step: int,
              node: Optional[str] = None,
              govern: bool = True) -> Optional[_Pending]:
        """Drain the meter's un-flushed energy into the fleet ledger and
        feed the window into the node's drift monitor.  Returns the newly
        parked pending migration, if this flush tripped one.

        ``govern=False`` books the energy without judging drift — for
        run-end drains whose partial tail window would otherwise pollute
        the rolling median (and whose trigger no checkpoint could ever
        apply)."""
        node = node or getattr(meter, "node", DEFAULT_NODE)
        snap = self._snapshots.setdefault(node, {})
        window_ws, window_s = drain_delta(meter.ledger, self.ledger, snap,
                                          node,
                                          phases=self.policy.drift_phases)
        tr = obs.TRACER
        if tr.enabled:
            tr.instant("governor.flush", node=node, t=meter.now,
                       tags={"step": step, "window_ws": window_ws,
                             "window_s": window_s, "govern": govern})
        if (window_s <= 0 and window_ws <= 0) or not govern:
            return None
        new_plan = self.monitor(node).observe(step, window_s, self.plan,
                                              energy_ws=window_ws)
        if new_plan is not None:
            ev = self.monitor(node).events[-1]
            self._pending[node] = _Pending(detected_step=step, node=node,
                                           drift_ratio=ev["drift_ratio"],
                                           window_ws=window_ws,
                                           median_ws=ev["median_ws"],
                                           plan=new_plan)
            return self._pending[node]
        return None

    # -- checkpoint boundary -------------------------------------------------

    @property
    def pending(self) -> Optional[_Pending]:
        """The most recently parked pending migration (None when empty);
        every parked node is applied at the next checkpoint."""
        if not self._pending:
            return None
        return next(reversed(list(self._pending.values())))

    def _reverify(self, pending: _Pending) -> str:
        """Re-measure the pending plan and the incumbent on the verify
        rung; returns "" when the migration is confirmed, else the
        rejection reason.  One verifier lives for the governor's lifetime,
        so its per-(plan, rung) cache keeps an unchanged incumbent from
        being re-lowered at every checkpoint that parks a migration."""
        from repro_torch.core.backends import confirms_preference
        if self._verifier is None:
            self._verifier = self.monitor(pending.node).make_verifier()
        v = self._verifier
        m_new = v.measure_plan(pending.plan, rung=self.verify_rung)
        m_old = v.measure_plan(self.plan, rung=self.verify_rung)
        if confirms_preference(m_new, m_old):
            return ""
        if not m_new.ok:
            return (f"{self.verify_rung} rung penalized the new plan: "
                    f"{m_new.error}")
        return (f"{self.verify_rung} rung disagrees with the analytic "
                f"estimate: new fitness {m_new.fitness():.4f} < incumbent "
                f"{m_old.fitness():.4f}")

    def checkpoint(self, step: int):
        """Judge every pending migration (one event per drifted node):
        re-verify it on ``verify_rung`` when configured, then apply or
        reject.  Returns the new plan when any was applied (the caller
        re-jits + restores there), else None."""
        if not self._pending:
            return None
        parked, self._pending = self._pending, {}
        applied = None
        for p in parked.values():
            reason = self._reverify(p) if self.verify_rung else ""
            self.events.append(GovernorEvent(
                step=step, detected_step=p.detected_step, node=p.node,
                drift_ratio=p.drift_ratio, window_ws=p.window_ws,
                median_ws=p.median_ws,
                old_plan=self.plan.describe(), new_plan=p.plan.describe(),
                applied=not reason, verify_rung=self.verify_rung or "",
                reject_reason=reason))
            tr = obs.TRACER
            if tr.enabled:
                tr.instant("governor.migrate", node=p.node,
                           tags={"step": step, "applied": not reason,
                                 "drift_ratio": p.drift_ratio,
                                 "reject_reason": reason[:80]})
            if reason:
                continue                # the real trial vetoed the estimate
            self.plan = p.plan
            applied = p.plan
        return applied

    # -- the single serving hook ---------------------------------------------

    def tick(self, meter: DecodeEnergyMeter, step: int,
             node: Optional[str] = None):
        """Call once per serve step; applies both cadences.  Returns the
        new plan when this step's checkpoint applied a migration."""
        if step % self.policy.flush_every == 0:
            self.flush(meter, step, node=node)
        if step % self.policy.checkpoint_every == 0:
            return self.checkpoint(step)
        return None

    # -- reporting -----------------------------------------------------------

    def summary(self) -> dict:
        return {"plan": self.plan.describe(),
                "total_ws": self.ledger.total_ws,
                "nodes": {n: pe.ws
                          for n, pe in self.ledger.rollup("node").items()},
                "tenants": {t: pe.ws
                            for t, pe in
                            self.ledger.rollup("tenant").items()},
                "events": [e.to_dict() for e in self.events]}
