"""The environment-adaptive flow (paper Fig. 1) on one card.

Counterpart of ``repro.core.adapt``, Steps 1-3, 6 and 7:

  Step 1  Code analysis                -> site census (intensity/loop counts)
  Step 2  Offloadable-part extraction  -> plan genome space for the arch
  Step 3  Search for suitable parts    -> staged destination search
                                          (GA + narrowing, §3.1-3.3)
  Step 4  Resource-amount adjustment   -> one card: ``chips = 1``
  Step 5  Placement-location adjustment-> one card: no multi-pod placement
  Step 6  Execution-file placement +   -> the smoke trial of the chosen plan
          operation verification          on ``rungs.smoke`` (the measured
                                          rung: a real run on the card),
                                          reused from the search when a
                                          finalist ran on that rung
  Step 7  In-operation reconfiguration -> ``Reconfigurator``: a runtime
                                          monitor that re-searches when
                                          the measured step energy drifts
                                          (the serving side is
                                          ``telemetry.governor``)

Steps 4-5 at pod scale (slices of 64-512 chips) come with the sharding
slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.configs.base import ArchConfig, PlanConfig, get_shape
from repro_torch.core.destinations import Requirement, SelectionLog, \
    select_destination
from repro_torch.core.ga import GAConfig
from repro_torch.core.intensity import site_census
from repro_torch.core.plan import PlanGenome
from repro_torch.core.power import H100
from repro_torch.core.verifier import RungPolicy, Verifier
from repro_torch.telemetry.dvfs import envelope_for
from repro_torch.telemetry.energy import EnergyLedger


# ---------------------------------------------------------------------------
# Step 7 — in-operation reconfiguration
# ---------------------------------------------------------------------------

@dataclass
class ReconfigPolicy:
    degrade_factor: float = 1.5     # re-search when step energy drifts 1.5x
    window: int = 16                # rolling baseline
    cooldown_steps: int = 64        # min distance between reconfigs


@dataclass
class Reconfigurator:
    """Runtime monitor: books each step into an ``EnergyLedger``; when the
    step's Watt*seconds drift past the rolling median by the policy factor
    (data drift, failing card, thermal throttle...), re-runs the offload
    search and emits a new plan.  Energy is the trigger — a throttled card
    that holds step time but burns boost watts still trips it — and when
    the caller has no power meter, step energy defaults to
    ``seconds x nominal_watts`` (the H100 envelope's active point unless
    given) so pure time degradation drifts the ledger identically.

    The caller swaps the plan at a checkpoint boundary (rebuild the model
    under the new plan on the same weights): reconfiguration is a
    checkpointed plan migration, not a live mutation.

    ``derive_requirement`` controls the re-search's latency bound: when
    True (``observe`` receives verifier-comparable per-step seconds) the
    search must beat the rolling median step time; set it False when the
    observed seconds live in another unit domain than the verifier's
    (e.g. serving flush windows) — the search then selects purely on the
    power-aware fitness.

    The re-search runs on the verifier's *search* rung (one card,
    analytic, unless ``verifier_factory`` says otherwise); the governor
    that parks the resulting plan as a pending migration may re-verify it
    on the measured rung before applying it (``rungs.governor``) — see
    ``repro_torch.telemetry.governor.PowerGovernor``.
    """
    cfg: ArchConfig
    shape_name: str
    policy: ReconfigPolicy = field(default_factory=ReconfigPolicy)
    ga: GAConfig = field(default_factory=lambda: GAConfig(population=6,
                                                          generations=3))
    verifier_factory: Optional[Callable] = None
    ledger: EnergyLedger = field(default_factory=EnergyLedger)
    nominal_watts: float = 0.0      # fallback W for un-metered steps
    node: str = "node0"             # which serving node this monitor watches
    derive_requirement: bool = True
    events: list = field(default_factory=list)
    _last_reconfig: int = -10**9

    def __post_init__(self) -> None:
        self.ledger.window = self.policy.window
        if self.nominal_watts <= 0:
            self.nominal_watts = envelope_for(H100).p_active

    def make_verifier(self) -> Verifier:
        """The verification environment this monitor re-searches in (and
        the governor re-verifies pending migrations with): one card,
        analytic, unless ``verifier_factory`` builds another."""
        if self.verifier_factory is not None:
            return self.verifier_factory()
        return Verifier(self.cfg, self.shape_name, mode="analytic")

    def for_node(self, node: str) -> "Reconfigurator":
        """A fresh monitor for another serving node: same arch/policy/search
        config, but its own rolling window, cooldown and event log — drift
        is judged against the node's own history, not the fleet's."""
        return Reconfigurator(self.cfg, self.shape_name, policy=self.policy,
                              ga=self.ga,
                              verifier_factory=self.verifier_factory,
                              nominal_watts=self.nominal_watts, node=node,
                              derive_requirement=self.derive_requirement)

    def observe(self, step: int, seconds: float,
                current_plan: PlanConfig,
                energy_ws: Optional[float] = None) -> Optional[PlanConfig]:
        """Returns a new plan when reconfiguration triggers, else None."""
        if energy_ws is None:
            energy_ws = seconds * self.nominal_watts
        med_s = self.ledger.median_step_seconds()
        med_ws = self.ledger.median_step_ws()
        ratio = self.ledger.drift_ratio(energy_ws)
        self.ledger.record_step(seconds, energy_ws)
        if ratio is None or ratio <= self.policy.degrade_factor:
            return None
        if step - self._last_reconfig < self.policy.cooldown_steps:
            return None
        self._last_reconfig = step
        v = self.make_verifier()
        shape = get_shape(self.shape_name)
        req = Requirement(max_seconds=med_s) \
            if self.derive_requirement and med_s is not None else None
        sel = select_destination(self.cfg, shape.kind, v, req, self.ga)
        new_plan = sel.chosen.genome.to_plan()
        self.events.append({"step": step, "node": self.node,
                            "seconds": seconds,
                            "median": med_s,
                            "energy_ws": energy_ws,
                            "median_ws": med_ws,
                            "drift_ratio": ratio,
                            "new_plan": new_plan.describe(),
                            "stage": sel.chosen.name})
        self.ledger.reset_steps()
        return new_plan


# ---------------------------------------------------------------------------
# The whole flow (Fig. 1)
# ---------------------------------------------------------------------------


@dataclass
class AdaptationReport:
    census: list = field(default_factory=list)          # step 1
    genes: list = field(default_factory=list)           # step 2
    selection: Optional[SelectionLog] = None            # step 3
    slices: list = field(default_factory=list)          # step 4
    placement: dict = field(default_factory=dict)       # step 5
    verified: Optional[dict] = None                     # step 6
    reconfigurator: Optional[Reconfigurator] = None     # step 7
    plan: Optional[PlanConfig] = None
    chips: int = 0

    def summary(self) -> str:
        chosen = self.selection.chosen if self.selection else None
        if chosen is None:
            return "incomplete"
        m = chosen.measurement
        return (f"sites={len(self.census)} genes={len(self.genes)} "
                f"stage={chosen.name} chips={self.chips} "
                f"pods={self.placement.get('pods')} "
                f"t={m.seconds*1e3:.1f}ms W={m.watts:.1f} "
                f"[{m.source}]")


def adapt(cfg: ArchConfig, shape_name: str,
          requirement: Optional[Requirement] = None,
          ga: GAConfig = GAConfig(population=8, generations=4),
          verify: bool = False,
          rungs: Optional[RungPolicy] = None,
          backends: Optional[dict] = None,
          log: Optional[Callable[[str], None]] = None) -> AdaptationReport:
    """Run Steps 1-3, 6 and 7 for (arch, shape) on one card.

    ``rungs`` selects the measurement rung per consumer (see
    ``repro_torch.core.verifier.RungPolicy``): Step 3's GA searches on
    ``rungs.search``, its narrowed finalists are promoted to
    ``rungs.finalist``, and Step 6's smoke trial runs on ``rungs.smoke``,
    entered only when ``verify=True``.  ``backends`` maps a rung to its
    backend instance (e.g. a ``MeasuredBackend`` holding loaded weights);
    Steps 3 and 6 share them.  The returned reconfigurator re-searches on
    the same ladder, with the same backends."""
    rep = AdaptationReport()
    shape = get_shape(shape_name)
    rungs = rungs or RungPolicy()
    backends = backends if backends is not None else {}

    # 1: code analysis
    rep.census = [dataclasses.asdict(s) for s in site_census(cfg, shape)]
    if log:
        log(f"step 1: {len(rep.census)} sites")
    # 2: offloadable-part extraction
    rep.genes = PlanGenome.gene_names(cfg, shape.kind)
    if log:
        log(f"step 2: genes = {rep.genes}")
    # 3: search (staged destinations incl. GA + narrowing), explicit rungs
    v = Verifier(cfg, shape_name, mode=rungs.search, rungs=rungs,
                 backends=backends)
    rep.selection = select_destination(cfg, shape.kind, v, requirement, ga,
                                       log=log)
    rep.plan = rep.selection.chosen.genome.to_plan()
    # 4-5: one card
    rep.chips = 1
    rep.placement = {"pods": 1, "multi_pod": False,
                     "note": "one card: no slice or pod placement"}
    # 6: operation verification.  The reference re-measures the chosen
    # plan here because Step 4 moved it to another chip count; on one card
    # that count is the search's own, so the search's verifier answers: a
    # finalist already tried on the smoke rung is not run again
    if verify:
        m6 = v.measure(rep.selection.chosen.genome, rung=rungs.smoke)
        trace = m6.trace
        rep.verified = {"status": "OK" if m6.ok else "FAIL",
                        "rung": rungs.smoke,
                        "seconds": m6.seconds,
                        "watts": m6.watts,
                        "energy_ws": m6.energy_j,
                        "utilization": m6.utilization,
                        "launches": dict(trace.meta.get("launches", {}))
                        if trace is not None else {},
                        "error": m6.error}
        if log:
            log(f"step 6 [{rungs.smoke}]: "
                f"{'OK' if m6.ok else 'FAIL ' + m6.error[:60]}")
    # 7: hand back the runtime reconfigurator (same verification ladder)
    rep.reconfigurator = Reconfigurator(
        cfg, shape_name,
        verifier_factory=lambda: Verifier(cfg, shape_name, mode=rungs.search,
                                          rungs=rungs,
                                          backends=dict(backends)))
    return rep
