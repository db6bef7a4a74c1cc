"""The environment-adaptive flow (paper Fig. 1), on one card or pod slices.

Counterpart of ``repro.core.adapt``:

  Step 1  Code analysis                -> site census (intensity/loop counts)
  Step 2  Offloadable-part extraction  -> plan genome space for the arch
  Step 3  Search for suitable parts    -> staged destination search
                                          (GA + narrowing, §3.1-3.3)
  Step 4  Resource-amount adjustment   -> one card: ``chips = 1``; given
                                          pod ``slices``, chip-slice sizing
                                          under the §3.3 cost model
                                          (``adjust_resources``)
  Step 5  Placement-location adjustment-> one card: no pod; given slices,
                                          single-pod vs multi-pod mesh
                                          (``adjust_placement``)
  Step 6  Execution-file placement +   -> the smoke trial of the chosen plan:
          operation verification          on one card on ``rungs.smoke``
                                          (the measured rung: a real run on
                                          the card), reused from the search
                                          when a finalist ran on that rung;
                                          on a slice, the compiled rung (the
                                          pod dry run) on the Step-5 mesh
  Step 7  In-operation reconfiguration -> ``Reconfigurator``: a runtime
                                          monitor that re-searches when
                                          the measured step energy drifts
                                          (the serving side is
                                          ``telemetry.governor``)

Steps 4-5 use the paper's cost framing: "initial cost such as hardware...
is 1/3 of the total cost, the operation cost such as power and maintenance
is 1/3" — so the objective blends chip-hours and energy, with rates the
operator sets (§3.3: "the evaluation formula needs to be set differently
for each business operator").  ``CostModel`` has no default rates: the
port carries no price of its own, so a caller that asks for pod slices
names them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.configs.base import ArchConfig, PlanConfig, get_shape
from repro_torch.core.destinations import Requirement, SelectionLog, \
    select_destination
from repro_torch.core.ga import GAConfig
from repro_torch.core.intensity import site_census
from repro_torch.core.plan import PlanGenome
from repro_torch.core.power import H100
from repro_torch.core.verifier import Measurement, RungPolicy, Verifier
from repro_torch.telemetry.dvfs import envelope_for
from repro_torch.telemetry.energy import EnergyLedger


# ---------------------------------------------------------------------------
# Step 4 — resource-amount adjustment (§3.3 cost structure)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CostModel:
    """Per-step cost in the operator's currency units.

    hw_rate: chip-seconds price (amortized hardware+development, the
    paper's 'initial cost' third); energy_rate: per-joule price (the
    'operation cost' third); fixed_rate: the 'other cost' third, per
    step.  The operator sets both rates; there are no defaults.
    """
    hw_rate: float                         # per chip-second
    energy_rate: float                     # per joule
    fixed_rate: float = 0.0                # per step

    def step_cost(self, m: Measurement, chips: int) -> float:
        return (self.hw_rate * chips * m.seconds
                + self.energy_rate * m.energy_j
                + self.fixed_rate)


@dataclass
class SliceChoice:
    chips: int
    measurement: Measurement
    cost: float
    tokens_per_cost: float


def adjust_resources(cfg: ArchConfig, shape_name: str, plan: PlanConfig,
                     slices: tuple[int, ...], cost: CostModel,
                     requirement: Optional[Requirement] = None,
                     verifier_factory: Optional[Callable] = None
                     ) -> list[SliceChoice]:
    """Measure the plan on several slice sizes; rank by cost efficiency.

    Each slice is measured on the analytic rung, with a pod's model axis
    (``launch.mesh.POD_SHAPE``: 16-way), unless ``verifier_factory(chips)``
    builds another verifier.  Returns choices
    sorted best-first (satisfying the requirement first, then lowest cost
    per step).
    """
    shape = get_shape(shape_name)
    out: list[SliceChoice] = []
    for chips in slices:
        v = (verifier_factory(chips) if verifier_factory
             else Verifier(cfg, shape_name, n_chips=chips, tp=_pod_tp(),
                           mode="analytic"))
        m = v.measure_plan(plan, shape.kind)
        c = cost.step_cost(m, chips)
        tokens = shape.tokens if shape.kind != "decode" else \
            shape.global_batch
        out.append(SliceChoice(chips, m, c,
                               tokens / c if c > 0 else 0.0))

    def key(s: SliceChoice):
        ok = s.measurement.ok and (requirement is None
                                   or requirement.satisfied(s.measurement))
        return (not ok, s.cost)

    out.sort(key=key)
    return out


# ---------------------------------------------------------------------------
# Step 5 — placement-location adjustment
# ---------------------------------------------------------------------------

def _pod_tp() -> int:
    """A pod's model axis (``launch.mesh.POD_SHAPE``)."""
    from repro_torch.launch.mesh import POD_SHAPE
    return POD_SHAPE[1]


def adjust_placement(chips: int) -> dict:
    """Map the chosen slice onto pods of ``launch.mesh.POD_SHAPE`` (256
    chips): TP stays inside a pod; DP spans pods."""
    from repro_torch.launch.mesh import POD_SHAPE
    per_pod = math.prod(POD_SHAPE)
    pods = max(1, -(-chips // per_pod))
    return {"pods": pods,
            "mesh": ("pod", "data", "model") if pods > 1
            else ("data", "model"),
            "multi_pod": pods > 1,
            "note": "TP inside a pod; DP across pods"}


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
          log: Optional[Callable[[str], None]] = None,
          slices: Optional[tuple[int, ...]] = None,
          cost: Optional[CostModel] = None) -> AdaptationReport:
    """Run Steps 1-7 for (arch, shape): on one card (``chips = 1``), or,
    given pod ``slices`` and their ``cost`` model, with Steps 4-5 at pod
    scale.

    Given slices, the search runs at one pod's chips and model axis (as
    the reference's),
    Step 4 ranks the slices by ``adjust_resources`` and Step 5 places the
    best on one pod or two; Step 6's smoke trial then runs on the compiled
    rung (the pod dry run, on the Step-5 mesh), whatever ``rungs.smoke``
    says: a slice is larger than the card the measured rung runs on.

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
    if slices and cost is None:
        raise ValueError("pod slices need the operator's CostModel")
    n_search, tp = 1, 1
    if slices:
        from repro_torch.launch.mesh import POD_SHAPE
        n_search, tp = math.prod(POD_SHAPE), _pod_tp()

    # 1: code analysis
    rep.census = [dataclasses.asdict(s) for s in site_census(cfg, shape)]
    if log:
        log(f"step 1: {len(rep.census)} sites")
    # 2: offloadable-part extraction
    rep.genes = PlanGenome.gene_names(cfg, shape.kind)
    if log:
        log(f"step 2: genes = {rep.genes}")
    # 3: search (staged destinations incl. GA + narrowing), explicit rungs
    v = Verifier(cfg, shape_name, n_chips=n_search, tp=tp,
                 mode=rungs.search, rungs=rungs, backends=backends)
    rep.selection = select_destination(cfg, shape.kind, v, requirement, ga,
                                       log=log)
    rep.plan = rep.selection.chosen.genome.to_plan()
    if slices:
        # 4: resource-amount adjustment; 5: placement
        rep.slices = adjust_resources(cfg, shape_name, rep.plan, slices,
                                      cost, requirement)
        rep.chips = rep.slices[0].chips
        rep.placement = adjust_placement(rep.chips)
        if log:
            log("step 4: " + ", ".join(
                f"{s.chips}ch->{s.cost:.4f}/step" for s in rep.slices))
    else:
        # 4-5: one card
        rep.chips = 1
        rep.placement = {"pods": 1, "multi_pod": False,
                         "note": "one card: no slice or pod placement"}
    # 6: operation verification.  The reference re-measures the chosen
    # plan here because Step 4 moved it to another chip count; on one card
    # that count is the search's own, so the search's verifier answers: a
    # finalist already tried on the smoke rung is not run again
    if verify and slices:
        # a slice's smoke: the compiled rung on the Step-5 mesh
        from repro_torch.core.backends import CompiledBackend
        v6 = Verifier(cfg, shape_name, n_chips=rep.chips, tp=tp, rungs=rungs,
                      backends={"compiled": backends.get(
                          "compiled", CompiledBackend(
                              multi_pod=rep.placement["multi_pod"]))})
        m6 = v6.measure_plan(rep.plan, shape.kind, rung="compiled")
        rep.verified = {"status": "OK" if m6.ok else "FAIL",
                        "rung": "compiled",
                        "seconds": m6.seconds,
                        "watts": m6.watts,
                        "energy_ws": m6.energy_j,
                        "utilization": m6.utilization,
                        "error": m6.error}
        if log:
            log(f"step 6 [compiled]: "
                f"{'OK' if m6.ok else 'FAIL ' + m6.error[:60]}")
    elif verify:
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
        verifier_factory=lambda: Verifier(cfg, shape_name, n_chips=n_search,
                                          tp=tp, mode=rungs.search,
                                          rungs=rungs,
                                          backends=dict(backends)))
    return rep
