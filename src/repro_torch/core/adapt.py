"""The environment-adaptive flow (paper Fig. 1) on one card.

Counterpart of ``repro.core.adapt``, Steps 1-3 and 6:

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

Steps 4-5 at pod scale (slices of 64-512 chips) come with the sharding
slice, Step 7's ``Reconfigurator`` with the serving governor (ROADMAP.md);
``AdaptationReport.reconfigurator`` stays None until then.
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
from repro_torch.core.verifier import RungPolicy, Verifier


@dataclass
class AdaptationReport:
    census: list = field(default_factory=list)          # step 1
    genes: list = field(default_factory=list)           # step 2
    selection: Optional[SelectionLog] = None            # step 3
    slices: list = field(default_factory=list)          # step 4
    placement: dict = field(default_factory=dict)       # step 5
    verified: Optional[dict] = None                     # step 6
    reconfigurator: Optional[object] = None             # step 7
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
    """Run Steps 1-3 and 6 for (arch, shape) on one card.

    ``rungs`` selects the measurement rung per consumer (see
    ``repro_torch.core.verifier.RungPolicy``): Step 3's GA searches on
    ``rungs.search``, its narrowed finalists are promoted to
    ``rungs.finalist``, and Step 6's smoke trial runs on ``rungs.smoke``,
    entered only when ``verify=True``.  ``backends`` maps a rung to its
    backend instance (e.g. a ``MeasuredBackend`` holding loaded weights);
    Steps 3 and 6 share them."""
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
    return rep
