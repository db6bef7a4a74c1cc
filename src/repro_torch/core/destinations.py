"""Mixed-environment offload-destination selection (paper §3.3).

Counterpart of ``repro.core.destinations``.  The paper orders verification
cheapest-first — many-core CPU, then GPU, then FPGA — and stops as soon as
a pattern satisfies the user requirement, because FPGA verification is
expensive.  On the card the ladder has the same cost asymmetry:

  1. xla_default   — the incumbent plan with stock ops (one measurement)
  2. xla_tuned     — GA over every gene, kernel destinations then clamped
                     back to stock ops: cheap trials, no kernel launches
  3. pallas        — narrowing (§3.2) + kernel-offload patterns: the
                     hand-written CUDA kernels ('pallas' keeps the
                     reference's name for the kernel destination)

All of stages 1-3 measure on the verifier's *search* rung (analytic:
milliseconds per pattern).  When the verifier's ``RungPolicy`` promotes
finalists (``rungs.finalist != rungs.search``), the survivors of stage 3
are then re-measured on the finalist rung — the measured trial on the card
— and the winner is picked among those real measurements; a finalist that
times out or runs out of memory on the higher rung penalties out of the
race no matter what the estimate promised.

The final selection uses the same (time)^-1/2 (power)^-1/2 value.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.ga import GAConfig, run_ga
from repro_torch.core.narrowing import narrow_candidates
from repro_torch.core.plan import GENES, PlanGenome
from repro_torch.core.verifier import Measurement, Verifier


@dataclass
class Requirement:
    """User SLO: a pattern 'sufficiently satisfies' it (paper wording)."""
    max_seconds: Optional[float] = None
    max_watts: Optional[float] = None

    def satisfied(self, m: Measurement) -> bool:
        if not m.ok:
            return False
        if self.max_seconds is not None and m.seconds > self.max_seconds:
            return False
        if self.max_watts is not None and m.watts > self.max_watts:
            return False
        return True


@dataclass
class Destination:
    name: str
    genome: PlanGenome
    measurement: Measurement
    stage: int


@dataclass
class SelectionLog:
    stages: list = field(default_factory=list)
    early_exit: Optional[str] = None
    chosen: Optional[Destination] = None


def _pallas_off(genome: PlanGenome) -> PlanGenome:
    """Clamp all kernel-destination genes to stock ops."""
    alleles = dict(genome.alleles)
    for g in ("attn_impl", "mlp_impl", "ssm_impl", "rglru_impl"):
        if g in alleles:
            vals = GENES[g][0]
            cur = vals[alleles[g]]
            if cur == "pallas":
                alleles[g] = vals.index("xla_chunked"
                                        if "xla_chunked" in vals else "xla")
    return PlanGenome(genome.cfg, genome.kind, alleles)


def select_destination(cfg: ArchConfig, kind: str, verifier: Verifier,
                       requirement: Optional[Requirement] = None,
                       ga: GAConfig = GAConfig(),
                       log=None, promote_top: int = 2) -> SelectionLog:
    out = SelectionLog()
    req = requirement or Requirement()
    search_rung = verifier.rungs.search

    def note(msg):
        if log:
            log(msg)

    # --- stage 1: incumbent plan, one cheap measurement ---------------------
    inc = PlanGenome.from_plan(cfg, kind, cfg.plan)
    inc = _pallas_off(inc)
    m1 = verifier.measure(inc, rung=search_rung)
    out.stages.append({"stage": "xla_default", "fitness": m1.fitness(),
                       "seconds": m1.seconds, "watts": m1.watts,
                       "trials": 1})
    note(f"stage 1 xla_default: t={m1.seconds*1e3:.2f}ms W={m1.watts:.0f}")
    best = Destination("xla_default", inc, m1, 1)
    if req.satisfied(m1):
        out.early_exit = "xla_default satisfied the requirement"
        out.chosen = best
        return out

    # --- stage 2: GA over stock-XLA genes (no kernel builds) ----------------
    t0 = verifier.n_trials
    res = run_ga(cfg, kind, verifier, ga)
    g2 = _pallas_off(res.best)
    m2 = verifier.measure(g2, rung=search_rung)
    out.stages.append({"stage": "xla_tuned", "fitness": m2.fitness(),
                       "seconds": m2.seconds, "watts": m2.watts,
                       "trials": verifier.n_trials - t0})
    note(f"stage 2 xla_tuned:   t={m2.seconds*1e3:.2f}ms W={m2.watts:.0f}")
    if m2.fitness() > best.measurement.fitness():
        best = Destination("xla_tuned", g2, m2, 2)
    if req.satisfied(m2):
        out.early_exit = "xla_tuned satisfied the requirement (skipping pallas)"
        out.chosen = best
        return out

    # --- stage 3: narrowing + Pallas kernel offload patterns ----------------
    t0 = verifier.n_trials
    rep = narrow_candidates(cfg, verifier.shape, best.genome.to_plan())
    note(f"stage 3 narrowing:   {rep.funnel()}")
    fallback = best                     # stage-1/2 winner (no kernels)
    stage3: list[Destination] = []
    for cand in rep.candidates:
        plan = dataclasses.replace(best.genome.to_plan(), **cand.overrides)
        g3 = PlanGenome.from_plan(cfg, kind, plan)
        m3 = verifier.measure(g3, rung=search_rung)
        note(f"  pallas[{cand.name}]: t={m3.seconds*1e3:.2f}ms "
             f"W={m3.watts:.0f} fit={m3.fitness():.4f}")
        stage3.append(Destination(f"pallas[{cand.name}]", g3, m3, 3))
        if m3.fitness() > best.measurement.fitness():
            best = stage3[-1]
    out.stages.append({"stage": "pallas", "fitness":
                       best.measurement.fitness(),
                       "seconds": best.measurement.seconds,
                       "watts": best.measurement.watts,
                       "trials": verifier.n_trials - t0})

    # --- finalist promotion: re-measure the survivors on the higher rung ----
    fin_rung = verifier.rungs.finalist
    if fin_rung != search_rung:
        t0 = verifier.n_trials
        stage3.sort(key=lambda d: -d.measurement.fitness())
        finalists = stage3[:max(promote_top, 0)]
        if all(f.name != best.name for f in finalists):
            finalists.append(best)      # the incumbent defends its title
        if all(f.name != fallback.name for f in finalists):
            # the stage-1/2 winner always competes on the real rung, so a
            # round where every kernel-offload finalist fails its trial can
            # still confirm the best stock-ops plan
            finalists.append(fallback)
        promoted: Optional[Destination] = None
        for f in finalists:
            mf = verifier.measure(f.genome, rung=fin_rung)
            note(f"  finalist[{f.name}] on {fin_rung}: "
                 f"t={mf.seconds*1e3:.2f}ms W={mf.watts:.0f} "
                 f"fit={mf.fitness():.4f}"
                 + ("" if mf.ok else f" PENALTY({mf.error[:40]})"))
            d = Destination(f.name, f.genome, mf, 3)
            if mf.ok and (promoted is None or mf.fitness()
                          > promoted.measurement.fitness()):
                promoted = d
        if promoted is not None:
            best = promoted
        else:
            # EVERY real trial failed (even the stock-ops fallback): keep
            # the search-rung best but say so — the stage stats must not
            # dress an analytic estimate up as a confirmed measurement
            note(f"  finalist[{fin_rung}]: no finalist survived the real "
                 f"trial; falling back to the UNCONFIRMED {best.name} "
                 f"estimate")
        out.stages.append({"stage": f"finalist[{fin_rung}]",
                           "confirmed": promoted is not None,
                           "fitness": best.measurement.fitness(),
                           "seconds": best.measurement.seconds,
                           "watts": best.measurement.watts,
                           "trials": verifier.n_trials - t0})
    out.chosen = best
    return out
