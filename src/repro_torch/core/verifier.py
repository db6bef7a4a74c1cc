"""Verification environment — a thin cache over the measurement rungs.

Counterpart of ``repro.core.verifier``.  The paper measures each offload
pattern on a real verification machine (3-minute timeout -> 1000 s
penalty), and re-measures only *new* patterns.  ``Verifier`` is exactly
that: a per-(pattern, rung) cache in front of the backend layer
(``repro_torch.core.backends``), plus the *promotion rules* that say which
consumer measures on which rung:

  * the GA inner loop burns thousands of trials -> ``rungs.search``
    (analytic, milliseconds per pattern);
  * the narrowed finalists of Step 3 earn a real trial -> ``rungs.
    finalist`` (measured on the card in production);
  * the Step-6 smoke and the governor's migration re-verification are
    single expensive trials -> ``rungs.smoke`` / ``rungs.governor``, the
    measured rung by default.

Passing ``rung=`` to ``measure``/``measure_plan`` overrides the default
for one call; ``backends`` overrides a rung's backend instance (tests
inject stubs or replay recordings there).  Everything expensive about a
rung lives in its backend — the Verifier itself only caches, counts
trials, and routes.

Cached *penalties* are not forever: a measured trial can fail transiently
(an out-of-memory on a card another process shares, a timeout on a loaded
host), and a penalty cached for the verifier's lifetime would permanently
skew every consumer that re-reads it.  ``PenaltyPolicy`` gives such
penalties a retry budget and an optional wall-clock TTL; analytic
penalties (OOM, bad plan) are deterministic and stay cached — retrying
them only burns trials.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.configs.base import ArchConfig, PlanConfig, get_shape
from repro_torch.core.backends import (MeasureContext,  # noqa: F401
                                       Measurement, MeasurementBackend,
                                       make_backend, penalty_measurement,
                                       plan_tag)
from repro_torch.core.fitness import TIMEOUT_SECONDS
from repro_torch.core.plan import PlanGenome
from repro_torch.core.power import H100, PowerModel


@dataclass(frozen=True)
class RungPolicy:
    """Promotion rules: which rung each consumer role measures on.

    The defaults promote only the explicitly-heavy paths: searches stay
    analytic (tests and the GA inner loop must stay milliseconds-cheap),
    while Step 6's operation verification and the governor's migration
    gate — both single, opt-in trials — run on the card.  Production flows
    that can afford a trial per finalist set ``finalist="measured"`` too.
    """
    search: str = "analytic"       # GA inner loop + stage-1/2 selection
    finalist: str = "analytic"     # Step-3 narrowed finalists
    smoke: str = "measured"        # Step-6 operation verification
    governor: str = "measured"     # Step-7 migration re-verification


#: the full paper ladder: cheap estimates inside the search, real
#: measurements for everything that survives the narrowing
PRODUCTION_RUNGS = RungPolicy(finalist="measured")


@dataclass(frozen=True)
class PenaltyPolicy:
    """Lifetime of a cached penalty ``Measurement``.

    A penalty on one of ``rungs`` is re-measured on a later cache lookup
    while its ``retries`` budget lasts; once the budget is spent it stays
    cached — unless ``ttl_s`` is set, in which case the penalty also
    expires after that many wall-clock seconds (without consuming the
    budget), so a long-lived verifier eventually re-tests a plan whose
    environment may have healed.  Rungs outside ``rungs`` (the analytic
    estimate) keep today's measure-once behaviour: their penalties are
    deterministic, and the GA's trial accounting
    (``n_trials == len(cache)``) depends on it.
    """
    retries: int = 1
    ttl_s: float = 0.0          # 0 = no time-based expiry
    rungs: tuple = ("measured", "replay")

    def applies(self, rung: str) -> bool:
        return rung in self.rungs


@dataclass
class Verifier:
    cfg: ArchConfig
    shape_name: str
    n_chips: int = 1
    tp: int = 1
    mode: str = "analytic"              # default rung for measure()
    power: PowerModel = field(default_factory=lambda: PowerModel(H100))
    timeout_s: float = TIMEOUT_SECONDS
    overlap: float = 0.0                # collective/compute overlap fraction
    cache: dict = field(default_factory=dict)
    n_trials: int = 0                   # actual (non-cache) measurements
    rungs: RungPolicy = field(default_factory=RungPolicy)
    backends: dict = field(default_factory=dict)   # rung -> backend override
    penalties: PenaltyPolicy = field(default_factory=PenaltyPolicy)
    clock: Callable[[], float] = time.monotonic    # TTL time base
    # (plan, rung) key -> (retries left, clock stamp of the last penalty)
    _penalty_meta: dict = field(default_factory=dict)

    @property
    def shape(self):
        return get_shape(self.shape_name)

    @property
    def context(self) -> MeasureContext:
        return MeasureContext(cfg=self.cfg, shape_name=self.shape_name,
                              n_chips=self.n_chips, tp=self.tp,
                              power=self.power, overlap=self.overlap,
                              timeout_s=self.timeout_s)

    # ------------------------------------------------------------------

    def backend(self, rung: Optional[str] = None) -> MeasurementBackend:
        """The backend measuring a rung (lazily built from the registry;
        pre-seeded entries in ``backends`` — stubs, replays — win)."""
        rung = rung or self.mode
        if rung not in self.backends:
            self.backends[rung] = make_backend(rung)
        return self.backends[rung]

    def _penalty_expired(self, key: tuple, rung: str,
                         m: Measurement) -> bool:
        """True when a cached penalty should be re-measured."""
        if m.ok or not self.penalties.applies(rung):
            return False
        left, stamp = self._penalty_meta.get(
            key, (self.penalties.retries, self.clock()))
        if left > 0:
            return True
        return self.penalties.ttl_s > 0 \
            and self.clock() - stamp >= self.penalties.ttl_s

    def _measure_cached(self, key: tuple, rung: str,
                        plan: PlanConfig) -> Measurement:
        cached = self.cache.get(key)
        if cached is not None and not self._penalty_expired(key, rung,
                                                            cached):
            return cached
        self.n_trials += 1
        m = self.backend(rung).measure(self.context, plan)
        self.cache[key] = m
        if m.ok:
            self._penalty_meta.pop(key, None)
        elif self.penalties.applies(rung):
            if cached is not None and not cached.ok:
                # a retry that failed again consumes one from the budget
                left, _ = self._penalty_meta.get(
                    key, (self.penalties.retries, 0.0))
                self._penalty_meta[key] = (max(left - 1, 0), self.clock())
            else:
                self._penalty_meta[key] = (self.penalties.retries,
                                           self.clock())
        return m

    def measure(self, genome: PlanGenome,
                rung: Optional[str] = None) -> Measurement:
        rung = rung or self.mode
        return self._measure_cached((genome.key(), rung), rung,
                                    genome.to_plan())

    def measure_plan(self, plan: PlanConfig, kind: Optional[str] = None,
                     rung: Optional[str] = None) -> Measurement:
        """Measure an exact plan (no snapping to the gene alphabet)."""
        del kind                        # kept for callers' back-compat
        rung = rung or self.mode
        return self._measure_cached(("plan", plan_tag(plan), rung), rung,
                                    plan)
