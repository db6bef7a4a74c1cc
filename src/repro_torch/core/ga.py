"""Genetic algorithm over execution plans (paper §3.1, power-aware).

Copy of ``repro.core.ga``.

Elitist GA with tournament selection, uniform crossover and per-gene
mutation.  The fitness is the paper's (time)^-1/2 * (power)^-1/2; setting
beta=0 recovers the previous papers' time-only search (the ablation
benchmarks compare the two).  Patterns are measured in the verification
environment (Verifier) on its *search* rung — the cheap analytic backend,
the inner-loop tier of the measurement-rung ladder; the narrowed winners
are promoted to the measured rung afterwards (see ``repro_torch.core.
destinations``).  Repeated patterns hit the cache, exactly as the paper
re-measures only unseen genes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import PlanGenome
from repro_torch.core.verifier import Measurement, Verifier


@dataclass
class GAConfig:
    population: int = 8
    generations: int = 6
    elites: int = 2
    tournament: int = 3
    mutation_rate: float = 0.15
    alpha: float = 0.5           # time exponent
    beta: float = 0.5            # power exponent (0 => time-only baseline)
    seed: int = 0


@dataclass
class GAResult:
    best: PlanGenome
    best_measurement: Measurement
    history: list = field(default_factory=list)
    n_trials: int = 0

    def summary(self) -> str:
        m = self.best_measurement
        return (f"best fitness={m.fitness():.4f} t={m.seconds*1e3:.2f}ms "
                f"W/chip={m.watts:.0f} E={m.energy_j:.1f}J "
                f"({self.n_trials} verification trials)\n"
                f"plan: {self.best.describe()}")


def run_ga(cfg: ArchConfig, kind: str, verifier: Verifier,
           ga: GAConfig = GAConfig(),
           seed_plans: Optional[list] = None,
           log: Optional[Callable[[str], None]] = None) -> GAResult:
    rng = np.random.default_rng(ga.seed)
    pop: list[PlanGenome] = []
    # seed with the arch's default plan (the incumbent) + any extras
    pop.append(PlanGenome.from_plan(cfg, kind, cfg.plan))
    for p in seed_plans or []:
        pop.append(PlanGenome.from_plan(cfg, kind, p))
    while len(pop) < ga.population:
        pop.append(PlanGenome.random(cfg, kind, rng))
    pop = pop[:ga.population]

    def fit(m: Measurement) -> float:
        return m.fitness(ga.alpha, ga.beta)

    rung = verifier.rungs.search      # the GA inner loop's cheap tier
    history = []
    best: PlanGenome = pop[0]
    best_m: Measurement = verifier.measure(best, rung=rung)

    for gen in range(ga.generations):
        scored = []
        for g in pop:
            m = verifier.measure(g, rung=rung)
            scored.append((fit(m), g, m))
        scored.sort(key=lambda x: -x[0])
        if scored[0][0] > fit(best_m):
            _, best, best_m = scored[0]
        gen_stats = {
            "gen": gen,
            "best_fitness": scored[0][0],
            "mean_fitness": float(np.mean([s[0] for s in scored])),
            "best_seconds": scored[0][2].seconds,
            "best_watts": scored[0][2].watts,
            "best_energy_j": scored[0][2].energy_j,
            "best_plan": scored[0][1].describe(),
        }
        history.append(gen_stats)
        if log:
            log(f"gen {gen}: best={gen_stats['best_fitness']:.4f} "
                f"t={gen_stats['best_seconds']*1e3:.2f}ms "
                f"W={gen_stats['best_watts']:.0f}")

        # next generation: elites + tournament offspring
        nxt = [s[1] for s in scored[:ga.elites]]
        while len(nxt) < ga.population:
            def pick():
                idx = rng.integers(len(scored), size=ga.tournament)
                return max((scored[i] for i in idx), key=lambda s: s[0])[1]
            child = pick().crossover(pick(), rng)
            nxt.append(child.mutate(rng, ga.mutation_rate))
        pop = nxt

    return GAResult(best=best, best_measurement=best_m, history=history,
                    n_trials=verifier.n_trials)
