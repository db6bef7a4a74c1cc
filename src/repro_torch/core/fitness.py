"""The paper's evaluation value: (time)^-1/2 * (power)^-1/2.

Copy of ``repro.core.fitness``.

Higher is better; short time AND low power both raise it.  The exponents are
configurable "per business operator" (paper §3.3).  Trials that fail or blow
the verification timeout are penalized with time = 1000 s (paper §4.1:
"If the performance measurement does not complete in 3 minutes, a timeout is
issued, and processing time is set to 1,000 seconds").
"""
from __future__ import annotations


TIMEOUT_SECONDS = 180.0      # 3-minute verification timeout (paper §4.1)
TIMEOUT_PENALTY_S = 1000.0   # penalized processing time (paper §4.1)
PENALTY_WATTS = 1000.0       # penalized power for an unmeasured wattage


def fitness(seconds: float, watts: float,
            alpha: float = 0.5, beta: float = 0.5) -> float:
    """(Processing time)^-alpha * (Power consumption)^-beta.

    A missing (``None``) component is penalized *independently*: a run
    whose wattage was never measured books ``PENALTY_WATTS`` but keeps its
    real processing time, and vice-versa — one unmeasured axis must not
    clobber a valid measurement on the other.
    """
    if seconds is None:
        seconds = TIMEOUT_PENALTY_S
    if watts is None:
        watts = PENALTY_WATTS
    seconds = max(float(seconds), 1e-12)
    watts = max(float(watts), 1e-12)
    return seconds ** -alpha * watts ** -beta


def fitness_time_only(seconds: float, watts: float) -> float:
    """The previous papers' evaluation value (time only) — the baseline the
    power-aware fitness is compared against in the reference's benchmarks/bench_ga.py."""
    return fitness(seconds, watts, alpha=1.0, beta=0.0)
