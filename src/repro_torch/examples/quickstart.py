"""Quickstart: power-aware automatic offload search on qwen2-7b.

    python -m repro_torch.examples.quickstart

Counterpart of the repo's ``examples/quickstart.py``, on the port's
``core/`` and its H100 spec:

1. Builds qwen2-7b's execution-plan search space (the paper's genome).
2. Runs the GA against the analytic verification environment (a pod of
   256 chips, 16-way model axis, as the reference's) with the paper's
   (time)^-1/2 (power)^-1/2 fitness.
3. Prints the chosen plan vs the incumbent: seconds, watts, Watt*seconds.

Does no device work: the analytic rung is the roofline estimate.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs import get_config
from repro_torch.core.ga import GAConfig, run_ga
from repro_torch.core.plan import PlanGenome
from repro_torch.core.power import H100
from repro_torch.core.verifier import Verifier
from repro_torch.launch.mesh import POD_SHAPE

CHIPS = 256


def run(log: Callable[[str], None] = print) -> dict:
    """The search on the verifier's spec (``core.power.H100``); returns
    the incumbent's and the GA's measurements and the GA's result."""
    cfg = get_config("qwen2-7b")
    verifier = Verifier(cfg, "train_4k", n_chips=CHIPS, tp=POD_SHAPE[1],
                        mode="analytic")

    incumbent = PlanGenome.from_plan(cfg, "train", cfg.plan)
    m0 = verifier.measure(incumbent)
    log(f"incumbent plan: t={m0.seconds*1e3:.1f} ms  "
        f"{m0.watts:.0f} W/chip  {m0.energy_j:.0f} J/step")

    res = run_ga(cfg, "train", verifier,
                 GAConfig(population=10, generations=8, seed=0), log=log)
    m = res.best_measurement
    log("\n== GA result ==")
    log(res.summary())
    log(f"\nspeedup: {m0.seconds/m.seconds:.2f}x   "
        f"energy: {m0.energy_j:.0f} J -> {m.energy_j:.0f} J "
        f"({m0.energy_j/m.energy_j:.2f}x lower)")
    return {"incumbent": m0, "best": m, "result": res}


def main() -> None:
    print(f"spec: {H100.name} (analytic rung, {CHIPS} chips)")
    run()


if __name__ == "__main__":
    main()
