"""The paper's Fig. 1 pipeline end to end — all seven steps on one arch.

    python -m repro_torch.examples.adapt_flow --hw-rate R --energy-rate E \
        [--arch qwen2-7b] [--shape train_4k] [--fixed-rate F]

Counterpart of the repo's ``examples/adapt_flow.py``, on the port's
``core/`` and its H100 spec.  Step 1 code analysis -> Step 2 offloadable
parts -> Step 3 staged search (GA + narrowing) -> Step 4 resource sizing
(§3.3 cost thirds) over pod slices of 64-512 chips -> Step 5 placement ->
Step 7 in-operation reconfiguration (a simulated slowdown triggers a
re-search).  Step 4's ``CostModel`` has no default rates: the operator
gives the price of a chip-second (``--hw-rate``) and of a joule
(``--energy-rate``), and optionally a fixed cost a step.

Does no device work: every step measures on the analytic rung.
"""
from __future__ import annotations

import argparse
from typing import Callable

from repro_torch.configs import get_config
from repro_torch.core.adapt import (CostModel, ReconfigPolicy, Reconfigurator,
                                    adapt)
from repro_torch.core.destinations import Requirement
from repro_torch.core.ga import GAConfig
from repro_torch.core.verifier import Verifier
from repro_torch.launch.mesh import POD_SHAPE

SLICES = (64, 128, 256, 512)
#: the chips Step 7's re-search runs on (the reference monitor's pod)
RESEARCH_CHIPS = 256


def run(arch: str, shape: str, cost: CostModel,
        log: Callable[[str], None] = print) -> dict:
    """Steps 1-5 and Step 7 for (arch, shape); returns the report and the
    reconfiguration's new plan (None when it took no action)."""
    cfg = get_config(arch)
    log(f"=== environment adaptation for {arch}/{shape} ===")
    rep = adapt(cfg, shape, requirement=Requirement(max_seconds=5.0),
                ga=GAConfig(population=6, generations=3, seed=0),
                slices=SLICES, cost=cost, log=lambda m: log("  " + m))
    log(f"\nstep 5: placement = {rep.placement}")
    log(f"chosen: {rep.chips} chips, plan = {rep.plan.describe()[:90]}...")
    best = rep.slices[0]
    log(f"step time {best.measurement.seconds*1e3:.1f} ms, "
        f"{best.measurement.watts:.0f} W/chip, "
        f"cost/step {best.cost:.5f}, "
        f"{best.tokens_per_cost:,.0f} tokens per cost unit")

    # step 7: simulate a mid-run slowdown (failing chip / thermal event)
    log("\n=== step 7: in-operation reconfiguration ===")
    r = Reconfigurator(cfg, shape,
                       policy=ReconfigPolicy(degrade_factor=1.5, window=4,
                                             cooldown_steps=0),
                       ga=GAConfig(population=4, generations=2, seed=1),
                       verifier_factory=lambda: Verifier(
                           cfg, shape, n_chips=RESEARCH_CHIPS,
                           tp=POD_SHAPE[1], mode="analytic"))
    t0 = best.measurement.seconds
    for step in range(4):
        r.observe(step, t0, rep.plan)
    log(f"  steps 0-3 healthy at {t0*1e3:.1f} ms")
    new_plan = r.observe(4, 3.0 * t0, rep.plan)
    log(f"  step 4 degraded to {3.0*t0*1e3:.1f} ms -> "
        f"{'reconfigured: ' + r.events[0]['stage'] if new_plan else 'no action'}")
    if new_plan:
        log("  new plan: " + new_plan.describe()[:90] + " ...")
        log("  (swap happens at the next checkpoint boundary — training "
            "rebuilds the model under the new plan and restores)")
    return {"report": rep, "new_plan": new_plan, "events": r.events}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--hw-rate", type=float, required=True,
                    help="price of one chip-second (Step 4's initial-cost "
                         "third)")
    ap.add_argument("--energy-rate", type=float, required=True,
                    help="price of one joule (the operation-cost third)")
    ap.add_argument("--fixed-rate", type=float, default=0.0,
                    help="other cost a step (the third third)")
    args = ap.parse_args(argv)
    run(args.arch, args.shape, CostModel(hw_rate=args.hw_rate,
                                         energy_rate=args.energy_rate,
                                         fixed_rate=args.fixed_rate))


if __name__ == "__main__":
    main()
