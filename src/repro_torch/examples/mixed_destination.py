"""Paper §3.3: mixed-environment destination selection with early exit.

    python -m repro_torch.examples.mixed_destination

Counterpart of the repo's ``examples/mixed_destination.py``, on the port's
``core/`` and its H100 spec.  Climbs the destination ladder (xla_default
-> xla_tuned -> pallas, the last the port's hand-written kernels) for
llama3-405b decode under two SLOs, showing the early exit skipping the
expensive rung when the requirement is already met.

Does no device work: the analytic rung is the roofline estimate.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs import get_config
from repro_torch.core.destinations import Requirement, select_destination
from repro_torch.core.ga import GAConfig
from repro_torch.core.power import H100
from repro_torch.core.verifier import Verifier
from repro_torch.launch.mesh import POD_SHAPE

CHIPS = 256
SLOS = (("loose SLO (200 ms/token)", 0.2), ("tight SLO (1 ms/token)", 1e-3))


def run(log: Callable[[str], None] = print) -> list:
    """The ladder under each SLO on the verifier's spec
    (``core.power.H100``); returns each SLO's selection and its
    verifier's trials."""
    cfg = get_config("llama3-405b")
    out = []
    for label, seconds in SLOS:
        log(f"\n=== decode_32k under {label} ===")
        v = Verifier(cfg, "decode_32k", n_chips=CHIPS, tp=POD_SHAPE[1],
                     mode="analytic")
        sel = select_destination(cfg, "decode", v,
                                 Requirement(max_seconds=seconds),
                                 GAConfig(population=6, generations=3,
                                          seed=0), log=log)
        m = sel.chosen.measurement
        log(f"chosen destination: {sel.chosen.name}  "
            f"t={m.seconds*1e3:.2f} ms  {m.watts:.0f} W/chip  "
            f"trials={v.n_trials}")
        if sel.early_exit:
            log(f"early exit: {sel.early_exit}")
        out.append({"slo": label, "selection": sel, "trials": v.n_trials})
    return out


def main() -> None:
    print(f"spec: {H100.name} (analytic rung, {CHIPS} chips)")
    run()


if __name__ == "__main__":
    main()
