"""repro_torch.fleet.power — the fleet power planner.

Counterpart of ``repro.fleet.power``: the placement layer beside the
``FleetScheduler``.  Where the scheduler decides *where a request runs*,
this package decides *which nodes are powered at all* — the paper's
idle-draw lever at fleet scale.

  * ``NodePowerState`` — per-node active/parked/gated/waking/probation
    machine with transition costs, booked into the node's own meter as
    first-class ``idle``/``transition`` phases (every ledger rollup
    still sums to ``total_ws``);
  * ``ArrivalForecaster`` — EWMA arrival-rate estimate + M/M/c expected
    queue depth: the sustained-load price the one-step-ahead router
    cannot see;
  * ``FleetPowerPlanner`` — consolidate-and-gate: the minimal node set
    meeting the queue-depth SLO at lowest forecast Ws, applied as
    ``PlacementEvent``s at checkpoint boundaries, with probe-based
    canary re-admission for gated and drained nodes.

``python -m repro_torch.launch.serve --placement gate|always_on
--slo-queue-depth N`` wires it on the CLI.
"""
from repro_torch.fleet.power.forecast import ArrivalForecaster  # noqa: F401
from repro_torch.fleet.power.planner import (MODES,  # noqa: F401
                                             FleetPowerPlanner,
                                             PlacementEvent,
                                             PowerPlanPolicy)
from repro_torch.fleet.power.states import (ACTIVE, GATED,  # noqa: F401
                                            PARKED, PROBATION, STATES,
                                            WAKING, NodePowerState,
                                            PowerStatePolicy)
