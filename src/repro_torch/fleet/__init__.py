"""repro_torch.fleet — the control plane over per-node power governors.

Counterpart of ``repro.fleet``'s object engine.  A ``ServeLoop`` meters
Watt*seconds and a ``PowerGovernor`` re-plans its node when its ledger
drifts; this package is the layer above: a ``FleetScheduler`` owns N
``Node``s (each a ServeLoop + DecodeEnergyMeter + optional per-node
governor bundle) and runs its policies on the merged fleet
``EnergyLedger``:

  * energy-aware routing — each request goes to the node with the lowest
    predicted marginal Ws/token (``Node.marginal_ws_per_token``);
  * cross-node load migration — a drifted node's queue and active slots
    drain to healthy nodes at a checkpoint boundary (``FleetEvent``);
  * tenant admission control — ``AdmissionController`` throttles submits
    against per-tenant ``WsBudget`` windows read off the fleet ledger;
  * fleet power placement (``repro_torch.fleet.power``) — a
    ``FleetPowerPlanner`` decides which nodes are powered at all:
    arrival forecasting (EWMA + M/M/c), consolidate-and-gate placement
    at checkpoint boundaries, probe-based canary re-admission, with
    idle/transition energy booked first-class through the node meters.

``python -m repro_torch.launch.serve --fleet N`` wires it on the CLI
(``--placement`` for the power planner).  The vectorized engines sit
beside it, with no model: the stepped ``VectorFleet`` (numpy node
arrays, joule-equivalent to the object engine by contract), the
event-horizon ``SegmentFleet`` (its booking plane in numpy, or folded on
the card with ``backend="torch"``) and the sharded
``ShardedSegmentFleet``; ``--engine vector|vector-seg|vector-torch|
vector-shard`` selects them on the CLI.
"""
from repro_torch.fleet.admission import (AdmissionController,  # noqa: F401
                                         AdmissionRejection)
from repro_torch.fleet.node import Node  # noqa: F401
from repro_torch.fleet.power import (ACTIVE, GATED, PARKED,  # noqa: F401
                                     PROBATION, STATES, WAKING,
                                     ArrivalForecaster, FleetPowerPlanner,
                                     NodePowerState, PlacementEvent,
                                     PowerPlanPolicy, PowerStatePolicy)
from repro_torch.fleet.scheduler import (FleetEvent,  # noqa: F401
                                         FleetPolicy, FleetScheduler,
                                         normalize_arrivals)
from repro_torch.fleet.segment import SegmentFleet  # noqa: F401
from repro_torch.fleet.shard import ShardedSegmentFleet  # noqa: F401
from repro_torch.fleet.vector import (VectorArrivals,  # noqa: F401
                                      VectorFleet, VectorNodeSpec)
