"""``Node`` — one serving node of the fleet control plane.

Counterpart of ``repro.fleet.node``.  A node is the (ServeLoop,
DecodeEnergyMeter, optional per-node PowerGovernor) bundle, addressed by
name.  The meter is the node's power instrument (envelope- or
source-driven, fed by the loop's measured slot occupancy), the governor is
the node-local plane (plan migrations on drift), and the loop is the work.

On top of the bundle the node exposes the routing signals the
``FleetScheduler`` dispatches on:

  * ``marginal_ws_per_token`` — the predicted energy cost of routing one
    more request here, from the node's current envelope point (or its
    source's drifted watts) and its real slot occupancy.  Sharing a decode
    batch amortizes the step's joules across its participants, so the
    router naturally *consolidates* onto warm nodes — and flees a node
    whose watts drifted up;
  * ``drain()`` / ``parked`` — the migration API: evict the node's queue
    and active slots as resumable requests, stop taking new work.

``Node.build`` meters at the H100 envelope by default (the reference
hard-codes its TPU's); a caller may pass any envelope or power source.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.device import DeviceLike
from repro_torch.serve.engine import Request, ServeLoop
from repro_torch.telemetry.energy import DecodeEnergyMeter


@dataclass
class Node:
    """One (loop, meter, governor) serving bundle, addressed by name."""
    name: str
    loop: ServeLoop
    meter: DecodeEnergyMeter
    governor: Optional[object] = None     # per-node PowerGovernor
    nominal_step_s: float = 2e-3          # step-time prior until measured
    # requests this node hosted (each at most once, however often it is
    # resubmitted here); a migrated request legitimately appears in every
    # host's list, so summing len(served) across a fleet counts hops
    served: list = field(default_factory=list)

    @classmethod
    def build(cls, name: str, model, params, *, slots: int = 4,
              max_seq: int = 128, envelope=None, source=None,
              governor=None, eos_id: int = 1, chips: int = 1,
              clock: Callable[[], float] = time.perf_counter,
              nominal_step_s: float = 2e-3,
              device: DeviceLike = None) -> "Node":
        """Wire a full serving node.  ``device`` goes to the ``ServeLoop``
        (default ``cuda``: raises without a card)."""
        if envelope is None:
            from repro_torch.core.power import H100
            from repro_torch.telemetry.dvfs import envelope_for
            envelope = envelope_for(H100)
        meter = DecodeEnergyMeter(envelope=envelope, chips=chips,
                                  source=source, node=name)
        loop = ServeLoop(model, params, batch_slots=slots, max_seq=max_seq,
                         eos_id=eos_id, meter=meter, governor=governor,
                         node=name, clock=clock, device=device)
        return cls(name=name, loop=loop, meter=meter, governor=governor,
                   nominal_step_s=nominal_step_s)

    # -- state ---------------------------------------------------------------

    @property
    def slots(self) -> int:
        return self.loop.slots

    @property
    def occupied(self) -> int:
        return self.loop.occupied_slots

    @property
    def queued(self) -> int:
        return len(self.loop.queue)

    @property
    def load(self) -> float:
        """Occupied + queued work as a fraction of the slot batch."""
        return (self.occupied + self.queued) / max(self.slots, 1)

    @property
    def parked(self) -> bool:
        return self.loop.parked

    @property
    def has_work(self) -> bool:
        return self.loop.has_work

    # -- routing signals -----------------------------------------------------

    def recent_step_seconds(self) -> float:
        """Measured mean decode-step seconds (the prior until warm)."""
        pe = self.meter.ledger.phases.get("decode")
        if pe is not None and pe.count > 0 and pe.seconds > 0:
            return pe.seconds / pe.count
        return self.nominal_step_s

    def marginal_ws_per_token(self) -> float:
        """Predicted marginal Watt*seconds per generated token of routing
        one more request to this node.

        A decode step at the node's next occupancy point costs
        ``watts x step_seconds`` and yields one token per participant, so
        the marginal request's share is that energy divided across the
        batch it would join — consolidation is energy-optimal until the
        batch is full, after which queued work waits (and burns idle
        watts), modelled as a linear overload penalty.  ``predict_watts``
        honours a drifted ``source``, so a browning-out node prices
        itself out of the fleet.  Parked nodes are infinitely expensive.
        """
        if self.parked:
            return float("inf")
        n_next = self.occupied + self.queued + 1
        util_next = min(n_next, self.slots) / max(self.slots, 1)
        dt = self.recent_step_seconds()
        watts = self.meter.predict_watts(util_next, dt_ahead=0.5 * dt)
        share = watts * dt / max(min(n_next, self.slots), 1)
        overload = max(n_next - self.slots, 0)
        return share * (1.0 + overload / max(self.slots, 1))

    # -- migration -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req not in self.served:
            self.served.append(req)
        self.loop.submit(req)

    def drain(self) -> list[Request]:
        return self.loop.drain()

    def to_dict(self) -> dict:
        return {"name": self.name, "slots": self.slots,
                "occupied": self.occupied, "queued": self.queued,
                "parked": self.parked, "served": len(self.served),
                "total_ws": self.meter.ledger.total_ws,
                "marginal_ws_per_token":
                    None if self.parked else self.marginal_ws_per_token()}
