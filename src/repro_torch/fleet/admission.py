"""Tenant admission control — the fleet ledger throttles its own writers.

The per-tenant energy bill (``EnergyLedger.rollup(by="tenant")``) already
says what every tenant *spent*; admission control turns it into what a
tenant *may* spend: each tenant gets a ``WsBudget`` (Watt*seconds per
rolling step window), and a submit is rejected while the tenant's window
is exhausted.  Rejected requests never reach a loop, so they book exactly
zero Watt*seconds — the throttle and the bill can never disagree, because
they read the same ledger.

Copy of ``repro.fleet.admission``: admission moves numbers, not tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from repro_torch import obs
from repro_torch.telemetry.energy import EnergyLedger, WsBudget


@dataclass(frozen=True)
class AdmissionRejection:
    """One throttled submit (it booked zero Ws — it never ran)."""
    step: int
    rid: int
    tenant: str
    spent_ws: float
    budget_ws: float

    @property
    def reason(self) -> str:
        return (f"tenant {self.tenant} spent {self.spent_ws:.2f}Ws of its "
                f"{self.budget_ws:.2f}Ws window")

    def to_dict(self) -> dict:
        return {"step": self.step, "rid": self.rid, "tenant": self.tenant,
                "spent_ws": self.spent_ws, "budget_ws": self.budget_ws,
                "reason": self.reason}


class AdmissionController:
    """Per-tenant Ws budget windows over a (fleet) ledger.

    ``budgets`` maps tenant -> ``WsBudget``; tenants without an entry get
    a private copy of ``default`` (``None`` = unmetered, always admitted).
    Budget state is per tenant — windows roll independently.
    """

    def __init__(self, budgets: Optional[dict] = None,
                 default: Optional[WsBudget] = None):
        self.budgets: dict[str, WsBudget] = dict(budgets or {})
        self.default = default
        self.rejections: list[AdmissionRejection] = []

    def budget_for(self, tenant: str) -> Optional[WsBudget]:
        if tenant not in self.budgets and self.default is not None:
            self.budgets[tenant] = replace(self.default)
        return self.budgets.get(tenant)

    def admit(self, req, step: int, ledger: EnergyLedger) -> bool:
        """Judge one submit against the tenant's current window; a
        rejection is logged (with the spend that caused it) and returns
        False — the caller must not enqueue the request."""
        budget = self.budget_for(req.tenant)
        if budget is None:
            self._observe(req, step, accepted=True)
            return True
        budget.roll(step, ledger, req.tenant)
        if budget.exhausted(ledger, req.tenant):
            self.rejections.append(AdmissionRejection(
                step=step, rid=req.rid, tenant=req.tenant,
                spent_ws=budget.spent_ws(ledger, req.tenant),
                budget_ws=budget.budget_ws))
            self._observe(req, step, accepted=False,
                          spent_ws=self.rejections[-1].spent_ws)
            return False
        self._observe(req, step, accepted=True)
        return True

    def _observe(self, req, step: int, accepted: bool,
                 spent_ws: float = 0.0) -> None:
        tr = obs.TRACER
        if tr.enabled:
            tags = {"rid": req.rid, "tenant": req.tenant, "step": step}
            if not accepted:
                tags["spent_ws"] = spent_ws
            tr.instant("admission.accept" if accepted
                       else "admission.throttle", tags=tags)
        mx = obs.METRICS
        if mx.enabled:
            mx.counter("admission_accepts_total" if accepted
                       else "admission_rejections_total",
                       "admission verdicts").inc()

    def rejected_by_tenant(self) -> dict:
        out: dict[str, int] = {}
        for r in self.rejections:
            out[r.tenant] = out.get(r.tenant, 0) + 1
        return out

    def summary(self, ledger: EnergyLedger) -> dict:
        rejected = self.rejected_by_tenant()
        return {tenant: {"budget_ws": b.budget_ws,
                         "window_steps": b.window_steps,
                         "spent_ws": b.spent_ws(ledger, tenant),
                         "rejected": rejected.get(tenant, 0)}
                for tenant, b in sorted(self.budgets.items())}
