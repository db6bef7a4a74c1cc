"""Joule attribution — join ledger cells onto overlapping spans.

The ``EnergyLedger`` says *what* was spent per ``(node, tenant, phase)``
cell; the span trace says *when* and *on whose behalf*.  The join maps
every cell's Watt*seconds onto the spans that describe it, so each span
carries ``attributed_ws`` and the trace sums to the ledger:

  * a span is a candidate for a cell when it lives on the cell's node,
    its ``phase`` tag equals the cell's phase, and its ``tenant`` tag
    (when present) equals the cell's tenant;
  * the cell's Ws distributes across candidates proportional to their
    ``ws`` tag (the exact booked energy the instrumentation accumulated
    via ``Span.extend``), falling back to span seconds, then to an even
    split — with the remainder pinned on the last candidate so every
    cell conserves *exactly*, not just proportionally;
  * a cell with no candidate spans (an uninstrumented booking) becomes a
    synthesized ``unattributed:<phase>`` span carrying the whole cell —
    conservation holds by construction, and the synthesized spans are
    the visible debt ("this energy has no timeline").

``conservation`` then checks the invariant the exporters rely on:
per-node attributed Ws equals the ledger's per-node rollup.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.obs.span import Span

#: ledger phases a request span tree carries energy for (idle/transition
#: cells have no request to sample, so the scale-up never sees them)
REQUEST_PHASES = ("prefill", "decode")


@dataclass
class AttributionResult:
    spans: list = field(default_factory=list)        # inputs, ws filled
    synthesized: list = field(default_factory=list)  # unattributed filler

    def all_spans(self) -> list:
        return list(self.spans) + list(self.synthesized)

    def attributed_by_node(self) -> dict:
        out: dict = {}
        for sp in self.all_spans():
            out[sp.node] = out.get(sp.node, 0.0) + sp.attributed_ws
        return out

    def conservation(self, ledger, tol: float = 1e-6) -> dict:
        """Per-node check: attributed Ws vs the ledger's node rollup."""
        attributed = self.attributed_by_node()
        rows = {}
        for node, pe in ledger.rollup("node").items():
            got = attributed.get(node, 0.0)
            rows[node] = {"ledger_ws": pe.ws, "attributed_ws": got,
                          "delta": got - pe.ws,
                          "ok": abs(got - pe.ws) <= tol * max(1.0, pe.ws)}
        return rows


def _candidates(spans_by_node: dict, node: str, tenant: str,
                phase: str) -> list:
    out = []
    for sp in spans_by_node.get(node, ()):
        if sp.tags.get("phase") != phase:
            continue
        if sp.tags.get("tenant", tenant) != tenant:
            continue
        out.append(sp)
    return out


def attribute_joules(spans: list, ledger) -> AttributionResult:
    """Fill ``attributed_ws`` on ``spans`` from ``ledger``'s cells and
    synthesize filler spans for un-spanned energy.  Idempotent: resets
    previous attributions first."""
    for sp in spans:
        sp.attributed_ws = 0.0
    by_node: dict = {}
    for sp in spans:
        by_node.setdefault(sp.node, []).append(sp)
    result = AttributionResult(spans=list(spans))
    for (node, tenant, phase), cell in sorted(ledger.cells.items()):
        cands = _candidates(by_node, node, tenant, phase)
        weights = [sp.tags.get("ws", 0.0) for sp in cands]
        if not any(w > 0 for w in weights):
            weights = [sp.seconds for sp in cands]
        if not any(w > 0 for w in weights):
            weights = [1.0] * len(cands)
        total_w = sum(weights)
        if not cands or total_w <= 0:
            result.synthesized.append(Span(
                name=f"unattributed:{phase}", node=node, t0=0.0,
                t1=cell.seconds,
                tags={"phase": phase, "tenant": tenant,
                      "synthesized": True},
                attributed_ws=cell.ws))
            continue
        handed = 0.0
        for sp, w in zip(cands[:-1], weights[:-1]):
            share = cell.ws * (w / total_w)
            sp.attributed_ws += share
            handed += share
        # the last candidate takes the remainder: the cell conserves
        # exactly, so per-node sums match the ledger to float-sum noise
        cands[-1].attributed_ws += cell.ws - handed
    return result


@dataclass
class SampledAttribution:
    """The sampled scale-up verdict next to the exact per-node join.

    ``result`` is the ordinary ``attribute_joules`` output over the same
    spans (per-node conservation holds by construction at any rate —
    un-sampled energy lands on synthesized filler spans).  The scale-up
    fields estimate the *request* energy from the sampled slice:

      * ``scaled_ws`` = sampled request Ws x (population / sampled)
        requests — the Horvitz-Thompson-style blow-up using the realized
        sample count, not the nominal rate;
      * ``error_ws`` = ``scaled_ws`` minus the ledger's request-phase
        rollup, the reported conservation error;
      * ``error_bound_ws`` — a sound deterministic bound: both the
        estimate and the truth lie in ``[N*min_ws, N*max_ws]`` of the
        per-request energy envelope, so the error cannot exceed
        ``N * (max_ws - min_ws)``.  Requires the population envelope the
        engine notes at finalize; ``None`` when unavailable.

    At rate 1.0 the sample is the population, ``scaled_ws`` equals the
    summed per-request bookings, and ``error_ws`` is float-sum noise.
    """

    result: AttributionResult
    sample_rate: float
    sampled_requests: int
    total_requests: Optional[int]
    sampled_ws: float
    scaled_ws: Optional[float]
    ledger_request_ws: float
    ledger_total_ws: float
    error_ws: Optional[float]
    error_bound_ws: Optional[float]
    ok: Optional[bool]

    def to_dict(self) -> dict:
        return {"sample_rate": self.sample_rate,
                "sampled_requests": self.sampled_requests,
                "total_requests": self.total_requests,
                "sampled_ws": self.sampled_ws,
                "scaled_ws": self.scaled_ws,
                "ledger_request_ws": self.ledger_request_ws,
                "ledger_total_ws": self.ledger_total_ws,
                "error_ws": self.error_ws,
                "error_bound_ws": self.error_bound_ws,
                "ok": self.ok}


def attribute_joules_sampled(spans: list, ledger, sample_rate: float,
                             population: Optional[dict] = None
                             ) -> SampledAttribution:
    """``attribute_joules`` plus the sampled-trace scale-up report.

    ``spans`` holds whatever the tracer collected — at sample rates
    below 1.0 that is a head-sampled slice of request trees (spans
    tagged ``sampled`` with request-phase ``ws`` weights) next to the
    aggregate per-(node, phase) spans.  ``population`` is the optional
    per-request energy envelope (``{"count", "min_ws", "max_ws"}``, what
    the reference's flight recorder notes); without it the blow-up
    falls back to the nominal rate and no error bound is reported.
    """
    result = attribute_joules(spans, ledger)
    by_rid: dict = {}
    for sp in spans:
        if not sp.tags.get("sampled"):
            continue
        if sp.tags.get("phase") not in REQUEST_PHASES:
            continue
        rid = sp.tags.get("rid", ("anon", id(sp)))
        by_rid[rid] = by_rid.get(rid, 0.0) + sp.tags.get("ws", 0.0)
    m = len(by_rid)
    sampled_ws = sum(by_rid.values())
    phases = ledger.rollup("phase")
    ledger_request_ws = sum(pe.ws for phase, pe in phases.items()
                            if phase in REQUEST_PHASES)
    total = int(population["count"]) if population else None
    scaled = error = bound = ok = None
    if m > 0:
        if total is not None:
            scaled = sampled_ws * (total / m)
            bound = total * (population["max_ws"] - population["min_ws"])
        else:
            scaled = sampled_ws / max(sample_rate, 1e-300)
        error = scaled - ledger_request_ws
        if bound is not None:
            slack = 1e-9 * max(ledger_request_ws, 1.0)
            ok = abs(error) <= bound + slack
    elif total in (0, None) or ledger_request_ws == 0.0:
        ok = True               # nothing sampled and nothing to explain
    return SampledAttribution(
        result=result, sample_rate=float(sample_rate),
        sampled_requests=m, total_requests=total, sampled_ws=sampled_ws,
        scaled_ws=scaled, ledger_request_ws=ledger_request_ws,
        ledger_total_ws=ledger.total_ws, error_ws=error,
        error_bound_ws=bound, ok=ok)
