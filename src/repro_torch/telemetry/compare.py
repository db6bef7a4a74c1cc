"""The paper's A/B energy harness — Watt*seconds, CPU-only vs offloaded.

Copy of ``repro.telemetry.compare``.

Fig. 5's method: run the workload on the un-offloaded destination and on
the offloaded one, integrate sampled watts over each run, and compare
Watt*seconds (the paper's MRI-Q anchor: 14 s x 121 W = 1690 Ws CPU-only
vs 2 s x 111 W = 223 Ws offloaded, a 7.6x energy cut).

``RunEnergy`` summarizes one run (from a trace, a verifier measurement, or
bare numbers); ``WsComparison`` holds the pair plus the derived ratios the
paper reports: time ratio, Ws ratio, average/peak watts per phase.

Serving mode extends the same report to continuous-batching traffic: a
``RunEnergy`` built with ``from_serving`` carries per-request
``RequestEnergy`` rows (prefill/decode Watt*seconds split, tenant label),
so the Fig. 5 A/B becomes "same request stream, CPU-only node vs offloaded
node" with an energy bill per request attached.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.telemetry.sampler import PowerSampler, PowerSource
from repro_torch.telemetry.trace import PowerTrace


@dataclass(frozen=True)
class RequestEnergy:
    """One served request's attributed energy (the per-tenant bill line)."""
    rid: int
    tenant: str
    tokens: int
    prefill_ws: float
    decode_ws: float

    @property
    def ws(self) -> float:
        return self.prefill_ws + self.decode_ws

    @property
    def ws_per_token(self) -> float:
        return self.ws / self.tokens if self.tokens > 0 else 0.0

    @classmethod
    def from_request(cls, req) -> "RequestEnergy":
        """From a ``repro_torch.serve.engine.Request`` (duck-typed: needs
        .rid/.tenant/.out/.prefill_ws/.decode_ws)."""
        return cls(rid=req.rid, tenant=req.tenant, tokens=len(req.out),
                   prefill_ws=req.prefill_ws, decode_ws=req.decode_ws)

    def to_dict(self) -> dict:
        return {"rid": self.rid, "tenant": self.tenant,
                "tokens": self.tokens, "prefill_ws": self.prefill_ws,
                "decode_ws": self.decode_ws, "ws": self.ws,
                "ws_per_token": self.ws_per_token}


@dataclass
class RunEnergy:
    """Energy summary of one run of one destination."""
    label: str
    seconds: float
    ws: float
    avg_w: float = 0.0
    peak_w: float = 0.0
    phases: dict = field(default_factory=dict)   # name -> stats dict
    trace: Optional[PowerTrace] = None
    requests: list = field(default_factory=list)  # RequestEnergy (serving)

    def __post_init__(self) -> None:
        if self.avg_w == 0.0 and self.seconds > 0:
            self.avg_w = self.ws / self.seconds
        if self.peak_w == 0.0:
            self.peak_w = self.avg_w

    @classmethod
    def from_trace(cls, label: str, trace: PowerTrace,
                   scale: float = 1.0) -> "RunEnergy":
        phases = {n: trace.phase_stats(n) for n in trace.phase_names()}
        if scale != 1.0:
            for st in phases.values():
                st["ws"] *= scale
                st["avg_w"] *= scale
                st["peak_w"] *= scale
        return cls(label=label, seconds=trace.duration,
                   ws=trace.energy_ws() * scale,
                   avg_w=trace.avg_watts() * scale,
                   peak_w=trace.peak_watts() * scale,
                   phases=phases, trace=trace)

    @classmethod
    def from_measurement(cls, label: str, m) -> "RunEnergy":
        """From a ``repro_torch.core.backends.Measurement`` (duck-typed: needs
        .seconds/.energy_j and optionally .trace)."""
        trace = getattr(m, "trace", None)
        if trace is not None and len(trace) >= 2:
            run = cls.from_trace(label, trace)
            run.ws = m.energy_j         # keep the ledgered number canonical
            return run
        return cls(label=label, seconds=m.seconds, ws=m.energy_j)

    @classmethod
    def from_serving(cls, label: str, meter, requests) -> "RunEnergy":
        """Serving mode: the meter's cumulative trace gives the run totals
        and prefill/decode phase stats; ``requests`` (served
        ``Request``s) become per-request bill lines."""
        run = cls.from_trace(label, meter.trace)
        run.requests = [RequestEnergy.from_request(r) for r in requests]
        return run


@dataclass
class WsComparison:
    """Baseline (CPU-only) vs candidate (offloaded) Watt*second report."""
    baseline: RunEnergy
    candidate: RunEnergy
    workload: str = ""

    @property
    def serving(self) -> bool:
        """True when either side carries per-request bill lines."""
        return bool(self.baseline.requests or self.candidate.requests)

    @property
    def time_ratio(self) -> float:
        return self.candidate.seconds / max(self.baseline.seconds, 1e-12)

    @property
    def ws_ratio(self) -> float:
        return self.candidate.ws / max(self.baseline.ws, 1e-12)

    @property
    def power_ratio(self) -> float:
        return self.candidate.avg_w / max(self.baseline.avg_w, 1e-12)

    @property
    def savings_ws(self) -> float:
        return self.baseline.ws - self.candidate.ws

    @property
    def savings_pct(self) -> float:
        return 100.0 * self.savings_ws / max(self.baseline.ws, 1e-12)

    @property
    def energy_cut(self) -> float:
        """The paper's headline: baseline_ws / candidate_ws (7.6x for
        MRI-Q)."""
        return self.baseline.ws / max(self.candidate.ws, 1e-12)

    def to_dict(self) -> dict:
        def run(r: RunEnergy) -> dict:
            d = {"label": r.label, "seconds": r.seconds, "ws": r.ws,
                 "avg_w": r.avg_w, "peak_w": r.peak_w,
                 "phases": r.phases}
            if r.requests:
                d["requests"] = [q.to_dict() for q in r.requests]
            return d
        return {"workload": self.workload,
                "serving": self.serving,
                "baseline": run(self.baseline),
                "candidate": run(self.candidate),
                "time_ratio": self.time_ratio, "ws_ratio": self.ws_ratio,
                "power_ratio": self.power_ratio,
                "savings_ws": self.savings_ws,
                "savings_pct": self.savings_pct,
                "energy_cut": self.energy_cut}


def compare(baseline: RunEnergy, candidate: RunEnergy,
            workload: str = "") -> WsComparison:
    return WsComparison(baseline=baseline, candidate=candidate,
                        workload=workload)


def ab_sample(workload: str,
              baseline_label: str, baseline_fn: Callable,
              candidate_label: str, candidate_fn: Callable,
              baseline_source: PowerSource, candidate_source: PowerSource,
              interval: float = 0.05) -> WsComparison:
    """Run both destinations under wall-clock sampling and compare.

    This is the full Fig. 5 protocol for workloads that actually execute on
    this host (each destination may draw from a different power source, as
    the paper's CPU-only and FPGA runs do).
    """
    _, trace_b = PowerSampler(baseline_source, interval).sample_during(
        baseline_fn)
    _, trace_c = PowerSampler(candidate_source, interval).sample_during(
        candidate_fn)
    return compare(RunEnergy.from_trace(baseline_label, trace_b),
                   RunEnergy.from_trace(candidate_label, trace_c),
                   workload=workload)
