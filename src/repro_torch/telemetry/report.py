"""Report rendering for traces, ledgers and Ws comparisons.

Copy of ``repro.telemetry.report``.

Two audiences: humans (aligned text tables, Fig. 5 style) and machines
(the same content as JSON / CSV lines for the benchmark harness, which
prints ``table,...`` rows).
"""
from __future__ import annotations

import json

from repro_torch.telemetry.compare import RunEnergy, WsComparison
from repro_torch.telemetry.energy import EnergyLedger
from repro_torch.telemetry.trace import PowerTrace


def _phase_rows(run: RunEnergy) -> list[tuple[str, dict]]:
    return sorted(run.phases.items(), key=lambda kv: -kv[1]["ws"])


def render_comparison_text(cmp: WsComparison) -> list[str]:
    """Fig. 5-style human-readable table (per-request rows in serving
    mode)."""
    head = f"Ws comparison — {cmp.workload}" if cmp.workload \
        else "Ws comparison"
    if cmp.serving:
        head += " [serving]"
    lines = [head,
             f"{'destination':<28} {'seconds':>9} {'Ws':>10} "
             f"{'avg W':>7} {'peak W':>7}"]
    for run in (cmp.baseline, cmp.candidate):
        lines.append(f"{run.label:<28} {run.seconds:>9.3f} {run.ws:>10.1f} "
                     f"{run.avg_w:>7.1f} {run.peak_w:>7.1f}")
        for name, st in _phase_rows(run):
            lines.append(f"  · {name:<24} {st['seconds']:>9.3f} "
                         f"{st['ws']:>10.1f} {st['avg_w']:>7.1f} "
                         f"{st['peak_w']:>7.1f}")
        for q in run.requests:
            lines.append(f"  req {q.rid:<4} tenant={q.tenant:<12} "
                         f"{q.tokens:>4}tok prefill={q.prefill_ws:>8.2f}Ws "
                         f"decode={q.decode_ws:>8.2f}Ws "
                         f"({q.ws_per_token:.3f}Ws/tok)")
    lines.append(f"time_ratio={cmp.time_ratio:.3f} "
                 f"ws_ratio={cmp.ws_ratio:.3f} "
                 f"power_ratio={cmp.power_ratio:.3f} "
                 f"savings={cmp.savings_ws:.1f}Ws ({cmp.savings_pct:.1f}%) "
                 f"energy_cut={cmp.energy_cut:.2f}x")
    return lines


def render_comparison_csv(cmp: WsComparison) -> list[str]:
    """``table,...`` rows for the benchmark harness."""
    wl = cmp.workload or "ab"
    lines = ["table,workload,destination,phase,seconds,ws,avg_w,peak_w"]
    for role, run in (("cpu_only", cmp.baseline),
                      ("offloaded", cmp.candidate)):
        lines.append(f"ws_compare,{wl},{run.label},total,"
                     f"{run.seconds:.4f},{run.ws:.2f},"
                     f"{run.avg_w:.1f},{run.peak_w:.1f}")
        for name, st in _phase_rows(run):
            lines.append(f"ws_compare,{wl},{run.label},{name},"
                         f"{st['seconds']:.4f},{st['ws']:.2f},"
                         f"{st['avg_w']:.1f},{st['peak_w']:.1f}")
        for q in run.requests:
            lines.append(f"ws_request,{wl},{run.label},"
                         f"rid={q.rid},tenant={q.tenant},"
                         f"tokens={q.tokens},prefill_ws={q.prefill_ws:.3f},"
                         f"decode_ws={q.decode_ws:.3f},ws={q.ws:.3f}")
    lines.append(f"ws_compare,{wl},derived,ratios,"
                 f"time_ratio={cmp.time_ratio:.3f},"
                 f"ws_ratio={cmp.ws_ratio:.3f},"
                 f"energy_cut={cmp.energy_cut:.2f}x,"
                 f"savings_pct={cmp.savings_pct:.1f}")
    return lines


def render_comparison_json(cmp: WsComparison, indent: int = 2) -> str:
    return json.dumps(cmp.to_dict(), indent=indent, sort_keys=True)


def render_trace_summary(trace: PowerTrace, label: str = "trace"
                         ) -> list[str]:
    s = trace.summary()
    lines = [f"{label}: {s['samples']} samples over {s['seconds']:.3f}s — "
             f"{s['ws']:.1f}Ws avg={s['avg_w']:.1f}W "
             f"peak={s['peak_w']:.1f}W p95={s['p95_w']:.1f}W"]
    # compiled-rung recordings carry the measured per-phase utilization
    util = trace.meta.get("utilization", {})
    for name, st in sorted(s["phases"].items(), key=lambda kv: -kv[1]["ws"]):
        extra = f"  util={util[name]:.2f}" if name in util else ""
        lines.append(f"  · {name:<24} {st['seconds']:>9.3f}s "
                     f"{st['ws']:>10.1f}Ws {st['avg_w']:>7.1f}W avg "
                     f"{st['peak_w']:>7.1f}W peak{extra}")
    if trace.meta.get("source"):
        lines.append(f"  measured on rung: {trace.meta['source']}")
    return lines


def render_ledger(ledger: EnergyLedger, label: str = "ledger") -> list[str]:
    lines = [f"{label}: total={ledger.total_ws:.1f}Ws "
             f"over {ledger.total_seconds:.3f}s busy"]
    for name, st in sorted(ledger.per_phase().items(),
                           key=lambda kv: -kv[1]["ws"]):
        lines.append(f"  · {name:<24} {st['seconds']:>9.3f}s "
                     f"{st['ws']:>10.1f}Ws {st['avg_w']:>7.1f}W avg "
                     f"x{st['count']}")
    for node, ws in sorted(ledger.nodes.items()):
        lines.append(f"  node {node}: {ws:.1f}Ws")
    return lines


def render_rollups(ledger: EnergyLedger, label: str = "fleet") -> list[str]:
    """The three cuts of the same joules: node, tenant, phase.  Each cut's
    rows sum to the ledger total — the fleet view, the energy bill, and
    the phase profile of one run."""
    lines = [f"{label}: total={ledger.total_ws:.1f}Ws "
             f"over {ledger.total_seconds:.3f}s busy"]
    for by in ("node", "tenant", "phase"):
        roll = ledger.rollup(by)
        if not roll:
            continue
        lines.append(f"  by {by}:")
        for name, pe in sorted(roll.items(), key=lambda kv: -kv[1].ws):
            lines.append(f"    {name:<22} {pe.seconds:>9.3f}s "
                         f"{pe.ws:>10.2f}Ws {pe.avg_watts:>7.1f}W avg "
                         f"peak={pe.peak_w:.1f}W x{pe.count}")
    return lines
