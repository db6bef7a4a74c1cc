"""Span-trace report — render a serve run's span export offline.

    python -m repro_torch.scripts.trace_report --trace spans.json
    python -m repro_torch.scripts.trace_report --trace spans.jsonl \
        [--metrics metrics.prom] [--slowest 10] [--json]
    python -m repro_torch.scripts.trace_report --flight flight.jsonl \
        [--steps-per-hour 3600] [--profile fleet-profile-phases.json]

``--trace`` accepts either export the serving CLI writes (``--trace-spans``
of ``repro_torch.launch.serve``): the Chrome ``trace_event`` JSON or the raw
spans JSONL sidecar — the format is auto-detected.  The text report shows

  * a per-span-name summary (count, total/mean/max seconds, attributed
    Watt*seconds),
  * the slowest individual spans,
  * a per-phase attributed-Ws treemap (text bars), which is where
    synthesized ``unattributed:*`` spans show up as visible debt.

``--flight`` renders a flight-recorder snapshot log (the serving CLI's
``--flight-log`` / the bench rungs' ``fleet-flight-*.jsonl``) as a
per-simulated-hour time series: mean aggregate watts (with text bars),
active nodes, peak queue depth, and arrivals.  A missing, empty, or
truncated flight log renders whatever made it to disk and exits 0 — a
killed run's log must still be inspectable.  ``--profile`` renders the
engine self-profiler table (``summary()["profile"]`` docs, or the bench
export's per-arm list).  ``--metrics`` additionally echoes the quantile
lines of a Prometheus text export (the serving CLI's ``--metrics-out``).
Imports only ``repro_torch.obs`` and does no device work, so it runs on a
machine that just holds the logs.  Exits non-zero on a missing, empty, or
span-less ``--trace`` input.

Counterpart of the repo's ``scripts/trace_report.py``: on the same files it
prints the same bytes and exits with the same codes.
"""
import argparse
import json
import sys
from pathlib import Path

from repro_torch.obs import (read_chrome_trace, read_flight_jsonl,
                             read_spans_jsonl)

BAR_WIDTH = 40


def load_trace(path: Path) -> list:
    """Auto-detect Chrome trace JSON vs spans JSONL by the first byte."""
    head = path.read_text(errors="replace").lstrip()[:1]
    if head == "{" and path.suffix != ".jsonl":
        return read_chrome_trace(path)
    try:
        return read_spans_jsonl(path)
    except (KeyError, ValueError):
        return read_chrome_trace(path)


def summarize(spans: list) -> dict:
    """Per-span-name rollup + per-phase attributed-Ws rollup."""
    by_name: dict = {}
    by_phase: dict = {}
    for sp in spans:
        row = by_name.setdefault(sp.name, {
            "count": 0, "seconds": 0.0, "max_seconds": 0.0, "ws": 0.0})
        row["count"] += 1
        row["seconds"] += sp.seconds
        row["max_seconds"] = max(row["max_seconds"], sp.seconds)
        row["ws"] += sp.attributed_ws
        phase = str(sp.tags.get("phase", "-"))
        by_phase[phase] = by_phase.get(phase, 0.0) + sp.attributed_ws
    return {"spans": len(spans),
            "nodes": sorted({sp.node for sp in spans}),
            "attributed_ws": sum(sp.attributed_ws for sp in spans),
            "by_name": by_name, "by_phase": by_phase}


def render(summary: dict, spans: list, slowest: int) -> list:
    lines = [f"== span trace: {summary['spans']} spans on "
             f"{len(summary['nodes'])} rows "
             f"({summary['attributed_ws']:.3f}Ws attributed) ==",
             f"{'span':<22}{'count':>7}{'total_s':>10}{'mean_s':>10}"
             f"{'max_s':>10}{'Ws':>10}"]
    for name, row in sorted(summary["by_name"].items(),
                            key=lambda kv: -kv[1]["seconds"]):
        mean = row["seconds"] / max(row["count"], 1)
        lines.append(f"{name:<22}{row['count']:>7}{row['seconds']:>10.4f}"
                     f"{mean:>10.5f}{row['max_seconds']:>10.5f}"
                     f"{row['ws']:>10.3f}")
    ranked = sorted(spans, key=lambda sp: -sp.seconds)[:max(slowest, 0)]
    if ranked:
        lines.append(f"-- slowest {len(ranked)} spans --")
        for sp in ranked:
            lines.append(f"  {sp.seconds:>9.5f}s {sp.name:<20} "
                         f"node={sp.node} t0={sp.t0:.5f} "
                         f"ws={sp.attributed_ws:.3f}")
    total_ws = sum(w for w in summary["by_phase"].values() if w > 0)
    if total_ws > 0:
        lines.append("-- attributed Ws by phase --")
        for phase, ws in sorted(summary["by_phase"].items(),
                                key=lambda kv: -kv[1]):
            bar = "#" * max(int(round(BAR_WIDTH * ws / total_ws)),
                            1 if ws > 0 else 0)
            lines.append(f"  {phase:<12}{ws:>10.3f}Ws "
                         f"{100 * ws / total_ws:>5.1f}% {bar}")
    return lines


def render_flight(rows: list, steps_per_hour: int) -> list:
    """Per-simulated-hour table over flight-log snapshot rows.

    Rows missing a ``t`` field (foreign JSON that slipped into the log)
    are skipped; an empty log renders a one-line notice — never a
    traceback — so a truncated log from a killed run stays inspectable.
    """
    rows = [r for r in rows if isinstance(r.get("t"), (int, float))]
    if not rows:
        return ["-- flight log: no snapshot rows --"]
    sph = max(int(steps_per_hour), 1)
    hours: dict = {}
    for r in rows:
        h = hours.setdefault(int(r["t"]) // sph, {
            "n": 0, "watts": 0.0, "active": 0, "queue": 0,
            "arrivals": 0, "ws": 0.0})
        h["n"] += 1
        h["watts"] += float(r.get("aggregate_watts", 0.0))
        h["active"] = max(h["active"], int(r.get("active_nodes", 0)))
        h["queue"] = max(h["queue"], int(r.get("queue_depth", 0)))
        h["arrivals"] += int(r.get("arrivals_in_window", 0))
        h["ws"] = max(h["ws"], float(r.get("cumulative_ws", 0.0)))
    peak = max(h["watts"] / h["n"] for h in hours.values())
    lines = [f"== flight log: {len(rows)} snapshots over "
             f"{len(hours)} simulated hours "
             f"({sph} steps/hour) ==",
             f"{'hour':>5}{'rows':>6}{'mean_W':>10}{'active':>8}"
             f"{'max_q':>7}{'arrivals':>10}{'cum_Ws':>12}"]
    for hr in sorted(hours):
        h = hours[hr]
        mean_w = h["watts"] / h["n"]
        bar = "#" * (max(int(round(BAR_WIDTH * mean_w / peak)), 1)
                     if peak > 0 and mean_w > 0 else 0)
        lines.append(f"{hr:>5}{h['n']:>6}{mean_w:>10.1f}"
                     f"{h['active']:>8}{h['queue']:>7}"
                     f"{h['arrivals']:>10}{h['ws']:>12.1f} {bar}")
    return lines


def _profile_arms(doc) -> list:
    """Normalize a profiler export to ``[(label, phases-dict), ...]``.

    Accepts a bare ``{"phases": ...}`` profile, an engine ``summary()``
    doc carrying one under ``"profile"``, the bench export's
    ``{"arms": [...]}`` shape, or a plain list of arm docs."""
    if isinstance(doc, list):
        arms = doc
    elif isinstance(doc, dict) and isinstance(doc.get("arms"), list):
        arms = doc["arms"]
    else:
        arms = [doc]
    out = []
    for i, arm in enumerate(arms):
        if not isinstance(arm, dict):
            continue
        prof = arm.get("profile", arm)
        phases = (prof or {}).get("phases")
        if not isinstance(phases, dict) or not phases:
            continue
        label = arm.get("label") or (
            f"shards={arm['shards']}" if "shards" in arm
            else arm.get("engine") or f"arm{i}")
        out.append((str(label), phases))
    return out


def render_profile(doc) -> list:
    arms = _profile_arms(doc)
    if not arms:
        return ["-- profiler: no phase counters --"]
    lines = []
    for label, phases in arms:
        total = sum(float(row.get("seconds", 0.0))
                    for row in phases.values())
        lines.append(f"== engine profile [{label}]: "
                     f"{total:.4f}s across {len(phases)} phases ==")
        lines.append(f"{'phase':<16}{'seconds':>10}{'count':>10}"
                     f"{'share':>8}")
        for p, row in sorted(phases.items(),
                             key=lambda kv: -kv[1].get("seconds", 0.0)):
            s = float(row.get("seconds", 0.0))
            share = 100.0 * s / total if total > 0 else 0.0
            lines.append(f"{p:<16}{s:>10.4f}{row.get('count', 0):>10}"
                         f"{share:>7.1f}%")
    return lines


def render_metrics(path: Path) -> list:
    """Echo the quantile summary lines of a Prometheus text export."""
    lines = [f"-- metrics quantiles ({path.name}) --"]
    for line in path.read_text().splitlines():
        if "quantile=" in line and not line.startswith("#"):
            lines.append(f"  {line}")
    return lines


def main(argv=None) -> None:
    """Render what ``argv`` (``sys.argv[1:]`` by default) names; exits 2
    on a bad argument and 1 with a message on a missing, empty or
    span-less ``--trace``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", default=None,
                    help="Chrome trace JSON or spans JSONL to render")
    ap.add_argument("--metrics", default=None,
                    help="Prometheus text export to echo quantiles from")
    ap.add_argument("--flight", default=None,
                    help="flight-recorder snapshot JSONL to render as a "
                         "per-simulated-hour time series (a missing or "
                         "truncated log renders what exists, exit 0)")
    ap.add_argument("--steps-per-hour", type=int, default=3600,
                    help="fleet steps per simulated hour for the "
                         "--flight bucketing")
    ap.add_argument("--profile", default=None,
                    help="engine self-profiler JSON (summary()['profile'] "
                         "or the bench per-arm export) to render")
    ap.add_argument("--slowest", type=int, default=8,
                    help="how many slowest spans to list")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of text")
    args = ap.parse_args(argv)

    if not (args.trace or args.flight or args.profile):
        ap.error("nothing to render — pass --trace, --flight, or "
                 "--profile")

    if args.trace:
        path = Path(args.trace)
        if not path.is_file():
            sys.exit(f"no such file: {path}")
        if path.stat().st_size == 0:
            sys.exit(f"empty file: {path}")
        spans = load_trace(path)
        if not spans:
            sys.exit(f"no spans in {path}")

        summary = summarize(spans)
        if args.json:
            print(json.dumps(summary, indent=2, sort_keys=True))
        else:
            for line in render(summary, spans, args.slowest):
                print(line)
            if args.metrics:
                mpath = Path(args.metrics)
                if not mpath.is_file():
                    sys.exit(f"no such file: {mpath}")
                for line in render_metrics(mpath):
                    print(line)

    if args.flight:
        for line in render_flight(read_flight_jsonl(args.flight),
                                  args.steps_per_hour):
            print(line)

    if args.profile:
        ppath = Path(args.profile)
        try:
            doc = json.loads(ppath.read_text())
        except (OSError, ValueError):
            print(f"-- profiler: no readable profile at {ppath} --")
            doc = None
        if doc is not None:
            for line in render_profile(doc):
                print(line)


if __name__ == "__main__":
    main()
