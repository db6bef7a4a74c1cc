"""Ws comparison report from persisted power traces / energy ledgers.

    python -m repro_torch.scripts.power_report --trace run.jsonl \
        [--baseline base.jsonl] [--json] [--label NAME] [--baseline-label N]
    python -m repro_torch.scripts.power_report --ledger fleet.json
    python -m repro_torch.scripts.power_report \
        --ledger node0.json --ledger node1.json   # merged fleet rollup

With ``--baseline`` the two JSONL traces are compared Fig.5-style (time
ratio, Ws ratio, avg/peak W per phase); with only ``--trace`` a single-run
summary is printed.  Compiled-rung recordings (the traces
``CompiledBackend`` persists next to its dry-run artifacts) additionally
render the measured per-stage utilization and the rung that produced
them.  ``--ledger`` renders a persisted EnergyLedger (the governed
serving loop's ``--ledger-out``) as node / tenant / phase rollups — the
fleet view and the per-tenant energy bill; repeat it to merge per-node
ledgers into one fleet rollup (``EnergyLedger.merge`` conserves every
cut).  Ledgers written under the fleet power planner carry the
first-class ``idle`` / ``transition`` phases (floor watts of powered
idle nodes, parked draw of gated ones, boot energy of wakes) billed to
the infra tenant — they render here like any other phase row and still
sum into ``total_ws``.  Imports only ``repro_torch.telemetry`` and does
no device work, so it runs on a machine that just holds the logs.

Counterpart of the repo's ``scripts/power_report.py``: on the same files it
prints the same bytes and exits with the same codes.
"""
import argparse
import json
from pathlib import Path

from repro_torch.telemetry import (EnergyLedger, PowerTrace, RunEnergy,
                                   compare, render_comparison_text,
                                   render_rollups, render_trace_summary)


def main(argv=None) -> None:
    """Render what ``argv`` (``sys.argv[1:]`` by default) names; a bad
    argument or a missing or empty file exits 2, as argparse does."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", default=None,
                    help="JSONL power trace of the run under test")
    ap.add_argument("--baseline", default=None,
                    help="JSONL power trace of the baseline (CPU-only) run")
    ap.add_argument("--ledger", action="append", default=None,
                    help="JSON energy ledger to render as node/tenant/"
                         "phase rollups; repeat to merge per-node ledgers "
                         "into one fleet rollup")
    ap.add_argument("--label", default=None,
                    help="label for --trace (default: file stem)")
    ap.add_argument("--baseline-label", default=None,
                    help="label for --baseline (default: file stem)")
    ap.add_argument("--workload", default="",
                    help="workload name for the report header")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    args = ap.parse_args(argv)

    if args.trace is None and args.ledger is None:
        ap.error("need --trace and/or --ledger")
    if args.baseline is not None and args.trace is None:
        ap.error("--baseline requires --trace")
    for p in [args.trace, args.baseline] + (args.ledger or []):
        if p is None:
            continue
        if not Path(p).is_file():
            ap.error(f"no such file: {p}")
        if Path(p).stat().st_size == 0:
            # an empty trace renders as an all-zero table that reads like
            # a real (idle) run — fail loudly instead
            ap.error(f"empty file: {p}")

    # json mode collects every requested section into ONE document (a bare
    # section when only one was asked for — the original CLI contract)
    json_doc: dict = {}

    if args.ledger:
        # one ledger renders as-is; several merge into the fleet rollup
        ledger = EnergyLedger()
        for p in args.ledger:
            ledger.merge(EnergyLedger.from_json(p))
        label = Path(args.ledger[0]).stem if len(args.ledger) == 1 \
            else f"fleet({len(args.ledger)} ledgers)"
        if args.json:
            rollups = {by: {k: pe.to_dict()
                            for k, pe in ledger.rollup(by).items()}
                       for by in ("node", "tenant", "phase")}
            json_doc["ledger"] = {"total_ws": ledger.total_ws,
                                  "total_seconds": ledger.total_seconds,
                                  "sources": [str(p) for p in args.ledger],
                                  "rollups": rollups}
        else:
            for line in render_rollups(ledger, label=label):
                print(line)

    if args.trace is not None:
        trace = PowerTrace.from_jsonl(args.trace)
        label = args.label or Path(args.trace).stem
        if args.baseline is None:
            if args.json:
                doc = trace.summary()
                if trace.meta:      # rung/utilization of the recording
                    doc["meta"] = trace.meta
                json_doc["trace"] = doc
            else:
                for line in render_trace_summary(trace, label):
                    print(line)
        else:
            base = PowerTrace.from_jsonl(args.baseline)
            base_label = args.baseline_label or Path(args.baseline).stem
            cmp_ = compare(RunEnergy.from_trace(base_label, base),
                           RunEnergy.from_trace(label, trace),
                           workload=args.workload)
            if args.json:
                json_doc["comparison"] = cmp_.to_dict()
            else:
                for line in render_comparison_text(cmp_):
                    print(line)

    if args.json:
        out = next(iter(json_doc.values())) if len(json_doc) == 1 \
            else json_doc
        print(json.dumps(out, indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
