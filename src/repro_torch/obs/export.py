"""Span export — Chrome ``trace_event`` JSON and spans JSONL.

The Chrome form opens in ``chrome://tracing`` / Perfetto: one process
row per node timeline (fleet control plane, each serving node, dry-run
sidecars), complete (``ph:"X"``) events whose args carry the span tags
and the attributed Watt*seconds.  Timestamps are exported in
microseconds, as the format requires.

The JSONL form is the lossless round-trip (``read_spans_jsonl`` inverts
``write_spans_jsonl``) the jax-free ``scripts/trace_report.py`` renders.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.obs.span import Span, load_spans_jsonl


def write_spans_jsonl(spans: list, path) -> str:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fh:
        for sp in spans:
            fh.write(json.dumps(sp.to_dict(), sort_keys=True) + "\n")
    return str(path)


def read_spans_jsonl(path) -> list:
    return load_spans_jsonl(path)


def chrome_trace_events(spans: list) -> list:
    """Spans -> trace_event dicts (one pid per node, names first)."""
    pids = {node: i + 1
            for i, node in enumerate(sorted({sp.node for sp in spans}))}
    events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": node}}
              for node, pid in pids.items()]
    for sp in spans:
        events.append({
            "name": sp.name, "ph": "X", "pid": pids[sp.node], "tid": 1,
            "ts": sp.t0 * 1e6, "dur": sp.seconds * 1e6,
            "cat": str(sp.tags.get("phase", "span")),
            "id": sp.span_id,
            "args": {**sp.tags, "span_id": sp.span_id,
                     "parent_id": sp.parent_id,
                     "attributed_ws": sp.attributed_ws}})
    return events


def write_chrome_trace(spans: list, path) -> str:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": chrome_trace_events(spans),
                                "displayTimeUnit": "ms"},
                               sort_keys=True) + "\n")
    return str(path)


def read_chrome_trace(path) -> list:
    """Rebuild spans from a Chrome trace JSON (inverse of the writer, up
    to the node label living on the process-name metadata row)."""
    doc = json.loads(Path(path).read_text())
    events = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    names = {ev["pid"]: ev["args"]["name"] for ev in events
             if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    spans = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        attributed = float(args.pop("attributed_ws", 0.0))
        span_id = int(args.pop("span_id", ev.get("id", 0)) or 0)
        parent_id = args.pop("parent_id", None)
        t0 = ev["ts"] / 1e6
        spans.append(Span(name=ev["name"],
                          node=names.get(ev["pid"], str(ev["pid"])),
                          t0=t0, t1=t0 + ev.get("dur", 0.0) / 1e6,
                          span_id=span_id, parent_id=parent_id,
                          tags=args, attributed_ws=attributed))
    return spans
