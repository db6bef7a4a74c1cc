"""Run cells of the benchmark one after another, each run its own process,
and keep every result line.

    python3 portbench/series.py --out DIR --seconds S [--stop] \
        CELL:SEED[:TRACE] [CELL:SEED[:TRACE] ...]

Each run is ``portbench/run.py`` as the benchmark's command runs it; its
result line and the end of its standard error go to ``DIR/runs.jsonl``,
one JSON object a run, with the card's name and power limit
(``nvidia-smi``).  A summary line a run goes to standard output.  Used to
measure the spread of the cells' metrics and to read the compared numbers
over many seeds.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--stop", action="store_true",
                    help="stop at the first run that fails or is not "
                    "correct")
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    gpu = card()
    print(f"card: {gpu}", flush=True)
    with open(out / "runs.jsonl", "a") as f:
        for spec in args.runs:
            parts = spec.split(":")
            cell, seed = parts[0], int(parts[1])
            trace = int(parts[2]) if len(parts) > 2 else 0
            t = time.perf_counter()
            p = subprocess.run(
                [sys.executable, str(ROOT / "portbench" / "run.py"),
                 "--workload", cell, "--seed", str(seed), "--seconds",
                 str(args.seconds), "--trace", str(trace)],
                cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t
            lines = p.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            rec = {"cell": cell, "seed": seed, "trace": trace,
                   "seconds": args.seconds, "rc": p.returncode,
                   "wall_s": wall, "card": gpu, "result": result,
                   "stderr": p.stderr[-3000:]}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            summary = {k: round(v["value"], 6) for k, v in
                       (result or {}).get("metrics", {}).items()}
            checks = {k: v["value"] for k, v in
                      (result or {}).get("checks", {}).items()}
            print(f"{cell} seed {seed} trace {trace} rc {p.returncode} "
                  f"wall {wall:.1f} s correct "
                  f"{(result or {}).get('correct')} {summary} {checks}",
                  flush=True)
            if result is None:
                print(p.stderr[-2000:], flush=True)
            if args.stop and not (result or {}).get("correct"):
                print("stopped: the run failed or is not correct",
                      flush=True)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
