"""The readings the limits of ``correct`` are set from, on the card at a
cell's own size: the program's numbers beside the control's, and for a
training cell those of each fault planted in the reference.

    python3 portbench/control.py --out DIR --seconds S CELL SEED [SEED ...]

A served cell runs the program's window for each seed (as ``run.py``
does) and judges its served tokens twice: against the float32 reference
(the program's reading) and with the float8 control in its place (the
gap of the token the control puts first).  A training cell runs no
program: the reference in float32 is held against the float8 control and
against the reference with half of each batch left out, the mean taken
over the rest.  (A train step that returns its state unchanged reads 1 by
the change's measure and needs no run.)  With ``--program`` a training
cell's own first steps instead, every reading of them.  One JSON line a
seed goes to ``DIR/control.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program", action="store_true",
                    help="a training cell: the program's readings of its "
                    "first steps instead of the control's")
    ap.add_argument("cell")
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import core
    from portbench.drivers import train as T
    from portbench.reference import train as R
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = core.load_cell(args.cell)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        t = time.perf_counter()
        if cell.traffic["driver"] == "serve":
            r = core.driver("serve").run(cell, seed, args.seconds, False,
                                         "cuda", t, control=True)
            rec = {"program": {k: v["value"] for k, v in r["checks"].items()},
                   "control": {k: v["value"] for k, v in r["control"].items()}}
        elif args.program:
            # the program's first steps and their readings, no window
            r = core.driver("train").run(cell, seed, 0.0, False, "cuda", t)
            rec = {"program": r["gaps"]}
        else:
            ref = core.reference(cell.config["reference"])
            micro = cell.config["plan"]["microbatches"]
            steps = cell.traffic["check_steps"]
            args_ = (ref, cell.config, cell.traffic, micro, seed, "cuda",
                     steps)
            want = T.reference_readings(*args_)
            low = T.reference_readings(*args_, lowp=True)
            half = T.reference_readings(
                *args_, rows=cell.traffic["batch"] // 2)
            rec = {"control": R.gaps(low, want), "half_batch": R.gaps(half, want),
                   "reference_loss": want["loss"]}
        rec.update(cell=args.cell, seed=seed, wall_s=time.perf_counter() - t)
        print(json.dumps(rec), flush=True)
        with open(out / "control.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
