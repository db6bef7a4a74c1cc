"""Run one cell of the port's benchmark on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell's files are found by name
(``portbench/core.py``).  With ``--trace 0`` the result line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.  The
last line of standard output is the result, one JSON object; the numbers
``correct`` compared, each beside its limit, are the last lines of
standard error and the last key of the result.  Without a CUDA card, or
with fewer cards than the cell asks for, it prints no result and exits
with 2; when a forbidden module (``core.FORBIDDEN``) is loaded at the end,
with 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernels build into its own fixed directory inside the
    # checkout; nothing else of it caches, and no library may pull in JAX
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    from portbench import core
    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {n}", file=sys.stderr)
        return 2
    out = core.driver(cell.traffic["driver"]).run(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    metrics = core.metrics_line(cell, out["readings"], bool(args.trace))
    device = out["device"]
    if args.trace and "profile" in out["readings"]:
        device["busy_s"] = out["readings"]["profile"]["busy_s"]
        device["window_s"] = out["readings"]["profile"]["window_s"]
    bad = core.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    checks = out["checks"]
    print(core.checks_text(checks), file=sys.stderr, flush=True)
    print(core.result_line(core.judge(checks), out["attempted"],
                           out["failed"], metrics, device, checks,
                           out["breakdown"] if args.trace else None),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
