#!/usr/bin/env python3
"""Serve qwen2-7b at full width with an earlier checkout of the port and
with this one, in turns, on one CUDA card.

    python3 src/repro_torch/benchmarks/serve_ab.py --parent DIR [--rounds 1]

DIR is the root of an earlier checkout (its ``src/repro_torch`` and its
``chip_smoke.py``), for example unpacked with

    git archive <commit> | tar -x -C DIR

Each side runs in a process of its own (it imports its own tree's package
and builds its own kernels), in the order earlier, current, current,
earlier (``--rounds`` times): qwen2-7b under the offload plan with
weights from seed 0, then ``chip_smoke.phase_serve`` (8 requests of 16
new tokens, 8 slots) and one prefill of 2 x 512 tokens, four times each;
the first of the four is a warm-up.  Prints the card's name and power
limit, then one line per run: the tokens/s of the three timed serves and
the seconds of the three timed prefills.  Run it as a file (not with
``-m``): each child imports the package of the tree it is given.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def child(tree: Path, label: str) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    CS.log = lambda msg: None
    cfg = get_config("qwen2-7b")
    model = Model(cfg, cfg.plan.replace(**CS.OFFLOAD))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 512)).astype(np.int32)).cuda()
    walls, prefills = [], []
    for _ in range(4):
        walls.append(CS.phase_serve(model, params))
        cache = model.init_cache(2, 512)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize()
        prefills.append(time.perf_counter() - t0)
    print(f"{label} ({tree}): serve tokens/s "
          + " ".join(f"{128 / w:.2f}" for w in walls[1:])
          + "; prefill 2x512 s " + " ".join(f"{p:.4f}" for p in prefills[1:]),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child.resolve(), args.label)
        return 0
    if args.parent is None:
        ap.error("--parent DIR is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    sides = {"earlier": args.parent.resolve(), "current": ROOT}
    for _ in range(args.rounds):
        for label in ("earlier", "current", "current", "earlier"):
            subprocess.run([sys.executable, __file__, "--child",
                            str(sides[label]), "--label", label],
                           check=True, timeout=1200)
    return 0


if __name__ == "__main__":
    sys.exit(main())
