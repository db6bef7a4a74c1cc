"""End-to-end training driver (CLI).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-lm \
        --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch tiny-test --steps 8

Counterpart of ``repro.launch.train``: runs the fault-tolerant driver on
``--device`` (default: the card; raises without one): synthetic-but-
learnable data, the arch's optimizer, periodic atomic checkpoints,
straggler accounting, optional failure injection (to demo
checkpoint-restart end to end: the run stops at the failure, and a second
run with ``--resume`` continues from the last checkpoint).  The step is
``train.step.TrainGraph``, the reference's jitted step with its buffers
donated: on ``cuda`` captured once as a CUDA graph and replayed for every
later step (captured again after a restore, which brings new optimizer
state).  Checkpoints
go to ``--ckpt-dir``, by default ``artifacts/torch/train_ckpt`` (the
reference's CLI keeps ``artifacts/train_ckpt``).
``run(args, model=None)`` is the library entry; ``model`` trains a model
the caller built (its own plan and device; ``args.device`` is then not
read).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import time
from pathlib import Path
from typing import Optional

from repro_torch.artifacts import TRAIN_CKPT
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft.driver import FailureInjector, TrainDriver
from repro_torch.models.model import Model
from repro_torch.train.step import TrainGraph, make_opt_init


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-lm")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config of the arch")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=str(TRAIN_CKPT))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (demo FT)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def run(args, model: Optional[Model] = None) -> dict:
    """Train ``args.steps`` steps (resuming from ``args.ckpt_dir`` with
    ``--resume``); prints the reference's report lines, writes
    ``train_log.json`` beside the checkpoints and returns the driver's
    result with the wall seconds.  An injected failure propagates."""
    if model is None:
        cfg = get_config(args.arch, reduced=args.reduced)
        cfg = dataclasses.replace(
            cfg, plan=cfg.plan.replace(microbatches=args.microbatches))
        model = Model(cfg, device=args.device)
    cfg = model.cfg
    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    driver = TrainDriver(
        model=model, train_step=TrainGraph(model),
        opt_init=make_opt_init(model), data_cfg=data_cfg,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        injector=FailureInjector(fail_at=set(args.fail_at)) if args.fail_at
        else None)

    t0 = time.time()
    result = driver.run(args.steps)
    wall = time.time() - t0

    losses = result["losses"]
    for rec in losses[:: args.log_every]:
        print(f"step {rec['step']:5d}  loss {rec['loss']:.4f}  "
              f"{rec['seconds']*1e3:.0f} ms")
    first = losses[0]["loss"] if losses else float("nan")
    last = losses[-1]["loss"] if losses else float("nan")
    print(f"\n{cfg.name}: {len(losses)} steps in {wall:.1f}s  "
          f"loss {first:.3f} -> {last:.3f}  "
          f"stragglers={len(result['stragglers'])}")
    out = Path(args.ckpt_dir) / "train_log.json"
    out.write_text(json.dumps(result, indent=1))
    print(f"log: {out}")
    return {**result, "wall_s": wall}


def main(argv: Optional[list] = None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
