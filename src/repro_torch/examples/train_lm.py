"""End to end: train the ~124M-param tiny-lm for a few hundred steps.

    python -m repro_torch.examples.train_lm [--steps 200] [--smoke] \
        [--device cpu] [--resume]

Counterpart of the repo's ``examples/train_lm.py``, a wrapper of the port's
train CLI (``repro_torch.launch.train``): synthetic-but-learnable data ->
the model -> AdamW -> atomic checkpoints every 50 steps -> restart-safe
(kill it and rerun with ``--resume``; the loss curve continues bit for
bit).  ``--smoke`` trains tiny-test for 8 steps with a checkpoint every 4.
Runs on ``--device`` (default: the card; raises without one); any other
flag of the train CLI passes through.
"""
from __future__ import annotations

import sys
from typing import Optional

from repro_torch.launch import train as T


def train_argv(argv: list) -> list:
    """The train CLI's arguments for ``argv``: ``--smoke``'s, or tiny-lm's
    defaults for whatever ``argv`` leaves out."""
    if "--smoke" in argv:
        return [a for a in argv if a != "--smoke"] + [
            "--arch", "tiny-test", "--steps", "8", "--batch", "2",
            "--seq", "64", "--ckpt-every", "4"]
    argv = list(argv)
    for flag, value in (("--arch", "tiny-lm"), ("--steps", "200"),
                        ("--batch", "4"), ("--seq", "256")):
        if flag not in argv:
            argv += [flag, value]
    return argv


def main(argv: Optional[list] = None) -> dict:
    return T.main(train_argv(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
