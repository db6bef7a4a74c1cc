"""On the card: each cell's control comes out not correct against the
cell's limits, on three seeds, at the cell's configuration with a short
window.  The float8 control puts its own first token in the program's
place (served cells) or its own first steps (the training cell); the
training cell's planted fault (half of each batch left out) must fail one
of its numbers too.  Skips without a card."""
import time

import pytest

from portbench import core

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
SERVED = ["qwen2-7b.serve_chat"]


def fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > v for k, v in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVED)
def test_served_control_fails(card, name):
    cell = core.load_cell(name)
    for seed in SEEDS:
        out = core.driver("serve").run(cell, seed, 5.0, False, "cuda",
                                       time.perf_counter(), control=True)
        assert core.judge(out["checks"]), out["checks"]
        assert not core.judge(out["control"]), out["control"]


@pytest.mark.cuda
def test_train_control_and_fault_fail(card):
    from portbench.drivers import train as T
    from portbench.reference import train as R
    cell = core.load_cell("mamba2-1.3b.train_4k")
    ref = core.reference(cell.config["reference"])
    for seed in SEEDS:
        args = (ref, cell.config, cell.traffic,
                cell.config["plan"]["microbatches"], seed, "cuda",
                cell.traffic["check_steps"])
        want = T.reference_readings(*args)
        low = R.gaps(T.reference_readings(*args, lowp=True), want)
        half = R.gaps(T.reference_readings(
            *args, rows=cell.traffic["batch"] // 2), want)
        assert fails(low, cell.limits), low
        assert fails(half, cell.limits), half
