"""mfu.train (%): model operations of the window's train steps (6 x the
products' weights x tokens, plus the SSD's forward and backward from its
shapes) over the window's seconds, against the card's bf16 peak."""
from portbench import core, work
from portbench.stats import share


def read(r):
    if "train_steps" not in r or not r["train_steps"]:
        return None
    ops = r["train_steps"] * core.reference(r["reference"]).train_step_flops(
        r["config"], r["batch"], r["seq_len"])
    return share(ops / r["window_s"], work.PEAK_BF16)
