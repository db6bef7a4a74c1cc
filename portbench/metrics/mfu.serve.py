"""mfu.serve (%): model operations of the tokens the requests need (each
prompt token once, each generated token once, at its own position) over
the window's seconds, against the card's bf16 peak."""
from portbench import core, work
from portbench.stats import share


def read(r):
    if "needed_tokens" not in r:
        return None
    ops = core.reference(r["reference"]).token_flops(
        r["config"], r["needed_tokens"], r["needed_ctx_sum"])
    return share(ops / r["window_s"], work.PEAK_BF16)
