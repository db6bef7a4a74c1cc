"""swiglu_decode_roofline (%): the swiglu kernel's decode design at the
serve batch (T = slots, qwen2-7b's d and f): the card's least time for
its work (``work.swiglu_work`` at the bf16 peak and HBM rate) over its
profiled device time a call (``rules/swiglu_decode.txt``, calls by the
kernel's launch counter)."""
from portbench import work
from portbench.stats import rule_seconds, share


def read(r):
    prof, calls = r.get("profile"), r.get("launches", {}).get("swiglu", 0)
    if not prof or not calls:
        return None
    cfg = r["config"]
    flops, nbytes = work.swiglu_work(r["slots"], cfg["hidden_size"],
                                     cfg["intermediate_size"])
    least = work.bound(flops, work.PEAK_BF16, nbytes)
    return share(least, rule_seconds(prof, "swiglu_decode") / calls)
