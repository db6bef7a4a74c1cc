"""ssd_roofline (%): the ssd kernel's forward at the train microbatch (one
row of seq_len, the config's heads, state and chunk, bf16): the card's
least time for its work (``work.ssd_work``) over its profiled device time a
call (``rules/ssd.txt``, calls by the kernel's launch counter)."""
from portbench import work
from portbench.stats import rule_seconds, share


def read(r):
    prof, calls = r.get("profile"), r.get("launches", {}).get("ssd", 0)
    if not prof or not calls:
        return None
    cfg = r["config"]
    di = cfg["expand"] * cfg["d_model"]
    flops, nbytes = work.ssd_work(r["micro_rows"], r["seq_len"],
                                  di // cfg["headdim"], cfg["headdim"],
                                  cfg["d_state"], cfg["chunk_size"], 2)
    least = work.bound(flops, work.PEAK_BF16, nbytes)
    return share(least, rule_seconds(prof, "ssd") / calls)
