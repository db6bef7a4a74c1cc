"""weight_cast_share.serve (%): device time of the dtype casts
(``rules/weight_casts.txt``; the per-call f32 -> bf16 weight casts of
``models/layers.py`` are nearly all of it) over all device time of the
profiled stretch."""
from portbench.stats import rule_seconds, share


def read(r):
    prof = r.get("profile")
    if not prof:
        return None
    return share(rule_seconds(prof, "weight_casts"), prof["busy_s"])
