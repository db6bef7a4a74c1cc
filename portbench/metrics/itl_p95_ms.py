"""itl_p95_ms (ms): 95th percentile of the gaps between consecutive output
tokens of one request, pooled over every request, both tokens in the
window (host clock after each step's sync)."""
from portbench.stats import quantile


def read(r):
    gaps = r.get("gaps_ms")
    return quantile(gaps, 0.95) if gaps else None
