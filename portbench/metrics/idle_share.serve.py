"""idle_share.serve (%): the window's wall time in which no decode step
ran on the card: 1 - (summed CUDA-event time of the replays) / window."""
from portbench.stats import share


def read(r):
    ms = r.get("replay_ms")
    if not ms:
        return None
    return share(r["window_s"] - sum(ms) / 1e3, r["window_s"])
