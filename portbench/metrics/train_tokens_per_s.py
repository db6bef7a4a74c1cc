"""train_tokens_per_s (tokens/s): tokens of the window's completed train
steps over those steps' wall time (host clock, synchronised)."""


def read(r):
    if "train_tokens" not in r or not r["window_s"]:
        return None
    return r["train_tokens"] / r["window_s"]
