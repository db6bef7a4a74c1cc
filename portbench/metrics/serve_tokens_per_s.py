"""serve_tokens_per_s (tokens/s): tokens generated for every request in the
window over the window's seconds (host clock)."""


def read(r):
    if "gen_tokens" not in r or not r["window_s"]:
        return None
    return r["gen_tokens"] / r["window_s"]
