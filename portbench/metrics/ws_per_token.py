"""ws_per_token (Ws/token): the card's energy over the window (its NVML
counter's mean draw between the updates that bracket the window, times the
window's seconds) over the window's tokens, generated or trained."""


def read(r):
    tokens = r.get("gen_tokens", r.get("train_tokens"))
    if "energy_j" not in r or not tokens:
        return None
    return r["energy_j"] / r["energy_s"] * r["window_s"] / tokens
