"""card_w (W): the card's mean draw over the window, from its NVML energy
counter (joules over seconds between the updates that bracket it)."""


def read(r):
    if "energy_j" not in r or not r["energy_s"]:
        return None
    return r["energy_j"] / r["energy_s"]
