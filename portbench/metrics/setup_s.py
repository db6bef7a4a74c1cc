"""setup_s (s): process start to the window's first step (host clock)."""


def read(r):
    return r.get("setup_s")
