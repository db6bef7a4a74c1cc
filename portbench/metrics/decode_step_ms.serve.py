"""decode_step_ms.serve (ms): mean device time of one replay of the
captured decode step over the window, CUDA events around each replay
(prompt steps included: they are the same replay)."""


def read(r):
    ms = r.get("replay_ms")
    return sum(ms) / len(ms) if ms else None
