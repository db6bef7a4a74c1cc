"""forced_step_share.serve (%): the serve loop's teacher-forced prompt steps
over all its steps in the window, counted from the prompt lengths of the
requests filled in the window and the loop's ``steps_done``."""
from portbench.stats import share


def read(r):
    if "forced_steps" not in r:
        return None
    return share(r["forced_steps"], r["forced_steps"] + r["decode_steps"])
