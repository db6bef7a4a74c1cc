"""capture_s.train (s): the train step's first call, its eager step and
its capture as a CUDA graph (``TrainGraph``), host clock."""


def read(r):
    return r.get("first_call_s")
