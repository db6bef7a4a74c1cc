"""The paper's contribution: power-aware automatic offload search, on the
card (counterpart of ``repro.core``).

Yamato (2021) searches discrete offload decisions (which loop goes to which
device) with evolutionary computation against measured time x power
fitness, narrowing expensive-to-evaluate candidates with static analysis
first.  Here the decision space is the execution plan of a model on one
H100 (which site runs on its hand-written kernel, the attention chunk, the
KV cache dtype) and the "verification environment" is a ladder of
measurement rungs (``core.backends``): the analytic roofline estimate on
the H100 spec for the search's inner loop, a measured trial on the card
(wall clock and the card's NVML energy counter) for the narrowed finalists
and the smoke trial, and recorded replays for offline runs.
"""
