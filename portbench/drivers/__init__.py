"""Drivers: one module a kind of traffic (``serve``, ``train``), named by
a mix's ``driver`` key.  ``run(cell, seed, seconds, trace, device,
t_start, arch=None)`` sets the program up, measures the window and
judges the outputs; it returns the raw readings the metric readers take,
the compared numbers, the device and the counts of work attempted and
failed."""
