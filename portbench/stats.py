"""Arithmetic the metric readers share: quantiles, and device seconds of
a group of profiled kernels."""
from __future__ import annotations

import re

from portbench import core


def quantile(values, q: float) -> float:
    """The ``q`` quantile of ``values`` with linear interpolation between
    the two nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    x = q * (len(v) - 1)
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def rule_seconds(profile: dict, rule: str) -> float:
    """Device seconds of the profiled kernels ``portbench/rules/<rule>.txt``
    matches."""
    pats = [re.compile(p) for p in core.kernel_rule(rule)]
    return sum(s for name, s, _ in profile["kernels"]
               if any(p.search(name) for p in pats))


def share(part: float, whole: float):
    """``part`` as a percentage of ``whole``; None where there is no whole
    or no part to read."""
    if not whole or part <= 0:
        return None
    return 100.0 * part / whole
