"""The yardstick's arithmetic: the card's peaks, the least time a piece of
work can take on it, and the operations and bytes of the kernels the
cells time.  (A model's own operations sit beside its plain reference,
``reference/<name>.py``.)

Frozen copies from the port's ``chip_smoke.py``: ``PEAK_*`` and ``bound``
(there ``bound()``, here in seconds), ``swiglu_work`` (the swiglu case's
``6 T d f`` operations and its bytes) and ``ssd_work`` (``ssd_work``).
"""
from __future__ import annotations

#: the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
PEAK_BF16 = 989e12      # FLOP/s, tensor cores
PEAK_F32 = 67e12        # FLOP/s, CUDA cores
PEAK_BYTES = 3.35e12    # B/s, HBM3


def bound(flops: float, peak: float, nbytes: float) -> float:
    """The card's least seconds for the work: the larger of its operations
    at ``peak`` and its bytes at the HBM rate."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def swiglu_work(t: int, d: int, f: int, elt: int = 2) -> tuple:
    """(operations, bytes) of silu(x wg) (x wi) wo for x (t, d): three
    weight matrices read once, x read and y written once."""
    return 6.0 * t * d * f, (3 * d * f + 2 * t * d) * elt


def ssd_work(b: int, s: int, h: int, p: int, n: int, q: int,
             elt: int) -> tuple:
    """(operations, bytes) the SSD function needs at this shape: the
    scores C B^T once per chunk; per head W' x over the pairs j <= i, the
    chunk's state and, for the chunks after the first, the carried
    state's part of y; each input read once, y and the final state
    written once."""
    flops = 0
    for c0 in range(0, s, q):
        L = min(q, s - c0)
        pairs = L * (L + 1) // 2
        flops += 2 * b * pairs * n + 2 * b * h * (
            pairs * p + L * p * n + (L * p * n if c0 else 0))
    nbytes = (2 * b * s * h * p + 2 * b * s * n) * elt + (b * s * h + h) * 4 \
        + b * h * p * n * 4
    return flops, nbytes
