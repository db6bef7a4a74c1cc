"""Fused SwiGLU MLP on the H100: binding of ``csrc/swiglu.cu``.

Counterpart of ``repro.kernels.swiglu`` (the Pallas TPU kernel
``swiglu_pallas``).  The ff axis is split across blocks and the partial
products meet in an f32 buffer by atomic adds; the (T, d_ff) intermediate
never reaches device memory.  See the source for its bound and design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (CudaKernel, c_int, c_ptr,
                                        check_operand, stream_of)

KERNEL = CudaKernel("swiglu", [c_ptr] * 6 + [c_int] * 4 + [c_ptr])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def swiglu_cuda(x, wi, wg, wo):
    """x (T,d); wi, wg (d,f); wo (f,d) -> (T,d), all one dtype; d and f
    multiples of 8."""
    dev = x.device
    check_operand("x", x, 2, tuple(DTYPES), dev)
    for name, w in (("wi", wi), ("wg", wg), ("wo", wo)):
        check_operand(name, w, 2, (x.dtype,), dev)
    t, d = x.shape
    f = wi.shape[1]
    if wi.shape != (d, f) or wg.shape != (d, f) or wo.shape != (f, d):
        raise ValueError(f"weights {tuple(wi.shape)}/{tuple(wg.shape)}/"
                         f"{tuple(wo.shape)} do not fit x {tuple(x.shape)}")
    if d % 8 or f % 8:
        raise ValueError(f"d={d} and f={f} must be multiples of 8")
    y32 = torch.empty((t, d), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    KERNEL.launch(x.data_ptr(), wi.data_ptr(), wg.data_ptr(), wo.data_ptr(),
                  y32.data_ptr(), y.data_ptr(), t, d, f, DTYPES[x.dtype],
                  stream_of(x))
    return y
