"""RG-LRU linear recurrence on the H100: binding of ``csrc/rglru.cu``.

Counterpart of ``repro.kernels.rglru`` (the Pallas TPU kernel
``rglru_pallas``).  One block per 32 channels of one batch row scans the
whole sequence in windows, each window split across the warps and their
segments combined in shared memory; see the source for its bound and
design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (CudaKernel, c_int, c_ptr,
                                        check_operand, stream_of)

KERNEL = CudaKernel("rglru", [c_ptr] * 3 + [c_int] * 3 + [c_ptr])


def smem_bytes() -> int:
    """Dynamic shared memory the launcher requests: none (its warps meet
    in 4 KB of static shared memory)."""
    return 0


def rglru_cuda(log_a, b):
    """log_a, b (B,S,W) f32 -> h (B,S,W) f32, h_t = exp(log_a_t) h_{t-1}
    + b_t from h = 0."""
    dev = log_a.device
    check_operand("log_a", log_a, 3, (torch.float32,), dev)
    check_operand("b", b, 3, (torch.float32,), dev)
    if b.shape != log_a.shape:
        raise ValueError(f"b {tuple(b.shape)} does not fit log_a "
                         f"{tuple(log_a.shape)}")
    h = torch.empty_like(b)
    KERNEL.launch(log_a.data_ptr(), b.data_ptr(), h.data_ptr(),
                  *log_a.shape, stream_of(b))
    return h
