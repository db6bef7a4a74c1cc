"""Flash attention on the H100: binding of ``csrc/flash_attention.cu``.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel).
Blocked online-softmax attention with GQA, causal and sliding-window masks
and scale 1/sqrt(D), computed in f32 and returned in q's dtype; see the
source for its bound and design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import (CudaKernel, c_int, c_ptr,
                                        check_operand, stream_of)

KERNEL = CudaKernel("flash_attention",
                    [c_ptr] * 4 + [c_int] * 8 + [ctypes.c_float, c_int,
                                                 c_ptr])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_cuda(q, k, v, causal: bool = True, window: int = 0):
    """q (B,S,Hq,D); k, v (B,T,Hkv,D) -> (B,S,Hq,D), all one dtype."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, 4, tuple(DTYPES), dev)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, t, hkv, d) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not fit q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"{hq} q heads do not group over {hkv} kv heads")
    if d % 8 or d > MAX_HEAD_DIM or (d > 128 and d % 16):
        raise ValueError(f"head dim {d} must be a multiple of 8 up to 128, "
                         f"or of 16 up to {MAX_HEAD_DIM}")
    o = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  b, s, t, hq, hkv, d, int(causal), int(window),
                  1.0 / math.sqrt(d), DTYPES[q.dtype], stream_of(q))
    return o
