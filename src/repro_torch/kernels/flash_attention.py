"""Flash attention on the H100: binding of ``csrc/flash_attention.cu``.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel).
Blocked online-softmax attention with GQA, causal and sliding-window masks
and scale 1/sqrt(D), returned in q's dtype: bf16 on the tensor cores (f32
accumulators, P rounded to bf16 before PV), f32 on the CUDA cores.  See the
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
#: the f32 kernel's query and key tiles (csrc ``BQ``, ``BK``)
F32_TILE = 64


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory the launcher requests at head dim ``d``.
    bf16 (``AttnTile``): a Q tile and two stages of K and V tiles of 64
    keys, rows of DMAX + 8 bf16 (64 queries and DMAX 128 up to D 128, else
    128 and 256); f32: Qᵀ twice, Kᵀ, V and Pᵀ in f32."""
    if dtype == torch.bfloat16:
        bq, dmax = (64, 128) if d <= 128 else (128, 256)
        return (bq + 4 * 64) * (dmax + 8) * 2
    if dtype == torch.float32:
        return (2 * d * F32_TILE + F32_TILE * d + F32_TILE * F32_TILE) * 4
    raise TypeError(f"dtype {dtype} not in {tuple(DTYPES)}")


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
