"""Mamba2 SSD chunked scan on the H100: binding of ``csrc/ssd.cu``.

Counterpart of ``repro.kernels.ssd`` (the Pallas TPU kernel
``ssd_pallas``).  Every chunk runs in parallel: one launch computes each
chunk's scores C Bᵀ (once for all heads) and each chunk's own state,
passes the states across chunks in order, then scans each 64-row query
tile against its key tiles below the diagonal, masked before the
exponential (bf16 products on the tensor cores, f32 on the CUDA cores).
See the source for its bound, design and roundings.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (CudaKernel, c_int, c_ptr,
                                        check_operand, stream_of)

KERNEL = CudaKernel("ssd", [c_ptr] * 11 + [c_int] * 7 + [c_ptr])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_STATE = 128


def ssd_cuda(x, dt, A, Bm, Cm, chunk: int):
    """x (B,S,H,P) and Bm/Cm (B,S,N) in one dtype, dt (B,S,H) and A (H,)
    f32 -> (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32), chunks
    of ``chunk`` positions (the last one may be shorter)."""
    dev = x.device
    check_operand("x", x, 4, tuple(DTYPES), dev)
    check_operand("dt", dt, 3, (torch.float32,), dev)
    check_operand("A", A, 1, (torch.float32,), dev)
    check_operand("Bm", Bm, 3, (x.dtype,), dev)
    check_operand("Cm", Cm, 3, (x.dtype,), dev)
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,) or Bm.shape != (b, s, n) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"head dim {p} / state {n} over {MAX_HEAD_DIM} / "
                         f"{MAX_STATE}")
    if s < 1 or chunk < 1:
        raise ValueError(f"sequence {s} and chunk {chunk} must be >= 1")
    q = min(chunk, s)
    nc = -(-s // q)
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    qp = 64 * -(-q // 64)
    # scratch, in one allocation: each chunk's own state (f32), the state
    # entering it (x's dtype), the chunks' cumsums of dt·A (B,H,S) and each
    # chunk's scores C Bᵀ (B,nc,QP,QP), QP = 64·ceil(Q/64)
    parts = [b * nc * h * p * n * 4, b * nc * h * p * n * x.element_size(),
             b * h * s * 4, b * nc * qp * qp * 4]
    ends = [0]
    for size in parts:
        ends.append(ends[-1] + -(-size // 256) * 256)
    ws = torch.empty(ends[-1], dtype=torch.uint8, device=dev)
    base = ws.data_ptr()
    KERNEL.launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                  Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                  *(base + e for e in ends[:4]), b, s, h, p, n, q,
                  DTYPES[x.dtype], stream_of(x))
    return y, state
