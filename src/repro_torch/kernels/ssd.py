"""Mamba2 SSD chunked scan on the H100: binding of ``csrc/ssd.cu``.

Counterpart of ``repro.kernels.ssd`` (the Pallas TPU kernel
``ssd_pallas``).  Every chunk runs in parallel: one launch computes each
chunk's scores C Bᵀ (once for all heads) and each chunk's own state,
passes the states across chunks in order, then scans each 64-row query
tile against its key tiles below the diagonal, masked before the
exponential (bf16 products on the tensor cores, f32 on the CUDA cores).
In bf16 it rounds only y, as it stores it: an f32 operand of a bf16
product enters it as two bf16 parts.  See the source for its bound,
design and arithmetic.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (CudaKernel, c_int, c_ptr,
                                        check_operand, stream_of)

KERNEL = CudaKernel("ssd", [c_ptr] * 11 + [c_int] * 7 + [c_ptr])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_STATE = 128


def _up16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(p: int, n: int, q: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory the launcher requests at head dim ``p``,
    state ``n`` and chunk ``q``: the largest of its passes' (scores C Bᵀ,
    the chunk states, the chunk scan; csrc tiles of 64 positions)."""
    bt, nq = 64, -(-q // 64)
    if dtype == torch.bfloat16:
        pp, np_ = _up16(p), _up16(n)
        ldp, ldn = pp + 8, np_ + 8
        gram = 2 * bt * ldn * 2
        # KG = 128 rows of x, B'_hi and B'_lo
        state = 128 * (ldp + 2 * ldn) * 2 + (2 * q + 8) * 4
        stage = bt * (bt + 8) * 4 + bt * ldp * 2
        scan = stage + max(stage, (bt + 2 * pp) * ldn * 2) + 2 * nq * bt * 4
        return max(gram, state, scan)
    if dtype == torch.float32:
        ldt = bt + 4
        u, v = (1 if p <= 64 else 2), (1 if n <= 64 else 2)
        gram = 2 * n * ldt * 4
        state = (bt * (64 * u + 4) + bt * (64 * v + 4) + 2 * q + 8) * 4
        ldx = 64 * u + 4
        scan = (bt * ldx + bt * ldt + 2 * nq * bt + n * ldt + n * ldx) * 4
        return max(gram, state, scan)
    raise TypeError(f"dtype {dtype} not in {tuple(DTYPES)}")


def scratch_ends(b: int, s: int, h: int, p: int, n: int, q: int) -> list:
    """Byte offsets of the launcher's four scratch parts in one allocation,
    and its size last: each chunk's own state (f32), the state entering it
    (f32, or in bf16 its hi and lo parts: the same bytes), the chunks'
    cumsums of dt·A (B,H,S) and each chunk's scores C Bᵀ (B,nc,QP,QP), QP
    = 64·ceil(Q/64); each part 256-byte aligned."""
    nc, qp = -(-s // q), 64 * -(-q // 64)
    ends = [0]
    for size in (b * nc * h * p * n * 4, b * nc * h * p * n * 4,
                 b * h * s * 4, b * nc * qp * qp * 4):
        ends.append(ends[-1] + -(-size // 256) * 256)
    return ends


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
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    ends = scratch_ends(b, s, h, p, n, q)
    ws = torch.empty(ends[-1], dtype=torch.uint8, device=dev)
    base = ws.data_ptr()
    KERNEL.launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                  Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                  *(base + e for e in ends[:4]), b, s, h, p, n, q,
                  DTYPES[x.dtype], stream_of(x))
    return y, state
