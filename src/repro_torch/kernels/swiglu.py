"""Fused SwiGLU MLP on the H100: binding of ``csrc/swiglu.cu``.

Counterpart of ``repro.kernels.swiglu`` (the Pallas TPU kernel
``swiglu_pallas``). bf16 runs on the tensor cores in one of two designs,
chosen here by T (``plan``): ``decode`` (T <= ``DECODE_MAX_T``,
mma.sync) splits the K-depth of both products across blocks and adds the
f32 partial sums in a fixed order; ``prefill`` (wgmma) runs a dual GEMM
x @ [wi | wg] with a silu epilogue and then a @ wo. Both keep a = silu(x
wg) * (x wi) as a (T, f) bf16 scratch between the two products. f32 runs
the CUDA-core kernel. See the source for its bound and design.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels._build import (CudaKernel, c_int, c_ptr,
                                        check_operand, stream_of)

KERNEL = CudaKernel("swiglu", [c_ptr] * 7 + [c_int] * 6 + [c_ptr])
DTYPES = (torch.float32, torch.bfloat16)
#: design codes of ``swiglu_launch``
DESIGNS = {"f32": 0, "decode": 1, "prefill": 2}
#: bf16: the decode design takes T up to this; at qwen2-7b's widths it is
#: the faster of the two through T=64 on the H100 (PERF.md)
DECODE_MAX_T = 64
#: the decode design's weight tile (K rows x N columns) and the blocks it
#: aims for: about 8 waves over the H100's 132 SMs
DECODE_TILE = 64
DECODE_BLOCKS = 8 * 132


def k_split(k: int, n: int) -> tuple[int, int]:
    """Split the K-depth ``k`` of a product with ``n`` output columns into
    (splits, rows per split) for the decode design: enough splits that
    the 64-column tiles times splits reach ``DECODE_BLOCKS``, each split a
    whole number of 64-row tiles."""
    tiles = math.ceil(n / DECODE_TILE)
    parts = max(1, min(math.ceil(DECODE_BLOCKS / tiles),
                       math.ceil(k / DECODE_TILE)))
    kc = math.ceil(math.ceil(k / parts) / DECODE_TILE) * DECODE_TILE
    return math.ceil(k / kc), kc


def plan(t: int, d: int, f: int, dtype: torch.dtype,
         design: str | None = None) -> dict:
    """The design a call takes and its scratch: ``ws`` f32 elements (f32:
    the (T, d) sum; bf16 decode: the K-split partials, z1 x 2 x T x f for
    h and g, then z2 x T x d for y), ``a`` bf16 elements (the (T, f)
    intermediate), and ``kc1``/``kc2``, the rows of d and of f per split.
    bf16 takes ``decode`` for T <= ``DECODE_MAX_T`` and ``prefill`` above,
    unless ``design`` names one (both take every T; measurements compare
    them on either side of the switch)."""
    if dtype == torch.float32:
        if design not in (None, "f32"):
            raise ValueError(f"f32 has one design, not {design!r}")
        return {"design": "f32", "ws": t * d, "a": 0, "kc1": 0, "kc2": 0}
    if design is None:
        design = "decode" if t <= DECODE_MAX_T else "prefill"
    if design == "decode":
        z1, kc1 = k_split(d, f)
        z2, kc2 = k_split(f, d)
        return {"design": "decode", "ws": z1 * 2 * t * f + z2 * t * d,
                "a": t * f, "kc1": kc1, "kc2": kc2}
    if design != "prefill":
        raise ValueError(f"unknown bf16 design {design!r}")
    return {"design": "prefill", "ws": 0, "a": t * f, "kc1": 0, "kc2": 0}


def _tile_smem(bm: int, bn: int, bk: int, stages: int, dual: bool) -> int:
    """An mma.sync decode ``Tile``'s ring: per stage an A tile and one or
    two B tiles, rows padded by 8 bf16."""
    return stages * (bm * (bk + 8) + (2 if dual else 1) * bk * (bn + 8)) * 2


def _wg_tile_smem(stages: int, dual: bool) -> int:
    """A wgmma prefill ``WgTile``'s ring: per stage 128 x 64 token rows
    and one or two 128 x 64 weight tiles, bf16, + 1 KB alignment slack."""
    return stages * (128 * 64 * 2 + (2 if dual else 1) * 128 * 64 * 2) \
        + 1024


def smem_bytes(t: int, d: int, f: int, dtype: torch.dtype,
               design: str | None = None) -> int:
    """Dynamic shared memory the launcher requests for (T, d) x (d, f):
    the larger of the two products' (f32: the one kernel's gated tile,
    x tile and weight panels, 8 or 64 tokens a tile)."""
    p = plan(t, d, f, dtype, design)["design"]
    if p == "f32":
        bt = 8 if t <= 32 else 64
        return (128 * bt + 32 * bt + 2 * 32 * 128) * 4
    if p == "decode":
        return max(_tile_smem(32, 64, 64, 4, True),
                   _tile_smem(32, 64, 64, 4, False))
    return max(_wg_tile_smem(4, True), _wg_tile_smem(3, False))


def swiglu_cuda(x, wi, wg, wo, design: str | None = None, out_a=None):
    """x (T,d); wi, wg (d,f); wo (f,d) -> (T,d), all one dtype; d and f
    multiples of 8.  ``design`` overrides ``plan``'s choice; ``out_a``, a
    (T, f) bf16 tensor, receives the bf16 designs' intermediate a (the
    card tests hold each product on its own through it)."""
    dev = x.device
    check_operand("x", x, 2, DTYPES, dev)
    for name, w in (("wi", wi), ("wg", wg), ("wo", wo)):
        check_operand(name, w, 2, (x.dtype,), dev)
    t, d = x.shape
    f = wi.shape[1]
    if wi.shape != (d, f) or wg.shape != (d, f) or wo.shape != (f, d):
        raise ValueError(f"weights {tuple(wi.shape)}/{tuple(wg.shape)}/"
                         f"{tuple(wo.shape)} do not fit x {tuple(x.shape)}")
    if d % 8 or f % 8:
        raise ValueError(f"d={d} and f={f} must be multiples of 8")
    p = plan(t, d, f, x.dtype, design)
    ws = torch.empty(max(p["ws"], 1), dtype=torch.float32, device=dev)
    if out_a is None:
        a = torch.empty(max(p["a"], 8), dtype=torch.bfloat16, device=dev)
    else:
        if p["design"] == "f32":
            raise ValueError("the f32 kernel keeps no intermediate a")
        check_operand("out_a", out_a, 2, (torch.bfloat16,), dev)
        if out_a.shape != (t, f):
            raise ValueError(f"out_a {tuple(out_a.shape)} is not {(t, f)}")
        a = out_a
    y = torch.empty_like(x)
    KERNEL.launch(x.data_ptr(), wi.data_ptr(), wg.data_ptr(), wo.data_ptr(),
                  ws.data_ptr(), a.data_ptr(), y.data_ptr(), t, d, f,
                  DESIGNS[p["design"]], p["kc1"], p["kc2"], stream_of(x))
    return y
