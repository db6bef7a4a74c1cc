"""Gradient compression: int8 block quantization with error feedback.

Counterpart of ``repro.train.compress``.  Gradients are quantized to int8
with the quantization residual carried in an error-feedback buffer, so the
scheme stays unbiased over steps (1-bit-Adam/EF-SGD style).
``ef_compress_tree`` is the numerics path inside the train step; like the
optimizers it works on leaf dicts (reference leaf path -> the port's
tensors; see ``train.optimizer``), so each stacked leaf gets one scale and
one error buffer, as in the reference.  ``compressed_psum`` is the
int8-on-the-wire sum over a ``torch.distributed`` group, the reference's
``shard_map`` collective.
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import is_stacked, leaf_shape, leaf_value

BLOCK = 512


def quantize(x: torch.Tensor):
    """f32 array -> (int8 blocks, f32 scales). Lossy."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale, shape, size: int) -> torch.Tensor:
    x = (q.float() * scale).reshape(-1)[:size]
    return x.reshape(shape)


def ef_compress(g: torch.Tensor, err: torch.Tensor):
    """One error-feedback round: returns (decompressed g_hat, new_err),
    with one scale for the whole tensor, as the reference's."""
    corrected = g.float() + err
    scale = corrected.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(corrected / scale), -127, 127)
    ghat = q * scale
    return ghat.to(g.dtype), corrected - ghat


def ef_init(params: dict) -> dict:
    """A zero f32 error buffer per reference leaf, in its shape."""
    return {k: torch.zeros(leaf_shape(k, ts), dtype=torch.float32,
                           device=ts[0].device)
            for k, ts in params.items()}


@torch.no_grad()
def ef_compress_tree(grads: dict, err_tree: dict):
    """``ef_compress`` on each reference leaf of ``grads`` (stacked one
    leaf at a time).  Returns (g_hat leaf dict, new error buffers)."""
    ghat, err = {}, {}
    for k, gs in grads.items():
        gh, err[k] = ef_compress(leaf_value(k, gs), err_tree[k])
        ghat[k] = list(gh.unbind(0)) if is_stacked(k) else [gh]
    return ghat, err


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-on-the-wire sum of ``x`` over ``group`` (default: the world),
    divided by the group's size: the reference's ``compressed_psum`` under
    ``shard_map``, in its order and dtypes.

    Each rank quantizes its own ``x`` in blocks (``quantize``); the int8
    payloads, widened to int32 so that the sum cannot overflow, are summed
    with ``all_reduce``; the scales are reduced with MAX (a replica's
    blocks share its own scale layout, so the common scale is the
    largest); the sum times the max scale, cut to ``x``'s size, is divided
    by the number of ranks and cast back to ``x``'s dtype.  As in the
    reference, the payload travels widened to int32."""
    import torch.distributed as dist
    q, s = quantize(x)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    smax = s.clone()
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    approx = (qsum.float() * smax).reshape(-1)[:x.numel()]
    n = dist.get_world_size(group)
    return (approx / n).reshape(x.shape).to(x.dtype)
