"""Gradient compression: int8 block quantization with error feedback.

Counterpart of ``repro.train.compress``.  Gradients are quantized to int8
with the quantization residual carried in an error-feedback buffer, so the
scheme stays unbiased over steps (1-bit-Adam/EF-SGD style).
``ef_compress_tree`` is the numerics path inside the train step; like the
optimizers it works on leaf dicts (reference leaf path -> the port's
tensors; see ``train.optimizer``), so each stacked leaf gets one scale and
one error buffer, as in the reference.  The reference's
``compressed_psum`` is a collective under ``shard_map`` and comes with the
train step's collectives (ROADMAP.md §A item 1).
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
