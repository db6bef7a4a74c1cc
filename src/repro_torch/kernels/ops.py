"""Public wrappers for the port's kernels (the 'pallas' destination).

Counterpart of ``repro.kernels.ops``.  Each wrapper dispatches on where its
tensors lie: CPU tensors go to the plain version in ``kernels.ref``; CUDA
tensors launch the hand-written kernel, or the launch raises — there is no
fallback.  The reference's "fall back to the oracle when a block is < 8"
rule existed for TPU tiling and is not carried over: the CUDA kernels mask
ragged edges, so decode batches of any size reach them.

No ``torch.autograd.Function`` yet: this slice serves.  The reference's
VJPs (the backward through the oracle) come with the training slice.
"""
from __future__ import annotations

import math

from repro_torch.device import same_device
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.mriq import mriq_cuda
from repro_torch.kernels.swiglu import swiglu_cuda


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q (B,S,Hq,D); k, v (B,T,Hkv,D) -> (B,S,Hq,D)."""
    if same_device(q, k, v).type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal, window)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, window)


def mriq(kx, ky, kz, phi_mag, x, y, z):
    """Parboil MRI-Q -> (Qr, Qi)."""
    args = (kx, ky, kz, phi_mag, x, y, z)
    if same_device(*args).type == "cpu":
        return _ref.mriq_ref(*args)
    return mriq_cuda(*(a.contiguous() for a in args))


def fused_swiglu(x, wi, wg, wo):
    """x (..., d) -> (..., d); flattens leading dims for the kernel."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    xf = x.reshape(math.prod(lead), d)
    if same_device(x, wi, wg, wo).type == "cpu":
        y = _ref.swiglu_ref(xf, wi, wg, wo)
    else:
        y = swiglu_cuda(xf.contiguous(), wi.contiguous(), wg.contiguous(),
                        wo.contiguous())
    return y.reshape(*lead, d)
