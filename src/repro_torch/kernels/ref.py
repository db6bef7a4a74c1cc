"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``, the jnp oracles).

These are what ``kernels.ops`` runs on CPU tensors and what the CUDA kernels
are held against on the card.  They repeat the reference's arithmetic and
are no yardstick of speed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import attention_naive

#: voxels per pass of ``mriq_ref``: bounds its (rows, M) intermediates to a
#: few hundred MB at the paper's M = 3072; rows are independent, so the
#: result does not depend on it
MRIQ_ROWS = 8192


def mriq_ref(kx, ky, kz, phi_mag, x, y, z):
    """Parboil MRI-Q: Q matrix for non-Cartesian 3D MRI reconstruction.

    Q_r(n) = sum_m phi_mag[m] * cos(2*pi * (kx[m] x[n] + ky[m] y[n] + kz[m] z[n]))
    Q_i(n) = sum_m phi_mag[m] * sin(2*pi * ...)
    """
    qr = torch.empty_like(x)
    qi = torch.empty_like(x)
    for i in range(0, x.shape[0], MRIQ_ROWS):
        sl = slice(i, i + MRIQ_ROWS)
        ang = 2.0 * math.pi * (torch.outer(x[sl], kx) + torch.outer(y[sl], ky)
                               + torch.outer(z[sl], kz))      # (rows, M)
        qr[sl] = torch.sum(phi_mag[None, :] * torch.cos(ang), dim=1)
        qi[sl] = torch.sum(phi_mag[None, :] * torch.sin(ang), dim=1)
    return qr, qi


def flash_attention_ref(q, k, v, causal=True, window=0):
    """q (B,S,Hq,D), k/v (B,T,Hkv,D) -> (B,S,Hq,D); positions from 0."""
    qpos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=k.device)
    return attention_naive(q, k, v, qpos, kpos, causal, window)


def swiglu_ref(x, wi, wg, wo):
    """(T,d) x -> ((silu(x wg) * (x wi)) wo)."""
    h = x @ wi
    g = x @ wg
    return (F.silu(g) * h) @ wo
