"""MRI-Q on the H100: binding of ``csrc/mriq.cu``.

Counterpart of ``repro.kernels.mriq`` (the Pallas TPU kernel
``mriq_pallas``).  One thread per voxel, k-space chunks staged in shared
memory, accurate ``sincosf``; see the source for its bound and design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (CudaKernel, c_int, c_ptr,
                                        check_operand, stream_of)

KERNEL = CudaKernel("mriq", [c_ptr] * 9 + [c_int, c_int, c_ptr])


def mriq_cuda(kx, ky, kz, phi_mag, x, y, z):
    """k-space (M,) f32 x4, voxels (N,) f32 x3 -> (Qr, Qi), each (N,) f32."""
    dev = x.device
    for name, t in (("kx", kx), ("ky", ky), ("kz", kz), ("phi_mag", phi_mag),
                    ("x", x), ("y", y), ("z", z)):
        check_operand(name, t, 1, (torch.float32,), dev)
    m, n = kx.shape[0], x.shape[0]
    if any(t.shape[0] != m for t in (ky, kz, phi_mag)) or \
            any(t.shape[0] != n for t in (y, z)):
        raise ValueError("k-space arrays must share one length, voxel "
                         "arrays another")
    qr = torch.empty_like(x)
    qi = torch.empty_like(x)
    KERNEL.launch(kx.data_ptr(), ky.data_ptr(), kz.data_ptr(),
                  phi_mag.data_ptr(), x.data_ptr(), y.data_ptr(),
                  z.data_ptr(), qr.data_ptr(), qi.data_ptr(), n, m,
                  stream_of(x))
    return qr, qi
