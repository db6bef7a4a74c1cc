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
from repro_torch.models.rglru import rglru_scan
from repro_torch.models.ssm import ssd_chunked

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


def swiglu_ref(x, wi, wg, wo, round_a=False):
    """(T,d) x -> ((silu(x wg) * (x wi)) wo).  ``round_a`` rounds the
    intermediate a = silu(x wg) * (x wi) to bf16 before the second product,
    as the bf16 kernel stores it (the tests hold that kernel to this mirror
    at the tight tolerance)."""
    h = x @ wi
    g = x @ wg
    a = F.silu(g) * h
    if round_a:
        a = a.to(torch.bfloat16).to(a.dtype)
    return a @ wo


def rglru_ref(log_a, b):
    """h_t = exp(log_a_t) h_{t-1} + b_t over axis 1, f32. (B,S,W)."""
    return rglru_scan(log_a, b)


def ssd_ref(x, dt, A, Bm, Cm, chunk=64):
    """Mamba2 SSD, chunked and masked before the exponential.  Returns
    (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32)."""
    return ssd_chunked(x, dt, A, Bm, Cm, chunk)


#: bf16's unit roundoff: a bf16 has an 8-bit significand, so rounding to
#: nearest moves a value by at most 2^-8 of itself
BF16_UNIT = 2.0 ** -8
#: the bf16 SSD kernel's roundings to bf16 before a product, as multiples
#: of BF16_UNIT on each path: y meets W' (intra-chunk) or B' then S_{c-1}
#: (carried state: 2u + u^2 <= 3u); the final state meets B' only
SSD_BF16_ROUNDINGS = {"y": 3, "state": 1}


def ssd_bf16_tolerance(x, dt, A, Bm, Cm, chunk, want):
    """Elementwise bounds on |kernel - want| for the bf16 SSD kernel, where
    ``want`` = (y, state) of the plain version in f32 on the same bf16
    inputs.  Each rounding moves its product by at most BF16_UNIT of the
    product's sum of |terms|; with dt >= 0 and every decay factor > 0 the
    plain version on absolute values bounds each such sum elementwise:
    ``Y_abs, S_abs = ssd_ref(|x|, dt, A, |B|, |C|, chunk)``.  Returns (y
    bound, state bound):
    ``k BF16_UNIT X_abs + 1e-4 max|want| + 2^-8 |want|`` (the last term:
    y's own rounding as it is stored; 1e-4 max|want|: f32 sums in another
    order), with k from SSD_BF16_ROUNDINGS."""
    f = [t.float() for t in (x, Bm, Cm)]
    y_abs, s_abs = ssd_ref(f[0].abs(), dt.float(), A.float(), f[1].abs(),
                           f[2].abs(), chunk)
    out = []
    for part, xa, w in (("y", y_abs, want[0]), ("state", s_abs, want[1])):
        w = w.float()
        out.append(SSD_BF16_ROUNDINGS[part] * BF16_UNIT * xa
                   + 1e-4 * float(w.abs().max()) + 2.0 ** -8 * w.abs())
    return tuple(out)


def ssd_scan_ref(x, dt, A, Bm, Cm):
    """Mamba2 SSD token by token, in f32: ``h = exp(dt·A)·h + dt·x⊗B``,
    ``y = C·h`` (the decode step's arithmetic over a whole sequence).
    Returns (y in x's dtype, final state), as ``ssd_ref`` does; it holds
    the chunk math of ``ssd_ref`` and of the kernel where the JAX
    reference is not finite."""
    b, s, h, p = x.shape
    state = torch.zeros((b, h, p, Bm.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()                                     # (B,H)
        da = torch.exp(dtt * A.float())
        dbx = torch.einsum("bhp,bn,bh->bhpn", x[:, t].float(),
                           Bm[:, t].float(), dtt)
        state = da[..., None, None] * state + dbx
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].float(), state))
    return torch.stack(ys, dim=1).to(x.dtype), state
