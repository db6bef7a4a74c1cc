"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``, the jnp oracles).

These are what ``kernels.ops`` runs on CPU tensors and what the CUDA kernels
are held against on the card.  They repeat the reference's arithmetic and
are no yardstick of speed.
"""
from __future__ import annotations

import math

import numpy as np
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


def mriq_inputs(seed: int, n: int, m: int, t_max: float | None = None,
                device="cpu"):
    """``mriq_ref``'s arguments from numpy seed ``seed``, f32 on ``device``:
    k-space and voxel coordinates standard normal, phi uniform in [0, 1).
    With ``t_max`` the voxel coordinates are scaled until the largest phase
    |x kx + y ky + z kz| over all pairs is t_max turns."""
    rng = np.random.default_rng(seed)
    k = [rng.standard_normal(m, dtype=np.float32) for _ in range(3)]
    phi = rng.random(m, dtype=np.float32)
    v = [rng.standard_normal(n, dtype=np.float32) for _ in range(3)]
    out = [torch.from_numpy(a).to(device) for a in (*k, phi, *v)]
    if t_max is not None:
        t_abs = 0.0
        for i in range(0, n, MRIQ_ROWS):
            t = sum(torch.outer(a[i:i + MRIQ_ROWS], b)
                    for a, b in zip(out[4:], out[:3]))
            t_abs = max(t_abs, float(t.abs().max()))
        out[4:] = [a * (t_max / t_abs) for a in out[4:]]
    return out


#: f32's unit roundoff (round to nearest: a result moves by at most u of
#: itself)
F32_UNIT = 2.0 ** -24
#: the coefficients of ``csrc/mriq.cu``'s polynomial path (hex literals, as
#: there): sin(2 pi f) = f (S1 + S3 w + S5 w^2 + S7 w^3) and cos(2 pi f) =
#: 1 + C2 w + C4 w^2 + C6 w^3, w = f^2, minimax on |f| <= 1/8
SINCOS_TURNS_SIN = tuple(float.fromhex(h) for h in (
    "0x1.921fb4p+2", "-0x1.4abba8p+5", "0x1.465a3ep+6", "-0x1.2cf5d4p+6"))
SINCOS_TURNS_COS = (1.0,) + tuple(float.fromhex(h) for h in (
    "-0x1.3bd3a2p+4", "0x1.03b162p+6", "-0x1.4ea9e8p+6"))
#: the polynomial path's max |error| against sin and cos of 2 pi r over
#: |r| <= 1/2, its f32 roundings included (2^-23.3 on a dense grid)
SINCOS_TURNS_MAX_ERR = 2.0 ** -23
#: the SFU path's max |error|: __sinf/__cosf's documented 2^-21.41 on
#: [-pi, pi], plus the angle's error: the rounding of 2 pi r (|2 pi r| <= pi
#: < 4: half an ulp, 2^-23) and the f32 constant 2 pi's own error times
#: |r| <= 1/2 (2^-23.45).  The argument can pass pi by one ulp (f32 2 pi is
#: above 2 pi, and halving it is exact); the bound is taken to hold there.
SFU_SINCOS_ERR = (2.0 ** -21.41 + 2.0 ** -23
                  + abs(float(np.float32(2 * math.pi)) - 2 * math.pi) / 2)
#: k points a group sum in ``csrc/mriq.cu``
MRIQ_GROUP = 96
#: 1.5 * 2^23: x + RINT_MAGIC - RINT_MAGIC is rint(x) for |x| < 2^22
RINT_MAGIC = 12582912.0


def _fma32(a, b, c):
    """fmaf in f32, emulated: the product of two f32 values is exact in
    f64, so the f64 sum rounded to f32 (rounded twice only where the f64
    sum itself rounds)."""
    return (a.double() * b.double() + c.double()).float()


def sincos_turns(r):
    """(sin, cos) of 2 pi r for f32 ``r`` with |r| <= 1/2, as the FP32-pipe
    path of ``csrc/mriq.cu`` computes them: the quadrant q = rint(4r) (by
    the magic constant), f = r - q/4 in [-1/8, 1/8] (exact), the
    polynomials ``SINCOS_TURNS_SIN``/``_COS`` in f^2 by fmaf, and sign and
    swap from q mod 4.  Each operation rounds to f32 as the kernel's does.
    Within ``SINCOS_TURNS_MAX_ERR`` of sin and cos; used by the tests."""
    r = r.float()
    u = _fma32(r, torch.full_like(r, 4.0), torch.full_like(r, RINT_MAGIC))
    q = u - RINT_MAGIC                                   # exact
    f = _fma32(q, torch.full_like(q, -0.25), r)          # exact
    w = f * f
    s1, s3, s5, s7 = (torch.tensor(c, dtype=torch.float32)
                      for c in SINCOS_TURNS_SIN)
    c0, c2, c4, c6 = (torch.tensor(c, dtype=torch.float32)
                      for c in SINCOS_TURNS_COS)
    ps = _fma32(_fma32(_fma32(s7.expand_as(w), w, s5), w, s3), w, s1) * f
    pc = _fma32(_fma32(_fma32(c6.expand_as(w), w, c4), w, c2), w, c0)
    qm = q.to(torch.int64) % 4
    swap = (qm % 2) == 1
    s = torch.where(swap, pc, ps)
    c = torch.where(swap, ps, pc)
    s = torch.where(qm >= 2, -s, s)
    c = torch.where((qm == 1) | (qm == 2), -c, c)
    return s, c


def mriq_f32_tolerance(kx, ky, kz, phi_mag, x, y, z):
    """Elementwise bound (N,) on |kernel - Q| for Qr and Qi of the MRI-Q
    kernel (``csrc/mriq.cu``), Q the exact sums on the same f32 inputs (in
    practice ``mriq_ref`` on float64 copies).  With u = 2^-24 (``F32_UNIT``)
    and P = sum_m |phi_m|, per voxel (x, y, z):

    * the phase: t = fmaf(x, kx, fmaf(y, ky, z kz)) rounds three times, by at
      most u of |z kz|, of |y ky| + |z kz| and of the total, so |t^ - t| <=
      u (1+u)^2 (|x kx| + 2 |y ky| + 3 |z kz|); the reduction r = t^ -
      rint(t^) is exact, and sin and cos move by at most the angle's error,
      2 pi |t^ - t|.  Over the pairs: 2 pi u (1+u)^2 (|x| sum|phi kx| +
      2 |y| sum|phi ky| + 3 |z| sum|phi kz|), three closed-form sums;
    * sin and cos of 2 pi r: at most ``SFU_SINCOS_ERR`` (the SFU path; the
      polynomial path's ``SINCOS_TURNS_MAX_ERR`` is smaller) times P;
    * the sums: a group of G = ``MRIQ_GROUP`` pairs adds by fmaf in order,
      within gamma_G = G u / (1 - G u) of its sum of |terms|; the groups
      add into a Kahan-compensated sum, within (2u + 4 n u^2) of the sum of
      |group sums| (n groups); every |term| is at most |phi| (1 + e), e the
      sin/cos error, so: (gamma_G + (2u + 4 n u^2)(1 + gamma_G)) (1 + e) P;
    * 2^-40 P for the float64 reference's own error.

    The f32 plain version pays the phase's roundings too, and more: it
    rounds 2 pi t and takes sin and cos of hundreds of radians."""
    u = F32_UNIT
    k = [t.double().abs() for t in (kx, ky, kz)]
    p = phi_mag.double().abs()
    tot = float(p.sum())
    m = kx.shape[0]
    n_groups = -(-m // MRIQ_GROUP)
    g = MRIQ_GROUP * u / (1 - MRIQ_GROUP * u)
    e = SFU_SINCOS_ERR
    sums = (g + (2 * u + 4 * n_groups * u * u) * (1 + g)) * (1 + e) * tot
    w = [float((p * kk).sum()) for kk in k]
    phase = 2 * math.pi * u * (1 + u) ** 2 * (
        x.double().abs() * w[0] + 2 * y.double().abs() * w[1]
        + 3 * z.double().abs() * w[2])
    return phase + e * tot + sums + 2.0 ** -40 * tot


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
#: the bf16 SSD kernel's hi/lo splits of an f32 operand before a product,
#: on each path: y meets W' (intra-chunk) or B' then S_{c-1} (carried
#: state); the final state meets B' only
SSD_BF16_SPLITS = {"y": 2, "state": 1}


def ssd_bf16_tolerance(x, dt, A, Bm, Cm, chunk, want):
    """Elementwise bounds on |kernel - want| for the bf16 SSD kernel, where
    ``want`` = (y, state) of the plain version in f32 on the same bf16
    inputs.  The kernel rounds one thing, y, once as it stores it (2^-8
    |want|).  Every f32 operand of a bf16 product (B', S_{c-1}, W') enters
    it as hi = bf16(v) and lo = bf16(v - hi), v - hi exact in f32, with
    |v - hi| <= u |v| and |v - hi - lo| <= u |v - hi| <= u^2 |v| (u =
    BF16_UNIT); x, B and C are bf16 already and exact.  So a split moves
    its product by at most u^2 of the product's sum of |terms|.  With dt
    >= 0 and every decay factor > 0, the plain version on absolute values
    bounds those sums elementwise: ``Y_abs, S_abs = ssd_ref(|x|, dt, A,
    |B|, |C|, chunk)``.  The state meets one split (B': u^2 S_abs).  y's
    intra-chunk part meets one (W'), its carried part two: B' moves S_{c-1}
    by at most u^2 S_abs, and the split of that moved state by at most
    u^2 (1 + u^2) S_abs; so k u^2 (1 + u^2) Y_abs with k from
    SSD_BF16_SPLITS covers both parts.  Returns (y bound, state bound),
    each ``k u^2 (1 + u^2) X_abs + 1e-4 (max|want| + |want|)`` (the
    second term: the f32 kernel's tolerance, f32 sums in another order),
    plus ``2^-8 |want|`` for y."""
    f = [t.float() for t in (x, Bm, Cm)]
    y_abs, s_abs = ssd_ref(f[0].abs(), dt.float(), A.float(), f[1].abs(),
                           f[2].abs(), chunk)
    u2 = BF16_UNIT ** 2 * (1 + BF16_UNIT ** 2)
    out = []
    for part, xa, w in (("y", y_abs, want[0]), ("state", s_abs, want[1])):
        w = w.float()
        bnd = SSD_BF16_SPLITS[part] * u2 * xa \
            + 1e-4 * (float(w.abs().max()) + w.abs())
        if part == "y":
            bnd = bnd + BF16_UNIT * w.abs()
        out.append(bnd)
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
