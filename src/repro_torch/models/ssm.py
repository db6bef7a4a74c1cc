"""Mamba2 (SSD — state-space duality) block.

Counterpart of ``repro.models.ssm``.  Prefill and the forward pass run the
chunked SSD scan: within a chunk the quadratic dual form, across chunks a
(H, P, N) state carried in f32.  The 'pallas' destination of
``plan.ssm_impl`` routes the scan to the SSD kernel (``kernels.ops.ssd``).
Decode is the plain recurrence ``h = exp(dt·A)·h + dt·x⊗B``, ``y = C·h``,
in stock ops, as in the reference.

``ssd_chunked`` takes the decay ``exp(cum_i − cum_j)`` only where i ≥ j:
the mask comes before the exponential.  The reference exponentiates the
whole (Q, Q) block and masks afterwards, which overflows to inf (and inf·0
to NaN) once a chunk's ``|Σ dt·A|`` passes f32's ~88 — at mamba2-1.3b's
own chunk of 256 (ROADMAP.md, fault C1).  Where the reference is finite the
two agree.

The cache (``init_ssm_cache``) is updated in place: decode and prefill
write the new conv window and SSM state into the dict's tensors and return
the same dict.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.models.layers import cast_weight, cdtype


def mamba2_spec(cfg: ArchConfig) -> dict:
    """param -> (shape, init rule) of one mamba2 mixer, with the
    reference's shapes and scales (``ssm.init_mamba2``)."""
    d, di, n, h, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_nheads, cfg.ssm_conv)
    in_width = 2 * di + 2 * n + h            # z, x, B, C, dt
    return {"in_proj": ((d, in_width), ("normal", 1.0 / math.sqrt(d))),
            "conv_w": ((k, di + 2 * n), ("normal", 1.0 / math.sqrt(k))),
            "conv_b": ((di + 2 * n,), ("zeros",)),
            "A_log": ((h,), ("zeros",)),     # A = -exp(A_log) = -1
            "D": ((h,), ("ones",)),
            "dt_bias": ((h,), ("zeros",)),
            "norm": ((di,), ("ones",)),
            "out_proj": ((di, d), ("normal", 1.0 / math.sqrt(di)))}


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x (B,S,C), w (K,C), state (B,K-1,C) or None
    -> (out (B,S,C), new state: the last K-1 rows of [state; x])."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return out + b, new_state


def _silu(x):
    """x·sigmoid(x) as ``jax.nn.silu`` computes it: in bf16 the sigmoid
    rounds before the product (``F.silu`` rounds once)."""
    return x * torch.sigmoid(x)


def _split_proj(zxbcdt, cfg: ArchConfig):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    assert dt.shape[-1] == h
    return z, xbc, dt


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan, masked before the exponential.

    x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N) -> (y (B,S,H,P) in x's
    dtype, final state (B,H,P,N) f32).  The chunk is the reference's:
    ``chunk`` if it divides S, else gcd(S, chunk).  One (B,Q,Q,H) decay
    block is live at a time.
    """
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = chunk if s % chunk == 0 else math.gcd(s, chunk) or s
    dA = (dt * A).float()                                  # (B,S,H) <= 0
    xd = (x * dt[..., None]).float()                       # dt-weighted input
    Bf, Cf = Bm.float(), Cm.float()
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    for c0 in range(0, s, q):
        sl = slice(c0, c0 + q)
        xdc, bc, cc = xd[:, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(dA[:, sl], dim=1)               # (B,Q,H)
        cb = torch.einsum("bsn,brn->bsr", cc, bc)          # (B,Q,Q)
        seg = cum[:, :, None, :] - cum[:, None, :, :]      # (B,Q,Q,H)
        decay = torch.exp(seg.masked_fill(~tri[None, :, :, None],
                                          float("-inf")))
        y_intra = torch.einsum("bsrh,brhp->bshp", cb[..., None] * decay, xdc)
        y_inter = torch.einsum("bsn,bhpn->bshp", cc, state) \
            * torch.exp(cum)[..., None]
        tail = torch.exp(cum[:, -1:, :] - cum)             # (B,Q,H)
        s_c = torch.einsum("bshp,bsn->bhpn", xdc * tail[..., None], bc)
        state = torch.exp(cum[:, -1, :])[..., None, None] * state + s_c
        y[:, sl] = (y_intra + y_inter).to(x.dtype)
    return y, state


def run_mamba2(params, x, cfg: ArchConfig, plan: PlanConfig, cache=None,
               decode=False):
    """Mamba2 mixing block. Returns (y, cache).

    cache = {'conv': (B,K-1,di+2N), 'ssm': (B,H,P,N) f32}, written in place
    (prefill and decode); None in the forward pass."""
    dt_c = cdtype(plan)
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    zxbcdt = torch.einsum("bsd,dw->bsw", x,
                          cast_weight(params["in_proj"], dt_c))
    z, xbc, dtt = _split_proj(zxbcdt, cfg)
    A = -torch.exp(params["A_log"].float())
    dt_act = F.softplus(dtt.float() + params["dt_bias"].float())
    conv_w = cast_weight(params["conv_w"], dt_c)
    conv_b = cast_weight(params["conv_b"], dt_c)

    if decode:
        xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, cache["conv"])
        xin = _silu(xbc[..., :di]).reshape(x.shape[0], 1, h, p)
        Bm = xbc[..., di:di + n]
        Cm = xbc[..., di + n:]
        hs = cache["ssm"]                                   # (B,H,P,N)
        da = torch.exp(dt_act[:, 0, :] * A)                 # (B,H)
        dbx = torch.einsum("bhp,bn,bh->bhpn", xin[:, 0].float(),
                           Bm[:, 0].float(), dt_act[:, 0])
        hs = da[..., None, None] * hs + dbx
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), hs)
        y = y + params["D"].float()[None, :, None] * xin[:, 0].float()
        y = y[:, None].to(dt_c)                             # (B,1,H,P)
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(hs)
    else:
        xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, None)
        xin = _silu(xbc[..., :di])
        Bm = xbc[..., di:di + n]
        Cm = xbc[..., di + n:]
        xh = xin.reshape(x.shape[0], x.shape[1], h, p)
        if plan.ssm_impl == "pallas":
            from repro_torch.kernels import ops as kops
            y, hstate = kops.ssd(xh, dt_act, A, Bm, Cm, chunk=cfg.ssm_chunk)
        else:
            y, hstate = ssd_chunked(xh, dt_act, A, Bm, Cm, cfg.ssm_chunk)
        y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
        if cache is not None:
            cache["conv"].copy_(new_conv)
            cache["ssm"].copy_(hstate)

    y = y.reshape(x.shape[0], -1, di)
    # gated RMSNorm (mamba2)
    y32 = y.float() * F.silu(z.float())
    y32 = y32 * torch.rsqrt(y32.square().mean(-1, keepdim=True) + 1e-6)
    y = (y32 * params["norm"].float()).to(dt_c)
    out = torch.einsum("bsw,wd->bsd", y,
                       cast_weight(params["out_proj"], dt_c))
    return out, cache


def init_ssm_cache(cfg: ArchConfig, batch: int,
                   device: torch.device) -> dict:
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state),
                                dtype=torch.float32, device=device),
            "ssm": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim,
                                cfg.ssm_state), dtype=torch.float32,
                               device=device)}
