"""Core transformer layers: norms, RoPE, GQA attention, MLP.

Counterpart of ``repro.models.layers`` (dense parts: RMSNorm and SwiGLU,
which every ported arch uses; LayerNorm, GELU, sliding windows and MoE come
with the families that need them).  Every temporal-mixing site reads its
destination from the plan:

  attention : 'xla' (naive), 'xla_chunked' (online softmax over KV chunks),
              'pallas' (the flash-attention kernel; prefill only, as in the
              reference — decode takes naive or chunked)
  mlp       : 'xla' (stock ops), 'pallas' (the fused SwiGLU kernel)

Parameters are plain tensors in dicts keyed as in the reference pytree, in
``plan.param_dtype``; compute runs in ``plan.compute_dtype`` with f32
softmax/norm accumulation.  Weights are cast to the compute dtype at each
call, as the reference does.  The KV cache is updated in place (the
reference returns a new cache; the port returns the same dicts, written).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, PlanConfig

NEG_INF = -1e30


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def cdtype(plan: PlanConfig) -> torch.dtype:
    return dtype_of(plan.compute_dtype)


def pdtype(plan: PlanConfig) -> torch.dtype:
    return dtype_of(plan.param_dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(params, x, cfg: ArchConfig):
    """RMSNorm with f32 accumulation (the ported archs' norm)."""
    x32 = x.float()
    ms = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + 1e-6) * params["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: (..., S, H, D) with positions (..., S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(-math.log(theta)
                     * torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freq             # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _qkv(params, x, cfg: ArchConfig, plan: PlanConfig, positions):
    dt = cdtype(plan)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _group(q, n_kv: int):
    """(B,S,Hq,D) -> (B,S,Hkv,G,D)."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def _mask(qpos, kpos, causal: bool, window: int):
    """qpos (Q,), kpos (K,) -> (Q,K) additive f32 mask."""
    m = torch.zeros((qpos.shape[0], kpos.shape[0]), dtype=torch.float32,
                    device=qpos.device)
    if causal:
        m = torch.where(kpos[None, :] <= qpos[:, None], m, NEG_INF)
    if window:
        m = torch.where(qpos[:, None] - kpos[None, :] < window, m, NEG_INF)
    return m


def attention_naive(q, k, v, qpos, kpos, causal=True, window=0):
    """Grouped full attention. q (B,S,Hq,D); k,v (B,T,Hkv,D)."""
    n_kv = k.shape[2]
    qg = _group(q, n_kv)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bsngd,btnd->bngst", qg, k).float() * scale
    s = s + _mask(qpos, kpos, causal, window)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bngst,btnd->bsngd", p, v)
    return o.reshape(q.shape)


def attention_chunked(q, k, v, qpos, kpos, causal=True, window=0,
                      chunk=1024):
    """Online-softmax attention over KV chunks (memory-bounded): the
    'xla_chunked' destination, the same math as flash attention in stock
    ops.  The reference's ``lax.scan`` over chunks is a Python loop."""
    b, s_q, hq, d = q.shape
    t = k.shape[1]
    if t % chunk != 0:
        chunk = math.gcd(t, chunk) or t
    n_kv = k.shape[2]
    qg = _group(q, n_kv)
    scale = 1.0 / math.sqrt(d)
    g = hq // n_kv
    m = torch.full((b, n_kv, g, s_q), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, n_kv, g, s_q), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n_kv, g, s_q, d), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, t, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = torch.einsum("bsngd,btnd->bngst", qg, kb).float() * scale
        s = s + _mask(qpos, kpos[c0:c0 + chunk], causal, window)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bngst,btnd->bngsd", p.to(q.dtype), vb).float()
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, s_q, hq, d).to(q.dtype)


def _kv_quant(x):
    """(B,S,H,D) -> (int8 values, f32 scale (B,S,H,1))."""
    x32 = x.float()
    s = x32.abs().amax(-1, keepdim=True) / 127.0 + 1e-9
    q = torch.clamp(torch.round(x32 / s), -127, 127)
    return q.to(torch.int8), s


def _kv_dequant(q, s, dtype):
    return (q.float() * s).to(dtype)


def run_attention(params, x, cfg: ArchConfig, plan: PlanConfig, positions,
                  cache=None, decode=False):
    """Temporal-mixing site (full attention). Returns (y, cache).

    The KV cache is a rolling buffer of length T with an explicit per-slot
    position array ``kpos`` (-1 = empty); decode writes slot ``pos % T``.  Keys are
    stored post-RoPE.  An int8 cache (detected by its dtype) stores
    per-(pos, head) absmax-quantized values + f32 scales.  ``positions`` is
    a (S,) int tensor; in decode it holds the one position of the whole
    batch.
    """
    q, k, v = _qkv(params, x, cfg, plan, positions)
    causal = not cfg.is_encoder
    int8_cache = cache is not None and cache["k"].dtype == torch.int8

    if decode:
        # the position stays on the device: no host sync per layer
        ck, cv, kpos = cache["k"], cache["v"], cache["kpos"]
        t = ck.shape[1]
        pos = positions[:1]
        slot = (pos % t).long()
        if int8_cache:
            kq, ks = _kv_quant(k)
            vq, vs = _kv_quant(v)
            ck.index_copy_(1, slot, kq)
            cv.index_copy_(1, slot, vq)
            cache["k_scale"].index_copy_(1, slot, ks)
            cache["v_scale"].index_copy_(1, slot, vs)
            kk = _kv_dequant(ck, cache["k_scale"], q.dtype)
            vv = _kv_dequant(cv, cache["v_scale"], q.dtype)
        else:
            ck.index_copy_(1, slot, k.to(ck.dtype))
            cv.index_copy_(1, slot, v.to(cv.dtype))
            kk, vv = ck.to(q.dtype), cv.to(q.dtype)
        kpos.index_copy_(0, slot, pos.to(kpos.dtype))
        valid = (kpos >= 0) & (kpos <= pos)
        kpos_m = torch.where(valid, kpos, pos + t + 10)  # fails causal rule
        qpos = pos.expand(q.shape[1])
        if plan.attn_impl == "xla" or t <= plan.attn_chunk:
            o = attention_naive(q, kk, vv, qpos, kpos_m, True)
        else:
            o = attention_chunked(q, kk, vv, qpos, kpos_m, True,
                                  chunk=plan.attn_chunk)
    else:
        kpos = qpos = positions
        impl = plan.attn_impl
        if impl == "pallas":
            from repro_torch.kernels import ops as kops
            o = kops.flash_attention(q, k, v, causal=causal)
        elif impl == "xla_chunked" and x.shape[1] > plan.attn_chunk:
            o = attention_chunked(q, k, v, qpos, kpos, causal,
                                  chunk=plan.attn_chunk)
        else:
            o = attention_naive(q, k, v, qpos, kpos, causal)
        if cache is not None:  # prefill: keep the last T positions
            t = cache["k"].shape[1]
            s = k.shape[1]
            ktail, vtail = k[:, -t:], v[:, -t:]
            tailpos = torch.arange(max(s - t, 0), s, dtype=torch.int32,
                                   device=k.device)
            slots = (tailpos % t).long()
            if int8_cache:
                kq, ks = _kv_quant(ktail)
                vq, vs = _kv_quant(vtail)
                cache["k"][:, slots] = kq
                cache["v"][:, slots] = vq
                cache["k_scale"][:, slots] = ks
                cache["v_scale"][:, slots] = vs
            else:
                cache["k"][:, slots] = ktail.to(cache["k"].dtype)
                cache["v"][:, slots] = vtail.to(cache["v"].dtype)
            cache["kpos"][slots] = tailpos

    y = torch.einsum("bshk,hkd->bsd", o, params["wo"].to(o.dtype))
    return y, cache


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------


def run_mlp(params, x, cfg: ArchConfig, plan: PlanConfig):
    """SwiGLU MLP (the ported archs' activation)."""
    dt = cdtype(plan)
    if plan.mlp_impl == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.fused_swiglu(x, params["wi"].to(dt), params["wg"].to(dt),
                                 params["wo"].to(dt))
    h = torch.einsum("bsd,df->bsf", x, params["wi"].to(dt))
    g = torch.einsum("bsd,df->bsf", x, params["wg"].to(dt))
    h = F.silu(g) * h
    return torch.einsum("bsf,fd->bsd", h, params["wo"].to(dt))


def run_moe(params, x, cfg: ArchConfig, plan: PlanConfig):
    raise NotImplementedError(
        "MoE routing is not ported yet (ROADMAP.md, port queue: MoE)")
