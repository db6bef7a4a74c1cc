"""Core transformer layers: norms, RoPE, GQA attention, MLP, MoE.

Counterpart of ``repro.models.layers``: RMSNorm and LayerNorm, RoPE,
grouped attention with causal, bidirectional (encoder) and sliding-window
masks, the SwiGLU and GELU MLPs, and the token-choice MoE with sort-based
capacity dispatch.  Every temporal-mixing site reads its destination from
the plan:

  attention : 'xla' (naive), 'xla_chunked' (online softmax over KV chunks),
              'pallas' (the flash-attention kernel; prefill only, as in the
              reference — decode takes naive or chunked)
  mlp       : 'xla' (stock ops), 'pallas' (the fused SwiGLU kernel; the
              GELU MLP has no kernel and always runs stock ops, as in the
              reference)
  moe       : 'xla' (sort-based capacity dispatch in stock ops; the
              reference computes its experts with ``jnp.einsum``, outside
              any kernel)

Parameters are plain tensors in dicts keyed as in the reference pytree, in
``plan.param_dtype``; compute runs in ``plan.compute_dtype`` with f32
softmax/norm accumulation.  Weights are cast to the compute dtype at each
call, as the reference does, each through ``cast_weight``, which names
the cast in a trace (the device range ``weights.cast``, the counters
``weights.casts`` and ``weights.cast_bytes``).  A step whose weights do
not change between calls (the captured decode step,
``serve.engine.DecodeGraph``) casts each weight once instead: under a
``FrozenCasts`` memo that records one step's casts, the steps it then
serves read the kept copies, the same bits, and cast nothing (counters
``weights.frozen_casts`` and ``weights.frozen_bytes``).  The KV cache is
updated in place (the reference returns a new cache; the port returns the
same dicts, written).
"""
from __future__ import annotations

import math
import weakref
from contextlib import contextmanager
from contextvars import ContextVar

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.parallel.sharding import is_dtensor

NEG_INF = -1e30


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def cdtype(plan: PlanConfig) -> torch.dtype:
    return dtype_of(plan.compute_dtype)


def pdtype(plan: PlanConfig) -> torch.dtype:
    return dtype_of(plan.param_dtype)


def cast_weight(w, dtype: torch.dtype):
    """``w.to(dtype)`` for a weight, never an activation or the KV cache:
    every cast of a weight to the compute dtype goes through here.
    A cast that changes the dtype runs inside the device range
    ``weights.cast`` and counts itself (``weights.casts``) and its source
    bytes (``weights.cast_bytes``) in ``obs.METRICS``; a captured graph
    records both and adds them on every replay.  Under a ``FrozenCasts``
    memo the cast goes through the memo (``FrozenCasts.cast``)."""
    if w.dtype == dtype:
        return w
    current = _FROZEN.get()
    if current is not None:
        return current[0].cast(w, dtype, serving=current[1])
    return _cast(w, dtype)


def _cast(w, dtype: torch.dtype):
    mx = obs.METRICS
    if mx.enabled:
        mx.counter("weights.casts").inc()
        mx.counter("weights.cast_bytes").add(w.numel() * w.element_size())
    with obs.device_range("weights.cast"):
        return w.to(dtype)


def local_tensor(t):
    """A ``DTensor``'s local tensor (under ``no_grad`` the one it holds,
    which an in-place write to the ``DTensor`` writes), else ``t``."""
    return t.to_local() if is_dtensor(t) else t


#: the current ``FrozenCasts`` memo and whether it serves (else records)
_FROZEN: ContextVar = ContextVar("frozen_casts", default=None)


class FrozenCasts:
    """The weights' casts of a step whose weights do not change between
    calls, made once and kept.

    Under ``recording()`` every cast ``cast_weight`` makes is made as
    ever (ranged and counted as a cast) and its result kept, keyed by the
    source's storage, layout and placements and the target dtype.  Under
    ``serving()`` a cast of a kept source returns the kept copy, the same
    bits ``w.to(dtype)`` makes, and enqueues no kernel: it counts
    ``weights.frozen_casts`` and adds the source bytes it did not cast to
    ``weights.frozen_bytes``.  A cast of a source not kept, or no longer
    alive, is made as ever, and the cast of a tensor that did not outlive
    the recorded step is not kept.  The copies live as long as the memo;
    the sources are held weakly (a view's by its base, whose version
    counter it shares), so the memo keeps no weight alive.

    ``stale()`` says whether a source, or one of ``watch``, has been
    written in place since it was recorded, or freed.  A ``DTensor``'s
    source is its local tensor, whose version counter a write through
    ``to_local()`` moves and a write to the ``DTensor`` does not: pass
    ``DTensor`` parameters as ``watch``.  A write through ``.data`` moves
    no version counter, and goes unseen."""

    def __init__(self, watch=()):
        self._kept: dict = {}       # key -> (weak ref to the source, copy)
        self._also = [weakref.ref(t) for t in watch]
        self._refs: list = []       # what stale() reads, as recorded
        self._versions: list = []

    @contextmanager
    def recording(self):
        token = _FROZEN.set((self, False))
        try:
            yield self
        finally:
            _FROZEN.reset(token)
            # a cast of a tensor the step made (a gathered shard) cannot
            # be served again: dropped with its copy
            self._kept = {k: e for k, e in self._kept.items()
                          if e[0]() is not None}
            self._refs = [ref for ref, _ in self._kept.values()] + self._also
            self._versions = [r()._version for r in self._refs]

    @contextmanager
    def serving(self):
        token = _FROZEN.set((self, True))
        try:
            yield self
        finally:
            _FROZEN.reset(token)

    def cast(self, w, dtype: torch.dtype, serving: bool):
        t = local_tensor(w)
        key = (t.device, t.data_ptr(), t.shape, t.stride(), w.dtype, dtype,
               getattr(w, "placements", None))
        if serving:
            hit = self._kept.get(key)
            if hit is None or hit[0]() is None:
                return _cast(w, dtype)
            mx = obs.METRICS
            if mx.enabled:
                mx.counter("weights.frozen_casts").inc()
                mx.counter("weights.frozen_bytes").add(
                    w.numel() * w.element_size())
            return hit[1]
        out = _cast(w, dtype)
        if key not in self._kept:
            self._kept[key] = (weakref.ref(t if t._base is None
                                           else t._base), out)
        return out

    @property
    def nbytes(self) -> int:
        """The device bytes the kept copies hold (a ``DTensor``'s local
        shard)."""
        return sum(local_tensor(c).numel() * c.element_size()
                   for _, c in self._kept.values())

    def stale(self) -> bool:
        try:
            return [r()._version for r in self._refs] != self._versions
        except AttributeError:      # a source was freed
            return True


def cast_bound(params, dtype: torch.dtype) -> tuple[int, int]:
    """(all, largest): the bytes, in ``dtype``, of every floating
    parameter of ``params`` (a ``Transformer``) that is not in ``dtype``,
    a ``DTensor``'s local shard: an upper bound on what a ``FrozenCasts``
    memo of its steps keeps, and its largest copy."""
    sizes = [local_tensor(p).numel() * dtype.itemsize
             for p in params.parameters()
             if p.is_floating_point() and p.dtype != dtype]
    return sum(sizes), max(sizes, default=0)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(params, x, cfg: ArchConfig):
    """RMSNorm, or for ``norm="layernorm"`` LayerNorm with a bias (the
    population variance, eps 1e-6 as the reference), f32 accumulation."""
    x32 = x.float()
    if cfg.norm == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, correction=0)
        y = (x32 - mu) * torch.rsqrt(var + 1e-6)
        y = y * params["scale"].float() + params["bias"].float()
    else:
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
    q = torch.einsum("bsd,dhk->bshk", x, cast_weight(params["wq"], dt))
    k = torch.einsum("bsd,dhk->bshk", x, cast_weight(params["wk"], dt))
    v = torch.einsum("bsd,dhk->bshk", x, cast_weight(params["wv"], dt))
    if cfg.qkv_bias:
        q = q + cast_weight(params["bq"], dt)
        k = k + cast_weight(params["bk"], dt)
        v = v + cast_weight(params["bv"], dt)
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


def _write_rows(dst, dim: int, index, src) -> None:
    """``dst.index_copy_(dim, index, src)``.  A ``DTensor`` cache (its
    entries batch-sharded and whole along ``dim``, as a layer's gathered
    cache is: ``parallel.sharding.layer_operands``) takes the copy on each
    rank's local tensors, its own batch rows from ``src`` laid out the same
    way: no sharding strategy is needed, which some torch releases lack
    for ``index_copy_``."""
    if not is_dtensor(dst):
        dst.index_copy_(dim, index, src)
        return
    if any(p.is_shard(dim) for p in dst.placements):
        raise ValueError(f"a cache sharded along the written dim {dim}")
    if is_dtensor(src):
        src = src.redistribute(dst.device_mesh, dst.placements).to_local()
    if is_dtensor(index):
        index = index.full_tensor()
    dst.to_local().index_copy_(dim, index, src)


def run_attention(params, x, cfg: ArchConfig, plan: PlanConfig, positions,
                  cache=None, decode=False, window=0):
    """Temporal-mixing site. Returns (y, cache).

    ``window`` > 0 is local attention: a query sees the ``window`` latest
    positions up to its own.  The KV cache is a rolling buffer of length T
    (``min(window, seq)`` for local attention, the full sequence otherwise)
    with an explicit per-slot position array ``kpos`` (-1 = empty); decode
    writes slot ``pos % T``.  Keys are
    stored post-RoPE.  An int8 cache (detected by its dtype) stores
    per-(pos, head) absmax-quantized values + f32 scales.  ``positions`` is
    a (S,) int tensor; in decode it holds the one position of the whole
    batch.
    """
    q, k, v = _qkv(params, x, cfg, plan, positions)
    o = attend(q, k, v, cfg, plan, positions, cache, decode, window)
    y = torch.einsum("bshk,hkd->bsd", o, cast_weight(params["wo"], o.dtype))
    return y, cache


def attend(q, k, v, cfg: ArchConfig, plan: PlanConfig, positions,
           cache=None, decode=False, window=0):
    """Attention of post-RoPE ``q`` (B,S,Hq,D) over ``k``, ``v``
    (B,S,Hkv,D), through the cache when one is given (``run_attention``):
    decode writes the one new position and attends over the cache; the
    forward pass and prefill attend over ``k`` and ``v``, and prefill then
    keeps their last T positions in the cache.  Returns o (B,S,Hq,D)."""
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
            _write_rows(ck, 1, slot, kq)
            _write_rows(cv, 1, slot, vq)
            _write_rows(cache["k_scale"], 1, slot, ks)
            _write_rows(cache["v_scale"], 1, slot, vs)
            kk = _kv_dequant(ck, cache["k_scale"], q.dtype)
            vv = _kv_dequant(cv, cache["v_scale"], q.dtype)
        else:
            _write_rows(ck, 1, slot, k.to(ck.dtype))
            _write_rows(cv, 1, slot, v.to(cv.dtype))
            kk, vv = ck.to(q.dtype), cv.to(q.dtype)
        _write_rows(kpos, 0, slot, pos.to(kpos.dtype))
        valid = (kpos >= 0) & (kpos <= pos)
        kpos_m = torch.where(valid, kpos, pos + t + 10)  # fails causal rule
        qpos = pos.expand(q.shape[1])
        if plan.attn_impl == "xla" or t <= plan.attn_chunk:
            return attention_naive(q, kk, vv, qpos, kpos_m, True, window)
        return attention_chunked(q, kk, vv, qpos, kpos_m, True, window,
                                 plan.attn_chunk)
    kpos = qpos = positions
    impl = plan.attn_impl
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        o = kops.flash_attention(q, k, v, causal=causal, window=window)
    elif impl == "xla_chunked" and q.shape[1] > plan.attn_chunk:
        o = attention_chunked(q, k, v, qpos, kpos, causal, window,
                              plan.attn_chunk)
    else:
        o = attention_naive(q, k, v, qpos, kpos, causal, window)
    if cache is not None:  # prefill: keep the last T positions
        t = cache["k"].shape[1]
        s = k.shape[1]
        tailpos = torch.arange(max(s - t, 0), s, dtype=torch.int32,
                               device=k.device)
        rows = cache_rows(k[:, -t:], v[:, -t:], int8_cache, cache)
        rows["kpos"] = tailpos
        slots = (tailpos % t).long()
        for name, r in rows.items():
            _write_rows(cache[name], 0 if name == "kpos" else 1, slots, r)
    return o


def cache_rows(k, v, int8_cache: bool, cache) -> dict:
    """The cache entries' new rows for post-RoPE ``k``, ``v`` (B,S,H,D):
    quantized with their scales for an int8 cache, else cast to the
    cache's dtype."""
    if int8_cache:
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------


def run_mlp(params, x, cfg: ArchConfig, plan: PlanConfig):
    """SwiGLU MLP, or for ``act="gelu"`` the GELU MLP with biases (tanh
    approximation, ``jax.nn.gelu``'s default)."""
    y = mlp_products(params, x, cfg, plan)
    if cfg.act == "gelu":
        y = y + cast_weight(params["bo"], cdtype(plan))
    return y


def mlp_products(params, x, cfg: ArchConfig, plan: PlanConfig):
    """The MLP without its output bias ``bo`` (the GELU MLP's; added once
    after a tensor-parallel reduction)."""
    dt = cdtype(plan)
    if cfg.act == "gelu":
        h = torch.einsum("bsd,df->bsf", x, cast_weight(params["wi"], dt)) \
            + cast_weight(params["bi"], dt)
        h = F.gelu(h, approximate="tanh")
        return torch.einsum("bsf,fd->bsd", h, cast_weight(params["wo"], dt))
    if plan.mlp_impl == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.fused_swiglu(x, cast_weight(params["wi"], dt),
                                 cast_weight(params["wg"], dt),
                                 cast_weight(params["wo"], dt))
    h = torch.einsum("bsd,df->bsf", x, cast_weight(params["wi"], dt))
    g = torch.einsum("bsd,df->bsf", x, cast_weight(params["wg"], dt))
    h = F.silu(g) * h
    return torch.einsum("bsf,fd->bsd", h, cast_weight(params["wo"], dt))


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Assignments an expert takes: top_k x tokens / experts x the
    capacity factor, rounded up to a multiple of 8 (at least 8)."""
    m = cfg.moe
    c = int(math.ceil(m.top_k * n_tokens / m.n_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)


def moe_route(params, xt, cfg: ArchConfig, plan: PlanConfig):
    """The router over tokens ``xt`` (t,d): its softmax in f32 (t,e), and
    each token's top k experts (t,k) with their gates renormalised."""
    return moe_gates(moe_logits(params["router"], xt, plan), cfg.moe.top_k)


def moe_logits(router, xt, plan: PlanConfig):
    """The router's logits (t,e) in f32."""
    return (xt @ cast_weight(router, cdtype(plan))).float()


def moe_gates(logits, top_k: int):
    """(softmax (t,e), gates (t,k), experts (t,k)) of f32 router logits.
    Ties go to the lower expert, as ``lax.top_k`` breaks them (a stable
    descending sort)."""
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :top_k], idx[:, :top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def moe_slots(idx, n_experts: int, cap: int):
    """Capacity assignment via a stable sort (no (T,E,C) dispatch tensor):
    the token-major assignments ``idx`` (t,k) sorted by expert, each one's
    position in its expert's run, and those at or past ``cap`` dropped.
    Returns (slot, keep), each (t*k,): a kept assignment's row
    ``expert * cap + position`` in the (e*cap, d) buffer; a dropped one's
    the overflow row ``e * cap``."""
    eid = idx.reshape(-1)
    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    run_start = torch.searchsorted(
        sorted_eid, torch.arange(n_experts, device=eid.device,
                                 dtype=eid.dtype))
    pos_sorted = torch.arange(eid.shape[0], device=eid.device) \
        - run_start[sorted_eid]
    pos = torch.empty_like(pos_sorted).index_copy_(0, order, pos_sorted)
    keep = pos < cap
    return torch.where(keep, eid * cap + pos, n_experts * cap), keep


def run_moe(params, x, cfg: ArchConfig, plan: PlanConfig):
    """Token-choice top-k routing with capacity; returns (y, aux_loss).

    Op for op the reference's sort-based dispatch (``moe_route``,
    ``moe_slots``) with the Switch aux loss.  Which assignments an expert
    drops depends on the whole flattened batch (b-major), later positions
    included.  The dispatch is an index copy (each kept slot takes one
    assignment; the dropped ones land in the overflow row, which is cut
    off) and the combine sums each token's k gated rows in a fixed order:
    no atomics on the card, one result for one input.
    """
    m = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, m.top_k, m.n_experts
    cap = moe_capacity(cfg, t)
    dt = cdtype(plan)

    xt = x.reshape(t, d)
    probs, gate, idx = moe_route(params, xt, cfg, plan)

    # load-balance auxiliary loss (Switch-style)
    density = F.one_hot(idx[:, 0], e).float().mean(0)
    aux = e * (density * probs.mean(0)).sum()

    slot, keep = moe_slots(idx, e, cap)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e * cap + 1, d), dtype=dt, device=x.device)
    buf.index_copy_(0, slot, xt[tok].to(dt))
    buf = buf[:-1].reshape(e, cap, d)

    # the experts' SwiGLU, batched over experts
    h = torch.bmm(buf, cast_weight(params["wi"], dt))
    g = torch.bmm(buf, cast_weight(params["wg"], dt))
    yb = torch.bmm(F.silu(g) * h, cast_weight(params["wo"], dt))

    # combine: each token's k assignments, gated, summed in order
    yfl = torch.cat([yb.reshape(e * cap, d),
                     torch.zeros((1, d), dtype=dt, device=x.device)])
    y_assign = yfl[slot] * (gate.reshape(-1, 1).to(dt) * keep[:, None])
    y = y_assign.reshape(t, k, d).sum(1)
    return y.reshape(b, s, d), aux
