"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro.models.rglru``.  Block: x -> {linear -> causal conv
-> RG-LRU} * {linear -> GELU} -> out proj.  RG-LRU per channel:

    r_t = sigmoid(W_a x_t + b_a)
    i_t = sigmoid(W_x x_t + b_x)
    log_a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = exp(log_a_t) * h_{t-1} + sqrt(1 - exp(2 log_a_t)) * (i_t * x_t)

Prefill and the forward pass run the linear recurrence over the whole
sequence: ``rglru_scan`` in stock ops (the reference's associative scan),
or the RG-LRU kernel under the 'pallas' destination of
``plan.rglru_impl``.  Decode is the one-step recurrence on a (B, W) f32
state, in stock ops, as in the reference.

The cache (``init_rglru_cache``) is updated in place: decode and prefill
write the new conv window and state into the dict's tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.models.layers import cast_weight, cdtype
from repro_torch.models.ssm import _causal_conv

RG_C = 8.0


def rglru_spec(cfg: ArchConfig) -> dict:
    """param -> (shape, init rule) of one RG-LRU block, with the
    reference's shapes and scales (``rglru.init_rglru_block``).  ``lam``
    takes the rule ``("lru_lambda",)``: Lambda = softplus^-1(-log(u)/16)
    for u ~ U(0.9², 0.999²), so that a = exp(-8·softplus(Lambda)) lies in
    (0.9, 0.999) as in Griffin."""
    d, w, k = cfg.d_model, cfg.lru_width, cfg.ssm_conv
    s_d, s_w = 1.0 / math.sqrt(d), 1.0 / math.sqrt(w)
    return {"w_in_x": ((d, w), ("normal", s_d)),
            "w_in_g": ((d, w), ("normal", s_d)),
            "conv_w": ((k, w), ("normal", 1.0 / math.sqrt(k))),
            "conv_b": ((w,), ("zeros",)),
            "w_a": ((w, w), ("normal", s_w)),
            "b_a": ((w,), ("zeros",)),
            "w_x": ((w, w), ("normal", s_w)),
            "b_x": ((w,), ("zeros",)),
            "lam": ((w,), ("lru_lambda",)),
            "w_out": ((w, d), ("normal", s_w))}


def lru_lambda_(p: torch.Tensor, generator: torch.Generator) -> None:
    """Fill ``p`` by the ``lru_lambda`` rule (see ``rglru_spec``)."""
    u = torch.empty_like(p, dtype=torch.float32).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=generator)
    p.copy_(torch.log(torch.exp(-torch.log(u) / (2 * RG_C)) - 1.0))


def rglru_gates(params, x, x_cols=None):
    """x (B,S,W) -> (log_a, b), both f32: h_t = exp(log_a_t) h + b_t.  The
    gate matmuls run in f32, as in the reference.  ``x_cols`` is the
    columns of ``x`` that the gate weights' columns gate (a
    tensor-parallel rank's slice of the width; ``x`` itself by default)."""
    x32 = x.float()
    xc = x32 if x_cols is None else x_cols.float()
    r = torch.sigmoid(x32 @ params["w_a"].float() + params["b_a"].float())
    i = torch.sigmoid(x32 @ params["w_x"].float() + params["b_x"].float())
    log_a = -RG_C * F.softplus(params["lam"].float()) * r
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xc)
    return log_a, b


def _combine(a1, b1, a2, b2):
    """The reference's ``combine`` of two steps of the recurrence."""
    return a2 * a1, a2 * b1 + b2


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along axis 1; ``even`` has as many
    elements as ``odd`` or one more."""
    m = odd.shape[1]
    out = torch.stack((even[:, :m], odd), dim=2).reshape(
        even.shape[0], 2 * m, *even.shape[2:])
    return out if even.shape[1] == m else torch.cat((out, even[:, m:]), 1)


def _associative_scan(a, b):
    """``lax.associative_scan(combine, (a, b), axis=1)``, its odd/even
    recursion op for op: combine adjacent pairs, scan the half-length
    result (the odd elements), combine each with the next even input (the
    even elements), then put element 0 in front and interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _associative_scan(
        *_combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ev_a, ev_b = _combine(odd_a[:, :-1], odd_b[:, :-1], a[:, 2::2],
                              b[:, 2::2])
    else:
        ev_a, ev_b = _combine(odd_a, odd_b, a[:, 2::2], b[:, 2::2])
    ev_a = torch.cat((a[:, :1], ev_a), dim=1)
    ev_b = torch.cat((b[:, :1], ev_b), dim=1)
    return _interleave(ev_a, odd_a), _interleave(ev_b, odd_b)


def rglru_scan(log_a, b):
    """The linear recurrence h_t = exp(log_a_t) h_{t-1} + b_t over axis 1,
    from h = 0, in f32. (B,S,W) -> h (B,S,W).  The reference's associative
    scan (``_associative_scan``): log2(S) levels of whole-tensor ops, so
    its autograd graph and backward stay short at any S."""
    return _associative_scan(torch.exp(log_a.float()), b.float())[1]


def run_rglru_block(params, x, cfg: ArchConfig, plan: PlanConfig, cache=None,
                    decode=False):
    """Returns (y, cache). cache = {'conv': (B,K-1,W), 'h': (B,W) f32},
    written in place (prefill and decode); None in the forward pass."""
    dt_c = cdtype(plan)
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x,
                               cast_weight(params["w_in_g"], dt_c)),
                  approximate="tanh")
    u = torch.einsum("bsd,dw->bsw", x, cast_weight(params["w_in_x"], dt_c))
    u, new_conv = _causal_conv(u, cast_weight(params["conv_w"], dt_c),
                               cast_weight(params["conv_b"], dt_c),
                               cache["conv"] if cache is not None else None)
    log_a, b = rglru_gates(params, u)
    if decode:
        h = torch.exp(log_a[:, 0]) * cache["h"] + b[:, 0]
        hs = h[:, None]
    elif plan.rglru_impl == "pallas":
        from repro_torch.kernels import ops as kops
        hs = kops.rglru(log_a, b)
    else:
        hs = rglru_scan(log_a, b)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(hs[:, -1])
    y = hs.to(dt_c) * gate
    return torch.einsum("bsw,wd->bsd", y,
                        cast_weight(params["w_out"], dt_c)), cache


def init_rglru_cache(cfg: ArchConfig, batch: int,
                     device: torch.device) -> dict:
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.lru_width),
                                dtype=torch.float32, device=device),
            "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                             device=device)}
