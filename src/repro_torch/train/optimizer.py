"""Optimizers: AdamW, Adafactor (factored second moments), int8-state Adam.

Counterpart of ``repro.train.optimizer``.  The reference maps each update
over the leaves of its params pytree, whose layer-unit leaves are stacked
over the units (``params["scan"]``).  The port keeps one tensor per layer,
so an optimizer here takes *leaf dicts*: reference leaf path -> the port's
tensors it holds (``train.step.param_leaves``, built from
``convert.leaf_groups``).  A ``scan/...`` leaf is the stack of its tensors
on a new first axis, as in the reference; every other leaf is its one
tensor.  The state is kept per reference leaf, with the reference's shapes,
and every statistic that is not elementwise (Adafactor's factoring and its
update-RMS clip, int8 Adam's blocks of 256 over the flattened leaf) is
taken over the stacked leaf, one leaf stacked at a time.

The updates write the new parameters into the port's tensors in place (the
reference donates its buffers) and return the new state.

Adafactor is the memory-critical choice for the 405B-class configs: the
second-moment estimate of an (m, n) matrix is stored as an (m,) row vector +
(n,) column vector instead of (m, n).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig


def is_stacked(path: str) -> bool:
    """Whether the reference stacks this leaf over the layer units."""
    return path.startswith("scan/")


def leaf_value(path: str, tensors: list) -> torch.Tensor:
    """The reference leaf: the stack of ``tensors`` or the one tensor."""
    return torch.stack(tensors) if is_stacked(path) else tensors[0]


def leaf_shape(path: str, tensors: list) -> tuple:
    shape = tuple(tensors[0].shape)
    return (len(tensors),) + shape if is_stacked(path) else shape


def write_leaf(path: str, tensors: list, value: torch.Tensor) -> None:
    """Write a reference leaf's new value into the port's tensors."""
    if is_stacked(path):
        for i, t in enumerate(tensors):
            t.copy_(value[i])
    else:
        tensors[0].copy_(value)


def _zeros(path: str, tensors: list, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(leaf_shape(path, tensors), dtype=dtype,
                       device=tensors[0].device)


def _step(state) -> tuple:
    step = state["step"] + 1
    return step, step.float()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params: dict) -> dict:
    return {"m": {k: _zeros(k, ts) for k, ts in params.items()},
            "v": {k: _zeros(k, ts) for k, ts in params.items()},
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, lr, b1=0.9,
                 b2=0.95, eps=1e-8, wd=0.1) -> dict:
    step, t = _step(state)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        # elementwise: each tensor of a stacked leaf on its own slice
        g32 = g.float()
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * torch.square(g32))
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        p32 = p.float()
        p.copy_(p32 - lr * (u + wd * p32))

    for k, ts in params.items():
        m, v = state["m"][k], state["v"][k]
        if is_stacked(k):
            for i, p in enumerate(ts):
                upd(p, grads[k][i], m[i], v[i])
        else:
            upd(ts[0], grads[k][0], m, v)
    return {"m": state["m"], "v": state["v"], "step": step}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern) — factored v, no first moment
# ---------------------------------------------------------------------------


def _factored(shape: tuple) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def adafactor_init(params: dict) -> dict:
    def st(k, ts):
        shape = leaf_shape(k, ts)
        dev = ts[0].device
        if _factored(shape):
            return {"vr": torch.zeros(shape[:-1], device=dev),
                    "vc": torch.zeros(shape[:-2] + shape[-1:], device=dev)}
        return {"v": _zeros(k, ts)}

    return {"v": {k: st(k, ts) for k, ts in params.items()},
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


@torch.no_grad()
def adafactor_update(params: dict, grads: dict, state: dict, lr, eps=1e-30,
                     clip=1.0, wd=0.0) -> dict:
    step, t = _step(state)
    beta = 1.0 - t ** -0.8

    def upd(p, g, s):
        g32 = g.float()
        g2 = torch.square(g32) + eps
        if _factored(tuple(p.shape)):
            vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
            vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
            rfac = torch.rsqrt(vr / vr.mean(-1, keepdim=True) + eps)
            cfac = torch.rsqrt(vc + eps)
            u = g32 * rfac[..., None] * cfac[..., None, :]
            news = {"vr": vr, "vc": vc}
        else:
            v = beta * s["v"] + (1 - beta) * g2
            u = g32 * torch.rsqrt(v + eps)
            news = {"v": v}
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms / clip, min=1.0)
        p32 = p.float()
        return (p32 - lr * (u + wd * p32)).to(p.dtype), news

    news = {}
    for k, ts in params.items():
        newp, news[k] = upd(leaf_value(k, ts), leaf_value(k, grads[k]),
                            state["v"][k])
        write_leaf(k, ts, newp)
    return {"v": news, "step": step}


# ---------------------------------------------------------------------------
# int8-quantized Adam state (distributed-optimization trick: 4x optimizer
# memory reduction; block-wise absmax quantization with f32 scales)
# ---------------------------------------------------------------------------

_QBLOCK = 256


def _q8(x: torch.Tensor) -> dict:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _QBLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _QBLOCK)
    scale = blocks.abs().amax(1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _dq8(s: dict, shape: tuple, size: int) -> torch.Tensor:
    x = (s["q"].float() * s["scale"]).reshape(-1)[:size]
    return x.reshape(shape)


def adam8_init(params: dict) -> dict:
    return {"m": {k: _q8(_zeros(k, ts)) for k, ts in params.items()},
            "v": {k: _q8(_zeros(k, ts)) for k, ts in params.items()},
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


@torch.no_grad()
def adam8_update(params: dict, grads: dict, state: dict, lr, b1=0.9,
                 b2=0.95, eps=1e-8, wd=0.1) -> dict:
    step, t = _step(state)
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t

    def upd(p, g, mq, vq):
        g32 = g.float()
        shape, size = tuple(p.shape), p.numel()
        m = b1 * _dq8(mq, shape, size) + (1 - b1) * g32
        v = b2 * _dq8(vq, shape, size) + (1 - b2) * torch.square(g32)
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        p32 = p.float()
        return (p32 - lr * (u + wd * p32)).to(p.dtype), _q8(m), _q8(v)

    newm, newv = {}, {}
    for k, ts in params.items():
        newp, newm[k], newv[k] = upd(leaf_value(k, ts),
                                     leaf_value(k, grads[k]),
                                     state["m"][k], state["v"][k])
        write_leaf(k, ts, newp)
    return {"m": newm, "v": newv, "step": step}


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
    "adam8": (adam8_init, adam8_update),
}


def _device(params: dict) -> torch.device:
    return next(iter(params.values()))[0].device


def opt_init(cfg: ArchConfig, params: dict) -> Any:
    return OPTIMIZERS[cfg.optimizer][0](params)


def opt_update(cfg: ArchConfig, params: dict, grads: dict, state):
    return OPTIMIZERS[cfg.optimizer][1](params, grads, state,
                                        lr=cfg.learning_rate)
