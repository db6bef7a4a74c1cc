"""Seeded weights, made on the device in one draw.

Both the program and the plain reference get their weights from
``make``: one f32 buffer the size of every parameter together, filled with
standard normals by one call on a ``torch.Generator`` seeded with the
cell's seed, then cut into the parameters (sorted by name) and scaled by
a rule a parameter: ``init_rule`` by default (normal / sqrt(fan-in) for
matrices, 0.02 for the embedding, ones for norm scales, zeros for
biases), or an architecture's own (``reference.<name>.init_rule``).  A
rule maps the standard normal draw z of each element, with u = Phi(z)
uniform on (0, 1): ``("normal", std)`` to z std; ``("log_of_uniform",
lo, hi)`` to ln(lo + (hi - lo) u); ``("softplus_inverse", lo, hi)`` to
v + ln(1 - exp(-v)), whose softplus is v, for v log-uniform on [lo, hi].
The same seed gives the same weights, bit for bit, on the same card.
"""
from __future__ import annotations

import math

import torch

ONES = ("scale", "norm", "D")
ZEROS = ("bq", "bk", "bv", "conv_b", "A_log", "dt_bias", "bias")


def init_rule(name: str, shape: tuple) -> tuple:
    """("normal", std) | ("ones",) | ("zeros",) for the parameter
    ``name`` of ``shape``."""
    leaf = name.rsplit(".", 1)[-1]
    if name == "embed":
        return ("normal", 0.02)
    if leaf in ONES:
        return ("ones",)
    if leaf in ZEROS:
        return ("zeros",)
    if leaf == "wo" and len(shape) == 3:        # (heads, head dim, d)
        return ("normal", 1.0 / math.sqrt(shape[0] * shape[1]))
    return ("normal", 1.0 / math.sqrt(shape[0]))


def numel(shape) -> int:
    return math.prod(shape)


def _uniform(t):
    """Phi(z) in place: a standard normal draw made uniform on (0, 1)."""
    return t.div_(math.sqrt(2.0)).erf_().add_(1.0).mul_(0.5)


def _apply(t, rule: tuple) -> None:
    kind = rule[0]
    if kind == "normal":
        t.mul_(rule[1])
    elif kind == "ones":
        t.fill_(1.0)
    elif kind == "zeros":
        t.zero_()
    elif kind == "log_of_uniform":
        _uniform(t).mul_(rule[2] - rule[1]).add_(rule[1]).log_()
    elif kind == "softplus_inverse":
        lo, hi = math.log(rule[1]), math.log(rule[2])
        _uniform(t).mul_(hi - lo).add_(lo).exp_()
        t.add_(torch.log(-torch.expm1(-t)))
    else:
        raise ValueError(f"unknown init rule {rule!r}")


@torch.no_grad()
def make(shapes: dict, seed: int, device, rule=init_rule) -> dict:
    """name -> f32 tensor of ``shapes[name]``, every one a view of one
    buffer drawn from ``seed`` on ``device`` and mapped by
    ``rule(name, shape)``."""
    names = sorted(shapes)
    total = sum(numel(shapes[n]) for n in names)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    out, off = {}, 0
    for n in names:
        shape = tuple(shapes[n])
        k = numel(shape)
        t = flat[off:off + k].view(shape)
        _apply(t, rule(n, shape))
        out[n] = t
        off += k
    return out


def for_model(ref, config: dict, seed: int, device) -> dict:
    """The weights of the plain reference ``ref``'s model of ``config``,
    by its own rule."""
    return make(ref.param_shapes(config), seed, device, ref.init_rule(config))
