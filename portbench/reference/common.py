"""Arithmetic shared by the plain references: norms, RoPE, and the
products, in float32 or, for the control, with every product's operands
rounded to float8 (e4m3, one scale per tensor).

Nothing here imports the program: the references read the weights the
harness made (``portbench.weights``) and the tokens it served.
"""
from __future__ import annotations

import contextlib
import math

import torch

#: largest finite float8 e4m3 value
FP8_MAX = 448.0


class _FakeFp8(torch.autograd.Function):
    """x rounded to float8 e4m3 at the scale amax / 448; the gradient
    passes through unchanged."""

    @staticmethod
    def forward(ctx, x):
        s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        return g


class Arith:
    """The products of a reference: float32 (``lowp`` False) or, for the
    control, float8 operands (``lowp`` True) summed in float32.  With
    ``frozen`` the second operand of ``mm``, a weight that no step
    changes, is rounded once and kept (serving only)."""

    def __init__(self, lowp: bool = False, frozen: bool = False):
        self.lowp = lowp
        self.frozen = frozen
        self._weights: dict = {}

    def q(self, x):
        return _FakeFp8.apply(x) if self.lowp else x

    def mm(self, a, b):
        if self.lowp and self.frozen:
            key = (b.data_ptr(), tuple(b.shape), tuple(b.stride()))
            if key not in self._weights:
                self._weights[key] = self.q(b)
            return self.q(a) @ self._weights[key]
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, *xs):
        return torch.einsum(eq, *(self.q(x) for x in xs))


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored afterwards."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def rms(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def silu(x):
    return x * torch.sigmoid(x)


def rope(x, positions, theta: float):
    """x (..., S, H, D) rotated by halves at ``positions`` (S,) float."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def cross_entropy(logits, targets):
    """Mean next-token cross-entropy of f32 logits (..., V)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.long().unsqueeze(-1))[..., 0]
    return (lse - ll).mean()
