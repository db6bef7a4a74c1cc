"""Public wrappers for the port's kernels (the 'pallas' destination).

Counterpart of ``repro.kernels.ops``.  Each wrapper dispatches on where its
tensors lie: CPU tensors go to the plain version in ``kernels.ref``; CUDA
tensors launch the hand-written kernel, or the launch raises — there is no
fallback.  The reference's "fall back to the oracle when a block is < 8"
rule existed for TPU tiling and is not carried over: the CUDA kernels mask
ragged edges, so decode batches of any size reach them.

``flash_attention``, ``fused_swiglu``, ``ssd`` and ``rglru`` are each a
``torch.autograd.Function``, as the reference's ops are each a
``jax.custom_vjp``: the forward is the kernel (the plain version on the
CPU), the backward differentiates the plain version rematerialized from
the saved inputs — so the 'pallas' destination trains as well as it
serves.  ``mriq`` has no backward, as in the reference.

The model's layers on a mesh call the wrappers on local tensors, inside
their tensor-parallel regions (``parallel.tp``).  A caller that hands a
wrapper ``DTensor`` inputs gets the route GSPMD takes around the
reference's ``pallas_call``, which it cannot partition: every input is
redistributed to ``Replicate()`` (a ``Partial`` is reduced, never read as
it is) and the wrapper runs on the local, whole tensors through
``local_map`` — the kernel on ``cuda``, the plain version on the CPU or
the meta device — its outputs replicated.  The autograd Functions run
inside, so the backward takes the same route.
"""
from __future__ import annotations

import math

import torch

from repro_torch import obs
from repro_torch.device import same_device
from repro_torch.parallel.sharding import is_dtensor, replicate
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.mriq import mriq_cuda
from repro_torch.kernels.rglru import rglru_cuda
from repro_torch.kernels.ssd import ssd_cuda
from repro_torch.kernels.swiglu import swiglu_cuda


def _blk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (the reference's block
    rule, which picks the SSD chunk)."""
    b = min(target, n)
    while n % b:
        b -= 1
    return b


def _plain(*tensors) -> bool:
    """Whether the plain version runs: the tensors lie on the CPU or the
    meta device (shapes only).  Anything else launches the kernel, whose
    wrapper refuses a device that is not ``cuda``."""
    return same_device(*tensors).type in ("cpu", "meta")


def _on_dtensors(fn, n_out: int, *args):
    """``fn(*args)``, or, when an argument is a ``DTensor``, ``fn`` through
    ``local_map`` on the ``DTensor`` arguments redistributed to
    ``Replicate()`` (plain tensors pass as they are, whole), its ``n_out``
    outputs replicated on the same mesh."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = dts[0].device_mesh
    # one output's placements are a list: local_map reads a tuple as one
    # placement list per output
    rep = [Replicate()] * mesh.ndim
    args = [replicate(a) for a in args]
    ins = tuple(rep if is_dtensor(a) else None for a in args)
    outs = rep if n_out == 1 else (rep,) * n_out
    return local_map(fn, out_placements=outs, in_placements=ins,
                     device_mesh=mesh)(*args)


def _plain_vjp(name: str, fn, saved, grads):
    """The backward of the Function of kernel ``name``: ``fn`` (a plain
    version) re-run on detached copies of the ``saved`` inputs under
    autograd, and its gradients with respect to each input for the output
    cotangents ``grads`` — the reference's ``jax.vjp`` of its oracle —
    inside the device range ``<name>.backward``: every plain backward runs
    here."""
    with obs.device_range(f"{name}.backward"):
        xs = [t.detach().requires_grad_() for t in saved]
        with torch.enable_grad():
            out = fn(*xs)
        out = out if isinstance(out, tuple) else (out,)
        return torch.autograd.grad(out, xs, grads, allow_unused=True)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if _plain(q, k, v):
            return _ref.flash_attention_ref(q, k, v, causal, window)
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, window)

    @staticmethod
    def backward(ctx, g):
        fn = lambda q, k, v: _ref.flash_attention_ref(  # noqa: E731
            q, k, v, ctx.causal, ctx.window)
        return (*_plain_vjp("flash", fn, ctx.saved_tensors, (g,)), None,
                None)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q (B,S,Hq,D); k, v (B,T,Hkv,D) -> (B,S,Hq,D).  ``causal`` and
    ``window`` are not differentiated."""
    return _on_dtensors(lambda q, k, v: _Flash.apply(q, k, v, causal,
                                                     window), 1, q, k, v)


def mriq(kx, ky, kz, phi_mag, x, y, z):
    """Parboil MRI-Q -> (Qr, Qi)."""
    args = (kx, ky, kz, phi_mag, x, y, z)
    if _plain(*args):
        return _ref.mriq_ref(*args)
    return mriq_cuda(*(a.contiguous() for a in args))


class _Swiglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xf, wi, wg, wo):
        ctx.save_for_backward(xf, wi, wg, wo)
        if _plain(xf, wi, wg, wo):
            return _ref.swiglu_ref(xf, wi, wg, wo)
        return swiglu_cuda(xf.contiguous(), wi.contiguous(),
                           wg.contiguous(), wo.contiguous())

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp("swiglu", _ref.swiglu_ref, ctx.saved_tensors,
                          (g,))


def fused_swiglu(x, wi, wg, wo):
    """x (..., d) -> (..., d); flattens leading dims for the kernel (and
    its backward, as the reference's, works on the flattened (T, d))."""
    def run(x, wi, wg, wo):
        lead = x.shape[:-1]
        d = x.shape[-1]
        y = _Swiglu.apply(x.reshape(math.prod(lead), d), wi, wg, wo)
        return y.reshape(*lead, d)
    return _on_dtensors(run, 1, x, wi, wg, wo)


class _Rglru(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_a, b):
        ctx.save_for_backward(log_a, b)
        if _plain(log_a, b):
            return _ref.rglru_ref(log_a, b)
        return rglru_cuda(log_a.float().contiguous(), b.float().contiguous())

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp("rglru", _ref.rglru_ref, ctx.saved_tensors,
                          (g.float(),))


def rglru(log_a, b):
    """log_a, b (B,S,W) -> h (B,S,W) f32: h_t = exp(log_a_t) h_{t-1} +
    b_t.  The backward takes the cotangent in f32, as the reference's."""
    return _on_dtensors(_Rglru.apply, 1, log_a, b)


class _Ssd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        q = _blk(x.shape[1], chunk)
        if _plain(x, dt, A, Bm, Cm):
            return _ref.ssd_ref(x, dt, A, Bm, Cm, q)
        return ssd_cuda(x.contiguous(), dt.float().contiguous(),
                        A.float().contiguous(), Bm.to(x.dtype).contiguous(),
                        Cm.to(x.dtype).contiguous(), q)

    @staticmethod
    def backward(ctx, gy, gstate):
        # the reference differentiates its oracle at the chunk it was
        # given (not the one the forward picked): the same function
        fn = lambda *a: _ref.ssd_ref(*a, max(ctx.chunk, 1))  # noqa: E731
        return (*_plain_vjp("ssd", fn, ctx.saved_tensors, (gy, gstate)),
                None)


def ssd(x, dt, A, Bm, Cm, chunk: int = 128):
    """Mamba2 SSD: x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N) ->
    (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32), in chunks of
    ``_blk(S, chunk)`` positions as the reference picks them.  ``chunk`` is
    not differentiated; an unused final state's cotangent arrives as
    zeros."""
    return _on_dtensors(lambda *a: _Ssd.apply(*a, chunk), 2,
                        x, dt, A, Bm, Cm)
