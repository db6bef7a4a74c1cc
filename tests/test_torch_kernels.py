"""The port's plain kernel versions against the JAX Pallas kernels (run in
interpret mode, as tests/test_kernels.py runs them) and the jnp oracles.

Inputs come from numpy seeds and go through both packages.  Tolerances are
tests/test_kernels.py's: mriq atol 5e-4 rtol 1e-4; flash 2e-5 (f32) and
2e-2 (bf16); swiglu 2e-5.  On CPU tensors the public wrappers run the plain
versions and never launch (or build) a kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.mriq import mriq_pallas
from repro.kernels.swiglu import swiglu_pallas
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mriq as MQ
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swiglu as SG

KERNELS = (MQ.KERNEL, FA.KERNEL, SG.KERNEL)


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol[0],
                               rtol=tol[1])


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


# ---------------------------------------------------------------------------
# MRI-Q
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,bn,bm", [(64, 32, 16, 8), (128, 64, 64, 64),
                                       (256, 96, 32, 32)])
def test_mriq_plain_matches_pallas_and_oracle(n, m, bn, bm):
    rng = np.random.default_rng(n)
    kx, ky, kz = (_np(rng, (m,)) for _ in range(3))
    phi = rng.random(m, dtype=np.float32)
    x, y, z = (_np(rng, (n,)) for _ in range(3))
    args = (kx, ky, kz, phi, x, y, z)
    qr, qi = ops.mriq(*map(_t, args))
    jargs = [jnp.asarray(a) for a in args]
    for want in (mriq_pallas(*jargs, block_n=bn, block_m=bm),
                 jref.mriq_ref(*jargs)):
        _close(qr, want[0], (5e-4, 1e-4))
        _close(qi, want[1], (5e-4, 1e-4))


def test_mriq_rows_are_independent_of_the_chunking():
    rng = np.random.default_rng(7)
    m, n = 16, ref.MRIQ_ROWS + 37          # spans two passes of mriq_ref
    k = [_t(_np(rng, (m,))) for _ in range(4)]
    x = [_t(_np(rng, (n,))) for _ in range(3)]
    qr, qi = ref.mriq_ref(*k, *x)
    tail = ref.mriq_ref(*k, *[a[-37:] for a in x])
    torch.testing.assert_close(qr[-37:], tail[0], rtol=0, atol=0)
    torch.testing.assert_close(qi[-37:], tail[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0)])
def test_flash_plain_matches_pallas_and_oracle(dtype, hq, hkv, causal,
                                               window):
    rng = np.random.default_rng(hq * 10 + hkv)
    b, s, d = 2, 64, 16
    q, k, v = (_np(rng, (b, s, h, d)) for h in (hq, hkv, hkv))
    o = ops.flash_attention(_t(q, getattr(torch, dtype)),
                            _t(k, getattr(torch, dtype)),
                            _t(v, getattr(torch, dtype)), causal, window)
    assert o.dtype == getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (jflash(jq, jk, jv, causal=causal, window=window,
                        block_q=16, block_k=16),
                 jref.flash_attention_ref(jq, jk, jv, causal, window)):
        _close(o.float(), want, (tol, tol))


# ---------------------------------------------------------------------------
# Fused SwiGLU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,d,f,bt,bf", [(32, 16, 32, 8, 8),
                                         (64, 32, 64, 32, 16),
                                         (128, 24, 48, 64, 48)])
def test_swiglu_plain_matches_pallas_and_oracle(t, d, f, bt, bf):
    rng = np.random.default_rng(t)
    x = _np(rng, (t, d))
    wi, wg, wo = _np(rng, (d, f), 0.2), _np(rng, (d, f), 0.2), \
        _np(rng, (f, d), 0.2)
    y = ops.fused_swiglu(*map(_t, (x, wi, wg, wo)))
    jargs = [jnp.asarray(a) for a in (x, wi, wg, wo)]
    for want in (swiglu_pallas(*jargs, block_t=bt, block_f=bf),
                 jref.swiglu_ref(*jargs)):
        _close(y, want, (2e-5, 2e-5))


def test_fused_swiglu_flattens_leading_dims():
    rng = np.random.default_rng(3)
    x = _np(rng, (2, 5, 16))
    wi, wg, wo = _np(rng, (16, 32), 0.2), _np(rng, (16, 32), 0.2), \
        _np(rng, (32, 16), 0.2)
    y = ops.fused_swiglu(*map(_t, (x, wi, wg, wo)))
    assert y.shape == (2, 5, 16)
    # the JAX wrapper takes its oracle here: 10 tokens tile below 8
    _close(y, jops.fused_swiglu(*map(jnp.asarray, (x, wi, wg, wo))),
           (2e-5, 2e-5))


# ---------------------------------------------------------------------------
# Dispatch and argument checks
# ---------------------------------------------------------------------------

def test_cpu_path_leaves_the_launch_counters_alone():
    rng = np.random.default_rng(0)
    before = [k.launches for k in KERNELS]
    ops.mriq(*[_t(_np(rng, (8,))) for _ in range(7)])
    q = _t(_np(rng, (1, 8, 2, 8)))
    ops.flash_attention(q, q, q)
    ops.fused_swiglu(_t(_np(rng, (4, 8))), _t(_np(rng, (8, 8))),
                     _t(_np(rng, (8, 8))), _t(_np(rng, (8, 8))))
    assert [k.launches for k in KERNELS] == before == [0, 0, 0]
    assert all(k._fn is None for k in KERNELS)       # nothing built/loaded


@pytest.mark.parametrize("call", [
    lambda t: FA.flash_attention_cuda(t((1, 8, 2, 8)), t((1, 8, 2, 8)),
                                      t((1, 8, 2, 8))),
    lambda t: SG.swiglu_cuda(t((4, 8)), t((8, 8)), t((8, 8)), t((8, 8))),
    lambda t: MQ.mriq_cuda(*[t((8,)) for _ in range(7)]),
], ids=["flash_attention", "swiglu", "mriq"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="must lie on"):
        call(lambda shape: torch.zeros(shape))


def test_ops_refuse_tensors_on_different_devices():
    q = torch.zeros((1, 8, 2, 8))
    with pytest.raises(ValueError, match="different devices"):
        ops.flash_attention(q, q.to("meta"), q)
    with pytest.raises(ValueError, match="different devices"):
        ops.fused_swiglu(torch.zeros((4, 8)), torch.zeros((8, 8)),
                         torch.zeros((8, 8), device="meta"),
                         torch.zeros((8, 8)))
