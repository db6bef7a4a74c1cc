"""The port's CUDA kernels against their plain versions, on the card.

The kernels compute in f32 and round once to the output dtype, so a bf16
result is held against the plain version run in f32 on the same bf16
inputs, to the final rounding: rtol 2^-8 (bf16's 8-bit mantissa) plus atol
1e-5 for the f32 sums taken in another order.  f32 results keep the
tolerances of tests/test_kernels.py.

jax-free.  Every test takes the ``cuda`` fixture, which skips (with the
reason) when no CUDA device is visible; on the H100 run them with
``python -m pytest -m cuda tests/test_torch_cuda.py``.  Shapes are small and
ragged on purpose: the kernels mask partial tiles instead of falling back.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mriq as MQ
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru as RG
from repro_torch.kernels import ssd as SD
from repro_torch.kernels import swiglu as SG
from repro_torch.models.model import Model

pytestmark = pytest.mark.cuda

TOL = {torch.float32: {"atol": 2e-5, "rtol": 2e-5},
       torch.bfloat16: {"atol": 1e-5, "rtol": 2.0 ** -8}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest -m cuda tests/test_torch_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype=torch.float32, scale=1.0):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            * scale).to(dtype).cuda()


@pytest.mark.parametrize("n,m", [(64, 32), (1000, 96), (4099, 3072)])
def test_mriq_kernel(cuda, n, m):
    rng = np.random.default_rng(n)
    k = [_randn(rng, (m,)) for _ in range(3)]
    phi = torch.from_numpy(rng.random(m, dtype=np.float32)).cuda()
    x = [_randn(rng, (n,)) for _ in range(3)]
    qr, qi = MQ.mriq_cuda(*k, phi, *x)
    qr0, qi0 = ref.mriq_ref(*k, phi, *x)
    torch.testing.assert_close(qr, qr0, atol=5e-4, rtol=1e-4)
    torch.testing.assert_close(qi, qi0, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1), (28, 4)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0), (False, 40)])
@pytest.mark.parametrize("s,d", [(64, 16), (100, 8), (130, 128)])
def test_flash_kernel(cuda, dtype, hq, hkv, causal, window, s, d):
    rng = np.random.default_rng(s + hq)
    q = _randn(rng, (2, s, hq, d), dtype)
    k = _randn(rng, (2, s, hkv, d), dtype)
    v = _randn(rng, (2, s, hkv, d), dtype)
    o = FA.flash_attention_cuda(q, k, v, causal, window)
    o0 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal,
                                 window)
    assert o.dtype == dtype
    torch.testing.assert_close(o.float(), o0, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(16, 1), (4, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96),
                                           (False, 40)])
@pytest.mark.parametrize("s,d", [(200, 256), (70, 144)])
def test_flash_kernel_wide_heads(cuda, dtype, hq, hkv, causal, window, s, d):
    """Head dims over 128 (recurrentgemma-9b's 256) take the kernel's
    second instance; the sliding window skips whole key tiles."""
    rng = np.random.default_rng(s + d + hq)
    q = _randn(rng, (2, s, hq, d), dtype)
    k = _randn(rng, (2, s, hkv, d), dtype)
    v = _randn(rng, (2, s, hkv, d), dtype)
    o = FA.flash_attention_cuda(q, k, v, causal, window)
    o0 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal,
                                 window)
    torch.testing.assert_close(o.float(), o0, **TOL[dtype])


def _ssd_inputs(rng, b, s, h, p, n, dtype, dt_shift=0.0):
    x = _randn(rng, (b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(_randn(rng, (b, s, h)) + dt_shift)
    A = -torch.exp(_randn(rng, (h,), scale=0.2))
    return (x, dt, A, _randn(rng, (b, s, n), dtype),
            _randn(rng, (b, s, n), dtype))


def _ssd_close(got, want):
    """Sums of up to N + Q f32 products in another order (atol 1e-4 x the
    largest value); a bf16 y also rounds once (rtol 2^-8)."""
    for g, w in zip(got, want):
        rtol = 2.0 ** -8 if g.dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk", [(64, 16), (130, 130), (520, 130),
                                     (300, 256), (257, 64), (7, 256)])
@pytest.mark.parametrize("p,n", [(64, 128), (16, 16), (8, 4), (24, 36)])
def test_ssd_kernel(cuda, dtype, s, chunk, p, n):
    """Whole and ragged chunks (130 = two 64-row tiles + 2; 300 = 256 + a
    short chunk), head dims that are not multiples of 16."""
    rng = np.random.default_rng(s + p + n)
    args = _ssd_inputs(rng, 2, s, 3, p, n, dtype)
    f32 = [a.float() for a in args]
    got = SD.ssd_cuda(*args, chunk)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _ssd_close(got, ref.ssd_ref(*f32, chunk) if s % chunk == 0
               else ref.ssd_scan_ref(*f32))


@pytest.mark.parametrize("chunk", [32, 64, 256])
def test_ssd_kernel_against_the_recurrence(cuda, chunk):
    """Slow decay: the state carries across key tiles and chunks."""
    rng = np.random.default_rng(chunk)
    args = _ssd_inputs(rng, 2, 512, 4, 64, 128, torch.float32, -4.0)
    _ssd_close(SD.ssd_cuda(*args, chunk), ref.ssd_scan_ref(*args))


@pytest.mark.parametrize("b,s,w", [(2, 64, 96), (1, 37, 4096),
                                   (3, 500, 130)])
def test_rglru_kernel(cuda, b, s, w):
    rng = np.random.default_rng(s + w)
    log_a = -torch.abs(_randn(rng, (b, s, w))) * 0.2
    bb = _randn(rng, (b, s, w), scale=0.5)
    h = RG.rglru_cuda(log_a, bb)
    torch.testing.assert_close(h, ref.rglru_ref(log_a, bb), atol=2e-5,
                               rtol=2e-5)
    assert bool((h.abs() <= bb.abs().cumsum(1) + 1e-4).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,f", [(1, 16, 32), (8, 32, 64), (37, 24, 48),
                                   (128, 64, 160), (300, 72, 200)])
def test_swiglu_kernel(cuda, dtype, t, d, f):
    rng = np.random.default_rng(t)
    x = _randn(rng, (t, d), dtype)
    wi = _randn(rng, (d, f), dtype, 0.2)
    wg = _randn(rng, (d, f), dtype, 0.2)
    wo = _randn(rng, (f, d), dtype, 0.2)
    y = SG.swiglu_cuda(x, wi, wg, wo)
    y0 = ref.swiglu_ref(x.float(), wi.float(), wg.float(), wo.float())
    assert y.dtype == dtype
    torch.testing.assert_close(y.float(), y0, **TOL[dtype])


def test_ops_launch_the_kernels_and_count(cuda):
    rng = np.random.default_rng(0)
    kernels = (MQ.KERNEL, FA.KERNEL, SG.KERNEL, SD.KERNEL, RG.KERNEL)
    before = [k.launches for k in kernels]
    k = [_randn(rng, (16,)) for _ in range(4)]
    ops.mriq(*k, *[_randn(rng, (32,)) for _ in range(3)])
    q = _randn(rng, (1, 16, 2, 8))
    ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    ops.fused_swiglu(_randn(rng, (2, 3, 8)), _randn(rng, (8, 16)),
                     _randn(rng, (8, 16)), _randn(rng, (16, 8)))
    ops.ssd(*_ssd_inputs(rng, 1, 24, 2, 8, 4, torch.bfloat16), chunk=16)
    ops.rglru(-torch.abs(_randn(rng, (1, 9, 8))), _randn(rng, (1, 9, 8)))
    after = [k.launches for k in kernels]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1, 1]


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(0)
    q = _randn(rng, (1, 16, 2, 8))
    with pytest.raises(TypeError):
        FA.flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        FA.flash_attention_cuda(q, q.cpu(), q)
    with pytest.raises(ValueError):          # head dim not a multiple of 8
        FA.flash_attention_cuda(q[..., :6].contiguous(),
                                q[..., :6].contiguous(),
                                q[..., :6].contiguous())
    x = _randn(rng, (4, 12))
    with pytest.raises(ValueError):          # d not a multiple of 8
        SG.swiglu_cuda(x, _randn(rng, (12, 16)), _randn(rng, (12, 16)),
                       _randn(rng, (16, 12)))
    with pytest.raises(ValueError):          # not contiguous
        SG.swiglu_cuda(_randn(rng, (8, 4)).T, _randn(rng, (8, 16)),
                       _randn(rng, (8, 16)), _randn(rng, (16, 8)))
    with pytest.raises(ValueError):          # D over 128, not a multiple of 16
        w = _randn(rng, (1, 8, 1, 136))
        FA.flash_attention_cuda(w, w, w)
    args = _ssd_inputs(rng, 1, 16, 2, 8, 4, torch.float32)
    with pytest.raises(TypeError):           # dt must be f32
        SD.ssd_cuda(args[0], args[1].bfloat16(), *args[2:], 8)
    with pytest.raises(ValueError):          # head dim over 128
        SD.ssd_cuda(_randn(rng, (1, 16, 2, 136)), *args[1:], 8)
    with pytest.raises(TypeError):           # f32 only
        RG.rglru_cuda(args[3].bfloat16(), args[4].bfloat16())


def test_reduced_qwen2_slice_on_the_card(cuda):
    _reduced_on_the_card("qwen2-7b")


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_reduced_recurrent_archs_on_the_card(cuda, arch):
    _reduced_on_the_card(arch)


def _reduced_on_the_card(arch):
    """A reduced config, f32: the offload plan on the card matches the
    plain path on the CPU (1e-4), and prefill + decode on the card match
    its own forward (1e-3, as tests/test_decode_consistency.py)."""
    cfg = get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(
        compute_dtype="float32", kv_cache_dtype="float32"))
    cpu = Model(cfg, cfg.plan.replace(attn_impl="xla"), device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, cfg.plan.replace(attn_impl="pallas", mlp_impl="pallas",
                                      ssm_impl="pallas", rglru_impl="pallas"),
                device="cuda")
    gparams = gpu.load(params.state_dict())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    want = cpu.forward(params, {"tokens": toks})
    full = gpu.forward(gparams, {"tokens": toks.cuda()})
    torch.testing.assert_close(full.cpu(), want, atol=1e-4, rtol=1e-4)
    cache = gpu.init_cache(2, 40)
    last, cache = gpu.prefill(gparams, {"tokens": toks[:, :32].cuda()}, cache)
    assert float((last - full[:, 31]).abs().max()) < 1e-3
    for t in range(32, 40):
        lg, cache = gpu.decode_step(
            gparams, {"tokens": toks[:, t:t + 1].cuda(), "pos": t}, cache)
        assert float((lg - full[:, t]).abs().max()) < 1e-3
