"""The port's CUDA kernels against their plain versions, on the card.

f32 results keep the tolerances of tests/test_kernels.py (the f32 kernels
compute on the CUDA cores and round nowhere).  mriq, whose sines and
cosines of the phase reduced in turns come from the SFU, is also held
against the plain version in f64: elementwise within
``ref.mriq_f32_tolerance`` (derived from its arithmetic), with a max error
at most twice the f32 plain version's.  With phases up to 2^12 turns it
is held against f64 alone: there the f32 plain version is itself off by
more than the f32 tolerance.  bf16 results are held against the plain
version run in f32 on the same bf16 inputs:

* ssd runs its chunk products on the tensor cores and rounds B' (the rows
  of B weighted by dt_j exp(cum_L - cum_j)), the carried state S and the
  decayed scores W' to bf16 before their products.  Each rounding moves
  a product by at most 2^-8 (bf16's unit roundoff) of its sum of |terms|,
  and the plain version run on |x|, |B|, |C| bounds those sums
  elementwise: y is held at 3 x 2^-8 Y_abs, the state at 2^-8 S_abs, each
  + 1e-4 max|plain| + 2^-8 |plain| (``ref.ssd_bf16_tolerance``).
* flash_attention runs on the tensor cores and rounds P to bf16 before PV,
  as the library's kernels do: each weight of a row moves by at most 2^-9
  of itself and the weights sum to 1, so the output moves by at most
  2^-9 max|v|; held at atol 2^-9 max|v| + 1e-5, rtol 2^-8 (the output's own
  rounding).  That is tighter than tests/test_kernels.py's 2e-2 for the
  bf16 Pallas kernel at these inputs.
* swiglu runs on the tensor cores and stores a = silu(x wg) * (x wi) in
  bf16 between its two products.  Against the f32 plain version: atol
  2^-9 (|a| @ |wo|) + 1e-5 (a's rounding, summed through wo), rtol 2^-8
  (y's rounding).  Each product is also held on its own to one rounding
  (rtol 2^-8, atol 1e-5) plus its f32 sums taken in another order on the
  tensor cores, 2^-20 of the sum of |products| (the card's readings sit
  near 2^-22): the kernel's a (``out_a``) against the f32 a, and y
  against that a @ wo in f32.  (The plain version that rounds its own a,
  ``swiglu_ref(round_a=True)``, is no tight mirror at full width: the two
  f32 computations of a round to neighbouring bf16 values here and
  there, and at T=1024, f=18944 those steps add up past 1e-5.)
* The bf16 swiglu adds its split sums in a fixed order, and mriq, ssd and
  rglru have one writer per output and sums in a fixed order: two launches
  agree bit for bit.

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

#: f32 kernels: tests/test_kernels.py's tolerance
TOL = {"atol": 2e-5, "rtol": 2e-5}
#: bf16 flash and swiglu round one intermediate (P, a) to bf16; see above
ROUND = 2.0 ** -9
#: f32 sums of many products in another order on the tensor cores, as a
#: share of the sum of |products|
SUM_ORDER = 2.0 ** -20


def _flash_close(o, o0, v):
    """o against the f32 plain version o0 (see the module docstring)."""
    if o.dtype == torch.float32:
        torch.testing.assert_close(o, o0, **TOL)
        return
    atol = ROUND * float(v.float().abs().max()) + 1e-5
    torch.testing.assert_close(o.float(), o0, atol=atol, rtol=2.0 ** -8)


def _swiglu_close(x, wi, wg, wo):
    """Runs the kernel and holds y against the f32 plain version; for bf16
    also the kernel's a against the f32 a, and y against a @ wo in f32
    (see the module docstring).  Returns y."""
    a_k = None
    if x.dtype == torch.bfloat16:
        a_k = torch.empty((x.shape[0], wi.shape[1]), dtype=torch.bfloat16,
                          device=x.device)
    y = SG.swiglu_cuda(x, wi, wg, wo, out_a=a_k)
    assert y.dtype == x.dtype
    f32 = [t.float() for t in (x, wi, wg, wo)]
    want = ref.swiglu_ref(*f32)
    if a_k is None:
        torch.testing.assert_close(y, want, **TOL)
        return y
    x32, wi32, wg32, wo32 = f32
    h, g = x32 @ wi32, x32 @ wg32
    a = torch.nn.functional.silu(g) * h
    _assert_within(y, want, ROUND * (a.abs() @ wo32.abs()) + 1e-5, 2.0 ** -8)
    # a moves by |silu(g)| dh + |h| |silu'(g)| dg, |silu'| < 1.1
    xa = x32.abs()
    sums = (torch.nn.functional.silu(g).abs() * (xa @ wi32.abs())
            + 1.1 * h.abs() * (xa @ wg32.abs()))
    _assert_within(a_k, a, SUM_ORDER * sums + 1e-5, 2.0 ** -8)
    _assert_within(y, a_k.float() @ wo32,
                   SUM_ORDER * (a_k.float().abs() @ wo32.abs()) + 1e-5,
                   2.0 ** -8)
    return y


def _assert_within(got, want, atol, rtol):
    """|got - want| <= atol + rtol |want| elementwise (atol a tensor)."""
    over = (got.float() - want).abs() - (atol + rtol * want.abs())
    assert bool(torch.isfinite(got.float()).all())
    assert float(over.max()) <= 0, (
        f"max excess {float(over.max()):.3e}, max err "
        f"{float((got.float() - want).abs().max()):.3e}")


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


def _mriq_checks(args, vs_plain=True):
    """The kernel within atol 5e-4 + rtol 1e-4 of the f32 plain version
    (``vs_plain``); within ``ref.mriq_f32_tolerance`` of the f64 plain
    version elementwise, with a max error at most twice the f32 plain
    version's; two launches equal bit for bit.  Without ``vs_plain`` the
    f32 plain version must itself miss f64 by more than that tolerance
    (large phases, where it rounds 2 pi t of thousands of turns)."""
    got = MQ.mriq_cuda(*args)
    again = MQ.mriq_cuda(*args)
    plain = ref.mriq_ref(*args)
    exact = ref.mriq_ref(*[a.double() for a in args])
    bnd = ref.mriq_f32_tolerance(*args)
    for g, a, p, e in zip(got, again, plain, exact):
        assert torch.equal(g, a)
        if vs_plain:
            torch.testing.assert_close(g, p, atol=5e-4, rtol=1e-4)
        err = (g.double() - e).abs()
        assert float((err - bnd).max()) <= 0, float(err.max())
        p_err = float((p.double() - e).abs().max())
        assert float(err.max()) <= 2 * p_err, (float(err.max()), p_err)
        if not vs_plain:
            assert p_err > 5e-4 + 1e-4 * float(e.abs().max())


@pytest.mark.parametrize("n,m", [(4099, 97), (4099, 3073), (1000, 1),
                                 (262147, 3072), (262144, 3072)])
def test_mriq_kernel_ragged_and_against_f64(cuda, n, m):
    """M not a multiple of the stage, the group or the inner loop's step;
    N not a multiple of a block's voxels; and the paper's size."""
    _mriq_checks(ref.mriq_inputs(n + m, n, m, device="cuda"))


@pytest.mark.parametrize("n,m", [(4099, 3072), (1000, 97)])
def test_mriq_kernel_large_phase(cuda, n, m):
    """Coordinates scaled until |t| reaches 2^12 turns: the turn reduction
    still holds the kernel to the f64 plain version at its derived bound."""
    _mriq_checks(ref.mriq_inputs(m, n, m, 2.0 ** 12, device="cuda"),
                 vs_plain=False)


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
    _flash_close(o, o0, v)


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
    _flash_close(o, o0, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_window_skips_many_tiles(cuda, dtype):
    """D=256, window 128 over 1000 positions: the last q tiles skip a dozen
    leading key tiles, and their first kept tile is masked for most of
    its rows."""
    rng = np.random.default_rng(256)
    q = _randn(rng, (1, 1000, 4, 256), dtype)
    k = _randn(rng, (1, 1000, 1, 256), dtype)
    v = _randn(rng, (1, 1000, 1, 256), dtype)
    o = FA.flash_attention_cuda(q, k, v, True, 128)
    _flash_close(o, ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                            True, 128), v)


def _ssd_inputs(rng, b, s, h, p, n, dtype, dt_shift=0.0):
    x = _randn(rng, (b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(_randn(rng, (b, s, h)) + dt_shift)
    A = -torch.exp(_randn(rng, (h,), scale=0.2))
    return (x, dt, A, _randn(rng, (b, s, n), dtype),
            _randn(rng, (b, s, n), dtype))


def _ssd_close(got, want, args, chunk):
    """f32: sums of up to N + Q f32 products in another order (atol 1e-4 x
    the largest value, rtol 1e-4).  bf16: the derived bound of
    ``ref.ssd_bf16_tolerance`` (see the module docstring)."""
    if got[0].dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w.float(), rtol=1e-4,
                                       atol=1e-4 * float(w.abs().max()))
        return
    bounds = ref.ssd_bf16_tolerance(*args, chunk, want)
    for g, w, bnd in zip(got, want, bounds):
        assert g.shape == w.shape
        _assert_within(g, w.float(), bnd, 0.0)


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
               else ref.ssd_scan_ref(*f32), args, chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_fast_decay(cuda, dtype):
    """dt ~ 3: every 64-row tile spans far more than the split's limit, so
    the diagonal tiles take exp(cum_i − cum_j) masked first (and chunk
    256's spans reach the thousands, far past f32's 88)."""
    rng = np.random.default_rng(11)
    args = _ssd_inputs(rng, 2, 512, 4, 64, 128, dtype, 3.0)
    got = SD.ssd_cuda(*args, 256)
    _ssd_close(got, ref.ssd_scan_ref(*[a.float() for a in args]), args, 256)


@pytest.mark.parametrize("chunk", [32, 64, 256])
def test_ssd_kernel_against_the_recurrence(cuda, chunk):
    """Slow decay: the state carries across key tiles and chunks."""
    rng = np.random.default_rng(chunk)
    args = _ssd_inputs(rng, 2, 512, 4, 64, 128, torch.float32, -4.0)
    _ssd_close(SD.ssd_cuda(*args, chunk), ref.ssd_scan_ref(*args), args,
               chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk", [(512, 256), (520, 130)])
def test_ssd_kernel_at_mamba2_shapes(cuda, dtype, s, chunk):
    """mamba2-1.3b's prefill (2 x 512, chunk 256) and forward (2 x 520,
    chunk _blk(520, 256) = 130: tiles 64 + 64 + 2) at its 64 heads of 64,
    state 128; held against the plain version and the recurrence."""
    rng = np.random.default_rng(s)
    args = _ssd_inputs(rng, 2, s, 64, 64, 128, dtype)
    f32 = [a.float() for a in args]
    got = SD.ssd_cuda(*args, chunk)
    _ssd_close(got, ref.ssd_ref(*f32, chunk), args, chunk)
    _ssd_close(got, ref.ssd_scan_ref(*f32), args, chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk,p,n", [(520, 130, 64, 128),
                                         (300, 256, 24, 36)])
def test_ssd_repeats_bit_for_bit(cuda, dtype, s, chunk, p, n):
    """One writer per output, sums in a fixed order: two launches agree."""
    args = _ssd_inputs(np.random.default_rng(3), 2, s, 4, p, n, dtype)
    y1, s1 = SD.ssd_cuda(*args, chunk)
    y2, s2 = SD.ssd_cuda(*args, chunk)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


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


def _rglru_inputs(rng, b, s, w):
    log_a = -torch.abs(_randn(rng, (b, s, w))) * 0.2
    return log_a, _randn(rng, (b, s, w), scale=0.5)


@pytest.mark.parametrize("b,s,w", [(2, 2568, 4096), (2, 300, 33),
                                   (1, 129, 4095), (2, 2560, 130)])
def test_rglru_kernel_at_path_shapes_and_ragged_widths(cuda, b, s, w):
    """recurrentgemma-9b's forward (2 x 2568: 10 windows of 256 + 8) and
    widths that leave a block's last warp lanes past W."""
    log_a, bb = _rglru_inputs(np.random.default_rng(s + w), b, s, w)
    h = RG.rglru_cuda(log_a, bb)
    torch.testing.assert_close(h, ref.rglru_ref(log_a, bb), atol=2e-5,
                               rtol=2e-5)
    assert bool((h.abs() <= bb.abs().cumsum(1) + 1e-4).all())


def test_rglru_repeats_bit_for_bit(cuda):
    log_a, bb = _rglru_inputs(np.random.default_rng(4), 2, 777, 200)
    assert torch.equal(RG.rglru_cuda(log_a, bb), RG.rglru_cuda(log_a, bb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,f", [(1, 16, 32), (8, 32, 64), (37, 24, 48),
                                   (128, 64, 160), (300, 72, 200)])
def test_swiglu_kernel(cuda, dtype, t, d, f):
    rng = np.random.default_rng(t)
    x = _randn(rng, (t, d), dtype)
    wi = _randn(rng, (d, f), dtype, 0.2)
    wg = _randn(rng, (d, f), dtype, 0.2)
    wo = _randn(rng, (f, d), dtype, 0.2)
    _swiglu_close(x, wi, wg, wo)


@pytest.mark.parametrize("t", [SG.DECODE_MAX_T, SG.DECODE_MAX_T + 1])
def test_swiglu_kernel_both_sides_of_the_switch(cuda, t):
    """The last T of the decode design and the first of the prefill one."""
    rng = np.random.default_rng(t)
    x = _randn(rng, (t, 200), torch.bfloat16)
    wi, wg = (_randn(rng, (200, 328), torch.bfloat16, 0.1) for _ in "ig")
    wo = _randn(rng, (328, 200), torch.bfloat16, 0.1)
    assert SG.plan(t, 200, 328, torch.bfloat16)["design"] == (
        "decode" if t <= SG.DECODE_MAX_T else "prefill")
    _swiglu_close(x, wi, wg, wo)


@pytest.mark.parametrize("t", [8, 1024])
def test_swiglu_kernel_at_qwen2_widths(cuda, t):
    """qwen2-7b's MLP (d 3584, f 18944) at decode and prefill T."""
    d, f = 3584, 18944
    rng = np.random.default_rng(t)
    x = _randn(rng, (t, d), torch.bfloat16)
    wi, wg = (_randn(rng, (d, f), torch.bfloat16, d ** -0.5) for _ in "ig")
    wo = _randn(rng, (f, d), torch.bfloat16, f ** -0.5)
    _swiglu_close(x, wi, wg, wo)


@pytest.mark.parametrize("t", [8, 300])
def test_swiglu_bf16_repeats_bit_for_bit(cuda, t):
    """No atomics: the split sums add in a fixed order (decode), and every
    output element has one writer (prefill)."""
    rng = np.random.default_rng(5)
    x = _randn(rng, (t, 512), torch.bfloat16)
    wi, wg = (_randn(rng, (512, 1024), torch.bfloat16, 0.05) for _ in "ig")
    wo = _randn(rng, (1024, 512), torch.bfloat16, 0.05)
    y1 = SG.swiglu_cuda(x, wi, wg, wo)
    y2 = SG.swiglu_cuda(x, wi, wg, wo)
    assert torch.equal(y1, y2)


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
    with pytest.raises(ValueError):          # state over 128
        wide = _randn(rng, (1, 16, 136))
        SD.ssd_cuda(*args[:3], wide, wide, 8)
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


# ---------------------------------------------------------------------------
# What narrowing's resource pre-check and the NVML power source read
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 64, 128, 144, 256])
def test_flash_smem_figure_is_what_its_launcher_requests(cuda, dtype, d):
    rng = np.random.default_rng(0)
    q = _randn(rng, (1, 70, 2, d), dtype)
    FA.flash_attention_cuda(q, q[:, :, :1].contiguous(),
                            q[:, :, :1].contiguous())
    assert FA.KERNEL.requested_smem() == FA.smem_bytes(d, dtype)
    assert FA.smem_bytes(d, dtype) <= torch.cuda.get_device_properties(
        cuda).shared_memory_per_block_optin


@pytest.mark.parametrize("dtype,t", [(torch.float32, 8), (torch.float32, 40),
                                     (torch.bfloat16, 8),
                                     (torch.bfloat16, 65)])
def test_swiglu_smem_figure_is_what_its_launcher_requests(cuda, dtype, t):
    rng = np.random.default_rng(1)
    x = _randn(rng, (t, 64), dtype)
    wi, wg = (_randn(rng, (64, 128), dtype, 0.1) for _ in "ig")
    SG.swiglu_cuda(x, wi, wg, _randn(rng, (128, 64), dtype, 0.1))
    assert SG.KERNEL.requested_smem() == SG.smem_bytes(t, 64, 128, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk,p,n", [(512, 256, 64, 128),
                                         (130, 130, 24, 36),
                                         (64, 16, 128, 16)])
def test_ssd_smem_figure_is_what_its_launcher_requests(cuda, dtype, s,
                                                        chunk, p, n):
    rng = np.random.default_rng(2)
    SD.ssd_cuda(*_ssd_inputs(rng, 1, s, 2, p, n, dtype), chunk)
    assert SD.KERNEL.requested_smem() == SD.smem_bytes(p, n, min(chunk, s),
                                                       dtype)


def test_rglru_smem_figure_is_what_its_launcher_requests(cuda):
    rng = np.random.default_rng(3)
    RG.rglru_cuda(-torch.abs(_randn(rng, (1, 9, 40))),
                  _randn(rng, (1, 9, 40)))
    assert RG.KERNEL.requested_smem() == RG.smem_bytes() == 0


def test_nvml_source_reads_a_draw_within_the_power_limit(cuda):
    from repro_torch.telemetry.nvml import (WINDOW_S, NvmlSource,
                                            check_window, sample_window)
    src = NvmlSource(cuda)
    assert src.name and 0 < src.period < 1.0

    def spin():
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
    win = sample_window(src, spin, WINDOW_S)
    assert 0 < win.watts <= src.power_limit_w * 1.05
    check_window("spin", win.counter)


def test_nvml_energy_counter_is_monotone(cuda):
    import time
    from repro_torch.telemetry.nvml import NvmlSource
    src = NvmlSource(cuda, period=0.01)
    reads = []
    for _ in range(40):
        reads.append(src.energy_j())
        time.sleep(0.01)
    assert all(b >= a for a, b in zip(reads, reads[1:]))
    assert reads[-1] > reads[0]


def test_measured_rung_launches_the_kernels_its_plan_names(cuda,
                                                           monkeypatch):
    from repro_torch.configs import CARD_SHAPES, ShapeSpec
    from repro_torch.core.backends import (MeasureContext, MeasuredBackend,
                                           plan_kernels)
    from repro_torch.core.plan import PlanGenome
    from repro_torch.telemetry.nvml import check_window
    monkeypatch.setitem(CARD_SHAPES, "card_test",
                        ShapeSpec("card_test", 256, 2, "prefill"))
    cfg = get_config("qwen2-7b", reduced=True)
    plan = cfg.plan.replace(attn_impl="pallas", mlp_impl="pallas")
    m = MeasuredBackend(device=cuda).measure(MeasureContext(cfg, "card_test"),
                                             plan)
    assert m.ok and m.source == "measured"
    want = plan_kernels(plan, PlanGenome.gene_names(cfg, "prefill"))
    assert want == ["flash_attention", "swiglu"]
    launches = m.trace.meta["launches"]
    assert all(launches[k] > 0 for k in want)
    assert launches["ssd"] == launches["rglru"] == 0
    check_window("trial", m.trace.meta["counter"])
    assert m.energy_j == pytest.approx(m.trace.integrate(), rel=1e-12)
    assert 0 < m.watts <= m.trace.meta["power_limit_w"] * 1.05
