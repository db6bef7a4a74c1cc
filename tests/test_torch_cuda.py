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

* ssd runs its chunk products on the tensor cores and, as the Pallas
  kernel, rounds only y, once as it stores it (rtol 2^-8).  B' (the rows
  of B weighted by dt_j exp(cum_L - cum_j)), the carried state S and the
  decayed scores W' enter their products as hi + lo, two bf16 parts, each
  such split within u^2 = 2^-16 of its product's sum of |terms|; the plain
  version run on |x|, |B|, |C| bounds those sums elementwise: y is held at
  2 u^2 (1 + u^2) Y_abs + 2^-8 |plain|, the state at u^2 (1 + u^2) S_abs,
  each + the f32 kernel's 1e-4 (max|plain| + |plain|)
  (``ref.ssd_bf16_tolerance``).
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
  tensor cores, 2^-20 of the sum of |products| (the second product's
  readings at T=1024 reach 6.5e-7 at qwen2-7b's widths), in proportion to
  the depth past 18944 products: the kernel's a (``out_a``) against the
  f32 a, and y against that a @ wo in f32.  (The plain version that rounds its own a,
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
#: share of the sum of |products|, up to a sum over qwen2-7b's f (18944
#: products); a deeper sum takes more accumulation steps, each of which may
#: lose up to a unit in the last place, so its share grows in proportion.
#: The second product's readings on the H100 at T=1024: 6.5e-7 at f 18944,
#: 1.47e-6 at llama3-405b's f 53248 (PERF.md)
SUM_ORDER = 2.0 ** -20
SUM_DEPTH = 18944


def sum_order(k: int) -> float:
    """The sum-order allowance of a sum over ``k`` products."""
    return SUM_ORDER * max(1.0, k / SUM_DEPTH)


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
    _assert_within(a_k, a, sum_order(x.shape[1]) * sums + 1e-5, 2.0 ** -8)
    _assert_within(y, a_k.float() @ wo32,
                   sum_order(wo.shape[0]) * (a_k.float().abs() @ wo32.abs())
                   + 1e-5,
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


def test_mriq_offload_patterns_on_the_card(cuda):
    """The MRI-Q pattern search's card paths at a small, ragged size:
    pinned copies, the naive pattern's aligned one-voxel launches, the trig
    pattern's device blocks and host sums, phiMag on the card; every
    pattern's (Qr, Qi) within ``bench_mriq.TOL`` of the CPU-only leg
    (``run`` raises otherwise), the naive voxel's parts timed."""
    from repro_torch.examples import mriq_offload
    from repro_torch.telemetry.sampler import ConstantSource
    MQ.KERNEL.launches = 0
    out = mriq_offload.run(cuda, ConstantSource(111.0), n_vox=4099, n_k=97,
                           naive_voxels=70, window_s=0.05,
                           log=lambda m: None)
    rows = {r["name"]: r for r in out["rows"]}
    assert list(rows) == list(mriq_offload.NOTES)
    assert set(rows["naive_per_voxel"]["voxel_parts"]) == \
        {"host", "h2d", "kernel", "d2h"}
    assert all(r["seconds"] > 0 for r in rows.values())
    assert MQ.KERNEL.launches >= 70 + 64


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,causal", [(16, 8, 64, True),
                                             (16, 16, 80, False),
                                             (32, 8, 160, True),
                                             (48, 1, 128, True),
                                             (128, 8, 128, True),
                                             (64, 8, 128, True),
                                             (16, 16, 128, True)])
def test_flash_kernel_at_the_new_archs_heads(cuda, dtype, hq, hkv, d,
                                             causal):
    """The heads of granite-moe-1b-a400m (D 64), hubert-xlarge (D 80, an
    encoder: non-causal), stablelm-12b (D 160: the 256-wide instance),
    granite-20b (a 48:1 group), llama3-405b (128:8), internvl2-76b (64:8)
    and moonshot-v1-16b-a3b (16:16), over a ragged 200 positions."""
    rng = np.random.default_rng(hq + d)
    q = _randn(rng, (2, 200, hq, d), dtype)
    k = _randn(rng, (2, 200, hkv, d), dtype)
    v = _randn(rng, (2, 200, hkv, d), dtype)
    o = FA.flash_attention_cuda(q, k, v, causal, 0)
    o0 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal, 0)
    assert o.dtype == dtype
    _flash_close(o, o0, v)


def _ssd_inputs(rng, b, s, h, p, n, dtype, dt_shift=0.0):
    x = _randn(rng, (b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(_randn(rng, (b, s, h)) + dt_shift)
    A = -torch.exp(_randn(rng, (h,), scale=0.2))
    return (x, dt, A, _randn(rng, (b, s, n), dtype),
            _randn(rng, (b, s, n), dtype))


def _ssd_close(got, want, args, chunk):
    """f32: sums of up to N + Q f32 products in another order (atol 1e-4 x
    the largest value, rtol 1e-4).  bf16: ``ref.ssd_bf16_tolerance``, y's
    own rounding and the splits' u^2 (see the module docstring)."""
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


def test_ssd_kernel_at_the_train_shape(cuda):
    """mamba2-1.3b's train microbatch (1 x 4096, chunk 256: 16 chunks in a
    row carry the state) in bf16, against the recurrence and the plain
    version."""
    rng = np.random.default_rng(4096)
    args = _ssd_inputs(rng, 1, 4096, 64, 64, 128, torch.bfloat16)
    f32 = [a.float() for a in args]
    got = SD.ssd_cuda(*args, 256)
    _ssd_close(got, ref.ssd_scan_ref(*f32), args, 256)
    _ssd_close(got, ref.ssd_ref(*f32, 256), args, 256)


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


@pytest.mark.parametrize("d,f", [(5120, 13824), (16384, 53248),
                                 (8192, 28672)])
@pytest.mark.parametrize("t", [2, 8, 1024])
def test_swiglu_kernel_at_stablelm_and_llama3_widths(cuda, t, d, f):
    """stablelm-12b's MLP (d 5120, f 13824), llama3-405b's (d 16384,
    f 53248, 4.6x qwen2-7b's width) and internvl2-76b's (d 8192, f 28672)
    at decode T (2: a decode step of two sequences) and prefill T; weights
    drawn on the card."""
    g = torch.Generator(device="cuda").manual_seed(t + d)

    def randn(shape, scale):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(torch.bfloat16)
    x = randn((t, d), 1.0)
    wi, wg = randn((d, f), d ** -0.5), randn((d, f), d ** -0.5)
    _swiglu_close(x, wi, wg, randn((f, d), f ** -0.5))


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


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "hubert-xlarge",
                                  "internvl2-76b"])
def test_reduced_new_archs_on_the_card(cuda, arch):
    """The MoE, encoder (audio frames) and vision archs: the MoE
    experts on stock ops, at capacity factor 16 (with drops a prefill and
    a longer forward route differently)."""
    _reduced_on_the_card(arch)


def _reduced_on_the_card(arch):
    """A reduced config, f32: the offload plan on the card matches the
    plain path on the CPU (1e-4), and prefill + decode on the card match
    its own forward (1e-3, as tests/test_decode_consistency.py; not for
    an encoder, which does not decode)."""
    cfg = get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(
        compute_dtype="float32", kv_cache_dtype="float32"))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    cpu = Model(cfg, cfg.plan.replace(attn_impl="xla"), device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, cfg.plan.replace(attn_impl="pallas", mlp_impl="pallas",
                                      ssm_impl="pallas", rglru_impl="pallas"),
                device="cuda")
    gparams = gpu.load(params.state_dict())
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))}
    if cfg.frontend == "audio_frames":
        batch = {"features": torch.from_numpy(rng.standard_normal(
            (2, 40, cfg.d_model)).astype(np.float32))}
    if cfg.frontend == "vision_patches":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_patches, cfg.d_model)).astype(np.float32))
    want = cpu.forward(params, batch)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    full = gpu.forward(gparams, gbatch)
    torch.testing.assert_close(full.cpu(), want, atol=1e-4, rtol=1e-4)
    if cfg.is_encoder:
        return
    toks = batch["tokens"]
    cache = gpu.init_cache(2, 40)
    last, cache = gpu.prefill(gparams, dict(gbatch, tokens=toks[:, :32]
                                            .cuda()), cache)
    assert float((last - full[:, 31]).abs().max()) < 1e-3
    for t in range(32, 40):
        lg, cache = gpu.decode_step(
            gparams, {"tokens": toks[:, t:t + 1].cuda(), "pos": t}, cache)
        assert float((lg - full[:, t]).abs().max()) < 1e-3


# ---------------------------------------------------------------------------
# What narrowing's resource pre-check and the NVML power source read
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 64, 80, 128, 144, 160, 256])
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


# ---------------------------------------------------------------------------
# Training: the autograd Functions and a train step on the card
# ---------------------------------------------------------------------------


def _function_cases(rng, dtype):
    """(name, kernel, Function call, plain version, inputs) for each of the
    four differentiable kernels at small ragged shapes."""
    q = _randn(rng, (2, 40, 4, 64), dtype)
    k, v = _randn(rng, (2, 40, 2, 64), dtype), _randn(rng, (2, 40, 2, 64),
                                                       dtype)
    x = _randn(rng, (2, 9, 32), dtype)
    w = [_randn(rng, (32, 48), dtype, 0.2), _randn(rng, (32, 48), dtype, 0.2),
         _randn(rng, (48, 32), dtype, 0.15)]
    s_args = list(_ssd_inputs(rng, 1, 48, 2, 16, 8, dtype))
    r_args = [-torch.abs(_randn(rng, (2, 33, 40))), _randn(rng, (2, 33, 40))]
    return [
        ("flash_attention", FA.KERNEL,
         lambda *a: ops.flash_attention(*a, True, 16),
         lambda *a: ref.flash_attention_ref(*a, True, 16), [q, k, v]),
        ("swiglu", SG.KERNEL, ops.fused_swiglu,
         lambda xx, *ws: ref.swiglu_ref(xx.reshape(-1, 32), *ws)
         .reshape(xx.shape), [x, *w]),
        ("ssd", SD.KERNEL, lambda *a: ops.ssd(*a, chunk=16),
         lambda *a: ref.ssd_ref(*a, 16), s_args),
        ("rglru", RG.KERNEL, ops.rglru, ref.rglru_ref, r_args)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functions_launch_forward_and_differentiate_the_plain_version(
        cuda, dtype):
    """Each Function's forward launches its kernel once (its backward
    none); its gradients are autograd of the plain version on the same
    inputs on the card: the same code, bit for bit."""
    rng = np.random.default_rng(21)
    for name, kernel, fn, plain, args in _function_cases(rng, dtype):
        args = [a.detach().requires_grad_() for a in args]
        n0 = kernel.launches
        out = fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        assert kernel.launches == n0 + 1, name
        cots = [torch.randn_like(o) for o in outs]
        got = torch.autograd.grad(outs, args, cots)
        assert kernel.launches == n0 + 1, name
        ref_out = plain(*args)
        ref_outs = ref_out if isinstance(ref_out, tuple) else (ref_out,)
        want = torch.autograd.grad(ref_outs, args, cots)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, i)


@pytest.mark.parametrize("s", [257, 4096])
def test_rglru_function_backward_is_the_plain_scan_on_the_card(cuda, s):
    """The rglru Function's backward (the plain version's associative scan
    rematerialized and differentiated, the cotangent in f32) equals
    autograd of the plain version on the card, at the train microbatch's
    S and a ragged one."""
    rng = np.random.default_rng(s)
    args = [-torch.abs(_randn(rng, (1, s, 40), scale=0.3)).requires_grad_(),
            _randn(rng, (1, s, 40)).requires_grad_()]
    out = ops.rglru(*args)
    cot = torch.randn_like(out)
    got = torch.autograd.grad(out, args, cot)
    want = torch.autograd.grad(ref.rglru_ref(*args), args, cot)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-1.3b",
                                  "recurrentgemma-9b"])
def test_reduced_train_step_on_the_card(cuda, arch):
    """A reduced config in f32 under the offload plan with full remat: the
    loss and gradient norm of a train step on the card match the plain
    path on the CPU (1e-4); each kernel of the path launches twice a
    microbatch in a layer of a full unit (the forward, then its
    recomputation in the backward) and once in the tail."""
    from repro_torch.train.step import make_opt_init, make_train_step
    cfg = get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(
        compute_dtype="float32", remat="full", microbatches=2))
    off = cfg.plan.replace(attn_impl="pallas", mlp_impl="pallas",
                           ssm_impl="pallas", rglru_impl="pallas")
    cpu = Model(cfg, cfg.plan.replace(attn_impl="xla"), device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, off, device="cuda")
    gparams = gpu.load(params.state_dict())
    rng = np.random.default_rng(2)
    t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 41))
                         .astype(np.int32))
    batch = {"tokens": t[:, :-1], "targets": t[:, 1:]}
    _, _, want = make_train_step(cpu)(params, make_opt_init(cpu)(params),
                                      batch)
    kernels = {"flash_attention": FA.KERNEL, "swiglu": SG.KERNEL,
               "ssd": SD.KERNEL, "rglru": RG.KERNEL}
    before = {n: k.launches for n, k in kernels.items()}
    _, _, got = make_train_step(gpu)(
        gparams, make_opt_init(gpu)(gparams),
        {k: v.cuda() for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-4)
    from repro_torch.models.transformer import unit_structure
    size, n_full = unit_structure(cfg)
    want_launches = dict.fromkeys(kernels, 0)
    for i, kind in enumerate(cfg.layer_kinds()):
        n = 2 * (2 if i < n_full * size else 1)   # 2 microbatches; remat
        site = {"attn": "flash_attention", "ssm": "ssd", "rec": "rglru"}
        want_launches[site[kind]] += n
        if kind != "ssm" and cfg.act == "swiglu":
            want_launches["swiglu"] += n
    assert {n: k.launches - before[n] for n, k in kernels.items()} \
        == want_launches
    for p in gparams.parameters():
        assert bool(torch.isfinite(p).all())


#: chip_smoke.py's hold of a first train step against the stock f32 step:
#: max(TRAIN_FLOOR |f32|, BF16_GAP_SLACK x the stock bf16 step's gap)
TRAIN_FLOOR = 2.0 ** -8
BF16_GAP_SLACK = 1.25


def _layer_norms(grads: dict, n_layers: int) -> list:
    """Each layer's gradient norm (f32), then the rest's (embedding and
    final norm)."""
    sums = [0.0] * (n_layers + 1)
    for name, g in grads.items():
        i = int(name.split(".")[1]) if name.startswith("layers.") \
            else n_layers
        sums[i] += float(torch.sum(torch.square(g.float())))
    return [v ** 0.5 for v in sums]


#: the stock bf16 step's chunk lengths for the C4 hold: ``ssd_chunked``
#: at each sums in f32 in another order, so the bf16 steps' spread over
#: them is the spread the stock function itself admits
C4_CHUNKS = (256, 128, 64)


def test_mamba2_first_step_grad_norm_at_24_layers(cuda):
    """ROADMAP C4: mamba2-1.3b at its published width, 24 of 48 layers,
    random weights from one init, one microbatch (1 x 4096) of
    train_4k_b4.  The first step's gradient norm under the offload plan
    (the ssd kernel, the config's chunk 256) must lie within
    max(2^-8 |f32|, 1.25 x max over c in C4_CHUNKS of |bf16_c - f32|) of
    the stock f32 step's (chunk 256): chip_smoke.py's hold, with the stock
    bf16 gap taken as the largest over the sum orders the stock function
    admits instead of one sample.  On this path the offload plan differs
    from the stock bf16 plan only in the ssd kernel against
    ``ssd_chunked``.  Prints every norm per layer and in total, and the
    first layer whose norm leaves the same hold; and three probes beside
    the held plans: the offload step again, the offload step at chunk 128
    (the kernel's own sum-order spread) and the offload plan in f32 (the
    f32 kernel)."""
    import gc
    from repro_torch.configs.base import get_shape
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.step import (global_norm, make_grad_step,
                                        param_leaves)
    layers = 24
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=layers)
    assert cfg.ssm_chunk == C4_CHUNKS[0]
    shape = get_shape("train_4k_b4")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=shape.seq_len,
                                  global_batch=shape.global_batch))
    batch = {k: torch.from_numpy(v[:1]).cuda()
             for k, v in data.batch(0).items()}
    one = cfg.plan.replace(microbatches=1)
    params = Model(cfg, one).init(torch.Generator(device="cuda")
                                  .manual_seed(0))
    off = one.replace(attn_impl="pallas", mlp_impl="pallas",
                      ssm_impl="pallas", rglru_impl="pallas")
    f32 = dict(compute_dtype="float32")

    def chunk(c):
        return dataclasses.replace(cfg, ssm_chunk=c)
    bf16 = [f"bf16 chunk {c}" for c in C4_CHUNKS]
    runs = {"f32": (cfg, one.replace(**f32)),
            **{label: (chunk(c), one) for label, c in zip(bf16, C4_CHUNKS)},
            "offload": (cfg, off), "offload again": (cfg, off),
            "offload chunk 128": (chunk(128), off),
            "offload f32": (cfg, off.replace(**f32))}
    total, per_layer = {}, {}
    for label, (c, plan) in runs.items():
        n0 = SD.KERNEL.launches
        grads, _ = make_grad_step(Model(c, plan))(params, batch)
        assert (SD.KERNEL.launches > n0) == (plan.ssm_impl == "pallas"), \
            label
        total[label] = float(global_norm(param_leaves(cfg, grads)))
        per_layer[label] = _layer_norms(grads, layers)
        del grads
        gc.collect()
        torch.cuda.empty_cache()
    for a, b in (("offload again", "offload"),
                 ("offload chunk 128", "offload"),
                 ("offload f32", "f32"),
                 *((label, "f32") for label in bf16)):
        print(f"C4 probe: {a} {total[a]:.6f} against {b} {total[b]:.6f}, "
              f"{abs(total[a] - total[b]) / total[b]:.3e} of it")

    def hold(norms):
        gap = max(abs(norms[label] - norms["f32"]) for label in bf16)
        return max(TRAIN_FLOOR * abs(norms["f32"]), BF16_GAP_SLACK * gap)
    layer = [{label: v[i] for label, v in per_layer.items()}
             for i in range(layers + 1)]
    first = next((i for i, n in enumerate(layer)
                  if abs(n["offload"] - n["f32"]) > hold(n)), None)
    for i, n in enumerate(layer):
        print(f"C4 {'layer ' + str(i) if i < layers else 'rest'}: "
              + " ".join(f"{label} {v:.6f}" for label, v in n.items())
              + f"; |offload - f32| {abs(n['offload'] - n['f32']):.3e} "
              f"hold {hold(n):.3e}")
    limit = hold(total)
    msg = ("C4 total: " + " ".join(f"{label} {v:.6f}"
                                   for label, v in total.items())
           + f"; |offload - f32| {abs(total['offload'] - total['f32']):.3e},"
           f" |offload chunk 128 - f32| "
           f"{abs(total['offload chunk 128'] - total['f32']):.3e}, limit "
           f"{limit:.3e} = max(2^-8 |f32|, {BF16_GAP_SLACK} x the largest "
           f"stock bf16 gap over chunks {C4_CHUNKS}); first layer off its "
           f"hold: {first}")
    print(msg)
    assert abs(total["offload"] - total["f32"]) <= limit, msg


def test_measured_train_trial_on_the_card(cuda, monkeypatch):
    from repro_torch.configs import CARD_SHAPES, ShapeSpec
    from repro_torch.core.backends import MeasureContext, MeasuredBackend
    from repro_torch.telemetry.nvml import check_window
    monkeypatch.setitem(CARD_SHAPES, "card_train",
                        ShapeSpec("card_train", 256, 4, "train"))
    cfg = get_config("qwen2-7b", reduced=True)
    plan = cfg.plan.replace(attn_impl="pallas", mlp_impl="pallas",
                            microbatches=2)
    rung = MeasuredBackend(device=cuda)
    m = rung.measure(MeasureContext(cfg, "card_train"), plan)
    assert m.ok and not rung.params
    launches = m.trace.meta["launches"]
    assert launches["flash_attention"] > 0 and launches["swiglu"] > 0
    check_window("trial", m.trace.meta["counter"])
    assert m.energy_j == pytest.approx(m.trace.integrate(), rel=1e-12)


# ---------------------------------------------------------------------------
# The fleet's torch backend on the card (stock torch ops, no CUDA C++)
# ---------------------------------------------------------------------------

def _fleet_engine(backend: str, **kw):
    from repro_torch.core.power import R740_ARRIA10
    from repro_torch.fleet import (FleetPolicy, PowerPlanPolicy,
                                   PowerStatePolicy, SegmentFleet,
                                   VectorNodeSpec)
    from repro_torch.telemetry import node_envelope
    env = node_envelope(R740_ARRIA10, accelerated=True)
    specs = [VectorNodeSpec(f"pod{i:02d}", env, slots=4, step_s=0.004,
                            max_seq=64) for i in range(32)]
    ppol = PowerPlanPolicy(
        mode="gate", slo_queue_depth=4.0, plan_every=16, min_active=1,
        min_active_steps=64, horizon_steps=64.0,
        states=PowerStatePolicy(gate_watts=3.0, boot_energy_ws=2.0,
                                warmup_steps=8, cooldown_steps=32))
    return SegmentFleet(specs, policy=FleetPolicy(
        flush_every=8, checkpoint_every=16, migrate_on_drift=False),
        plan=ppol, loop_model="serve", backend=backend, **kw)


def test_fleet_control_plane_twins_on_the_card(cuda):
    """Route winners exact with marginal and load ties; the Erlang-C sweep
    at 1024 nodes x 4 slots (c_max 4096) within rtol 1e-9, atol 1e-12."""
    from repro_torch.fleet.power.forecast import ArrivalForecaster
    from repro_torch.fleet.torch_backend import (
        expected_queue_depth_many_torch, route_argmin_np, route_argmin_torch)
    rng = np.random.default_rng(5)
    for trial in range(40):
        n = 1024
        marg = rng.integers(0, 4, n) * 0.125
        marg[rng.random(n) < 0.1] = np.inf
        load = rng.integers(0, 3, n) / 4.0
        rank = rng.permutation(n)
        active = rng.random(n) < (0.6 if trial % 4 else 0.002)
        assert route_argmin_torch(marg, load, rank, active, device=cuda) \
            == route_argmin_np(marg, load, rank, active)
    servers = np.arange(4, 4097, 4)
    fc = ArrivalForecaster()
    for lam in (0.01, 3.0, 300.0):
        for service in (4.0, 16.0):
            fc._n, fc._gap_ewma, fc._last_t = 1, 1.0 / lam, 0.0
            want = fc.expected_queue_depth_many(servers, service, now=0.0)
            got = expected_queue_depth_many_torch(servers, service, lam,
                                                  device=cuda)
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_torch_booking_plane_on_the_card(cuda):
    """The segment engine with its booking plane folded on the card: the
    numpy plane's events and tokens, its ledger within rtol 1e-12, the
    carries on the card until finalize, every chunk timed."""
    from repro_torch.fleet import VectorArrivals
    arr = VectorArrivals.diurnal(4000, tenants=4, hours=24,
                                 steps_per_hour=100, max_new=8, seed=7)
    ref = _fleet_engine("numpy")
    fin_ref = ref.run(arr, max_steps=20_000)
    got = _fleet_engine("torch", device=cuda)
    assert got.device == cuda
    fin = got.run(arr, max_steps=20_000)
    assert fin == fin_ref and len(fin) == 4000
    assert [(e.step, e.node, e.action) for e in got.events] == \
        [(e.step, e.node, e.action) for e in ref.events]
    for r, q in zip(got.results(), ref.results()):
        assert (r["rid"], r["node"], r["tokens"], r["finished"]) == \
            (q["rid"], q["node"], q["tokens"], q["finished"])
        assert r["decode_ws"] == pytest.approx(q["decode_ws"], rel=1e-12)
    assert got.total_ws == pytest.approx(ref.total_ws, rel=1e-12)
    for key, cell in ref.ledger.cells.items():
        c = got.ledger.cells[key]
        assert c.count == cell.count and c.peak_w == cell.peak_w
        assert c.ws == pytest.approx(cell.ws, rel=1e-12)
    acc = got._acc
    assert all(t.device.type == "cuda" for t in acc._dec_carry)
    rows = acc.timings()
    assert rows and sum(r["records"] for r in rows) == acc.records
    assert all(r["h2d_ms"] >= 0.0 and r["fold_ms"] > 0.0 for r in rows)


def test_planner_torch_backend_on_the_card(cuda):
    from repro_torch.fleet import FleetPowerPlanner, PowerPlanPolicy
    planner = FleetPowerPlanner(policy=PowerPlanPolicy(), backend="torch")
    assert planner.device.type == "cuda"
    for _ in range(5):
        planner.forecaster.observe(float(_))
    slots = np.cumsum(np.full(1024, 4))
    got = planner._lq_sweep(slots, 16.0, 5, 64.0)
    want = planner.forecaster.expected_queue_depth_many(
        slots, 16.0, now=5, horizon=64.0)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# The sharding plan on the card: the one-card mesh and the measured rung
# ---------------------------------------------------------------------------


def test_host_mesh_on_the_card_is_one_by_one_and_torn_down(cuda):
    """``make_host_mesh()`` builds ``(1, 1)`` over its own one-rank NCCL
    group; every rule resolves to replicated there; the group goes with
    ``destroy_host_mesh``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import destroy_host_mesh, make_host_mesh
    from repro_torch.parallel import param_sharding as PS
    from repro_torch.parallel.sharding import make_rules, n_shards
    assert not dist.is_initialized()
    try:
        dm = make_host_mesh()
        assert (tuple(dm.shape), dm.mesh_dim_names, dm.device_type) == \
            ((1, 1), ("data", "model"), "cuda")
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        cfg = get_config("qwen2-7b", reduced=True)
        params = Model(cfg, device=cuda).init(
            torch.Generator(device=cuda).manual_seed(0))
        rules = make_rules(cfg, dm, cfg.plan)
        specs = PS.param_spec_tree(params, rules)
        assert specs and all(n_shards(s, dm) == 1 for s in specs.values())
    finally:
        destroy_host_mesh()
    assert not dist.is_initialized()


def test_measured_rung_refuses_a_context_larger_than_its_mesh(cuda,
                                                              monkeypatch):
    from repro_torch.configs import CARD_SHAPES, ShapeSpec
    from repro_torch.core.backends import MeasureContext, MeasuredBackend
    from repro_torch.launch.mesh import host_mesh
    monkeypatch.setitem(CARD_SHAPES, "card_test",
                        ShapeSpec("card_test", 256, 2, "decode"))
    cfg = get_config("qwen2-7b", reduced=True)
    with host_mesh() as dm:
        rung = MeasuredBackend(device=cuda, mesh=dm, decode_steps=4)
        with pytest.raises(ValueError, match="mesh holds 1 devices"):
            rung.measure(MeasureContext(cfg, "card_test", n_chips=256,
                                        tp=16), cfg.plan)
        assert not rung.outputs
        m = rung.measure(MeasureContext(cfg, "card_test"), cfg.plan)
        assert m.ok and m.seconds > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dtensor_inputs_launch_the_kernels_through_local_map(cuda, dtype):
    """On the one-card mesh, ``DTensor`` inputs reach each Function
    through ``local_map``: the kernel launches (never the plain version),
    once in the forward, and the outputs and the gradients equal the plain
    tensors' call bit for bit."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import host_mesh
    rng = np.random.default_rng(22)
    with host_mesh() as dm:
        for name, kernel, fn, plain, args in _function_cases(rng, dtype):
            args = [a.detach().requires_grad_() for a in args]
            want = fn(*args)
            wants = want if isinstance(want, tuple) else (want,)
            cots = [torch.randn_like(o) for o in wants]
            wgrads = torch.autograd.grad(wants, args, cots)
            dargs = [DTensor.from_local(a.detach(), dm, [Replicate()] * 2)
                     .requires_grad_() for a in args]
            n0 = kernel.launches
            got = fn(*dargs)
            gots = got if isinstance(got, tuple) else (got,)
            assert kernel.launches == n0 + 1, name
            assert all(isinstance(o, DTensor) for o in gots), name
            ggrads = torch.autograd.grad(
                gots, dargs, [DTensor.from_local(c, dm, [Replicate()] * 2)
                              for c in cots])
            assert kernel.launches == n0 + 1, name
            for a, b in zip(gots, wants):
                assert torch.equal(a.to_local(), b), name
            for a, b in zip(ggrads, wgrads):
                assert torch.equal(a.to_local(), b), name


def test_rules_train_step_on_the_host_mesh(cuda):
    """One AdamW step of reduced qwen2-7b under the offload plan with
    ``rules`` on the one-card mesh (parameters and state as Replicate
    DTensors) equals the step without rules bit for bit, and launches
    flash_attention and swiglu."""
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.parallel.param_sharding import distribute
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.step import make_opt_init, make_train_step
    cfg = get_config("qwen2-7b", reduced=True)
    plan = cfg.plan.replace(attn_impl="pallas", mlp_impl="pallas",
                            fused_grad_reduce=True)
    cfg = dataclasses.replace(cfg, plan=plan)
    model = Model(cfg, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 65)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def step(rules=None):
        p = model.init(torch.Generator(device=cuda).manual_seed(0))
        o = make_opt_init(model)(p)
        if rules is not None:
            p, o, _ = distribute(rules, p, o)
        return make_train_step(model, rules)(p, o, batch)
    p0, _, m0 = step()
    with host_mesh() as dm:
        n0 = (FA.KERNEL.launches, SG.KERNEL.launches)
        p1, _, m1 = step(make_rules(cfg, dm, plan))
        assert FA.KERNEL.launches > n0[0] and SG.KERNEL.launches > n0[1]
        assert float(m1["loss"].full_tensor()) == float(m0["loss"])
        assert float(m1["grad_norm"].full_tensor()) == \
            float(m0["grad_norm"])
        for (n, a), (_, b) in zip(p0.named_parameters(),
                                  p1.named_parameters()):
            assert torch.equal(a, b.full_tensor()), n


# ---------------------------------------------------------------------------
# The serve loop's decode step as a captured CUDA graph
# ---------------------------------------------------------------------------

#: one tiny config per kind of cache, bf16, under the offload plan:
#: (arch, plan fields)
CACHE_KINDS = {
    "bf16_attention": ("tiny-test", {}),
    "int8_attention": ("tiny-test", {"kv_cache_dtype": "int8"}),
    "ssm": ("mamba2-1.3b", {}),
    "rglru": ("recurrentgemma-9b", {}),
    "moe": ("granite-moe-1b-a400m", {}),
}
OFFLOAD = dict(attn_impl="pallas", mlp_impl="pallas", ssm_impl="pallas",
               rglru_impl="pallas")


def _serving(kind, seed=0):
    arch, fields = CACHE_KINDS[kind]
    cfg = get_config(arch, reduced=arch != "tiny-test")
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(**OFFLOAD,
                                                         **fields))
    model = Model(cfg, device="cuda")
    return model, model.init(torch.Generator(device="cuda")
                             .manual_seed(seed))


def _direct_step(model, params, toks, pos, cache):
    """The decode step called eagerly, an int position, a fresh token
    tensor."""
    from repro_torch.serve.engine import make_decode_step
    return make_decode_step(model)(
        params, {"tokens": torch.from_numpy(toks.copy()).cuda(),
                 "pos": int(pos)}, cache)[0]


def _clone(cache):
    return [{k: v.clone() for k, v in c.items()} for c in cache]


@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_decode_graph_replays_the_eager_step_bit_for_bit(cuda, kind):
    """Every step of ``ServeLoop.decode`` on the card is a replay of one
    captured graph: logits and every cache tensor equal the eager step's
    on a copy of the cache, bit for bit."""
    from repro_torch.serve.engine import ServeLoop
    model, params = _serving(kind)
    loop = ServeLoop(model, params, batch_slots=2, max_seq=16)
    eager = _clone(loop.cache)
    rng = np.random.default_rng(1)
    graph = None
    for pos in range(8):
        toks = rng.integers(2, model.cfg.vocab_size, (2, 1)).astype(np.int32)
        got = loop.decode(toks, pos).clone()
        graph = graph or loop.graph
        assert loop.graph is graph and graph.pool_bytes > 0
        want = _direct_step(model, params, toks, pos, eager)
        assert torch.equal(got, want), pos
        for c, e in zip(loop.cache, eager):
            for k in c:
                assert torch.equal(c[k], e[k]), (pos, k)


def test_decode_graph_counts_its_replayed_launches(cuda):
    """A replay calls no launcher, so the graph adds the launches its
    capture recorded (one swiglu a layer) on every replay; the capture
    itself counts none."""
    from repro_torch.serve.engine import ServeLoop
    model, params = _serving("bf16_attention")
    loop = ServeLoop(model, params, batch_slots=2, max_seq=16)
    toks = np.full((2, 1), 5, np.int32)
    n0 = SG.KERNEL.launches
    loop.decode(toks, 0)
    per_step = model.cfg.n_layers
    # the warm-up step ran eagerly and counted itself
    assert loop.graph.launches == {SG.KERNEL: per_step}
    assert SG.KERNEL.launches == n0 + 2 * per_step
    for pos in range(1, 4):
        loop.decode(toks, pos)
    assert SG.KERNEL.launches == n0 + 5 * per_step


def test_decode_graph_recaptures_when_params_are_swapped(cuda):
    from repro_torch.serve.engine import ServeLoop
    model, params = _serving("bf16_attention")
    _, other = _serving("bf16_attention", seed=1)
    loop = ServeLoop(model, params, batch_slots=2, max_seq=16)
    toks = np.full((2, 1), 7, np.int32)
    loop.decode(toks, 0)
    first = loop.graph
    eager = _clone(loop.cache)
    loop.params = other
    got = loop.decode(toks, 1).clone()
    assert loop.graph is not first
    assert torch.equal(got, _direct_step(model, other, toks, 1, eager))
    model2 = Model(model.cfg, model.plan, model.device)
    loop.model = model2
    loop.decode(toks, 2)
    second = loop.graph
    assert second is not first
    loop.decode(toks, 3)
    assert loop.graph is second


# ---------------------------------------------------------------------------
# The train step as a captured CUDA graph (train.step.TrainGraph)
# ---------------------------------------------------------------------------

TRAIN_GRAPH_STEPS = 4


def _train_graph_model():
    """tiny-lm under the offload plan, full remat over two microbatches,
    and four seeded batches of 2 x 128 tokens on the card."""
    cfg = get_config("tiny-lm")
    model = Model(cfg, cfg.plan.replace(**OFFLOAD, remat="full",
                                        microbatches=2), device="cuda")
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(TRAIN_GRAPH_STEPS):
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 129))
                             .astype(np.int32)).cuda()
        batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    return model, batches


def _train_state(model):
    from repro_torch.train.step import make_opt_init
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    return params, make_opt_init(model)(params)


def _state_tensors(state, prefix=""):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_state_tensors(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture
def deterministic(monkeypatch):
    """Deterministic algorithms (the embedding's backward accumulates with
    atomics otherwise) with cuBLAS's deterministic workspace setting."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_train_graph_replays_the_eager_step_bit_for_bit(cuda, deterministic):
    """The first call is the eager step (and the capture), the next three
    are replays: the loss, the gradient norm, every parameter and every
    optimizer-state tensor equal ``make_train_step``'s from the same
    weights, step by step; the state keeps its storage.  New optimizer
    state captures the step again."""
    from repro_torch.train.step import TrainGraph, make_train_step
    model, batches = _train_graph_model()
    params, state = _train_state(model)
    gparams, gstate = _train_state(model)
    ptrs = {k: t.data_ptr() for k, t in _state_tensors(gstate).items()}
    step, graph = make_train_step(model), TrainGraph(model)
    for i, b in enumerate(batches):
        params, state, met = step(params, state, b)
        gparams, gstate, gmet = graph(gparams, gstate, b)
        if i == 0:
            first = graph.graph
            assert first is not None and graph.pool_bytes > 0
        assert graph.graph is first and graph.binds == 1
        for key in ("loss", "grad_norm"):
            assert torch.equal(gmet[key], met[key]), (i, key)
        want, got = _state_tensors(state), _state_tensors(gstate)
        for path, t in want.items():
            assert torch.equal(got[path], t), (i, path)
        assert {k: t.data_ptr() for k, t in got.items()} == ptrs
        for (n, p), q in zip(params.named_parameters(),
                             gparams.parameters()):
            assert torch.equal(q, p), (i, n)
    assert int(gstate["step"]) == TRAIN_GRAPH_STEPS
    other = {k: v for k, v in gstate.items()}
    graph(gparams, other, batches[0])
    assert graph.binds == 2 and graph.graph is not first


def test_train_graph_counts_its_replayed_launches(cuda):
    """A replay adds the launches one eager step makes, kernel by kernel;
    the capture itself counts none."""
    from repro_torch.train.step import TrainGraph, make_train_step
    model, batches = _train_graph_model()
    kernels = (FA.KERNEL, SG.KERNEL)
    params, state = _train_state(model)
    n0 = [k.launches for k in kernels]
    make_train_step(model)(params, state, batches[0])
    eager = {k: k.launches - n for k, n in zip(kernels, n0)}
    assert all(eager.values())
    params, state = _train_state(model)
    graph = TrainGraph(model)
    n0 = [k.launches for k in kernels]
    graph(params, state, batches[0])
    assert graph.launches == eager
    for b in batches[1:]:
        graph(params, state, b)
    assert [k.launches - n for k, n in zip(kernels, n0)] \
        == [len(batches) * eager[k] for k in kernels]


# ---------------------------------------------------------------------------
# The steps under rules as CUDA graphs, on the one-rank NCCL mesh
# ---------------------------------------------------------------------------

def _rules_model(**plan):
    """Reduced qwen2-7b under the offload plan (and ``plan``'s fields) on
    the card."""
    cfg = get_config("qwen2-7b", reduced=True)
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(**OFFLOAD, **plan))
    return Model(cfg, device="cuda")


def _locals(cache):
    return [{k: v.to_local().clone() for k, v in c.items()} for c in cache]


def test_rules_decode_graph_replays_the_eager_rules_step(cuda):
    """``DecodeGraph`` under rules, the parameters and the cache laid out
    on the mesh: four replays against the eager rules step on a copy of
    the cache, logits and every cache shard bit for bit; the warm-up left
    the cache as it was."""
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.parallel.param_sharding import distribute
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.serve.engine import DecodeGraph, make_decode_step
    model = _rules_model()
    rng = np.random.default_rng(5)
    with host_mesh() as dm:
        rules = make_rules(model.cfg, dm, model.plan)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        params, _, cache = distribute(rules, params,
                                      cache=model.init_cache(2, 16))
        eager = [{k: v.clone() for k, v in c.items()} for c in cache]
        tok = torch.zeros((2, 1), dtype=torch.int32, device="cuda")
        pos = torch.zeros((), dtype=torch.int32, device="cuda")
        before = _locals(cache)
        graph = DecodeGraph(model, params, cache, tok, pos, rules)
        for c, b in zip(_locals(cache), before):
            assert all(torch.equal(c[k], b[k]) for k in c)
        assert graph.pool_bytes > 0 and graph.launches
        step = make_decode_step(model, rules)
        for i in range(4):
            tok.copy_(torch.from_numpy(rng.integers(
                0, model.cfg.vocab_size, (2, 1)).astype(np.int32)))
            pos.fill_(i)
            got = graph.replay()
            with torch.no_grad():
                want = step(params, {"tokens": tok, "pos": pos}, eager)[0]
            assert torch.equal(got.to_local(), want.to_local()), i
            for c, e in zip(cache, eager):
                for k in c:
                    assert c[k].placements == e[k].placements, (i, k)
                    assert torch.equal(c[k].to_local(), e[k].to_local()), \
                        (i, k)


def test_rules_train_graph_replays_the_eager_rules_step(cuda,
                                                         deterministic):
    """``TrainGraph(model, rules)`` on the one-rank NCCL mesh against
    ``make_train_step(model, rules)`` (its state laid back at its
    placements, ``pin_state``) over three steps from one seed: loss, grad
    norm, every parameter and state shard bit for bit, the state keeping
    its storage and placements, a replay launching what an eager step
    launches."""
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.parallel.param_sharding import distribute
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.step import (TrainGraph, make_opt_init,
                                        make_train_step, pin_state)
    model = _rules_model(fused_grad_reduce=True)
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(3):
        t = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (2, 65))
                             .astype(np.int32)).cuda()
        batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    kernels = (FA.KERNEL, SG.KERNEL)
    with host_mesh() as dm:
        rules = make_rules(model.cfg, dm, model.plan)

        def state():
            p = model.init(torch.Generator(device="cuda").manual_seed(0))
            p, o, _ = distribute(rules, p, make_opt_init(model)(p))
            return p, o
        params, opt = state()
        gparams, gopt = state()
        ptrs = {k: t.to_local().data_ptr()
                for k, t in _state_tensors(gopt).items()}
        step, graph = make_train_step(model, rules), TrainGraph(model, rules)
        eager_launches = None
        for i, b in enumerate(batches):
            n0 = [k.launches for k in kernels]
            params, new, met = step(params, opt, b)
            opt = pin_state(new, opt)
            if eager_launches is None:
                eager_launches = {k: k.launches - n
                                  for k, n in zip(kernels, n0)}
            gparams, gopt, gmet = graph(gparams, gopt, b)
            for key in ("loss", "grad_norm"):
                assert torch.equal(gmet[key].full_tensor(),
                                   met[key].full_tensor()), (i, key)
            want, got = _state_tensors(opt), _state_tensors(gopt)
            for path, t in want.items():
                assert got[path].placements == t.placements, (i, path)
                assert torch.equal(got[path].to_local(), t.to_local()), \
                    (i, path)
            assert {k: t.to_local().data_ptr() for k, t in got.items()} \
                == ptrs
            for (n, p), q in zip(params.named_parameters(),
                                 gparams.parameters()):
                assert torch.equal(q.to_local(), p.to_local()), (i, n)
        assert graph.graph is not None and graph.binds == 1
        assert all(eager_launches.values())
        assert {k: graph.launches.get(k, 0) for k in kernels} \
            == eager_launches


def test_measured_decode_trial_replays_its_eager_loop(cuda, monkeypatch):
    """The measured rung's decode trial on the one-rank NCCL mesh: a
    replayed call against an eager call from the same cache state, logits
    and cache bit for bit; through the rung, the trial's graph is in the
    trace's meta and its replays are in the launch counts."""
    from repro_torch.configs import CARD_SHAPES, ShapeSpec
    from repro_torch.core.backends import (DecodeTrial, MeasureContext,
                                           MeasuredBackend, _fill_cache)
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.parallel.sharding import make_rules
    monkeypatch.setitem(CARD_SHAPES, "card_test",
                        ShapeSpec("card_test", 256, 2, "decode"))
    for kv in ("bfloat16", "int8"):
        model = _rules_model(kv_cache_dtype=kv)
        with host_mesh() as dm:
            rules = make_rules(model.cfg, dm, model.plan)
            params = model.init(torch.Generator(device="cuda")
                                .manual_seed(0))
            cache = model.init_cache(2, 256)
            _fill_cache(cache, 252, torch.Generator(device="cuda")
                        .manual_seed(1))
            toks = torch.from_numpy(np.random.default_rng(2).integers(
                0, model.cfg.vocab_size, (2, 4)).astype(np.int32)).cuda()
            trial = DecodeTrial(model, params, cache, toks, 252,
                                torch.cuda.synchronize, rules)
            trial()
            assert trial.graph is not None
            start = [{k: v.clone() for k, v in c.items()} for c in cache]
            got = trial()
            replayed = [{k: v.clone() for k, v in c.items()} for c in cache]
            for c, s0 in zip(cache, start):
                for k in c:
                    c[k].copy_(s0[k])
            want = trial.eager()
            assert torch.equal(got, want), kv
            for c, r in zip(cache, replayed):
                assert all(torch.equal(c[k], r[k]) for k in c), kv

            rung = MeasuredBackend(device=cuda, mesh=dm, decode_steps=4)
            n0 = SG.KERNEL.launches
            m = rung.measure(MeasureContext(model.cfg, "card_test"),
                             model.plan)
            assert m.ok and m.trace.meta["graph"]["capture_ms"] > 0, kv
            calls = m.trace.meta["calls"] + 1
            assert SG.KERNEL.launches - n0 == \
                m.trace.meta["launches"]["swiglu"]
            assert m.trace.meta["launches"]["swiglu"] == \
                (4 * calls + 1) * model.cfg.n_layers, kv


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_measured_rung_oom_in_a_capture_is_a_penalty(cuda, monkeypatch,
                                                      kind):
    """An OOM inside the capture of the trial's step (an allocation no
    card holds, made only while capturing) is the paper's penalty: the
    trial and its graph are dropped and the device's memory is back at
    its level; the next trial runs."""
    from repro_torch.configs import CARD_SHAPES, ShapeSpec
    from repro_torch.core.backends import (MEMORY_SLACK, MeasureContext,
                                           MeasuredBackend)
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.serve import engine
    from repro_torch.train import step as S
    mod, name = (engine, "make_decode_step") if kind == "decode" \
        else (S, "make_train_step")
    real = getattr(mod, name)

    def oom_in_capture(model, rules=None):
        fn = real(model, rules)

        def step(*args):
            if torch.cuda.is_current_stream_capturing():
                torch.empty(1 << 44, dtype=torch.uint8, device="cuda")
            return fn(*args)
        return step
    shape = ShapeSpec("card_test", 256 if kind == "decode" else 64, 2, kind)
    monkeypatch.setitem(CARD_SHAPES, "card_test", shape)
    model = _rules_model()
    with host_mesh() as dm:
        rung = MeasuredBackend(device=cuda, mesh=dm, decode_steps=4)
        ctx = MeasureContext(model.cfg, "card_test")
        torch.cuda.synchronize()
        level = torch.cuda.memory_allocated()
        monkeypatch.setattr(mod, name, oom_in_capture)
        m = rung.measure(ctx, model.plan)
        assert not m.ok and m.error.startswith("OOM"), m.error
        torch.cuda.empty_cache()
        assert torch.cuda.memory_allocated() <= level + MEMORY_SLACK
        monkeypatch.setattr(mod, name, real)
        assert rung.measure(ctx, model.plan).ok


def test_train_graph_refuses_a_host_sync_in_the_step(cuda, monkeypatch):
    """A step that reads a value back to the host (``.item()``) cannot be
    captured: the call raises after its eager step, and the next call on
    the same state raises without running anything."""
    from repro_torch.train.step import TrainGraph
    model, batches = _train_graph_model()
    params, state = _train_state(model)
    loss = model.loss

    def syncing(*args, **kw):
        out = loss(*args, **kw)
        out[0].item()
        return out
    monkeypatch.setattr(model, "loss", syncing)
    graph = TrainGraph(model)
    with pytest.raises(RuntimeError):
        graph(params, state, batches[0])
    assert graph.graph is None and int(state["step"]) == 1
    before = [p.clone() for p in params.parameters()]
    n0 = FA.KERNEL.launches
    with pytest.raises(RuntimeError, match="capture failed"):
        graph(params, state, batches[1])
    assert FA.KERNEL.launches == n0 and int(state["step"]) == 1
    for p, q in zip(params.parameters(), before):
        assert torch.equal(p, q)
