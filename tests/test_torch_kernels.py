"""The port's plain kernel versions against the JAX Pallas kernels (run in
interpret mode, as tests/test_kernels.py runs them) and the jnp oracles.

Inputs come from numpy seeds and go through both packages.  Tolerances are
tests/test_kernels.py's: mriq atol 5e-4 rtol 1e-4; flash 2e-5 (f32) and
2e-2 (bf16); swiglu 2e-5; rglru 2e-5; ssd 1e-4, and 2e-4 across chunk
sizes.  The mirrors of the bf16 SSD kernel's arithmetic on bf16 inputs
are held at ``ref.ssd_bf16_tolerance``.  On CPU tensors the public wrappers run the plain versions and
never launch (or build) a kernel.
"""
import inspect
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.mriq import mriq_pallas
from repro.kernels.rglru import rglru_pallas
from repro.kernels.ssd import ssd_pallas
from repro.kernels.swiglu import swiglu_pallas
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mriq as MQ
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru as RG
from repro_torch.kernels import ssd as SD
from repro_torch.kernels import swiglu as SG

KERNELS = (MQ.KERNEL, FA.KERNEL, SG.KERNEL, SD.KERNEL, RG.KERNEL)


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


MRIQ_CU = Path(MQ.__file__).parent / "csrc" / "mriq.cu"


def _cu_constants():
    """The float and int constants of ``csrc/mriq.cu``, by name, as
    written there (``constexpr float NAME = literal;``)."""
    src = MRIQ_CU.read_text()
    out = {}
    for name, lit in re.findall(
            r"constexpr (?:float|int) (\w+) = ([-0-9a-fA-Fx.p+*]+?)f?;", src):
        if "*" in lit:
            continue
        out[name] = float.fromhex(lit) if "x" in lit else float(lit)
    return out


def _reduce_turns(t):
    """t - rint(t) in f32, as the kernel takes it (magic constant)."""
    n = (t + ref.RINT_MAGIC) - ref.RINT_MAGIC
    return t - n


def mriq_turns(kx, ky, kz, phi, x, y, z, poly_every=0, voxels=4,
               threads=256, group=96):
    """The MRI-Q kernel's arithmetic in plain PyTorch, f32: t = fmaf(x, kx,
    fmaf(y, ky, z kz)), r = t - rint(t), sin and cos of 2 pi r by
    ``ref.sincos_turns`` for the pairs the kernel sends to its FP32 pipe
    (voxel i sits in slot v = (i // threads) % voxels of its thread, and
    pair (m, i) goes there when (m voxels + v) % poly_every == poly_every -
    1) and, for the rest (the card's SFU), f64 sin and cos rounded to f32;
    each voxel's pairs added by fmaf in groups of ``group`` k points, the
    groups into a Kahan sum, in k order.  ``poly_every`` 0: every pair on
    the SFU stand-in."""
    f = ref._fma32
    t = f(x[:, None], kx[None, :],
          f(y[:, None], ky[None, :], z[:, None] * kz[None, :]))
    r = _reduce_turns(t)
    s_p, c_p = ref.sincos_turns(r)
    ang = 2 * math.pi * r.double()
    s, c = torch.sin(ang).float(), torch.cos(ang).float()
    if poly_every:
        slot = (torch.arange(x.shape[0]) // threads) % voxels
        on = (torch.arange(kx.shape[0])[None, :] * voxels
              + slot[:, None]) % poly_every == poly_every - 1
        s, c = torch.where(on, s_p, s), torch.where(on, c_p, c)
    out = []
    for trig in (c, s):
        tot = torch.zeros_like(x)
        comp = torch.zeros_like(x)
        for g0 in range(0, kx.shape[0], group):
            acc = torch.zeros_like(x)
            for j in range(g0, min(g0 + group, kx.shape[0])):
                acc = f(phi[j].expand_as(acc), trig[:, j], acc)
            yv = acc - comp
            tt = tot + yv
            comp = (tt - tot) - yv
            tot = tt
        out.append(tot)
    return out[0], out[1]


def test_mriq_cu_constants_match_the_mirror():
    """The polynomial's coefficients, the group and the magic constant in
    ``csrc/mriq.cu`` are the mirror's (read from the source, so the two
    cannot drift)."""
    cu = _cu_constants()
    names = ("SIN1", "SIN3", "SIN5", "SIN7")
    assert [cu[k] for k in names] == list(ref.SINCOS_TURNS_SIN)
    assert [1.0] + [cu[k] for k in ("COS2", "COS4", "COS6")] == \
        list(ref.SINCOS_TURNS_COS)
    assert all(np.float32(c) == c for c in ref.SINCOS_TURNS_SIN
               + ref.SINCOS_TURNS_COS)
    assert cu["GROUP"] == ref.MRIQ_GROUP
    assert cu["RINT_MAGIC"] == ref.RINT_MAGIC == 1.5 * 2 ** 23
    assert cu["POLY_EVERY"] == 0 or ref.MRIQ_GROUP % cu["POLY_EVERY"] == 0
    defaults = inspect.signature(mriq_turns).parameters
    for name, key in (("poly_every", "POLY_EVERY"), ("voxels", "V"),
                      ("threads", "THREADS"), ("group", "GROUP")):
        assert defaults[name].default == cu[key]


def test_sincos_turns_within_its_stated_error():
    """The FP32-pipe path against f64 sin and cos of 2 pi r on a dense
    grid of |r| <= 1/2 (every quadrant edge included)."""
    grid = np.linspace(-0.5, 0.5, 1_000_001).astype(np.float32)
    edges = np.array([k / 8 for k in range(-4, 5)], np.float32)
    r = torch.from_numpy(np.concatenate([
        grid, edges, np.nextafter(edges, np.float32(1)),
        np.nextafter(edges, np.float32(-1))]).clip(-0.5, 0.5))
    s, c = ref.sincos_turns(r)
    ang = 2 * math.pi * r.double()
    err = max(float((s.double() - torch.sin(ang)).abs().max()),
              float((c.double() - torch.cos(ang)).abs().max()))
    assert err <= ref.SINCOS_TURNS_MAX_ERR
    assert err > ref.SINCOS_TURNS_MAX_ERR / 2      # the stated error is tight
    assert ref.SINCOS_TURNS_MAX_ERR < ref.SFU_SINCOS_ERR


@pytest.mark.parametrize("scale", [1.0, 1e3, 2.0 ** 21])
def test_turn_reduction_is_exact(scale):
    """r = t - rint(t) lies in [-1/2, 1/2] and t - r is an integer, exactly,
    for |t| up to 2^22."""
    t = _t(np.random.default_rng(3).uniform(-scale, scale, 100_000)
           .astype(np.float32))
    r = _reduce_turns(t)
    n = t.double() - r.double()
    assert bool((r.abs() <= 0.5).all())
    assert bool((n == torch.round(n)).all())
    assert bool((r.double() + n == t.double()).all())


@pytest.mark.parametrize("poly_every", [12, 1, 0])
@pytest.mark.parametrize("n,m,bn,bm", [(64, 32, 16, 8), (128, 64, 64, 64),
                                       (256, 96, 32, 32)])
def test_mriq_turns_matches_pallas_and_oracle(n, m, bn, bm, poly_every):
    """The kernel's turn-reduced arithmetic (polynomial on every 12th pair,
    on every pair, on none; voxel slots of 16 so that both occur)
    against the Pallas kernel (interpret mode) and the jnp oracle at
    tests/test_kernels.py's tolerance."""
    rng = np.random.default_rng(n)
    kx, ky, kz = (_np(rng, (m,)) for _ in range(3))
    phi = rng.random(m, dtype=np.float32)
    x, y, z = (_np(rng, (n,)) for _ in range(3))
    args = (kx, ky, kz, phi, x, y, z)
    qr, qi = mriq_turns(*map(_t, args), poly_every=poly_every, threads=16)
    jargs = [jnp.asarray(a) for a in args]
    for want in (mriq_pallas(*jargs, block_n=bn, block_m=bm),
                 jref.mriq_ref(*jargs)):
        _close(qr, want[0], (5e-4, 1e-4))
        _close(qi, want[1], (5e-4, 1e-4))


@pytest.mark.parametrize("poly_every", [0, 12])
@pytest.mark.parametrize("n,m,t_max", [(64, 97, None), (200, 3073, None),
                                       (64, 300, 2.0 ** 12)])
def test_mriq_turns_within_the_derived_bound_of_f64(n, m, t_max, poly_every):
    """The kernel's arithmetic (SFU pairs stood in by f64 sin/cos rounded
    to f32; no pair or one in 12 on the polynomial) within ``ref.mriq_f32_tolerance`` of the f64 plain version
    elementwise, and no further from it than the f32 plain version is;
    M not a multiple of the group or of the polynomial's stride, and
    coordinates scaled until |t| reaches 2^12 turns, where the f32 plain
    version is off by more than the vs-plain tolerance."""
    args = ref.mriq_inputs(m, n, m, t_max)
    got = mriq_turns(*args, poly_every=poly_every, threads=16)
    exact = ref.mriq_ref(*[a.double() for a in args])
    plain = ref.mriq_ref(*args)
    bnd = ref.mriq_f32_tolerance(*args)
    for g, p, e in zip(got, plain, exact):
        err = (g.double() - e).abs()
        assert bool((err <= bnd).all())
        p_err = float((p.double() - e).abs().max())
        assert float(err.max()) <= 2 * p_err
        if t_max is not None:
            assert p_err > 5e-4 + 1e-4 * float(e.abs().max())


def test_mriq_f32_tolerance_is_what_the_docstring_says():
    kx, ky, kz, phi, x, y, z = ref.mriq_inputs(5, 16, 100)
    u, p = 2.0 ** -24, phi.double().abs()
    d = [a.double() for a in (kx, ky, kz, x, y, z)]
    phase = 2 * math.pi * u * (1 + u) ** 2 * (
        p * (torch.outer(d[3], d[0]).abs() + 2 * torch.outer(d[4], d[1]).abs()
             + 3 * torch.outer(d[5], d[2]).abs())).sum(1)
    G = ref.MRIQ_GROUP
    n_groups, g = -(-100 // G), G * u / (1 - G * u)
    e = ref.SFU_SINCOS_ERR
    sums = (g + (2 * u + 4 * n_groups * u * u) * (1 + g)) * (1 + e)
    want = phase + (e + sums + 2.0 ** -40) * float(p.sum())
    torch.testing.assert_close(ref.mriq_f32_tolerance(kx, ky, kz, phi, x, y,
                                                      z), want)


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


@pytest.mark.parametrize("t,d,f", [(8, 16, 32), (32, 32, 64),
                                   (64, 24, 48)])
def test_swiglu_round_a_mirror_matches_pallas_on_rounded_a(t, d, f):
    """``swiglu_ref(round_a=True)`` is the JAX oracle with a rounded to
    bf16 before the second product, and stays within that one rounding
    (2^-9 (|a| @ |wo|)) of the Pallas kernel, which keeps a in f32."""
    rng = np.random.default_rng(t + d)
    x = _np(rng, (t, d))
    wi, wg, wo = _np(rng, (d, f), 0.2), _np(rng, (d, f), 0.2), \
        _np(rng, (f, d), 0.2)
    y = ref.swiglu_ref(*map(_t, (x, wi, wg, wo)), round_a=True)
    jx, jwi, jwg, jwo = (jnp.asarray(a) for a in (x, wi, wg, wo))
    a = jax.nn.silu(jx @ jwg) * (jx @ jwi)
    a_bf16 = a.astype(jnp.bfloat16).astype(jnp.float32)
    _close(y, a_bf16 @ jwo, (2e-5, 2e-5))
    bound = 2.0 ** -9 * (np.abs(np.asarray(a)) @ np.abs(wo)) + 2e-5
    got = y.numpy() - np.asarray(swiglu_pallas(jx, jwi, jwg, jwo,
                                               block_t=8, block_f=16))
    assert bool((np.abs(got) <= bound).all())
    assert not np.allclose(y.numpy(), ref.swiglu_ref(
        *map(_t, (x, wi, wg, wo))).numpy(), atol=1e-7, rtol=0)


@pytest.mark.parametrize("t,design", [(1, "decode"), (8, "decode"),
                                      (SG.DECODE_MAX_T, "decode"),
                                      (SG.DECODE_MAX_T + 1, "prefill"),
                                      (1024, "prefill")])
def test_swiglu_plan_picks_the_design_by_t(t, design):
    p = SG.plan(t, 3584, 18944, torch.bfloat16)
    assert p["design"] == design and p["a"] == t * 18944
    assert SG.plan(t, 3584, 18944, torch.float32) == {
        "design": "f32", "ws": t * 3584, "a": 0, "kc1": 0, "kc2": 0}
    other = "prefill" if design == "decode" else "decode"
    assert SG.plan(t, 3584, 18944, torch.bfloat16, other)["design"] == other
    with pytest.raises(ValueError):
        SG.plan(t, 3584, 18944, torch.float32, "decode")


def test_swiglu_decode_scratch_at_qwen2_widths():
    """T=8: d split in 4 (1184 gate blocks), f in 19 (1064 down blocks);
    the partials are 7.1 MB beside 407 MB of weights."""
    p = SG.plan(8, 3584, 18944, torch.bfloat16)
    assert (p["kc1"], p["kc2"]) == (896, 1024)
    assert p["ws"] == 4 * 2 * 8 * 18944 + 19 * 8 * 3584
    assert SG.plan(SG.DECODE_MAX_T + 1, 3584, 18944,
                   torch.bfloat16)["ws"] == 0


@pytest.mark.parametrize("k,n", [(16, 32), (3584, 18944), (18944, 3584),
                                 (72, 200), (200, 8), (64 * 1000 + 8, 64)])
def test_swiglu_k_split_covers_k_in_whole_tiles(k, n):
    z, kc = SG.k_split(k, n)
    assert kc % SG.DECODE_TILE == 0 and (z - 1) * kc < k <= z * kc
    blocks = z * -(-n // SG.DECODE_TILE)
    assert blocks >= min(SG.DECODE_BLOCKS, -(-n // SG.DECODE_TILE)
                         * -(-k // SG.DECODE_TILE)) // 2


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
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru_inputs(rng, b, s, w, decay=0.2, scale=0.5):
    return (-np.abs(_np(rng, (b, s, w))) * decay, _np(rng, (b, s, w), scale))


@pytest.mark.parametrize("s,w,bt,bw", [(32, 64, 8, 16), (64, 128, 16, 128),
                                       (128, 96, 32, 32)])
def test_rglru_plain_matches_pallas_and_oracle(s, w, bt, bw):
    log_a, b = _rglru_inputs(np.random.default_rng(s), 2, s, w)
    h = ops.rglru(_t(log_a), _t(b))
    assert h.dtype == torch.float32
    ja, jb = jnp.asarray(log_a), jnp.asarray(b)
    for want in (rglru_pallas(ja, jb, block_w=bw, block_t=bt),
                 jref.rglru_ref(ja, jb), jops.rglru(ja, jb)):
        _close(h, want, (2e-5, 2e-5))


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("s", [16, 64])
def test_rglru_plain_decay_bound(seed, s):
    """|h| <= cumsum|b| for log_a < 0 (a contraction), as
    tests/test_kernels.py's property test."""
    rng = np.random.default_rng(seed)
    log_a = -np.abs(_np(rng, (1, s, 16))) - 1e-3
    b = _np(rng, (1, s, 16))
    h = ops.rglru(_t(log_a), _t(b))
    assert bool((h.abs() <= _t(np.cumsum(np.abs(b), axis=1)) + 1e-4).all())


# ---------------------------------------------------------------------------
# SSD (mamba2)
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, b, s, h, p, n, a_scale=0.2, dt_scale=1.0):
    x = _np(rng, (b, s, h, p))
    dt = (np.log1p(np.exp(_np(rng, (b, s, h)))) * dt_scale).astype(
        np.float32)
    A = -np.exp(_np(rng, (h,), a_scale)).astype(np.float32)
    return x, dt, A, _np(rng, (b, s, n)), _np(rng, (b, s, n))


@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (128, 64)])
def test_ssd_plain_matches_pallas_and_oracle(s, chunk):
    # dt halved: at chunk 64 a chunk's |sum dt*A| can pass 88, where the
    # JAX reference's exp-then-mask gives NaN (fault C1, test_torch_ssm.py)
    args = _ssd_inputs(np.random.default_rng(s), 2, s, 3, 8, 4, dt_scale=0.5)
    y, hs = ops.ssd(*map(_t, args), chunk=chunk)
    assert y.dtype == hs.dtype == torch.float32 and hs.shape == (2, 3, 8, 4)
    jargs = [jnp.asarray(a) for a in args]
    for want in (ssd_pallas(*jargs, chunk=chunk),
                 jref.ssd_ref(*jargs, chunk=chunk),
                 jops.ssd(*jargs, chunk=chunk)):
        _close(y, want[0], (1e-4, 1e-4))
        _close(hs, want[1], (1e-4, 1e-4))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_ssd_plain_chunk_invariance(seed, chunk):
    """The chunk size must not change the result (tests/test_kernels.py's
    property test, against the JAX reference in one chunk)."""
    args = _ssd_inputs(np.random.default_rng(seed), 1, 32, 2, 4, 4, 0.1)
    y, hs = ops.ssd(*map(_t, args), chunk=chunk)
    y0, hs0 = jref.ssd_ref(*map(jnp.asarray, args), chunk=32)
    _close(y, y0, (2e-4, 2e-4))
    _close(hs, hs0, (2e-4, 2e-4))


def test_ssd_scan_ref_is_the_chunked_scan_token_by_token():
    args = [_t(a) for a in _ssd_inputs(np.random.default_rng(9), 2, 48, 3,
                                       8, 4)]
    for got, want in zip(ref.ssd_scan_ref(*args), ref.ssd_ref(*args, 16)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_ssd_picks_the_reference_chunk():
    """``ops.ssd`` chunks by ``_blk`` (520 tokens at chunk 256 -> 130, as
    the kernel route of the reference), ``ssd_ref`` by gcd."""
    assert ops._blk(520, 256) == 130 and ops._blk(512, 256) == 256
    assert ops._blk(7, 256) == 7 and ops._blk(40, 16) == 10


# ---------------------------------------------------------------------------
# Mirrors of the CUDA kernels' arithmetic (csrc/ssd.cu, csrc/rglru.cu)
# ---------------------------------------------------------------------------

def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    """t as the bf16 kernel feeds an f32 operand to a bf16 product: hi =
    bf16(t) plus lo = bf16(t - hi), summed exactly in f32."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def ssd_passes(x, dt, A, Bm, Cm, chunk, tile=64, rounded=False,
               split=False, split_span=64.0):
    """The SSD kernel's decomposition in plain PyTorch: chunks of
    min(chunk, S) positions (the last may be shorter); pass 1, each chunk's
    state s_c = xᵀ B' with B' = B · dt_j exp(cum_L − cum_j); pass 2, S_c =
    exp(cum_L) S_{c-1} + s_c in chunk order; pass 3, W' = (C Bᵀ) · exp(cum_i
    − cum_j) · dt_j for j ≤ i (masked before the exponential; the decay
    taken as exp(cum_i − cum_i0) exp(cum_i0 − cum_j), i0 the query
    ``tile``'s first row, below the diagonal tile and on it where the
    tile's span cum_i0 − cum_last is under ``split_span``), y = W' x +
    exp(cum_i) C S_{c-1}ᵀ.
    ``split`` feeds B', S_{c-1} and W' to their products as hi + lo, two
    bf16 parts, as the bf16 kernel does; ``rounded`` rounds them to bf16
    alone, as the bf16 kernel did before it split them.  Returns (y in x's
    dtype, final state f32)."""
    b, s, h, p = x.shape
    q = min(chunk, s)
    rnd = _split if split else _bf16 if rounded else (lambda t: t)
    xf, Bf, Cf, dtf = x.float(), Bm.float(), Cm.float(), dt.float()
    state = torch.zeros((b, h, p, Bm.shape[-1]))
    y = torch.empty((b, s, h, p))
    for c0 in range(0, s, q):
        sl = slice(c0, min(s, c0 + q))
        xc, bc, cc, dtc = xf[:, sl], Bf[:, sl], Cf[:, sl], dtf[:, sl]
        L = xc.shape[1]
        cum = torch.cumsum(dtc * A.float(), dim=1)                 # (B,L,H)
        w = dtc * torch.exp(cum[:, -1:] - cum)
        bprime = rnd(bc[:, :, None, :] * w[..., None])              # (B,L,H,N)
        s_c = torch.einsum("bjhp,bjhn->bhpn", xc, bprime)
        enter = rnd(state)
        state = torch.exp(cum[:, -1])[..., None, None] * state + s_c
        i = torch.arange(L)
        i0 = (i // tile) * tile
        last = torch.clamp(i0 + tile, max=L) - 1
        below = (i[None, :] < i0[:, None])[None, :, :, None]      # (1,i,j,1)
        diag = ((i[None, :] <= i[:, None])[None, :, :, None]) & ~below
        split = (cum[:, i0] - cum[:, last] < split_span)[:, :, None, :]
        fact = below | (diag & split)                               # (B,i,j,H)
        ci = cum[:, :, None, :]                                     # (B,i,1,H)
        cj = cum[:, None, :, :]                                     # (B,1,j,H)
        c0i = cum[:, i0][:, :, None, :]
        neg = torch.tensor(float("-inf"))
        decay = torch.where(
            fact,
            torch.exp(torch.where(fact, ci - c0i, neg))
            * torch.exp(torch.where(fact, c0i - cj, neg)),
            torch.exp(torch.where(diag & ~split, ci - cj, neg)))
        gram = torch.einsum("bin,bjn->bij", cc, bc)
        wp = rnd(gram[..., None] * decay * dtc[:, None, :, :])     # (B,i,j,H)
        y_in = torch.einsum("bijh,bjhp->bihp", wp, xc)
        y_st = torch.einsum("bin,bhpn->bihp", cc, enter) \
            * torch.exp(cum)[..., None]
        y[:, sl] = y_st + y_in
    return y.to(x.dtype), state


@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (128, 64), (128, 128)])
def test_ssd_pass_mirror_matches_pallas_and_oracle(s, chunk):
    """The decomposition in f32 against the Pallas kernel (interpret mode),
    the jnp oracle and the port's plain version, at 1e-4 (dt halved where
    the JAX reference would overflow, fault C1)."""
    args = _ssd_inputs(np.random.default_rng(s + chunk), 2, s, 3, 8, 4,
                       dt_scale=0.25)
    y, hs = ssd_passes(*map(_t, args), chunk)
    jargs = [jnp.asarray(a) for a in args]
    for want in (ssd_pallas(*jargs, chunk=chunk),
                 jref.ssd_ref(*jargs, chunk=chunk)):
        _close(y, want[0], (1e-4, 1e-4))
        _close(hs, want[1], (1e-4, 1e-4))
    for got, want in zip((y, hs), ref.ssd_ref(*map(_t, args), chunk)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("split_span", [64.0, 0.0])
@pytest.mark.parametrize("s,chunk,p,n", [(300, 256, 8, 4), (257, 64, 24, 36),
                                         (7, 256, 16, 16), (520, 130, 8, 16)])
def test_ssd_pass_mirror_ragged_chunks_against_the_recurrence(s, chunk, p, n,
                                                              split_span):
    """Short last chunks and tiles (130 = 64 + 64 + 2) in f32 against the
    token-by-token recurrence, at 1e-4 of the largest value, with the
    diagonal tiles' decay split where their span allows and never split."""
    args = [_t(a) for a in _ssd_inputs(np.random.default_rng(s), 1, s, 2, p,
                                       n)]
    for got, want in zip(ssd_passes(*args, chunk, split_span=split_span),
                         ref.ssd_scan_ref(*args)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


def _ssd_bf16_case(s, chunk, scan, batch=2, heads=3, p=16, n=32):
    """bf16 inputs (as f32 tensors) from numpy seed ``s``, and the plain
    version in f32 on them: of the recurrence where ``scan`` (the JAX
    reference is NaN there, fault C1: dt not scaled down), else the
    chunked plain version (dt quartered)."""
    x, dt, A, Bm, Cm = _ssd_inputs(np.random.default_rng(s), batch, s,
                                   heads, p, n,
                                   dt_scale=1.0 if scan else 0.25)
    xb, Bb, Cb = (_bf16(_t(a)) for a in (x, Bm, Cm))
    args = (xb, _t(dt), _t(A), Bb, Cb)
    want = ref.ssd_scan_ref(*args) if scan else ref.ssd_ref(*args, chunk)
    return args, want


def _within(got, want, bounds):
    return all(bool(((g - w).abs() <= bnd).all())
               for g, w, bnd in zip(got, want, bounds))


@pytest.mark.parametrize("s,chunk,scan", [(64, 16, False), (128, 64, False),
                                          (512, 256, True), (520, 130, True)])
def test_ssd_bf16_roundings_within_the_derived_bound(s, chunk, scan):
    """The bf16 kernel's arithmetic (B', S and W' split into hi + lo bf16
    parts) on bf16 inputs stays within ``ref.ssd_bf16_tolerance`` of the
    f32 plain version; the arithmetic it had before (B', S and W' rounded
    to bf16 alone, fault C10) lies outside it, and moves the result."""
    args, want = _ssd_bf16_case(s, chunk, scan)
    bounds = ref.ssd_bf16_tolerance(*args, chunk, want)
    assert _within(ssd_passes(*args, chunk, split=True), want, bounds)
    old = ssd_passes(*args, chunk, rounded=True)
    for g, w, bnd in zip(old, want, bounds):
        assert not bool(((g - w).abs() <= bnd).all())
    assert not torch.allclose(old[0], want[0], atol=1e-6, rtol=0)


@pytest.mark.parametrize("s,chunk", [(128, 16), (256, 32), (512, 64)])
def test_ssd_bf16_split_mirror_matches_pallas_and_oracle(s, chunk):
    """Eight chunks: the split arithmetic on bf16 inputs within the bound
    of the Pallas kernel (interpret mode), the jnp oracle and the port's
    plain version, each in f32 on the same inputs (dt quartered: the JAX
    reference is finite)."""
    args, want = _ssd_bf16_case(s, chunk, False)
    got = ssd_passes(*args, chunk, split=True)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    for jw in (ssd_pallas(*jargs, chunk=chunk),
               jref.ssd_ref(*jargs, chunk=chunk)):
        jw = tuple(torch.from_numpy(np.array(w, np.float32)) for w in jw)
        assert _within(got, jw, ref.ssd_bf16_tolerance(*args, chunk, jw))
    assert _within(got, want, ref.ssd_bf16_tolerance(*args, chunk, want))


@pytest.mark.parametrize("s,chunk", [(2048, 256), (2100, 256), (1170, 130)])
def test_ssd_bf16_split_mirror_against_the_recurrence(s, chunk):
    """Eight or more chunks at the chunks of mamba2-1.3b's paths (256, and
    130 = 64 + 64 + 2; 2100 ends in a short chunk), dt unscaled (the JAX
    reference is NaN): the split arithmetic within the bound of the
    token-by-token recurrence, the old arithmetic outside it."""
    args, want = _ssd_bf16_case(s, chunk, True, batch=1)
    bounds = ref.ssd_bf16_tolerance(*args, chunk, want)
    assert _within(ssd_passes(*args, chunk, split=True), want, bounds)
    assert not _within(ssd_passes(*args, chunk, rounded=True), want, bounds)


def test_ssd_bf16_tolerance_is_what_the_docstring_says():
    args = [_t(a) for a in _ssd_inputs(np.random.default_rng(2), 1, 16, 2,
                                       4, 4)]
    want = ref.ssd_ref(*args, 8)
    absy, abss = ref.ssd_ref(args[0].abs(), args[1], args[2],
                             args[3].abs(), args[4].abs(), 8)
    by, bs = ref.ssd_bf16_tolerance(*args, 8, want)
    u = 2.0 ** -8
    for bnd, xa, w, k, own in ((by, absy, want[0], 2, u),
                               (bs, abss, want[1], 1, 0.0)):
        torch.testing.assert_close(
            bnd, k * u * u * (1 + u * u) * xa
            + 1e-4 * (w.abs().max() + w.abs()) + own * w.abs())


def rglru_window_scan(log_a, b, seg=32, warps=8):
    """The RG-LRU kernel's scan in plain PyTorch: windows of warps·seg
    steps; each segment of seg steps scanned from h = 0 with the running
    product of a = exp(log_a); the segments' (product, end) pairs folded in
    warp order from the window's carry-in; h = local + product · carry_in.
    Steps past S enter as (log_a, b) = (0, 0)."""
    bsz, s, w = log_a.shape
    win = warps * seg
    pad = -s % win
    a = torch.exp(torch.nn.functional.pad(log_a.float(), (0, 0, 0, pad)))
    bp = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    n = (s + pad) // win
    a = a.reshape(bsz, n, warps, seg, w)
    bp = bp.reshape(bsz, n, warps, seg, w)
    loc = torch.empty_like(bp)
    prod = torch.empty_like(bp)
    hv = torch.zeros((bsz, n, warps, w))
    pv = torch.ones((bsz, n, warps, w))
    for u in range(seg):
        hv = a[:, :, :, u] * hv + bp[:, :, :, u]
        pv = pv * a[:, :, :, u]
        loc[:, :, :, u], prod[:, :, :, u] = hv, pv
    h = torch.empty_like(bp)
    carry = torch.zeros((bsz, w))
    for k in range(n):
        for m in range(warps):
            h[:, k, m] = loc[:, k, m] + prod[:, k, m] * carry[:, None]
            carry = prod[:, k, m, -1] * carry + loc[:, k, m, -1]
    return h.reshape(bsz, n * win, w)[:, :s]


@pytest.mark.parametrize("s,w,seg,warps", [(600, 64, 32, 8), (37, 96, 16, 8),
                                           (500, 130, 16, 8), (200, 40, 8, 4),
                                           (129, 33, 4, 2), (64, 32, 32, 1)])
def test_rglru_window_scan_mirror_matches_pallas_and_oracle(s, w, seg, warps):
    """Several segment and window sizes, S and W that are not multiples of
    the window or of 32, at tests/test_kernels.py's 2e-5."""
    log_a, b = _rglru_inputs(np.random.default_rng(s + w), 2, s, w)
    h = rglru_window_scan(_t(log_a), _t(b), seg, warps)
    ja, jb = jnp.asarray(log_a), jnp.asarray(b)
    for want in (rglru_pallas(ja, jb, block_w=w, block_t=s),
                 jref.rglru_ref(ja, jb)):
        _close(h, want, (2e-5, 2e-5))
    torch.testing.assert_close(h, ref.rglru_ref(_t(log_a), _t(b)),
                               atol=2e-5, rtol=2e-5)
    assert bool((h.abs() <= _t(np.cumsum(np.abs(b), axis=1)) + 1e-4).all())


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
    ops.ssd(*map(_t, _ssd_inputs(rng, 1, 16, 2, 4, 4)), chunk=8)
    ops.rglru(*map(_t, _rglru_inputs(rng, 1, 8, 4)))
    assert [k.launches for k in KERNELS] == before == [0] * 5
    assert all(k._fn is None for k in KERNELS)       # nothing built/loaded


@pytest.mark.parametrize("call", [
    lambda t: FA.flash_attention_cuda(t((1, 8, 2, 8)), t((1, 8, 2, 8)),
                                      t((1, 8, 2, 8))),
    lambda t: SG.swiglu_cuda(t((4, 8)), t((8, 8)), t((8, 8)), t((8, 8))),
    lambda t: MQ.mriq_cuda(*[t((8,)) for _ in range(7)]),
    lambda t: SD.ssd_cuda(t((1, 8, 2, 4)), t((1, 8, 2)), t((2,)),
                          t((1, 8, 4)), t((1, 8, 4)), 8),
    lambda t: RG.rglru_cuda(t((1, 8, 4)), t((1, 8, 4))),
], ids=["flash_attention", "swiglu", "mriq", "ssd", "rglru"])
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
    with pytest.raises(ValueError, match="different devices"):
        ops.rglru(torch.zeros((1, 4, 8)), torch.zeros((1, 4, 8),
                                                      device="meta"))
    x = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="different devices"):
        ops.ssd(x, torch.zeros((1, 8, 2)), torch.zeros((2,), device="meta"),
                torch.zeros((1, 8, 4)), torch.zeros((1, 8, 4)))
