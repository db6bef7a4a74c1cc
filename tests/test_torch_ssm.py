"""The port's mamba2 block (``repro_torch.models.ssm``) against
``repro.models.ssm``, and the SSD reference fault C1.

f32 throughout, on numpy inputs handed to both packages.  Layer outputs at
1e-5 as tests/test_torch_layers.py (2e-5 for the recurrent decode steps);
the SSD scan at tests/test_kernels.py's 1e-4, and 2e-4 across chunk sizes.
The mixer's parameters are the JAX init's with every vector (conv bias,
A_log, D, dt bias, norm) redrawn, so each one reaches the output.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(**plan):
    plan = {"compute_dtype": "float32", "kv_cache_dtype": "float32", **plan}
    jc, tc = jget("mamba2-1.3b", True), get_config("mamba2-1.3b", True)
    return (dataclasses.replace(jc, plan=jc.plan.replace(**plan)),
            dataclasses.replace(tc, plan=tc.plan.replace(**plan)))


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _mixer(rng, jc):
    p = jax.tree.map(np.asarray, JS.init_mamba2(jax.random.PRNGKey(0), jc))
    for k in ("conv_b", "A_log", "dt_bias"):
        p[k] = _np(rng, p[k].shape, 0.3)
    p["D"] = 1.0 + _np(rng, p["D"].shape, 0.3)
    p["norm"] = 1.0 + _np(rng, p["norm"].shape, 0.3)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def _bench_inputs(seed):
    """``benchmarks/bench_kernels.py``'s SSD shapes and scales: x (1,256,4,
    16), dt = softplus(N), A = -exp(0.2 N), B/C (1,256,16)."""
    rng = np.random.default_rng(seed)
    x = _np(rng, (1, 256, 4, 16))
    dt = np.log1p(np.exp(_np(rng, (1, 256, 4)))).astype(np.float32)
    A = -np.exp(_np(rng, (4,), 0.2)).astype(np.float32)
    return x, dt, A, _np(rng, (1, 256, 16)), _np(rng, (1, 256, 16))


# ---------------------------------------------------------------------------
# C1: the reference's SSD overflows at chunks >= 128; the port does not
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_c1_port_ssd_is_finite_where_the_reference_is_not(seed, chunk):
    """At chunk 256 a chunk's |sum dt*A| is ~200, so the reference's
    exp(cum_i - cum_j) over the whole block overflows above the diagonal
    and the mask turns inf into NaN.  The port masks first: ``ssd_ref`` and
    ``ops.ssd`` stay finite at chunks 128 and 256 and equal the reference
    at chunk 32, where it is finite (2e-4, the chunk-invariance
    tolerance)."""
    args = _bench_inputs(seed)
    targs, jargs = [torch.from_numpy(a) for a in args], \
        [jnp.asarray(a) for a in args]
    y32, hs32 = jref.ssd_ref(*jargs, chunk=32)
    assert np.isfinite(np.asarray(y32)).all()
    if chunk == 256:
        assert np.isnan(np.asarray(jref.ssd_ref(*jargs, chunk=256)[0])).any()
    for y, hs in (ref.ssd_ref(*targs, chunk), ops.ssd(*targs, chunk=chunk)):
        assert bool(torch.isfinite(y).all() and torch.isfinite(hs).all())
        _close(y, y32, atol=2e-4, rtol=2e-4)
        _close(hs, hs32, atol=2e-4, rtol=2e-4)
    y, hs = ref.ssd_ref(*targs, 32)
    _close(y, y32, atol=2e-4, rtol=2e-4)
    _close(hs, hs32, atol=2e-4, rtol=2e-4)


def test_c1_recurrence_agrees_at_the_full_chunk():
    """The token-by-token recurrence (no chunk, no exp of a positive
    number) agrees with the port's chunk-256 scan."""
    targs = [torch.from_numpy(a) for a in _bench_inputs(2)]
    for got, want in zip(ref.ssd_scan_ref(*targs), ref.ssd_ref(*targs, 256)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_ssd_chunked_matches_the_reference_where_it_is_finite():
    """Same inputs, chunk 16 (the reduced config's): the port's stock-op
    scan equals the reference's, ragged length (40 -> gcd chunk 8)
    included."""
    rng = np.random.default_rng(3)
    for s in (48, 40):
        args = (_np(rng, (2, s, 4, 8)),
                np.log1p(np.exp(_np(rng, (2, s, 4)))).astype(np.float32),
                -np.exp(_np(rng, (4,), 0.2)).astype(np.float32),
                _np(rng, (2, s, 6)), _np(rng, (2, s, 6)))
        y, hs = S.ssd_chunked(*map(torch.from_numpy, args), 16)
        jy, jhs = JS.ssd_chunked(*map(jnp.asarray, args), 16)
        _close(y, jy, atol=1e-4, rtol=1e-4)
        _close(hs, jhs, atol=1e-4, rtol=1e-4)
        _close(ops.ssd(*map(torch.from_numpy, args), chunk=16)[0],
               jops.ssd(*map(jnp.asarray, args), chunk=16)[0],
               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(4)
    x, w, b = _np(rng, (2, 7, 5)), _np(rng, (4, 5)), _np(rng, (5,))
    st = _np(rng, (2, 3, 5)) if with_state else None
    got = S._causal_conv(*map(torch.from_numpy, (x, w, b)),
                         None if st is None else torch.from_numpy(st))
    want = JS._causal_conv(*map(jnp.asarray, (x, w, b)),
                           None if st is None else jnp.asarray(st))
    for g, wnt in zip(got, want):
        _close(g, wnt)


def test_mixer_spec_matches_the_reference_init():
    jc, tc = _cfgs()
    jp = JS.init_mamba2(jax.random.PRNGKey(0), jc)
    spec = S.mamba2_spec(tc)
    assert {k: v[0] for k, v in spec.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k in ("conv_b", "A_log", "dt_bias"):
        assert spec[k][1] == ("zeros",) and not np.asarray(jp[k]).any()
    for k in ("D", "norm"):
        assert spec[k][1] == ("ones",) and (np.asarray(jp[k]) == 1).all()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_run_mamba2_forward(impl):
    jc, tc = _cfgs(ssm_impl=impl)
    rng = np.random.default_rng(5)
    jp, tp = _mixer(rng, jc)
    x = _np(rng, (2, 40, jc.d_model))
    got, cache = S.run_mamba2(tp, torch.from_numpy(x), tc, tc.plan)
    want, _ = JS.run_mamba2(jp, jnp.asarray(x), jc, jc.plan)
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_run_mamba2_prefill_then_decode(impl):
    """Prefill fills the conv window and SSM state in place; decode steps
    then run the recurrence; outputs and caches equal the reference's."""
    jc, tc = _cfgs(ssm_impl=impl)
    rng = np.random.default_rng(6)
    jp, tp = _mixer(rng, jc)
    b, s = 2, 32
    jcache = JS.init_ssm_cache(jc, b)
    tcache = S.init_ssm_cache(tc, b, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    x = _np(rng, (b, s, jc.d_model))
    ty, tcache2 = S.run_mamba2(tp, torch.from_numpy(x), tc, tc.plan, tcache)
    jy, jcache = JS.run_mamba2(jp, jnp.asarray(x), jc, jc.plan, jcache)
    assert tcache2 is tcache                 # written in place
    _close(ty, jy)
    for k in jcache:
        _close(tcache[k], jcache[k])
    for _ in range(3):
        xs = _np(rng, (b, 1, jc.d_model))
        ty, tcache = S.run_mamba2(tp, torch.from_numpy(xs), tc, tc.plan,
                                  tcache, decode=True)
        jy, jcache = JS.run_mamba2(jp, jnp.asarray(xs), jc, jc.plan, jcache,
                                   decode=True)
        _close(ty, jy, atol=2e-5, rtol=2e-5)
        for k in jcache:
            _close(tcache[k], jcache[k], atol=2e-5, rtol=2e-5)


def test_ssm_layers_hold_no_mlp():
    """An ``ssm`` layer is norm1 + mixer with a plain residual (reference
    ``transformer.apply_layer``); its cache is the block's."""
    jc, tc = _cfgs()
    spec = T.layer_spec(tc, "ssm")
    assert set(spec) == {"norm1", "mixer"}
    jl = JT.init_layer(jax.random.PRNGKey(0), jc, "ssm")
    assert set(jl) == set(spec)
    cache = T.init_layer_cache(tc, "ssm", 2, 16, torch.device("cpu"))
    jcache = JT.init_layer_cache(jc, "ssm", 2, 16)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}


def test_bf16_layers_match_the_reference_given_the_same_input():
    """Reduced mamba2-1.3b in bf16, layer by layer from the reference's own
    residual stream: each port layer is within 2^-6 of max|out| of the
    reference's (measured: 2^-7.4; the two frameworks round silu and the
    SSD's output at different places).  Through the stack the reduced
    model amplifies such last bits 25x per layer, which is why the
    logits are held to the reference's own bf16 gap
    (tests/test_torch_model.py)."""
    from repro.models.model import Model as JModel
    from repro_torch.convert import params_from_jax
    from repro_torch.models.model import Model
    jc, tc = jget("mamba2-1.3b", True), get_config("mamba2-1.3b", True)
    jp = jax.tree.map(np.asarray, JModel(jc).init(jax.random.PRNGKey(0)))
    params = Model(tc, device="cpu").load(params_from_jax(tc, jp))
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 40))
    h = jnp.asarray(jp["embed"]).astype(jnp.bfloat16)[jnp.asarray(toks)]
    pos, tpos = jnp.arange(40), torch.arange(40, dtype=torch.int32)
    for i in range(tc.n_layers):
        lp = jax.tree.map(lambda a: jnp.asarray(a[i]), jp["scan"]["l0"])
        want, _, _ = JT.apply_layer(lp, h, "ssm", jc, jc.plan, pos, None,
                                    False, None)
        got, _, _ = T.apply_layer(params.layers[i], torch.from_numpy(
            np.asarray(h, np.float32)).bfloat16(), tc, tc.plan, tpos, None,
            False)
        want = np.asarray(want, np.float32)
        _close(got, want, atol=2.0 ** -6 * np.abs(want).max(), rtol=0)
        h = jnp.asarray(want, jnp.bfloat16)
