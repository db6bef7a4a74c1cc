"""The port's RG-LRU block (``repro_torch.models.rglru``) against
``repro.models.rglru``.

f32 throughout, on numpy inputs handed to both packages: 1e-5 as
tests/test_torch_layers.py (the scan at tests/test_kernels.py's 2e-5).  The
block's parameters are the JAX init's with the gate biases and the conv
bias redrawn, so each one reaches the output.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ref as JREF
from repro.models import rglru as JR
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import rglru as R
from repro_torch.models import transformer as T

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(**plan):
    plan = {"compute_dtype": "float32", "kv_cache_dtype": "float32", **plan}
    jc = jget("recurrentgemma-9b", True)
    tc = get_config("recurrentgemma-9b", True)
    return (dataclasses.replace(jc, plan=jc.plan.replace(**plan)),
            dataclasses.replace(tc, plan=tc.plan.replace(**plan)))


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _block(rng, jc):
    p = jax.tree.map(np.asarray,
                     JR.init_rglru_block(jax.random.PRNGKey(0), jc))
    for k in ("conv_b", "b_a", "b_x"):
        p[k] = _np(rng, p[k].shape, 0.3)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def test_rglru_gates():
    jc, _ = _cfgs()
    rng = np.random.default_rng(0)
    jp, tp = _block(rng, jc)
    x = _np(rng, (2, 9, jc.lru_width))
    for g, w in zip(R.rglru_gates(tp, torch.from_numpy(x)),
                    JR.rglru_gates(jp, jnp.asarray(x))):
        assert g.dtype == torch.float32
        _close(g, w)


#: sequence lengths of the scan's twins: 1 and 2 (the recursion's base),
#: odd and even lengths at every level down, powers of two and their
#: neighbours; 4096 (the train microbatch) at a narrow width
SCAN_S = [1, 2, 3, 17, 64, 127, 128, 257, 4096]


def _scan_inputs(s, w):
    rng = np.random.default_rng(s)
    return -np.abs(_np(rng, (2, s, w))) * 0.3, _np(rng, (2, s, w))


@pytest.mark.parametrize("s", SCAN_S)
def test_rglru_scan(s):
    log_a, b = _scan_inputs(s, 24 if s < 4096 else 8)
    _close(R.rglru_scan(torch.from_numpy(log_a), torch.from_numpy(b)),
           JR.rglru_scan(jnp.asarray(log_a), jnp.asarray(b)),
           atol=2e-5, rtol=2e-5)


#: the plain path's gradients against ``jax.vjp`` of the reference's
#: oracle: the same recursion, its ``exp`` and products rounded by XLA and
#: torch (at most 3.8e-6 apart at S = 4096): the scan's own tolerance
GRAD_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s", [3, 64, 257, 4096])
def test_rglru_gradients_match_the_reference_vjp(s):
    """``ops.rglru`` on the CPU (the plain version forward, its autograd
    backward with the cotangent in f32) against ``jax.vjp`` of the
    reference's ``kernels.ref.rglru_ref`` on the same inputs and
    cotangent."""
    log_a, b = _scan_inputs(s, 8)
    cot = _np(np.random.default_rng(s + 1), log_a.shape)
    jout, vjp = jax.vjp(JREF.rglru_ref, jnp.asarray(log_a), jnp.asarray(b))
    jga, jgb = vjp(jnp.asarray(cot))
    ta, tb = (torch.from_numpy(a).requires_grad_() for a in (log_a, b))
    out = ops.rglru(ta, tb)
    _close(out.detach(), jout, atol=2e-5, rtol=2e-5)
    ga, gb = torch.autograd.grad(out, (ta, tb), torch.from_numpy(cot))
    _close(ga, jga, **GRAD_TOL)
    _close(gb, jgb, **GRAD_TOL)


def _graph_nodes(t):
    """The autograd nodes ``t`` hangs from."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return len(seen)


def test_rglru_scan_graph_is_log_depth():
    """At S = 4096 the scan's autograd graph holds log2(S) levels of a few
    whole-tensor ops (205 nodes), not one step a position (a loop over
    time: 16,387)."""
    log_a, b = (torch.from_numpy(a).requires_grad_()
                for a in _scan_inputs(4096, 4))
    assert _graph_nodes(R.rglru_scan(log_a, b)) <= 400


def test_block_spec_matches_the_reference_init():
    jc, tc = _cfgs()
    jp = JR.init_rglru_block(jax.random.PRNGKey(0), jc)
    spec = R.rglru_spec(tc)
    assert {k: v[0] for k, v in spec.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert spec["lam"][1] == ("lru_lambda",)


def test_lru_lambda_puts_the_decay_where_griffin_does():
    """a = exp(-8 softplus(Lambda)) lies in (0.9, 0.999), as with the
    reference's init, and the rule draws from the generator it is given."""
    lam = torch.empty(4096)
    R.lru_lambda_(lam, torch.Generator().manual_seed(0))
    a = torch.exp(-R.RG_C * torch.nn.functional.softplus(lam))
    assert float(a.min()) > 0.9 and float(a.max()) < 0.999
    jc, _ = _cfgs()
    ja = np.exp(-8.0 * np.log1p(np.exp(np.asarray(
        JR.init_rglru_block(jax.random.PRNGKey(1), jc)["lam"]))))
    assert ja.min() > 0.9 and ja.max() < 0.999
    again = torch.empty(4096)
    R.lru_lambda_(again, torch.Generator().manual_seed(0))
    assert torch.equal(again, lam)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_run_rglru_block_forward(impl):
    jc, tc = _cfgs(rglru_impl=impl)
    rng = np.random.default_rng(1)
    jp, tp = _block(rng, jc)
    x = _np(rng, (2, 40, jc.d_model))
    got, cache = R.run_rglru_block(tp, torch.from_numpy(x), tc, tc.plan)
    want, _ = JR.run_rglru_block(jp, jnp.asarray(x), jc, jc.plan)
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_run_rglru_block_prefill_then_decode(impl):
    """Prefill fills the conv window and the state in place; decode steps
    run the one-step recurrence; outputs and caches equal the
    reference's."""
    jc, tc = _cfgs(rglru_impl=impl)
    rng = np.random.default_rng(2)
    jp, tp = _block(rng, jc)
    b = 2
    jcache = JR.init_rglru_cache(jc, b)
    tcache = R.init_rglru_cache(tc, b, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    x = _np(rng, (b, 24, jc.d_model))
    ty, tcache2 = R.run_rglru_block(tp, torch.from_numpy(x), tc, tc.plan,
                                    tcache)
    jy, jcache = JR.run_rglru_block(jp, jnp.asarray(x), jc, jc.plan, jcache)
    assert tcache2 is tcache                 # written in place
    _close(ty, jy)
    for k in jcache:
        _close(tcache[k], jcache[k])
    for _ in range(3):
        xs = _np(rng, (b, 1, jc.d_model))
        ty, tcache = R.run_rglru_block(tp, torch.from_numpy(xs), tc,
                                       tc.plan, tcache, decode=True)
        jy, jcache = JR.run_rglru_block(jp, jnp.asarray(xs), jc, jc.plan,
                                        jcache, decode=True)
        _close(ty, jy)
        for k in jcache:
            _close(tcache[k], jcache[k])


def test_hybrid_layers_and_caches_follow_the_reference():
    """rec layers carry norm1/mixer/norm2/mlp (a GELU MLP with biases);
    the hybrid attention cache is min(window, seq) long."""
    jc, tc = _cfgs()
    for kind in ("rec", "attn"):
        spec = T.layer_spec(tc, kind)
        jl = JT.init_layer(jax.random.PRNGKey(0), jc, kind)
        assert {n: {k: v[0] for k, v in ps.items()}
                for n, ps in spec.items()} == \
            {n: {k: tuple(v.shape) for k, v in ps.items()}
             for n, ps in jl.items()}
        for seq in (16, 100):
            cache = T.init_layer_cache(tc, kind, 2, seq, torch.device("cpu"))
            jcache = JT.init_layer_cache(jc, kind, 2, seq)
            assert {k: tuple(v.shape) for k, v in cache.items()} == \
                {k: tuple(v.shape) for k, v in jcache.items()}
    assert T.init_layer_cache(tc, "attn", 1, 100,
                              torch.device("cpu"))["k"].shape[1] == 32
