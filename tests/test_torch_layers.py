"""The port's dense layers against ``repro.models.layers``, on numpy inputs.

f32 throughout (1e-5 unless stated); the int8 KV cache compares its
quantized values exactly.  Parameters are numpy arrays handed to both
packages, with non-zero biases so the QKV bias path is exercised.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(arch="qwen2-7b", **plan):
    plan = {"compute_dtype": "float32", "kv_cache_dtype": "float32", **plan}
    jc, tc = jget(arch, reduced=True), get_config(arch, reduced=True)
    return (dataclasses.replace(jc, plan=jc.plan.replace(**plan)),
            dataclasses.replace(tc, plan=tc.plan.replace(**plan)))


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, **tol):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **(tol or TOL))


def _attn_params(rng, cfg):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {"wq": _np(rng, (d, hq, dh), d ** -0.5),
         "wk": _np(rng, (d, hkv, dh), d ** -0.5),
         "wv": _np(rng, (d, hkv, dh), d ** -0.5),
         "wo": _np(rng, (hq, dh, d), (hq * dh) ** -0.5),
         "bq": _np(rng, (hq, dh), 0.1), "bk": _np(rng, (hkv, dh), 0.1),
         "bv": _np(rng, (hkv, dh), 0.1)}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(dtype):
    jc, tc = _cfgs()
    rng = np.random.default_rng(0)
    x = _np(rng, (2, 5, jc.d_model), 3.0)
    p = {"scale": _np(rng, (jc.d_model,))}
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x).to(getattr(torch, dtype)), tc)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x, dtype), jc)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    _close(got, want, **tol)


@pytest.mark.parametrize("offset", [0, 37])
def test_rope(offset):
    rng = np.random.default_rng(1)
    x = _np(rng, (2, 6, 3, 16))
    pos = np.arange(offset, offset + 6, dtype=np.int32)
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    _close(got, JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


def test_qkv_with_bias():
    jc, tc = _cfgs()
    rng = np.random.default_rng(2)
    jp, tp = _attn_params(rng, jc)
    x = _np(rng, (2, 7, jc.d_model))
    pos = np.arange(7, dtype=np.int32)
    got = L._qkv(tp, torch.from_numpy(x), tc, tc.plan, torch.from_numpy(pos))
    want = JL._qkv(jp, jnp.asarray(x), jc, jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0),
                                           (False, 6)])
@pytest.mark.parametrize("chunk", [4, 6, 32])
def test_naive_and_chunked_attention(hq, hkv, causal, window, chunk):
    rng = np.random.default_rng(hq + window)
    s, t, d = 7, 12, 8
    q, k, v = _np(rng, (2, s, hq, d)), _np(rng, (2, t, hkv, d)), \
        _np(rng, (2, t, hkv, d))
    qpos = np.arange(5, 5 + s, dtype=np.int32)
    kpos = np.arange(t, dtype=np.int32)
    tq = [torch.from_numpy(a) for a in (q, k, v, qpos, kpos)]
    jq = [jnp.asarray(a) for a in (q, k, v, qpos, kpos)]
    naive = JL.attention_naive(*jq, causal, window)
    _close(L.attention_naive(*tq, causal, window), naive)
    _close(L.attention_chunked(*tq, causal, window, chunk),
           JL.attention_chunked(*jq, causal, window, chunk))
    _close(L.attention_chunked(*tq, causal, window, chunk), naive,
           atol=1e-5, rtol=1e-4)


def test_mask_is_additive_neg_inf():
    qpos, kpos = np.arange(3, 6, dtype=np.int32), np.arange(8, dtype=np.int32)
    for causal, window in ((True, 0), (True, 2), (False, 3)):
        got = L._mask(torch.from_numpy(qpos), torch.from_numpy(kpos), causal,
                      window)
        _close(got, JL._mask(jnp.asarray(qpos), jnp.asarray(kpos), causal,
                             window), atol=0, rtol=0)


def test_kv_quant_roundtrip_matches():
    rng = np.random.default_rng(4)
    x = _np(rng, (2, 5, 3, 16), 2.0)
    tq, ts = L._kv_quant(torch.from_numpy(x).to(torch.bfloat16))
    jq, js = JL._kv_quant(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    _close(ts, js, atol=0, rtol=1e-7)
    _close(L._kv_dequant(tq, ts, torch.float32),
           JL._kv_dequant(jq, js, jnp.float32), atol=1e-7, rtol=1e-6)


def _cache_pair(jc, tc, batch, seq):
    return (JT.init_layer_cache(jc, "attn", batch, seq),
            T.init_layer_cache(tc, batch, seq, torch.device("cpu")))


def _cache_close(tcache, jcache):
    assert set(tcache) == set(jcache)
    for key, val in jcache.items():
        if key in ("k", "v") and val.dtype == jnp.int8:
            np.testing.assert_array_equal(tcache[key].numpy(),
                                          np.asarray(val))
        else:
            _close(tcache[key], val)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("impl", ["xla", "xla_chunked", "pallas"])
def test_run_attention_prefill_then_decode(kv, impl):
    """Prefill longer than the cache (keeps the last T positions), then
    decode past the cache length (the rolling slot overwrites the oldest,
    empty slots take the pos + t + 10 rule)."""
    jc, tc = _cfgs(kv_cache_dtype=kv, attn_impl=impl, attn_chunk=4)
    rng = np.random.default_rng(5)
    jp, tp = _attn_params(rng, jc)
    b, s, t = 2, 10, 8
    x = _np(rng, (b, s, jc.d_model))
    jcache, tcache = _cache_pair(jc, tc, b, t)
    pos = np.arange(s, dtype=np.int32)
    jy, jcache = JL.run_attention(jp, jnp.asarray(x), jc, jc.plan,
                                  jnp.asarray(pos), jcache)
    ty, tcache = L.run_attention(tp, torch.from_numpy(x), tc, tc.plan,
                                 torch.from_numpy(pos), tcache)
    _close(ty, jy)
    _cache_close(tcache, jcache)
    for p in range(s, s + 3):
        xs = _np(rng, (b, 1, jc.d_model))
        jy, jcache = JL.run_attention(jp, jnp.asarray(xs), jc, jc.plan,
                                      jnp.asarray([p], jnp.int32), jcache,
                                      decode=True)
        ty, tcache = L.run_attention(tp, torch.from_numpy(xs), tc, tc.plan,
                                     torch.tensor([p], dtype=torch.int32),
                                     tcache, decode=True)
        _close(ty, jy, atol=2e-5, rtol=2e-5)
        _cache_close(tcache, jcache)


@pytest.mark.parametrize("impl", ["xla", "xla_chunked"])
def test_decode_into_an_empty_cache(impl):
    """Decode from position 0 into a fresh cache: every other slot is
    empty (kpos -1) and must stay out of the softmax."""
    jc, tc = _cfgs(attn_impl=impl, attn_chunk=4)
    rng = np.random.default_rng(6)
    jp, tp = _attn_params(rng, jc)
    jcache, tcache = _cache_pair(jc, tc, 1, 12)
    for p in range(3):
        xs = _np(rng, (1, 1, jc.d_model))
        jy, jcache = JL.run_attention(jp, jnp.asarray(xs), jc, jc.plan,
                                      jnp.asarray([p], jnp.int32), jcache,
                                      decode=True)
        ty, tcache = L.run_attention(tp, torch.from_numpy(xs), tc, tc.plan,
                                     torch.tensor([p], dtype=torch.int32),
                                     tcache, decode=True)
        _close(ty, jy)
    _cache_close(tcache, jcache)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("tokens", [1, 9])
def test_run_mlp(impl, tokens):
    jc, tc = _cfgs(mlp_impl=impl)
    rng = np.random.default_rng(7)
    d, f = jc.d_model, jc.d_ff
    p = {"wi": _np(rng, (d, f), d ** -0.5), "wg": _np(rng, (d, f), d ** -0.5),
         "wo": _np(rng, (f, d), f ** -0.5)}
    x = _np(rng, (2, tokens, d))
    got = L.run_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), tc, tc.plan)
    want = JL.run_mlp({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x), jc, jc.plan)
    _close(got, want)


def test_run_moe_names_the_roadmap_item():
    _, tc = _cfgs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        L.run_moe({}, torch.zeros(1, 1, tc.d_model), tc, tc.plan)
