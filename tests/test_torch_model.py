"""The port's model against ``repro.models`` with weights carried by
``repro_torch.convert.params_from_jax``.

Tolerances: f32 compute, 1e-4 on the logits (sums taken in another order);
bf16 compute, 5% of the largest logit — bf16 keeps 8 bits (2^-8 = 0.4%), the
two frameworks round at different places and the differences compound
through the layers (measured: 1.3-1.4% on these configs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro_torch.configs import MoEConfig, get_config, list_archs
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model

ARCHS = ["tiny-test", "qwen2-7b"]


def _f32(cfg):
    return dataclasses.replace(cfg, plan=cfg.plan.replace(
        compute_dtype="float32", kv_cache_dtype="float32"))


def _pair(arch, f32=True, seed=0):
    """(JAX cfg, JAX params as numpy, port cfg, port Model, port params)."""
    jcfg, cfg = jget(arch, reduced=True), get_config(arch, reduced=True)
    if f32:
        jcfg, cfg = _f32(jcfg), _f32(cfg)
    jp = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(seed)))
    model = Model(cfg, device="cpu")
    return jcfg, jp, cfg, model, model.load(params_from_jax(cfg, jp))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_registry_holds_the_ported_archs():
    assert list_archs() == ["qwen2-7b", "tiny-lm", "tiny-lm-fast",
                            "tiny-test"]
    for name in list_archs():
        for reduced in (False, True):
            got = dataclasses.asdict(get_config(name, reduced))
            want = dataclasses.asdict(jget(name, reduced))
            # the port's plan holds the reference plan's fields it reads
            plan, jplan = got.pop("plan"), want.pop("plan")
            assert got == want
            assert plan == {k: jplan[k] for k in plan}


@pytest.mark.parametrize("field,value", [("attn_impl", "cuda"),
                                         ("mlp_impl", "xla_chunked")])
def test_plan_rejects_an_unknown_destination(field, value):
    plan = get_config("tiny-test").plan
    with pytest.raises(ValueError, match=field):
        plan.replace(**{field: value})


def test_full_qwen2_7b_sizes():
    cfg = get_config("qwen2-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab_size) == \
        (28, 3584, 28, 4, 128, 18944, 152064)
    assert abs(cfg.param_count() / 1e9 - 7.62) < 0.01


@pytest.mark.parametrize("arch", ARCHS)
def test_state_covers_every_parameter(arch):
    _, jp, cfg, model, params = _pair(arch)
    state = params_from_jax(cfg, jp)
    assert set(state) == set(dict(params.named_parameters()))
    n_jax = sum(np.asarray(a).size for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in params.parameters()) == n_jax


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_forward_logits_match_jax(arch, f32):
    jcfg, jp, cfg, model, params = _pair(arch, f32)
    toks = _tokens(cfg, (2, 40))
    want = np.asarray(JT.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                 jcfg.plan)[0], np.float32)
    got = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == getattr(torch, cfg.plan.compute_dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if f32 else \
        dict(atol=0.05 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """Port twin of tests/test_decode_consistency.py, and the decode logits
    also against the JAX forward."""
    jcfg, jp, cfg, model, params = _pair(arch)
    b, s, split = 2, 16, 8
    toks = _tokens(cfg, (b, s))
    full = model.forward(params, {"tokens": torch.from_numpy(toks)})
    cache = model.init_cache(b, s)
    last, cache = model.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :split])}, cache)
    assert float((last - full[:, split - 1]).abs().max()) < 1e-3
    outs = []
    for t in range(split, s):
        lg, cache = model.decode_step(
            params, {"tokens": torch.from_numpy(toks[:, t:t + 1]), "pos": t},
            cache)
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    assert float((dec - full[:, split:]).abs().max()) < 1e-3
    want = np.asarray(JT.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                 jcfg.plan)[0])
    np.testing.assert_allclose(dec.numpy(), want[:, split:], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_pallas_plan_equals_xla_plan_on_cpu(arch):
    """On the CPU the offload plan runs the kernels' plain versions: the
    same numbers as the stock path (prompt longer than attn_chunk, so the
    xla_chunked default takes its chunked branch)."""
    _, _, cfg, model, params = _pair(arch)
    toks = {"tokens": torch.from_numpy(_tokens(cfg, (2, 48)))}
    base = model.forward(params, toks)
    for plan in (cfg.plan.replace(attn_impl="pallas", mlp_impl="pallas"),
                 cfg.plan.replace(attn_impl="xla", mlp_impl="xla")):
        torch.testing.assert_close(model.with_plan(plan).forward(params, toks),
                                   base, atol=1e-5, rtol=1e-5)


def test_int8_kv_cache_decode_matches_jax():
    jcfg, jp, cfg, model, params = _pair("qwen2-7b")
    jcfg, cfg = (dataclasses.replace(c, plan=c.plan.replace(
        kv_cache_dtype="int8")) for c in (jcfg, cfg))
    model = Model(cfg, device="cpu")
    jmodel = JModel(jcfg)
    toks = _tokens(cfg, (2, 12))
    cache, jcache = model.init_cache(2, 12), jmodel.init_cache(2, 12)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :6])},
                             cache)
    _, jcache = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :6])},
                               jcache)
    for t in range(6, 12):
        lg, cache = model.decode_step(
            params, {"tokens": torch.from_numpy(toks[:, t:t + 1]), "pos": t},
            cache)
        jlg, jcache = jmodel.decode_step(
            jp, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                 "pos": jnp.asarray(t, jnp.int32)}, jcache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=1e-4)


def test_init_uses_the_reference_scales():
    cfg = get_config("tiny-test")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    layer = params.layers[0]
    assert abs(float(params.embed.std()) - 0.02) < 0.002
    assert abs(float(layer.mixer["wq"].std()) - cfg.d_model ** -0.5) < 0.02
    assert abs(float(layer.mlp["wo"].std()) - cfg.d_ff ** -0.5) < 0.02
    assert float(params.final_norm["scale"].min()) == 1.0
    again = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert torch.equal(again.lm_head, params.lm_head)


def test_unported_families_raise():
    tiny = get_config("tiny-test")
    for cfg in (dataclasses.replace(tiny, family="ssm"),
                dataclasses.replace(tiny, family="hybrid",
                                    layer_pattern=("rec", "rec", "attn")),
                dataclasses.replace(tiny, family="moe",
                                    moe=MoEConfig(4, 2, 32)),
                dataclasses.replace(tiny, norm="layernorm"),
                dataclasses.replace(tiny, act="gelu")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(cfg, device="cpu")
