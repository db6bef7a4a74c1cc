"""The port's model against ``repro.models`` with weights carried by
``repro_torch.convert.params_from_jax``.

Tolerances: f32 compute, 1e-4 on the logits (sums taken in another order);
bf16 compute, 5% of the largest logit — bf16 keeps 8 bits (2^-8 = 0.4%), the
two frameworks round at different places and the differences compound
through the layers (measured: 1.3-1.7% on qwen2-7b and recurrentgemma-9b).
Reduced mamba2-1.3b amplifies last-bit differences far more: the
reference's own bf16 logits lie 11-35% of max|logit| from its f32 logits
(weight seeds 0-5), so there the port's bf16 logits are held to that gap,
measured in the test (and each bf16 layer, given the same input, to
2^-6 in tests/test_torch_ssm.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import list_archs as jlist_archs
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro_torch.configs import MoEConfig, get_config, list_archs
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as T
from repro_torch.models.model import Model

ARCHS = ["tiny-test", "qwen2-7b", "mamba2-1.3b", "recurrentgemma-9b"]
#: archs whose reference bf16 logits lie further than 5% from its own f32
#: logits (module docstring)
BF16_SENSITIVE = {"mamba2-1.3b"}
#: every compute site on its kernel (the plain versions on the CPU)
OFFLOAD = dict(attn_impl="pallas", mlp_impl="pallas", ssm_impl="pallas",
               rglru_impl="pallas")


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


def _logit_tol(arch, f32, jcfg, jp, toks, want):
    if f32:
        return dict(atol=1e-4, rtol=1e-4)
    atol = 0.05 * np.abs(want).max()
    if arch in BF16_SENSITIVE:
        jf = dataclasses.replace(jcfg, plan=jcfg.plan.replace(
            compute_dtype="float32"))
        ref32 = np.asarray(JT.forward(jp, {"tokens": jnp.asarray(toks)}, jf,
                                      jf.plan)[0])
        atol = max(atol, float(np.abs(want - ref32).max()))
    return dict(atol=atol, rtol=0)


def test_registry_holds_the_ported_archs():
    """Every arch of the reference, with its published and reduced
    configs."""
    assert list_archs() == jlist_archs() == [
        "granite-20b", "granite-moe-1b-a400m", "hubert-xlarge",
        "internvl2-76b", "llama3-405b", "mamba2-1.3b", "moonshot-v1-16b-a3b",
        "qwen2-7b", "recurrentgemma-9b", "stablelm-12b", "tiny-lm",
        "tiny-lm-fast", "tiny-test"]
    for name in list_archs():
        for reduced in (False, True):
            got = dataclasses.asdict(get_config(name, reduced))
            want = dataclasses.asdict(jget(name, reduced))
            # the port's plan holds the reference plan's fields it reads
            plan, jplan = got.pop("plan"), want.pop("plan")
            assert got == want
            assert plan == {k: jplan[k] for k in plan}


@pytest.mark.parametrize("field,value", [("attn_impl", "cuda"),
                                         ("mlp_impl", "xla_chunked"),
                                         ("ssm_impl", "triton"),
                                         ("rglru_impl", "xla_chunked")])
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


def test_full_mamba2_and_recurrentgemma_sizes():
    m = get_config("mamba2-1.3b")
    assert (m.n_layers, m.d_model, m.d_inner, m.ssm_nheads, m.ssm_headdim,
            m.ssm_state, m.ssm_conv, m.ssm_chunk, m.vocab_size,
            m.tie_embeddings) == (48, 2048, 4096, 64, 64, 128, 4, 256,
                                  50280, True)
    assert abs(m.param_count() / 1e9 - 1.34) < 0.01
    r = get_config("recurrentgemma-9b")
    assert (r.n_layers, r.d_model, r.n_heads, r.n_kv_heads, r.d_head,
            r.d_ff, r.act, r.local_window, r.lru_width, r.vocab_size) == \
        (38, 4096, 16, 1, 256, 12288, "gelu", 2048, 4096, 256000)
    kinds = r.layer_kinds()
    assert kinds == ["rec", "rec", "attn"] * 12 + ["rec", "rec"]
    assert abs(r.param_count() / 1e9 - 8.53) < 0.01
    for cfg in (m, r):      # the reference's pytree, leaf for leaf
        shapes = jax.eval_shape(JModel(jget(cfg.name)).init,
                                jax.random.PRNGKey(0))
        weights = T.Transformer(cfg, torch.device("meta"))
        assert sum(p.numel() for p in weights.parameters()) == \
            sum(a.size for a in jax.tree.leaves(shapes))


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
    np.testing.assert_allclose(got.float().numpy(), want,
                               **_logit_tol(arch, f32, jcfg, jp, toks, want))


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
    for plan in (cfg.plan.replace(**OFFLOAD),
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
    """The MoE, LayerNorm and front-end variants of the stacks build and
    run; what still raises is a norm, activation or front end the
    reference does not define."""
    tiny = get_config("tiny-test")
    hybrid = get_config("recurrentgemma-9b", reduced=True)
    for cfg in (dataclasses.replace(tiny, act="relu"),
                dataclasses.replace(tiny, norm="batchnorm"),
                dataclasses.replace(hybrid, frontend="video_frames")):
        with pytest.raises(NotImplementedError, match="reference defines"):
            Model(cfg, device="cpu")
    toks = {"tokens": torch.zeros((1, 6), dtype=torch.int32)}
    for cfg in (dataclasses.replace(tiny, family="moe",
                                    moe=MoEConfig(4, 2, 32)),
                dataclasses.replace(tiny, norm="layernorm"),
                dataclasses.replace(hybrid, norm="layernorm"),
                dataclasses.replace(get_config("mamba2-1.3b", reduced=True),
                                    norm="layernorm"),
                dataclasses.replace(hybrid, frontend="vision_patches"),
                dataclasses.replace(tiny, family="ssm", ssm_state=8,
                                    ssm_headdim=16),
                dataclasses.replace(tiny, family="hybrid",
                                    layer_pattern=("rec", "rec", "attn"),
                                    lru_width=32, local_window=8),
                dataclasses.replace(tiny, act="gelu")):
        model = Model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        logits = model.forward(params, toks)
        assert logits.shape == (1, 6, cfg.vocab_size)
        assert bool(torch.isfinite(logits.float()).all())
    frames = dataclasses.replace(tiny, frontend="audio_frames",
                                 is_encoder=True)
    model = Model(frames, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert params.frontend.shape == (tiny.d_model, tiny.d_model)
    logits = model.forward(params, {"features": torch.randn(
        (1, 6, tiny.d_model), generator=torch.Generator().manual_seed(1))})
    assert logits.shape == (1, 6, tiny.vocab_size)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_offload_plan_logits_match_jax(arch, f32):
    """Both packages on the offload plan: the JAX kernels in interpret mode
    (SSD at chunk _blk(40, 16) = 10; RG-LRU and flash attention over the
    40 tokens), the port's plain versions."""
    jcfg, jp, cfg, _, _ = _pair(arch, f32)
    jcfg = dataclasses.replace(jcfg, plan=jcfg.plan.replace(**OFFLOAD))
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(**OFFLOAD))
    model = Model(cfg, device="cpu")
    params = model.load(params_from_jax(cfg, jp))
    toks = _tokens(cfg, (2, 40))
    want = np.asarray(JT.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                 jcfg.plan)[0], np.float32)
    got = model.forward(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.float().numpy(), want,
                               **_logit_tol(arch, f32, jcfg, jp, toks, want))


def test_sliding_window_cache_rolls():
    """Port twin of tests/test_decode_consistency.py: recurrentgemma decode
    from an empty cache past a window of 8 (an 8-slot KV cache) matches the
    full forward, and the JAX forward."""
    jcfg, jp, cfg, _, _ = _pair("recurrentgemma-9b")
    jcfg, cfg = (dataclasses.replace(c, local_window=8) for c in (jcfg, cfg))
    model = Model(cfg, device="cpu")
    params = model.load(params_from_jax(cfg, jp))
    toks = _tokens(cfg, (1, 24), seed=3)
    full = model.forward(params, {"tokens": torch.from_numpy(toks)})
    cache = model.init_cache(1, 24)
    assert all(c["k"].shape[1] == 8 for c in cache if "k" in c)
    outs = []
    for t in range(24):
        lg, cache = model.decode_step(
            params, {"tokens": torch.from_numpy(toks[:, t:t + 1]), "pos": t},
            cache)
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    assert float((dec[:, 1:] - full[:, 1:]).abs().max()) < 1e-3
    want = np.asarray(JT.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                 jcfg.plan)[0])
    np.testing.assert_allclose(dec.numpy(), want, atol=1e-4, rtol=1e-4)


def test_layer_order_matches_the_reference_stack():
    """Unit-major, then the tail: the port's layer i is the reference's
    scan unit i // 3, layer i % 3, for the first 36 of 38 layers."""
    jcfg, jp, cfg, _, params = _pair("recurrentgemma-9b")
    unit, n_full, tail = JT.unit_structure(jcfg)
    assert (unit, n_full, tail) == (("rec", "rec", "attn"), 1,
                                    ("rec", "rec"))
    assert [layer.kind for layer in params.layers] == \
        list(unit) * n_full + list(tail)
    np.testing.assert_array_equal(
        params.layers[2].mixer["wq"].numpy(), jp["scan"]["l2"]["mixer"]
        ["wq"][0])
    np.testing.assert_array_equal(
        params.layers[4].mixer["lam"].numpy(), jp["tail"]["t1"]["mixer"]
        ["lam"])
