"""The seven archs of the MoE / LayerNorm / front-end slice against the
JAX package, at their reduced configs with weights carried by
``repro_torch.convert.params_from_jax``.

Mirrors ``tests/test_smoke_archs.py`` (published sizes, forward shapes)
and ``tests/test_decode_consistency.py`` (prefill + decode against the
teacher-forced forward in f32, MoE at capacity factor 16: token-choice
capacity is not causal, so with drops a prefill and a longer forward route
differently, legitimately).  Tolerances: f32 logits within 1e-4 of the
reference's (sums in another order); bf16 within 5% of the largest logit,
the rule of ``tests/test_torch_model.py`` (the two frameworks round at
different places and the differences compound through the layers).  As
there, an arch whose reference bf16 logits lie further than that from its
own f32 logits is held to that gap, measured in the test: the MoE archs,
where one bf16 rounding of a router logit flips an expert (the reference's
own bf16 logits lie 9-20% of max|logit| from its f32 logits on these
weights; ``run_moe`` itself, given the same input, is held to 2^-6 in
``tests/test_torch_moe.py``).  LayerNorm within 1e-6.  The audio arch
takes frames (``features``), the vision arch token ids with patch
embeddings over its first ``n_patches`` positions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro_torch.configs import MoEConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import Model

ARCHS = ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b", "granite-20b",
         "stablelm-12b", "llama3-405b", "hubert-xlarge", "internvl2-76b"]
#: every arch but the encoder decodes
DECODABLE = [a for a in ARCHS if a != "hubert-xlarge"]
OFFLOAD = dict(attn_impl="pallas", mlp_impl="pallas")
#: archs whose reference bf16 logits lie further than 5% from its own f32
#: logits (module docstring)
BF16_SENSITIVE = {"granite-moe-1b-a400m", "moonshot-v1-16b-a3b"}


def _f32(cfg, moe_factor=None):
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(
        compute_dtype="float32", kv_cache_dtype="float32"))
    if moe_factor is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=MoEConfig(
            cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
            capacity_factor=moe_factor))
    return cfg


def _pair(arch, f32=True, moe_factor=None, plan=None, seed=0):
    """(JAX cfg, JAX params as numpy, port cfg, port Model, port params)."""
    jcfg, cfg = jget(arch, reduced=True), get_config(arch, reduced=True)
    if f32:
        jcfg, cfg = _f32(jcfg, moe_factor), _f32(cfg, moe_factor)
    if plan:
        jcfg, cfg = (dataclasses.replace(c, plan=c.plan.replace(**plan))
                     for c in (jcfg, cfg))
    jp = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(seed)))
    model = Model(cfg, device="cpu")
    return jcfg, jp, cfg, model, model.load(params_from_jax(cfg, jp))


def _batch(cfg, b=2, s=40, seed=1):
    """(JAX batch, port batch) from one numpy draw: frames for audio,
    token ids (+ patch embeddings for vision) otherwise."""
    rng = np.random.default_rng(seed)
    arrs = {}
    if cfg.frontend == "audio_frames":
        arrs["features"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        arrs["tokens"] = rng.integers(0, cfg.vocab_size,
                                      (b, s)).astype(np.int32)
    if cfg.frontend == "vision_patches":
        arrs["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


def _ref_logits(jp, jbatch, jcfg):
    return np.asarray(JT.forward(jp, jbatch, jcfg, jcfg.plan)[0], np.float32)


def _logit_tol(arch, f32, jcfg, jp, jbatch, want):
    if f32:
        return dict(atol=1e-4, rtol=1e-4)
    atol = 0.05 * np.abs(want).max()
    if arch in BF16_SENSITIVE:
        jf = dataclasses.replace(jcfg, plan=jcfg.plan.replace(
            compute_dtype="float32"))
        atol = max(atol, float(np.abs(want - _ref_logits(jp, jbatch,
                                                         jf)).max()))
    return dict(atol=atol, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_registered(arch):
    """The published numbers (``tests/test_smoke_archs.py``' table) and
    the head dims the kernels see."""
    table = {
        "hubert-xlarge": (48, 1280, 16, 16, 5120, 504, 80),
        "internvl2-76b": (80, 8192, 64, 8, 28672, 128256, 128),
        "granite-20b": (52, 6144, 48, 1, 24576, 49152, 128),
        "llama3-405b": (126, 16384, 128, 8, 53248, 128256, 128),
        "stablelm-12b": (40, 5120, 32, 8, 13824, 100352, 160),
        "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 1408, 163840, 128),
        "granite-moe-1b-a400m": (24, 1024, 16, 8, 512, 49155, 64),
    }
    cfg = get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.d_head) == table[arch]
    assert cfg.param_count() == jget(arch).param_count()
    assert cfg.applicable_shapes() == jget(arch).applicable_shapes()


def test_moe_configs_and_param_counts():
    m1 = get_config("moonshot-v1-16b-a3b").moe
    assert (m1.n_experts, m1.top_k, m1.d_ff_expert) == (64, 6, 1408)
    m2 = get_config("granite-moe-1b-a400m").moe
    assert (m2.n_experts, m2.top_k, m2.d_ff_expert) == (32, 8, 512)
    assert 3.8e11 < get_config("llama3-405b").param_count() < 4.3e11
    assert get_config("llama3-405b").plan.param_dtype == "bfloat16"
    assert get_config("llama3-405b").plan.attn_chunk == 512
    cfg = get_config("moonshot-v1-16b-a3b")
    assert 1.0e10 < cfg.param_count() < 3.2e10
    assert 2.5e9 < cfg.active_param_count() < 5.5e9
    assert "decode_32k" not in get_config("hubert-xlarge").applicable_shapes()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_weights_match_the_reference_pytree(arch):
    """At published width (no memory: the meta device), leaf for leaf."""
    shapes = jax.eval_shape(JModel(jget(arch)).init, jax.random.PRNGKey(0))
    weights = T.Transformer(get_config(arch), torch.device("meta"))
    assert sum(p.numel() for p in weights.parameters()) == \
        sum(a.size for a in jax.tree.leaves(shapes))
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        get_config(arch).plan.param_dtype]
    assert {p.dtype for p in weights.parameters()} == {dt}


@pytest.mark.parametrize("arch", ARCHS)
def test_state_covers_every_parameter(arch):
    _, jp, cfg, model, params = _pair(arch)
    state = params_from_jax(cfg, jp)
    assert set(state) == set(dict(params.named_parameters()))
    n_jax = sum(np.asarray(a).size for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in params.parameters()) == n_jax
    layer = params.layers[0]
    if cfg.moe is not None:
        assert hasattr(layer, "moe") and not hasattr(layer, "mlp")
        np.testing.assert_array_equal(
            layer.moe["wo"].numpy(), jp["scan"]["l0"]["moe"]["wo"][0])
    if cfg.norm == "layernorm":
        assert set(layer.norm2) == {"scale", "bias"}
        assert set(params.final_norm) == {"scale", "bias"}
    if cfg.frontend == "audio_frames":
        np.testing.assert_array_equal(params.frontend.numpy(),
                                      jp["frontend"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_forward_logits_match_jax(arch, f32):
    jcfg, jp, cfg, model, params = _pair(arch, f32)
    jbatch, batch = _batch(cfg)
    want = _ref_logits(jp, jbatch, jcfg)
    got = model.forward(params, batch)
    assert got.shape == (2, 40, cfg.vocab_size)
    assert got.dtype == getattr(torch, cfg.plan.compute_dtype)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **_logit_tol(arch, f32, jcfg, jp, jbatch,
                                            want))


@pytest.mark.parametrize("arch", DECODABLE)
def test_prefill_then_decode_matches_forward(arch):
    """Port twin of tests/test_decode_consistency.py (f32, MoE at capacity
    factor 16), and the decode logits also against the JAX forward."""
    jcfg, jp, cfg, model, params = _pair(arch, moe_factor=16.0)
    b, s, split = 2, 16, 8
    if cfg.frontend == "vision_patches":
        split = cfg.n_patches + 2       # the prompt holds every patch
        s = split + 8
    jbatch, batch = _batch(cfg, b, s)
    full = model.forward(params, batch)
    cache = model.init_cache(b, s)
    pb = dict(batch, tokens=batch["tokens"][:, :split])
    last, cache = model.prefill(params, pb, cache)
    assert float((last - full[:, split - 1]).abs().max()) < 1e-3
    outs = []
    for t in range(split, s):
        lg, cache = model.decode_step(
            params, {"tokens": batch["tokens"][:, t:t + 1], "pos": t}, cache)
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    assert float((dec - full[:, split:]).abs().max()) < 1e-3
    want = _ref_logits(jp, jbatch, jcfg)
    np.testing.assert_allclose(dec.numpy(), want[:, split:], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_offload_plan_logits_match_jax(arch):
    """Both packages on the offload plan, f32: the JAX flash attention
    (and swiglu) kernels in interpret mode, the port's plain versions;
    the MoE experts and the GELU MLP run stock ops on both sides."""
    jcfg, jp, cfg, model, params = _pair(arch, plan=OFFLOAD)
    jbatch, batch = _batch(cfg)
    want = _ref_logits(jp, jbatch, jcfg)
    np.testing.assert_allclose(model.forward(params, batch).numpy(), want,
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_pallas_plan_equals_xla_plan_on_cpu(arch):
    """On the CPU the offload plan runs the kernels' plain versions: the
    same numbers as the stock paths (48 positions, past attn_chunk)."""
    _, _, cfg, model, params = _pair(arch)
    _, batch = _batch(cfg, 2, 48)
    base = model.forward(params, batch)
    for plan in (cfg.plan.replace(**OFFLOAD),
                 cfg.plan.replace(attn_impl="xla", mlp_impl="xla")):
        torch.testing.assert_close(model.with_plan(plan).forward(params,
                                                                 batch),
                                   base, atol=1e-5, rtol=1e-5)


def test_layernorm_matches_the_reference():
    jcfg, cfg = jget("granite-20b", True), get_config("granite-20b", True)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, cfg.d_model)) * 3 + 1.5).astype(
        np.float32)
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32),
         "bias": rng.standard_normal(cfg.d_model).astype(np.float32)}
    want = np.asarray(JL.apply_norm(p, jnp.asarray(x), jcfg))
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # zero mean, unit population variance before the scale and bias
    unit = L.apply_norm({"scale": torch.ones(cfg.d_model),
                         "bias": torch.zeros(cfg.d_model)},
                        torch.from_numpy(x), cfg)
    torch.testing.assert_close(unit.mean(-1), torch.zeros(3, 7), atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(unit.var(-1, correction=0),
                               torch.ones(3, 7), atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-76b"])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_embed_inputs_match_the_reference(arch, f32):
    """Audio: the frames through ``frontend`` (no embedding gather);
    vision: the patch embeddings over the first ``n_patches`` positions,
    token embeddings after them."""
    jcfg, jp, cfg, _, params = _pair(arch, f32)
    jbatch, batch = _batch(cfg, 2, 12)
    want = np.asarray(JT.embed_inputs(jp, jbatch, jcfg, jcfg.plan),
                      np.float32)
    got = T.embed_inputs(params, batch, cfg, cfg.plan)
    assert got.dtype == getattr(torch, cfg.plan.compute_dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    if cfg.frontend == "vision_patches":
        n = cfg.n_patches
        torch.testing.assert_close(
            got[:, :n], batch["patch_embeds"].to(got.dtype))
        torch.testing.assert_close(
            got[:, n:], params.embed[batch["tokens"][:, n:]].to(got.dtype))


def test_vision_prompt_shorter_than_its_patches_raises():
    _, _, cfg, model, params = _pair("internvl2-76b")
    _, batch = _batch(cfg, 2, cfg.n_patches - 1)
    with pytest.raises(ValueError, match="patch embeddings"):
        model.forward(params, batch)
    # without patch embeddings the vision arch embeds tokens only
    del batch["patch_embeds"]
    assert model.forward(params, batch).shape[1] == cfg.n_patches - 1


def test_encoder_attends_both_ways():
    """hubert-xlarge is bidirectional: a change in the last frame moves
    the first position's logits; in a decoder it cannot."""
    for arch, moves in (("hubert-xlarge", True), ("stablelm-12b", False)):
        _, _, cfg, model, params = _pair(arch)
        _, batch = _batch(cfg, 1, 24)
        base = model.forward(params, batch)
        key = "features" if cfg.frontend == "audio_frames" else "tokens"
        other = batch[key].clone()
        other[:, -1] = (other[:, -1] + 1) if key == "tokens" \
            else -other[:, -1]
        moved = model.forward(params, dict(batch, **{key: other}))
        delta = float((moved[:, 0] - base[:, 0]).abs().max())
        assert (delta > 1e-3) if moves else (delta == 0.0)
