"""Tiny configs for examples/tests (copy of ``repro.configs.tiny``).

``tiny-lm`` — a ~100M-class dense model for the end-to-end training example.
``tiny-test`` — minimal model for fast unit tests.
"""
from repro_torch.configs.base import (ArchConfig, PlanConfig, register,
                                      FULL_ATTENTION_SKIPS)

TINY_LM = ArchConfig(
    name="tiny-lm",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab_size=32000,
    plan=PlanConfig(remat="none", attn_chunk=256),
    learning_rate=6e-4,
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
)

TINY_LM_FAST = ArchConfig(
    name="tiny-lm-fast",
    family="dense",
    n_layers=6,
    d_model=384,
    n_heads=6,
    n_kv_heads=2,
    d_ff=1024,
    vocab_size=8192,
    plan=PlanConfig(remat="none", attn_chunk=128),
    learning_rate=1e-3,
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
)

TINY_TEST = ArchConfig(
    name="tiny-test",
    family="dense",
    n_layers=2,
    d_model=32,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=64,
    plan=PlanConfig(remat="none", attn_chunk=16),
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
)

register(TINY_LM, TINY_LM)
register(TINY_LM_FAST, TINY_LM_FAST)
register(TINY_TEST, TINY_TEST)
