"""Moonlight-16B-A3B (kimi/moonshot) [moe] — 64 experts, top-6 (copy of
``repro.configs.moonshot_v1_16b_a3b``).

48L d_model=2048 16H (kv=16) d_ff_expert=1408 vocab=163840
[hf:moonshotai/Moonlight-16B-A3B].  Experts shard over the TP axis (EP).
28.1 B parameters: 112 GB in the f32 ``param_dtype``, more than one 80 GB
H100 holds; a card run cuts layers only.
"""
from repro_torch.configs.base import (ArchConfig, MoEConfig, PlanConfig,
                                      register, FULL_ATTENTION_SKIPS)

FULL = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408),
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
    plan=PlanConfig(remat="full", microbatches=8),
)

REDUCED = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=128,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96),
    plan=PlanConfig(remat="none", attn_chunk=32),
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
)

register(FULL, REDUCED)
