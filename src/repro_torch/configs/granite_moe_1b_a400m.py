"""Granite-3.0-1B-A400M [moe] — 32 experts, top-8 (copy of
``repro.configs.granite_moe_1b_a400m``).

24L d_model=1024 16H (GQA kv=8) d_ff_expert=512 vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base].
1.38 B parameters (24 layers of 32 experts): 5.5 GB in the f32
``param_dtype``, which one 80 GB H100 holds whole.
"""
from repro_torch.configs.base import (ArchConfig, MoEConfig, PlanConfig,
                                      register, FULL_ATTENTION_SKIPS)

FULL = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
    plan=PlanConfig(remat="full", microbatches=4),
)

REDUCED = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=128,
    moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=96),
    plan=PlanConfig(remat="none", attn_chunk=32),
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
)

register(FULL, REDUCED)
