"""InternVL2-76B [vlm] — InternViT + InternLM2 backbone (copy of
``repro.configs.internvl2_76b``).

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 [arXiv:2404.16821].
The vision tower is a stub: ``input_specs`` provides precomputed patch
embeddings that overwrite the first ``n_patches`` token positions.
70.6 B parameters in the backbone: 282 GB in the f32 ``param_dtype``;
a card run cuts layers only.
"""
from repro_torch.configs.base import (ArchConfig, PlanConfig, register,
                                      FULL_ATTENTION_SKIPS)

FULL = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    n_patches=256,
    optimizer="adafactor",
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
    plan=PlanConfig(remat="full", microbatches=8),
)

REDUCED = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=128,
    frontend="vision_patches",
    n_patches=8,
    plan=PlanConfig(remat="none", attn_chunk=32),
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
)

register(FULL, REDUCED)
