"""Qwen2-7B [dense] — GQA with QKV bias (copy of ``repro.configs.qwen2_7b``).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 [arXiv:2407.10671; hf].
7.62 B parameters: 30.5 GB in the f32 ``param_dtype``, which one 80 GB H100
holds whole.
"""
from repro_torch.configs.base import (ArchConfig, PlanConfig, register,
                                      FULL_ATTENTION_SKIPS)

FULL = ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
)

REDUCED = ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=128,
    qkv_bias=True,
    plan=PlanConfig(attn_chunk=32),
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
)

register(FULL, REDUCED)
