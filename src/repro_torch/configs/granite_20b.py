"""Granite-20B (code) [dense] — llama-arch with MQA (kv=1) (copy of
``repro.configs.granite_20b``).

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152 [arXiv:2405.04324; hf].
kv=1 => KV is replicated along TP; the q-per-kv group axis (48) carries TP.
20.3 B parameters: 81.3 GB in the f32 ``param_dtype``, more than one
80 GB H100 holds with room to run; a card run cuts layers only.
"""
from repro_torch.configs.base import (ArchConfig, PlanConfig, register,
                                      FULL_ATTENTION_SKIPS)

FULL = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",
    norm="layernorm",
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
    plan=PlanConfig(remat="full", microbatches=8),
)

REDUCED = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=1,
    d_ff=160,
    vocab_size=128,
    act="gelu",
    norm="layernorm",
    plan=PlanConfig(remat="none", attn_chunk=32),
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
)

register(FULL, REDUCED)
