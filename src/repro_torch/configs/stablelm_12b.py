"""StableLM-2-12B [dense] (copy of
``repro.configs.stablelm_12b``).

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352
[hf:stabilityai/stablelm-2-12b].
12.1 B parameters: 48.6 GB in the f32 ``param_dtype``, which one 80 GB
H100 holds whole.
"""
from repro_torch.configs.base import (ArchConfig, PlanConfig, register,
                                      FULL_ATTENTION_SKIPS)

FULL = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
    plan=PlanConfig(remat="full", microbatches=4),
)

REDUCED = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=128,
    plan=PlanConfig(remat="none", attn_chunk=32),
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
)

register(FULL, REDUCED)
