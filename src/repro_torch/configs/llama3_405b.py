"""Llama3-405B [dense] — GQA, 128k vocab (copy of
``repro.configs.llama3_405b``).

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256 [arXiv:2407.21783].
The reference trains it on a pod with adafactor, full remat, a
sequence-sharded residual stream and 16-way microbatching; the port keeps
its bf16 params and 512-key attention chunks.
406 B parameters: 812 GB in its bf16 ``param_dtype``; a card run cuts
layers only.
"""
from repro_torch.configs.base import (ArchConfig, PlanConfig, register,
                                      FULL_ATTENTION_SKIPS)

FULL = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    optimizer="adafactor",
    plan=PlanConfig(remat="full", microbatches=16, seq_shard=True,
                    fsdp=True, attn_chunk=512,
                    param_dtype="bfloat16", accum_dtype="bfloat16"),
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
)

REDUCED = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=128,
    optimizer="adafactor",
    plan=PlanConfig(remat="none", attn_chunk=32, microbatches=2),
    skip_shapes=dict(FULL_ATTENTION_SKIPS),
)

register(FULL, REDUCED)
