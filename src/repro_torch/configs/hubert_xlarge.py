"""HuBERT-XLarge [audio] — encoder-only, w2v2 architecture (copy of
``repro.configs.hubert_xlarge``).

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 [arXiv:2106.07447].
Frontend (CNN feature extractor) is a stub: ``input_specs`` provides
precomputed frame embeddings.  Encoder-only => no decode shapes.
0.96 B parameters: 3.8 GB in the f32 ``param_dtype``, which one 80 GB
H100 holds whole.
"""
from repro_torch.configs.base import (ArchConfig, PlanConfig, register,
                                      ENCODER_SKIPS, FULL_ATTENTION_SKIPS)

FULL = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    act="gelu",
    norm="layernorm",
    is_encoder=True,
    frontend="audio_frames",
    skip_shapes={**ENCODER_SKIPS, **FULL_ATTENTION_SKIPS},
    plan=PlanConfig(remat="full", microbatches=2),
)

REDUCED = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=64,
    act="gelu",
    norm="layernorm",
    is_encoder=True,
    frontend="audio_frames",
    plan=PlanConfig(remat="none", attn_chunk=32),
    skip_shapes={**ENCODER_SKIPS, **FULL_ATTENTION_SKIPS},
)

register(FULL, REDUCED)
