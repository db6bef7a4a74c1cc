"""RecurrentGemma-9B [hybrid] — RG-LRU + local attention, 2:1 pattern
(copy of ``repro.configs.recurrentgemma_9b``).

38L d_model=4096 16H (kv=1, head dim 256) d_ff=12288 (GELU MLP)
vocab=256000 [arXiv:2402.19427].  Layer pattern (rec, rec, attn) x 12 +
(rec, rec) tail = 38 layers; local attention window 2048; RG-LRU width
4096.  8.53 B parameters: 34.1 GB in the f32 ``param_dtype``.
"""
from repro_torch.configs.base import ArchConfig, PlanConfig, register

FULL = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    act="gelu",
    layer_pattern=("rec", "rec", "attn"),
    local_window=2048,
    lru_width=4096,
    plan=PlanConfig(remat="full", microbatches=4),
)

REDUCED = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=5,          # (rec, rec, attn) + (rec, rec) tail
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=160,
    vocab_size=128,
    act="gelu",
    layer_pattern=("rec", "rec", "attn"),
    local_window=32,
    lru_width=64,
    plan=PlanConfig(remat="none", attn_chunk=32),
)

register(FULL, REDUCED)
