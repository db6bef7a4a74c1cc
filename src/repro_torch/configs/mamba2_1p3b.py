"""Mamba2-1.3B [ssm] — SSD, attention-free (copy of
``repro.configs.mamba2_1p3b``).

48L d_model=2048 d_inner=4096 64 heads of 64, state N=128, conv 4, chunk
256, vocab=50280, tied embeddings [arXiv:2405.21060].  1.34 B parameters:
5.4 GB in the f32 ``param_dtype``.  The plan has no attention sites; the
'pallas' destination of ``ssm_impl`` is the SSD kernel.
"""
from repro_torch.configs.base import ArchConfig, PlanConfig, register

FULL = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    plan=PlanConfig(remat="full", microbatches=4),
)

REDUCED = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=128,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_conv=4,
    ssm_chunk=16,
    tie_embeddings=True,
    plan=PlanConfig(remat="none"),
)

register(FULL, REDUCED)
