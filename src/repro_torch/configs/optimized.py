"""Optimized plans per (arch, shape-kind) (counterpart of
``repro.configs.optimized``, copied op for op).

The reference derived them on its pod (a 256-chip mesh) from hillclimbed
cells and re-lowered each one:

  * small archs whose bf16 weights fit one chip -> pure DP (use_tp=False):
    no per-layer TP collectives;
  * everything -> async collective overlap (+int8 EF gradient wire for
    trains);
  * decode cells -> int8 KV cache;
  * qwen2-7b's train -> remat off under pure DP.

Its memory gate for use_tp=False (params + ZeRO'd states + stash within
one chip) admits the <=7B-ish dense/MoE/SSM archs (qwen2-7b, mamba2-1.3b,
granite-moe-1b, hubert-xlarge); 12B-and-up keep TP.  On one H100 only the
non-sharding genes change the computation: the decode plans' int8 KV
cache, and the train plans' int8 EF gradients and remat.
"""
from __future__ import annotations

from repro_torch.configs.base import PlanConfig, get_config

# archs whose bf16 weights (+states) fit a single chip AND whose train step
# tolerates losing the model axis.  MoE trains are excluded: without EP the
# (experts, capacity, d) dispatch buffer un-shards and its scatter becomes
# a full-buffer all-reduce; MoE decode is fine (tiny buffers).
_PURE_DP = {"qwen2-7b", "mamba2-1.3b", "hubert-xlarge"}
_PURE_DP_DECODE = {"granite-moe-1b-a400m", "mamba2-1.3b"}


def optimized_plan(arch: str, kind: str) -> PlanConfig:
    """Best-known plan for (arch, shape-kind); baseline plan + tuned genes."""
    cfg = get_config(arch)
    plan = cfg.plan.replace(overlap_collectives=True)
    if kind == "train":
        plan = plan.replace(grad_compress="int8_ef", fused_grad_reduce=True)
        if arch in _PURE_DP:
            plan = plan.replace(use_tp=False, microbatches=1, fsdp=True)
        if arch == "qwen2-7b":
            # the reference GA's pick — remat off fits under pure DP
            plan = plan.replace(remat="none", attn_chunk=2048, fsdp=False)
    elif kind in ("prefill", "decode"):
        if cfg.n_heads and cfg.n_kv_heads:
            plan = plan.replace(kv_cache_dtype="int8")
        if kind == "decode" and arch in _PURE_DP_DECODE:
            # tiny models: even the replicated weight read is cheap
            plan = plan.replace(use_tp=False)
    return plan
