"""Arithmetic-intensity analysis + loop census + analytic program estimator.

Counterpart of ``repro.core.intensity``: ``site_census`` is copied op for
op; ``estimate_program`` for prefill and decode, on the port's plans, which
have no tensor parallelism (``tp = 1``).  A train shape raises: training
is ROADMAP.md §A item 5.  ``SiteStats.vmem_working_set`` keeps the
reference's figure (the twin tests hold the census equal); the card's
resource pre-check in ``core.narrowing`` asks the kernels instead.

The paper narrows FPGA offload candidates with (a) arithmetic-intensity
analysis (ROSE), (b) loop counts (gcov/gprof) and (c) resource pre-compiles.
``site_census`` is (a)+(b) for our offloadable sites: per-site FLOPs, HBM
bytes, intensity and invocation counts derived from the architecture math.

``estimate_program`` is the analytic fast path of the verification
environment: given (cfg, shape, plan, mesh) it predicts total FLOPs, HBM
traffic, collective bytes and peak per-chip memory for one step.  The
compiled dry-run is the slow path; §Roofline cross-checks the two.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import math

from repro_torch.configs.base import ArchConfig, PlanConfig, ShapeSpec

BF16 = 2
F32 = 4


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Tokens an expert takes (copy of ``repro.models.layers.moe_capacity``):
    top_k x tokens / experts x the capacity factor, rounded up to 8."""
    m = cfg.moe
    c = int(math.ceil(m.top_k * n_tokens / m.n_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _dt_bytes(name: str) -> int:
    return {"bfloat16": 2, "float32": 4, "float16": 2, "int8": 1}[name]


@dataclass
class SiteStats:
    name: str                 # attn | mlp | moe | ssm | rglru | embed | head
    flops: float              # per step, whole program, forward only
    hbm_bytes: float          # weight+activation traffic, forward only
    count: int                # invocations per step (the "loop count")
    vmem_working_set: int     # bytes needed in VMEM for the natural tile

    @property
    def intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)


def _attn_flops(cfg: ArchConfig, t: int, s_kv: int) -> float:
    """t query tokens attending over s_kv keys, all layers with attention."""
    hq, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    proj = 2.0 * t * d * (hq + 2 * hkv) * dh + 2.0 * t * hq * dh * d
    scores = 2.0 * t * s_kv * hq * dh * 2  # qk^T and pv
    return proj + scores


def site_census(cfg: ArchConfig, shape: ShapeSpec,
                plan: PlanConfig | None = None) -> list[SiteStats]:
    plan = plan or cfg.plan
    cdt = _dt_bytes(plan.compute_dtype)
    d, v = cfg.d_model, cfg.vocab_size
    kinds = cfg.layer_kinds()
    n_attn = sum(1 for k in kinds if k == "attn")
    n_ssm = sum(1 for k in kinds if k == "ssm")
    n_rec = sum(1 for k in kinds if k == "rec")
    n_mlp = n_attn + n_rec if cfg.family in ("hybrid",) else n_attn

    if shape.kind == "decode":
        t = shape.global_batch          # one token per sequence
        s_kv = shape.seq_len
    else:
        t = shape.tokens
        s_kv = shape.seq_len

    sites: list[SiteStats] = []

    # embedding + head (memory-dominated)
    sites.append(SiteStats("embed", 0.0, t * d * cdt + v * d * cdt, 1,
                           256 * d * cdt))
    sites.append(SiteStats("head", 2.0 * t * d * v, (d * v + t * v) * cdt, 1,
                           128 * v // 128 * cdt))

    if n_attn:
        window = cfg.local_window if cfg.family == "hybrid" else 0
        eff_kv = min(window, s_kv) if window else s_kv
        fl = _attn_flops(cfg, t, eff_kv) * n_attn
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        w = (d * (hq + 2 * hkv) * dh + hq * dh * d) * cdt * n_attn
        act = t * (hq + 2 * hkv) * dh * cdt * 2 * n_attn
        scores_traffic = 0.0
        if plan.attn_impl == "xla":      # naive: S^2 scores hit HBM
            scores_traffic = 2.0 * t * eff_kv * hq * F32 * n_attn
        blk = plan.attn_chunk
        vmem = (blk * dh * cdt * 3 + blk * blk * F32)
        sites.append(SiteStats("attn", fl, w + act + scores_traffic,
                               n_attn, vmem))

    if cfg.moe is not None:
        e = cfg.moe
        cap = moe_capacity(cfg, t)
        routed = min(cap * e.n_experts, t * e.top_k)
        fl = (2.0 * t * d * e.n_experts            # router
              + 6.0 * routed * d * e.d_ff_expert) * cfg.n_layers
        w = (3 * d * e.d_ff_expert * e.n_experts + d * e.n_experts) * cdt \
            * cfg.n_layers
        act = (t * d * 2 + routed * d * 2) * cdt * cfg.n_layers
        sites.append(SiteStats("moe", fl, w + act, cfg.n_layers,
                               128 * e.d_ff_expert * cdt * 3))
    elif n_mlp:
        mult = 6.0 if cfg.act == "swiglu" else 4.0
        fl = mult * t * d * cfg.d_ff * n_mlp
        nw = 3 if cfg.act == "swiglu" else 2
        w = nw * d * cfg.d_ff * cdt * n_mlp
        inter = 0.0
        if plan.mlp_impl != "pallas":    # fused kernel keeps h in VMEM
            inter = 2.0 * t * cfg.d_ff * cdt * n_mlp
        sites.append(SiteStats("mlp", fl, w + t * d * cdt * 2 * n_mlp + inter,
                               n_mlp, 128 * cfg.d_ff * cdt * 2))

    if n_ssm:
        di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
        q = cfg.ssm_chunk
        proj = 2.0 * t * d * (2 * di + 2 * n + h) + 2.0 * t * di * d
        conv = 2.0 * cfg.ssm_conv * t * (di + 2 * n)
        if shape.kind == "decode":
            ssd = 4.0 * t * h * p * n                    # recurrent update
        else:
            ssd = t * h * (2.0 * q * (n + p) + 4.0 * p * n)
        fl = (proj + conv + ssd) * n_ssm
        w = (d * (2 * di + 2 * n + h) + di * d) * cdt * n_ssm
        act = t * (2 * di + 2 * n) * cdt * 2 * n_ssm
        sites.append(SiteStats("ssm", fl, w + act, n_ssm,
                               q * (p + 2 * n) * F32 + q * q * F32))

    if n_rec:
        w_lru = cfg.lru_width
        gates = 4.0 * t * w_lru * w_lru
        proj = 2.0 * t * d * w_lru * 3
        scan = 7.0 * t * w_lru
        mlp_fl = (6.0 if cfg.act == "swiglu" else 4.0) * t * d * cfg.d_ff
        fl = (gates + proj + scan) * n_rec
        w = (2 * w_lru * w_lru + 3 * d * w_lru) * cdt * n_rec
        sites.append(SiteStats("rglru", fl, w + t * w_lru * cdt * 4 * n_rec,
                               n_rec, 512 * w_lru * F32))
        del mlp_fl

    return sites


@dataclass
class Estimate:
    """Whole-step analytic estimate (totals across chips)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0          # per-chip ICI payload bytes
    coll_ops: int = 0                # collective launches per step
    peak_mem_per_chip: float = 0.0
    breakdown: dict = field(default_factory=dict)


def estimate_program(cfg: ArchConfig, shape: ShapeSpec, plan: PlanConfig,
                     n_chips: int, tp: int = 1) -> Estimate:
    """Analytic forward roofline inputs for one prefill or decode step.

    ``tp`` is kept for the reference's signature; the port's plans carry
    no tensor parallelism, so it is 1 whatever is passed (the reference
    with ``use_tp=False``)."""
    if shape.kind == "train":
        raise NotImplementedError(
            "train shapes: training is not ported yet (ROADMAP.md, section "
            "A item 5)")
    sites = site_census(cfg, shape, plan)
    fwd_flops = sum(s.flops for s in sites)
    fwd_hbm = sum(s.hbm_bytes for s in sites)
    cdt = _dt_bytes(plan.compute_dtype)
    pdt = _dt_bytes(plan.param_dtype)
    n_params = cfg.param_count()
    d = cfg.d_model
    tp = 1
    dp = max(n_chips // tp, 1)

    est = Estimate()
    est.breakdown = {s.name: s.flops for s in sites}
    est.flops = fwd_flops
    est.hbm_bytes = fwd_hbm
    t_tok = shape.global_batch if shape.kind == "decode" else shape.tokens
    est.coll_bytes = 0.0
    kv = 0.0
    if cfg.n_heads:
        window = cfg.local_window if cfg.family == "hybrid" else 0
        eff = min(window, shape.seq_len) if window else shape.seq_len
        n_attn = sum(1 for k in cfg.layer_kinds() if k == "attn")
        kv = (shape.global_batch * eff * 2 * cfg.n_kv_heads * cfg.d_head
              * _dt_bytes(plan.kv_cache_dtype) * n_attn)
    est.coll_ops = 0
    est.hbm_bytes += kv                                # cache traffic
    est.peak_mem_per_chip = (n_params * pdt / min(n_chips, tp * dp)
                             + kv / n_chips
                             + (t_tok / n_chips) * d * cdt * 4)
    return est
