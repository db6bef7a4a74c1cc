"""Candidate narrowing (paper §3.2), on the card.

Counterpart of ``repro.core.narrowing``.  Measuring a kernel-offload
pattern on the card is the expensive trial — the analogue of the
hours-long FPGA place-and-route.  So, before measuring anything, narrow
the offload candidates the way the paper does:

  1. arithmetic-intensity analysis (ROSE)       -> SiteStats.intensity
  2. loop counts / profiling (gcov, gprof)      -> SiteStats.count, flops share
  3. resource pre-check (FF/LUT mid-compile)    -> the site's kernel fits a block
  4. keep the top-k patterns, measure them, then
  5. combine the best singles and re-measure (paper's second round).

Steps 1, 2, 4 and 5 are the reference's.  Step 3 is the card's own: the
reference tests a TPU VMEM working set against 16 MiB, a figure that means
nothing here (at ``attn_chunk`` 256 the census' attention working set is
already ~458 KB, above the 227 KB of shared memory a Hopper block may
have, so a literal port would reject every kernel that runs).  Instead
each kernel wrapper reports the dynamic shared memory its launcher
requests at the site's shape and dtype (``smem_bytes``), held against the
card's opt-in maximum a block (``SharedMemoryFit``).  The pre-check is a
parameter (``fits``): any callable of (site, cfg, shape, plan) that
returns a rejection reason or None.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig, PlanConfig, ShapeSpec
from repro_torch.core.intensity import SiteStats, site_census
from repro_torch.kernels import flash_attention, rglru, ssd, swiglu
from repro_torch.kernels.ops import _blk as ssd_chunk
from repro_torch.models.layers import dtype_of

#: an H100's opt-in shared memory a block (227 KB), the limit where no
#: CUDA device is visible
SMEM_OPTIN_BYTES = 232448
MIN_FLOPS_SHARE = 0.01           # "loop statements with a large number of loops"
MIN_INTENSITY = 8.0              # below this the site is bandwidth-bound anyway

#: site -> the plan gene that offloads it to its kernel (the 'pallas'
#: destination)
SITE_GENE = {"attn": "attn_impl", "mlp": "mlp_impl", "ssm": "ssm_impl",
             "rglru": "rglru_impl"}

#: a resource pre-check: (site, cfg, shape, plan) -> rejection reason or None
Fits = Callable[[SiteStats, ArchConfig, ShapeSpec, PlanConfig],
                Optional[str]]


@dataclass
class Candidate:
    name: str                          # e.g. 'attn', 'attn+mlp'
    overrides: dict                    # plan gene overrides
    rationale: dict = field(default_factory=dict)


@dataclass
class NarrowingReport:
    considered: list = field(default_factory=list)    # all sites w/ stats
    rejected: list = field(default_factory=list)      # (site, reason)
    candidates: list = field(default_factory=list)    # surviving Candidates

    def funnel(self) -> str:
        return (f"{len(self.considered)} sites -> "
                f"{len(self.candidates)} measurement patterns "
                f"({len(self.rejected)} rejected by static analysis)")


def site_smem_bytes(site: str, cfg: ArchConfig, shape: ShapeSpec,
                    plan: PlanConfig) -> int:
    """The dynamic shared memory the site's kernel launcher requests at the
    shape and compute dtype the site gives it."""
    dt = dtype_of(plan.compute_dtype)
    if site == "attn":
        return flash_attention.smem_bytes(cfg.d_head, dt)
    if site == "mlp":
        t = shape.global_batch if shape.kind == "decode" else shape.tokens
        return swiglu.smem_bytes(t, cfg.d_model, cfg.d_ff, dt)
    if site == "ssm":
        return ssd.smem_bytes(cfg.ssm_headdim, cfg.ssm_state,
                              ssd_chunk(shape.seq_len, cfg.ssm_chunk), dt)
    if site == "rglru":
        return rglru.smem_bytes()
    raise KeyError(f"no kernel for site {site!r}")


@dataclass(frozen=True)
class SharedMemoryFit:
    """The card's resource pre-check: the site kernel's shared memory a
    block against ``limit``, the opt-in maximum a block may have."""
    limit: int = SMEM_OPTIN_BYTES

    @classmethod
    def for_device(cls, device=None) -> "SharedMemoryFit":
        """The limit of a CUDA device (the current one for None when a card
        is visible); ``SMEM_OPTIN_BYTES`` on the CPU."""
        if device is None and torch.cuda.is_available():
            device = torch.cuda.current_device()
        if device is None or torch.device(device).type != "cuda":
            return cls()
        return cls(torch.cuda.get_device_properties(device)
                   .shared_memory_per_block_optin)

    def __call__(self, site: SiteStats, cfg: ArchConfig, shape: ShapeSpec,
                 plan: PlanConfig) -> Optional[str]:
        need = site_smem_bytes(site.name, cfg, shape, plan)
        if need <= self.limit:
            return None
        return (f"shared memory {need} B a block > {self.limit} B "
                f"(resource pre-check)")


def narrow_candidates(cfg: ArchConfig, shape: ShapeSpec,
                      plan: PlanConfig | None = None,
                      top_k: int = 4,
                      combine: bool = True,
                      fits: Optional[Fits] = None) -> NarrowingReport:
    plan = plan or cfg.plan
    fits = fits or SharedMemoryFit.for_device()
    sites = site_census(cfg, shape, plan)
    total_flops = sum(s.flops for s in sites) or 1.0
    rep = NarrowingReport()

    scored: list[tuple[float, SiteStats]] = []
    for s in sites:
        rep.considered.append({
            "site": s.name, "flops": s.flops, "intensity": s.intensity,
            "count": s.count, "flops_share": s.flops / total_flops,
            "vmem_ws": s.vmem_working_set,
        })
        if s.name not in SITE_GENE:
            rep.rejected.append((s.name, "no Pallas destination for site"))
            continue
        if s.flops / total_flops < MIN_FLOPS_SHARE:
            rep.rejected.append(
                (s.name, f"flops share {s.flops/total_flops:.1%} < "
                         f"{MIN_FLOPS_SHARE:.0%} (loop-count filter)"))
            continue
        if s.intensity < MIN_INTENSITY:
            rep.rejected.append(
                (s.name, f"arithmetic intensity {s.intensity:.1f} < "
                         f"{MIN_INTENSITY} (bandwidth-bound)"))
            continue
        reason = fits(s, cfg, shape, plan)
        if reason is not None:
            rep.rejected.append((s.name, reason))
            continue
        scored.append((s.flops / total_flops * max(s.intensity, 1.0), s))

    scored.sort(key=lambda x: -x[0])
    singles = scored[:top_k]
    for score, s in singles:
        rep.candidates.append(Candidate(
            name=s.name,
            overrides={SITE_GENE[s.name]: "pallas"},
            rationale={"score": score, "intensity": s.intensity,
                       "flops_share": s.flops / total_flops}))

    # paper §3.2: "for a single-loop statement that can be further speeded
    # up, a pattern of the combination is also created"
    if combine and len(singles) >= 2:
        for i in range(min(2, len(singles))):
            for j in range(i + 1, min(3, len(singles))):
                a, b = singles[i][1], singles[j][1]
                rep.candidates.append(Candidate(
                    name=f"{a.name}+{b.name}",
                    overrides={SITE_GENE[a.name]: "pallas",
                               SITE_GENE[b.name]: "pallas"},
                    rationale={"combo_of": [a.name, b.name]}))
    return rep
