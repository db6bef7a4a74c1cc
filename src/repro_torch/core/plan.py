"""Execution-plan genome — the paper's per-loop offload bits, lifted to plans.

Counterpart of ``repro.core.plan``.  ``GENES`` keeps the reference's genes
that the port's ``PlanConfig`` has (the four site destinations, the chunk
of chunked attention, the KV cache dtype), with the same alleles and
applicability predicates.  The sharding genes (``fsdp``, ``seq_shard``,
``use_tp``, ``overlap_collectives``) come with the sharding slice, the
train genes (``remat``, ``microbatches``, ``fused_grad_reduce``,
``grad_compress``) with the training slice (ROADMAP.md).

The paper geneticizes one bit per parallelizable loop (1 = offload to GPU,
0 = CPU).  Here the decision space is the execution plan of a model on the
card; each gene is a site destination or a knob of a site.  Genes are small
categorical alphabets, so the GA operators work per-gene.

Gene applicability is arch-dependent: an attention-free arch (mamba2) simply
has no attention genes (the technique applies, the sites differ).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np

from repro_torch.configs.base import ArchConfig, PlanConfig

# name -> (alleles, applicability predicate)
GENES: dict[str, tuple[tuple, Any]] = {
    "attn_impl": (("xla", "xla_chunked", "pallas"),
                  lambda cfg, kind: cfg.n_heads > 0),
    "mlp_impl": (("xla", "pallas"),
                 lambda cfg, kind: cfg.d_ff > 0 or cfg.moe is not None),
    "ssm_impl": (("xla", "pallas"), lambda cfg, kind: cfg.family == "ssm"),
    "rglru_impl": (("xla", "pallas"),
                   lambda cfg, kind: cfg.family == "hybrid"),
    "attn_chunk": ((256, 512, 1024, 2048),
                   lambda cfg, kind: cfg.n_heads > 0),
    "kv_cache_dtype": (("bfloat16", "float32", "int8"),
                       lambda cfg, kind: kind in ("prefill", "decode")
                       and cfg.n_heads > 0),
}


@dataclass
class PlanGenome:
    """A genome = assignment of allele indices to applicable genes."""

    cfg: ArchConfig
    kind: str                      # train | prefill | decode
    alleles: dict[str, int]

    # -- construction ---------------------------------------------------------

    @classmethod
    def gene_names(cls, cfg: ArchConfig, kind: str) -> list[str]:
        return [g for g, (_, pred) in GENES.items() if pred(cfg, kind)]

    @classmethod
    def from_plan(cls, cfg: ArchConfig, kind: str,
                  plan: PlanConfig) -> "PlanGenome":
        alleles = {}
        for g in cls.gene_names(cfg, kind):
            vals = GENES[g][0]
            v = getattr(plan, g)
            alleles[g] = vals.index(v) if v in vals else 0
        return cls(cfg, kind, alleles)

    @classmethod
    def random(cls, cfg: ArchConfig, kind: str, rng: np.random.Generator
               ) -> "PlanGenome":
        alleles = {g: int(rng.integers(len(GENES[g][0])))
                   for g in cls.gene_names(cfg, kind)}
        return cls(cfg, kind, alleles)

    # -- genome ops -----------------------------------------------------------

    def to_plan(self, base: PlanConfig | None = None) -> PlanConfig:
        plan = base or self.cfg.plan
        kw = {g: GENES[g][0][i] for g, i in self.alleles.items()}
        return dataclasses.replace(plan, **kw)

    def key(self) -> tuple:
        """Hashable pattern id — the paper re-measures only new patterns."""
        return tuple(sorted(self.alleles.items()))

    def mutate(self, rng: np.random.Generator, rate: float = 0.15
               ) -> "PlanGenome":
        alleles = dict(self.alleles)
        for g in alleles:
            if rng.random() < rate:
                alleles[g] = int(rng.integers(len(GENES[g][0])))
        return PlanGenome(self.cfg, self.kind, alleles)

    def crossover(self, other: "PlanGenome", rng: np.random.Generator
                  ) -> "PlanGenome":
        alleles = {g: (self.alleles[g] if rng.random() < 0.5
                       else other.alleles[g])
                   for g in self.alleles}
        return PlanGenome(self.cfg, self.kind, alleles)

    def describe(self) -> str:
        return ",".join(f"{g}={GENES[g][0][i]}"
                        for g, i in sorted(self.alleles.items()))
