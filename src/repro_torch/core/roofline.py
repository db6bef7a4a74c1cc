"""Roofline analysis over dry-run records (§Roofline deliverable).

Counterpart of ``repro.core.roofline``.  For each (arch, shape, mesh)
record that ``launch.dryrun`` produced, derive:

    compute term    = FLOPs / (chips x the card's FLOP rate)
    memory term     = HBM bytes / (chips x the card's HBM rate)
    collective term = collective bytes / (chips x its NVLink rate)

on the spec of ``core.power`` (``H100`` unless a ``PowerModel`` is given;
the rates are the spec's reached ones where it has them).  The terms come
from ``estimate_program`` (config math, with the pod meshes' 16-way
model axis); the record's collective census
(per rank) is the floor of the collective bytes, as in the reference.

The record's ``flops`` is whole-program and global: the dry run runs
every layer and microbatch (nothing is a loop body counted once), so
unlike the reference's HLO count it takes no trip-count correction.  It
is reported beside the model's 6·N·D (train) / 2·N·D (inference) FLOPs as
the useful-compute ratio, with the dominant term and a one-line
suggestion.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from repro_torch.artifacts import DRYRUN
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.intensity import estimate_program
from repro_torch.core.power import H100, PowerModel
from repro_torch.launch.mesh import POD_SHAPE

ART = DRYRUN


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    status: str
    # seconds
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    traced_flops: float = 0.0        # the dry run's global FLOP count
    useful_ratio: float = 0.0
    roofline_fraction: float = 0.0   # t_compute / step time
    watts_per_chip: float = 0.0
    energy_j: float = 0.0
    note: str = ""
    suggestion: str = ""
    raw: dict = field(default_factory=dict)

    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory) + self.t_collective


_SUGGEST = {
    "compute": ("compute-bound: keep the tensor cores busy — larger "
                "per-card tiles, fused kernels (wgmma with a TMA "
                "producer), or drop remat recompute"),
    "memory": ("memory-bound: cut HBM traffic — fuse elementwise chains "
               "into the matmul kernels, keep scores and intermediates in "
               "shared memory and registers, quantize the KV cache"),
    "collective": ("collective-bound: shrink or overlap NVLink traffic — "
                   "reduce-scatter instead of all-reduce, int8 gradient "
                   "compression, overlap gradient reduction with the "
                   "backward"),
}


def analyze_record(rec: dict, power: Optional[PowerModel] = None
                   ) -> RooflineRow:
    power = power or PowerModel(H100)
    row = RooflineRow(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                      chips=rec.get("n_chips", 256), status=rec["status"])
    if rec["status"] != "OK":
        row.note = rec.get("reason", rec.get("error", ""))[:120]
        return row

    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    # both pod meshes hold a 16-way model axis (launch.mesh.POD_SHAPE)
    est = estimate_program(cfg, shape, cfg.plan, row.chips, POD_SHAPE[1])

    row.traced_flops = float(rec.get("flops", 0.0))
    # the census is per rank: the analytic per-layer model is the primary
    # term and the recorded census its floor
    coll_raw = rec["collectives"]["total_bytes"]
    coll_eff = max(coll_raw, est.coll_bytes)

    row.t_compute = power.compute_term(est.flops, row.chips)
    row.t_memory = power.memory_term(est.hbm_bytes, row.chips)
    row.t_collective = power.collective_term(coll_eff * row.chips,
                                             row.chips)
    terms = {"compute": row.t_compute, "memory": row.t_memory,
             "collective": row.t_collective}
    row.dominant = max(terms, key=terms.get)
    row.model_flops = rec.get("model_flops", 0.0)
    row.useful_ratio = (row.model_flops / row.traced_flops
                        if row.traced_flops else 0.0)
    t = row.step_time()
    row.roofline_fraction = row.t_compute / t if t else 0.0
    row.watts_per_chip = power.watts(
        est.flops, est.hbm_bytes, coll_eff * row.chips, t,
        row.chips) / row.chips
    row.energy_j = row.watts_per_chip * t * row.chips
    row.suggestion = _SUGGEST[row.dominant]
    row.note = rec.get("execution", "")
    row.raw = {
        "traced_flops": row.traced_flops,
        "coll_bytes_raw_per_chip": coll_raw,
        "analytic_flops": est.flops,
        "analytic_hbm": est.hbm_bytes,
        "analytic_coll": est.coll_bytes,
    }
    return row


def load_rows(mesh: str = "pod16x16",
              art: Optional[Path] = None) -> list[RooflineRow]:
    """A row per dry-run record of ``mesh`` under ``art`` (plan variants,
    whose keys carry a tag, excluded)."""
    rows = []
    for p in sorted(Path(art or ART).glob(f"*__{mesh}.json")):
        rec = json.loads(p.read_text())
        rows.append(analyze_record(rec))
    return rows


def table(rows: list[RooflineRow]) -> str:
    hdr = (f"{'arch':26s} {'shape':12s} {'dom':10s} {'t_comp(s)':>10s} "
           f"{'t_mem(s)':>10s} {'t_coll(s)':>10s} {'roofl%':>7s} "
           f"{'useful%':>8s} {'W/chip':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.status != "OK":
            lines.append(f"{r.arch:26s} {r.shape:12s} {r.status}: {r.note}")
            continue
        lines.append(
            f"{r.arch:26s} {r.shape:12s} {r.dominant:10s} "
            f"{r.t_compute:10.4f} {r.t_memory:10.4f} {r.t_collective:10.4f} "
            f"{r.roofline_fraction*100:6.1f}% "
            f"{min(r.useful_ratio,9.99)*100:7.1f}% {r.watts_per_chip:7.0f}")
    for note in sorted({r.note for r in rows if r.status == "OK" and r.note}):
        lines.append(f"execution: {note}")
    return "\n".join(lines)


def main() -> None:
    print(table(load_rows()))


if __name__ == "__main__":
    main()
