"""Fleet-wide sweep: run every runnable cell's pod dry run under its
optimized plan and compare the roofline terms with the arch's plan's.

    python -m repro_torch.scripts.optimize_all [--arch A] [--shape S]

Counterpart of the repo's ``scripts/optimize_all.py``, over the port's pod
dry run: each cell is ``launch.dryrun.run_cell`` on the fake 256-rank
group (everything on the meta device), its collective bytes the
``core/transfer.py`` census of what the step issues, and the terms
``PowerModel(H100)``'s over ``core.intensity.estimate_program`` at a pod's
16-way model axis.  The arch's plan's record is read from the dry run's
cache (``artifacts/torch/dryrun/``) or run when it is missing.  ``--arch``
and ``--shape`` take a subset of the cells.  The rows go to
``artifacts/torch/hillclimb/fleet_optimized.json`` (the repo's own script
writes ``artifacts/hillclimb/``).  Does no device work: the dry run traces
on the meta device.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
from pathlib import Path
from typing import Callable, Optional

from repro_torch.artifacts import HILLCLIMB
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.optimized import optimized_plan
from repro_torch.core.intensity import estimate_program
from repro_torch.core.power import H100, PowerModel
from repro_torch.launch.dryrun import ART, run_cell
from repro_torch.launch.mesh import POD_SHAPE

CHIPS = 256
POWER = PowerModel(H100)
#: a pod's model axis, which the reference's estimate takes by default
POD_TP = POD_SHAPE[1]
OUT = HILLCLIMB


def terms(rec: dict, cfg, shape, plan, power: PowerModel) -> dict:
    """The roofline terms of one dry-run record under ``power``: the
    estimate's, the collective bytes the larger of the census's and the
    estimate's."""
    est = estimate_program(cfg, shape, plan, CHIPS, tp=POD_TP)
    coll = max(rec["collectives"]["total_bytes"], est.coll_bytes)
    tc = power.compute_term(est.flops, CHIPS)
    tm = power.memory_term(est.hbm_bytes, CHIPS)
    tcl = power.collective_term(coll * CHIPS, CHIPS)
    if plan.overlap_collectives:
        tcl *= 0.5
    t = max(tc, tm) + tcl
    return {"t": t, "tc": tc, "tm": tm, "tcl": tcl,
            "roofline": tc / t if t else 0.0,
            "watts": power.watts(est.flops, est.hbm_bytes, coll * CHIPS, t,
                                 CHIPS) / CHIPS}


def cells(arch: Optional[str] = None, shape: Optional[str] = None) -> list:
    """The (arch, shape) cells of the sweep: every published arch and
    shape it runs, or the subset ``arch`` / ``shape`` name."""
    archs = [arch] if arch else [a for a in list_archs()
                                 if not a.startswith("tiny")]
    return [(a, s) for a in archs
            for s in ([shape] if shape else list(SHAPES))
            if s not in get_config(a).skip_shapes]


def run(cell_list: list, art: Path = ART, out: Path = OUT,
        log: Callable[[str], None] = print) -> list:
    """Sweep ``cell_list`` (dry runs cached under ``art``); returns the
    rows written to ``out/fleet_optimized.json``."""
    rows = []
    log(f"{'cell':44s} {'base_t':>9s} {'opt_t':>9s} {'speedup':>8s} "
        f"{'roofl':>13s} {'status'}")
    for arch, shape_name in cell_list:
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        base_rec = run_cell(arch, shape_name, multi_pod=False, art=art)
        if base_rec["status"] != "OK":
            continue
        base = terms(base_rec, cfg, shape, cfg.plan, POWER)
        plan = optimized_plan(arch, shape.kind)
        if plan == cfg.plan:
            continue
        rec = run_cell(arch, shape_name, multi_pod=False, plan=plan,
                       tag="_opt", art=art)
        cell = f"{arch}/{shape_name}"
        if rec["status"] != "OK":
            log(f"{cell:44s} {base['t']:9.4f} {'—':>9s} {'—':>8s} "
                f"{'—':>13s} FAIL {rec.get('error', '')[:60]}")
            rows.append({"cell": cell, "status": "FAIL",
                         "error": rec.get("error", "")[:200]})
            continue
        opt = terms(rec, cfg, shape, plan, POWER)
        sp = base["t"] / opt["t"]
        log(f"{cell:44s} {base['t']:9.4f} {opt['t']:9.4f} "
            f"{sp:7.2f}x {base['roofline']*100:5.1f}->"
            f"{opt['roofline']*100:5.1f}% OK")
        rows.append({"cell": cell, "status": "OK", "base": base, "opt": opt,
                     "speedup": sp, "plan": plan.describe()})
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "fleet_optimized.json").write_text(json.dumps(rows, indent=1))
    oks = [r for r in rows if r["status"] == "OK"]
    if oks:
        log(f"\n{len(oks)} cells optimized; median speedup "
            f"{statistics.median(r['speedup'] for r in oks):.2f}x; geomean "
            f"{math.prod(r['speedup'] for r in oks) ** (1 / len(oks)):.2f}x")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="only this arch's cells")
    ap.add_argument("--shape", default=None, help="only this shape's cells")
    args = ap.parse_args(argv)
    run(cells(args.arch, args.shape))


if __name__ == "__main__":
    main()
