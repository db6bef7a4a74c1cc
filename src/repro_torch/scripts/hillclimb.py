"""Hillclimb: hypothesis -> change -> dry run -> validate.

    python -m repro_torch.scripts.hillclimb [--arch A] [--shape S] [--extra]

Counterpart of the repo's ``scripts/hillclimb.py``, over the port's pod
dry run.  Runs its three cells (A: mamba2-1.3b train_4k, the worst train
roofline; B: llama3-405b decode_32k, the most collective-bound; C:
qwen2-7b train_4k, the paper's representative, whose first plan the GA
finds), each plan variant one ``launch.dryrun.run_cell`` on the fake
256-rank group, and records the ``core/transfer.py`` census beside the
roofline terms of ``PowerModel(H100)`` over the estimate at a pod's
16-way model axis, before and after.  ``--arch`` and ``--shape`` take the
cells of that arch or shape; ``--extra`` adds the reference's two follow-up
probes (A4-A5, C4), which it gates on ``HC_EXTRA_A`` / ``HC_EXTRA``.  The
log goes to ``artifacts/torch/hillclimb/hillclimb_log.json`` (the repo's
own script writes ``artifacts/hillclimb/``).  Does no device work: the dry
run traces on the meta device.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.power import PowerModel
from repro_torch.launch.dryrun import ART, run_cell
from repro_torch.scripts.optimize_all import (CHIPS, OUT, POD_TP, POWER,
                                              terms)


def metrics(rec: dict, cfg, shape, plan, power: PowerModel,
            tag: str) -> dict:
    """One dry-run record's roofline terms and census under ``power``."""
    if rec["status"] != "OK":
        return {"status": rec["status"],
                "error": rec.get("error", "")[:200], "tag": tag}
    t = terms(rec, cfg, shape, plan, power)
    mem = rec["memory"]
    return {
        "status": "OK", "tag": tag,
        "t_compute": t["tc"], "t_memory": t["tm"], "t_collective": t["tcl"],
        "step_time": t["t"], "watts_chip": t["watts"],
        "energy_j": t["watts"] * t["t"] * CHIPS,
        "roofline_fraction": t["roofline"],
        "coll_bytes_census": rec["collectives"]["total_bytes"],
        "coll_count_census": rec["collectives"].get("total_count", 0),
        # the meta device allocates no temporaries: argument bytes only
        "mem_dev_gib": mem["argument_size_in_bytes"] / 2**30,
        "trace_s": rec["trace_s"],
    }


def log_iter(cell, name, hypothesis, m_before, m_after, notes="",
             log: Callable[[str], None] = print) -> dict:
    if m_after["status"] != "OK":
        verdict = f"FAILED: {m_after.get('error')}"
    else:
        dom_b = max(("t_compute", "t_memory", "t_collective"),
                    key=lambda k: m_before[k])
        delta = 1 - m_after[dom_b] / max(m_before[dom_b], 1e-12)
        sp = m_before["step_time"] / m_after["step_time"]
        verdict = (f"dominant({dom_b}) {m_before[dom_b]:.4f}s -> "
                   f"{m_after[dom_b]:.4f}s ({delta:+.1%}); "
                   f"step {m_before['step_time']:.4f}->"
                   f"{m_after['step_time']:.4f}s ({sp:.2f}x); "
                   f"E {m_before['energy_j']:.0f}->"
                   f"{m_after['energy_j']:.0f}J")
    rec = {"cell": cell, "iteration": name, "hypothesis": hypothesis,
           "before": m_before, "after": m_after, "verdict": verdict,
           "notes": notes}
    log(f"\n[{cell}] {name}\n  H: {hypothesis}\n  -> {verdict}"
        + (f"\n  note: {notes}" if notes else ""))
    return rec


@dataclass
class Sweep:
    """Where the dry runs cache (``art``) and the log lines' sink."""
    art: Path = ART
    log: Callable[[str], None] = print

    def measure(self, arch: str, shape_name: str, plan, tag: str) -> dict:
        rec = run_cell(arch, shape_name, multi_pod=False, plan=plan,
                       tag=tag, art=self.art)
        return metrics(rec, get_config(arch), SHAPES[shape_name], plan,
                       POWER, tag)

    def step(self, cell: str, name: str, hypothesis: str, before: dict,
             after: dict, notes: str = "") -> dict:
        return log_iter(cell, name, hypothesis, before, after, notes,
                        log=self.log)


def cell_a(sw: Sweep, arch: str, shp: str) -> list:
    """Per-layer TP collectives on a 1.3B model."""
    cell = f"{arch}/{shp}"
    base_plan = get_config(arch).plan
    a0 = sw.measure(arch, shp, base_plan, "_hc_a0")
    sw.log("[A] baseline: " + json.dumps(
        {k: round(v, 4) if isinstance(v, float) else v
         for k, v in a0.items()}, indent=0))
    p = base_plan.replace(use_tp=False, microbatches=1)
    a1 = sw.measure(arch, shp, p, "_hc_a1")
    log = [sw.step(
        cell, "A1 pure-DP (use_tp=False)",
        "a 1.3B model does not need 16-way TP on 256 chips; mapping the "
        "model axis into DP removes ~2*(T/dp)*d*L per-layer TP traffic at "
        "the cost of replicated weights (1.3B*4B/256-way ZeRO fits)",
        a0, a1)]
    p2 = p.replace(grad_compress="int8_ef")
    a2 = sw.measure(arch, shp, p2, "_hc_a2")
    log.append(sw.step(
        cell, "A2 +int8 error-feedback grad compression",
        "DP gradient all-reduce is now the collective floor; int8 wire "
        "format cuts its bytes 4x (napkin: dp term /4)", a1, a2,
        notes="the census counts the collectives the step issues, at f32: "
              "the wire saving needs compressed_psum "
              "(tests/test_torch_pod.py covers it); the analytic "
              "collective term reflects it."))
    p3 = p2.replace(overlap_collectives=True)
    a3 = sw.measure(arch, shp, p3, "_hc_a3")
    log.append(sw.step(
        cell, "A3 +collective/compute overlap",
        "remaining FSDP gathers are per-layer and independent of the next "
        "layer's compute; async scheduling hides ~50%", a2, a3))
    return log


def cell_b(sw: Sweep, arch: str, shp: str) -> list:
    """The seq-sharded KV cache gathered across TP every layer."""
    cell = f"{arch}/{shp}"
    base_plan = get_config(arch).plan
    b0 = sw.measure(arch, shp, base_plan, "_hc_b0")
    p = base_plan.replace(kv_cache_dtype="int8")
    b1 = sw.measure(arch, shp, p, "_hc_b1")
    log = [sw.step(
        cell, "B1 int8 KV cache",
        "the dominant collective is the per-layer gather of the "
        "seq-sharded KV cache (kv=8 cannot take 16-way TP); int8 storage "
        "halves the gathered payload and the cache's HBM traffic", b0, b1)]
    p2 = p.replace(overlap_collectives=True)
    b2 = sw.measure(arch, shp, p2, "_hc_b2")
    log.append(sw.step(
        cell, "B2 +collective/compute overlap",
        "cache gathers for layer l+1 can prefetch under layer l compute "
        "(decode compute is tiny but gather latency chains; 50% hide)",
        b1, b2))
    p3 = p2.replace(attn_chunk=2048)
    b3 = sw.measure(arch, shp, p3, "_hc_b3")
    log.append(sw.step(
        cell, "B3 larger attention chunk (512->2048)",
        "decode attention over 32k cache in 2048-blocks quarters the "
        "number of chunk-scan iterations (less per-step overhead, same "
        "bytes) — expect small or no dominant-term change (refutation "
        "probe)", b2, b3))
    return log


def cell_c(sw: Sweep, arch: str, shp: str) -> list:
    """The GA finds the plan (the paper's method), then sharding beyond
    the paper."""
    from repro_torch.core.ga import GAConfig, run_ga
    from repro_torch.core.verifier import Verifier
    cell = f"{arch}/{shp}"
    cfg = get_config(arch)
    c0 = sw.measure(arch, shp, cfg.plan, "_hc_c0")
    v = Verifier(cfg, shp, n_chips=CHIPS, tp=POD_TP, mode="analytic",
                 power=POWER)
    res = run_ga(cfg, SHAPES[shp].kind, v,
                 GAConfig(population=12, generations=8, seed=0))
    ga_plan = res.best.to_plan()
    c1 = sw.measure(arch, shp, ga_plan, "_hc_c1")
    log = [sw.step(
        cell, "C1 GA-selected plan (PAPER-FAITHFUL)",
        "the paper's method: GA over offload genes with power fitness in "
        "the verification environment; best genome: " + res.best.describe(),
        c0, c1)]
    c2_plan = ga_plan.replace(use_tp=False, microbatches=1,
                              grad_compress="int8_ef")
    c2 = sw.measure(arch, shp, c2_plan, "_hc_c2")
    log.append(sw.step(
        cell, "C2 BEYOND-PAPER pure-DP + int8 grads",
        "7B fits pure DP+ZeRO on 256 chips (28GB fp32 states / 256); "
        "removes all per-layer TP collectives; DP gradient all-reduce "
        "compressed 4x", c1, c2))
    c3 = sw.measure(arch, shp, c2_plan.replace(overlap_collectives=True),
                    "_hc_c3")
    log.append(sw.step(
        cell, "C3 +overlap",
        "hide half of the remaining FSDP/DP traffic under backward",
        c2, c3))
    return log


def cell_a_extra(sw: Sweep, arch: str, shp: str) -> list:
    """A4/A5: with collectives tamed, the new dominant term (compute:
    remat's recompute)."""
    cell = f"{arch}/{shp}"
    a3_plan = get_config(arch).plan.replace(
        use_tp=False, microbatches=1, grad_compress="int8_ef",
        overlap_collectives=True)
    a3 = sw.measure(arch, shp, a3_plan, "_hc_a3")
    a4 = sw.measure(arch, shp, a3_plan.replace(remat="none"), "_hc_a4")
    log = [sw.step(
        cell, "A4 remat=none (drop recompute)",
        "collectives are hidden; compute now dominates and remat=full "
        "recomputes the forward (4x fwd-flops multiplier vs 3x) IF the "
        "activation stash fits", a3, a4)]
    a5 = sw.measure(arch, shp, a3_plan.replace(remat="dots"), "_hc_a5")
    log.append(sw.step(
        cell, "A5 remat=dots (middle ground)",
        "if full-stash OOMs or regresses memory, checkpoint only the "
        "matmul outputs: 3.5x multiplier, half the stash",
        a4 if a4["status"] == "OK" else a3, a5))
    return log


def cell_c_extra(sw: Sweep, arch: str, shp: str) -> list:
    """C4: does ZeRO (fsdp) help or hurt pure-DP qwen2-7b?"""
    cell = f"{arch}/{shp}"
    c3_plan = get_config(arch).plan.replace(
        use_tp=False, microbatches=1, grad_compress="int8_ef",
        overlap_collectives=True, fsdp=False, remat="none", attn_chunk=2048)
    c3 = sw.measure(arch, shp, c3_plan, "_hc_c3b")
    c4 = sw.measure(arch, shp, c3_plan.replace(fsdp=True), "_hc_c4")
    return [sw.step(
        cell, "C4 +ZeRO weight sharding (fsdp=True)",
        "with weights replicated, ZeRO shards them 256-way but must gather "
        "them per layer per pass — expect gathers to GROW (refutation "
        "probe: fsdp is a memory lever, not a collective lever, when the "
        "model already fits)", c3, c4)]


@dataclass(frozen=True)
class Cell:
    key: str
    arch: str
    shape: str
    run: Callable[[Sweep, str, str], list]


CELLS = (Cell("A", "mamba2-1.3b", "train_4k", cell_a),
         Cell("B", "llama3-405b", "decode_32k", cell_b),
         Cell("C", "qwen2-7b", "train_4k", cell_c))
EXTRA = (Cell("A+", "mamba2-1.3b", "train_4k", cell_a_extra),
         Cell("C+", "qwen2-7b", "train_4k", cell_c_extra))


def select(arch: Optional[str] = None, shape: Optional[str] = None,
           extra: bool = False) -> list:
    """The cells ``arch`` and ``shape`` name (all when neither does)."""
    return [c for c in CELLS + (EXTRA if extra else ())
            if arch in (None, c.arch) and shape in (None, c.shape)]


def run(cells: list, sweep: Optional[Sweep] = None,
        out: Path = OUT) -> list:
    """Run ``cells``; returns the log written to
    ``out/hillclimb_log.json``."""
    sweep = sweep or Sweep()
    log = []
    for c in cells:
        log.extend(c.run(sweep, c.arch, c.shape))
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "hillclimb_log.json").write_text(json.dumps(log, indent=1))
    sweep.log(f"\nwrote {out / 'hillclimb_log.json'}")
    return log


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="only this arch's cells")
    ap.add_argument("--shape", default=None, help="only this shape's cells")
    ap.add_argument("--extra", action="store_true",
                    help="add the follow-up probes A4-A5 and C4")
    args = ap.parse_args(argv)
    run(select(args.arch, args.shape, args.extra))


if __name__ == "__main__":
    main()
