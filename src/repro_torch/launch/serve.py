"""Serving driver (CLI): a power-governed fleet of continuous-batching
decode loops on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny-test \
        --requests 6 --device cpu

Fleet serving (the control plane over per-node Step-7 governors):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny-test \
        --fleet 2 --requests 12 --tenants teamA,teamB --govern \
        --admission teamB=2.5 --admission-window 64 \
        --ledger-out artifacts/serve/fleet.json --device cpu

Counterpart of ``repro.launch.serve``'s object engine.  Every run builds
``--fleet N`` nodes (each a ServeLoop + DVFS-envelope DecodeEnergyMeter
bundle at the H100 envelope, ``repro_torch.fleet.Node``) under one
``FleetScheduler``: requests route to the node with the lowest predicted
marginal Ws/token (``--router round_robin`` for the energy-blind
baseline), a drifted node's load drains to healthy nodes at a checkpoint
boundary (``FleetEvent``), and ``--admission tenant=Ws[,t=Ws]`` throttles
submits against per-tenant budget windows on the merged fleet ledger.
With ``--govern`` each node additionally gets its own PowerGovernor, so
plan migrations keep working underneath the fleet plane; with
``--verify-rung measured`` a pending migration is re-verified by real
trials of both plans on the card at ``--recon-shape`` before it applies.
With ``--placement gate`` the fleet power planner
(``repro_torch.fleet.power``) additionally decides which nodes are
powered at all (``--placement always_on`` keeps every node powered — the
A/B baseline; ``--slo-queue-depth`` is the queue SLO the planner must
hold).  The nodes share one model and its weights, and time-share the
one device.

The model runs on ``--device`` (default: the card; raises without one).
The printed lines and the persisted files keep the reference's formats,
so ``scripts/power_report.py --ledger`` and ``scripts/trace_report.py``
render the port's output unchanged.  ``run(args, model, params)`` is the
library entry: it serves on weights the caller already holds.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.adapt import ReconfigPolicy, Reconfigurator
from repro_torch.core.backends import MeasuredBackend
from repro_torch.core.ga import GAConfig
from repro_torch.core.verifier import Verifier
from repro_torch.fleet import (AdmissionController, FleetPolicy,
                               FleetPowerPlanner, FleetScheduler, Node,
                               PowerPlanPolicy)
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request
from repro_torch.telemetry import (GovernorPolicy, PowerGovernor, WsBudget,
                                   render_rollups)

#: the one fleet engine ported; the reference's vectorized engines come
#: with ROADMAP.md's section A item 5
ENGINES = ("object",)
#: rungs a pending migration may be re-verified on
VERIFY_RUNGS = ("measured", "replay")


def parse_diurnal(spec: str) -> list:
    """``1:8:1,160:12:3`` -> due steps [1..8] + [160, 163, ..] — each
    ``start:count:spacing`` burst contributes ``count`` arrivals spaced
    ``spacing`` fleet steps apart, starting at ``start``."""
    due = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) != 3:
            raise ValueError(f"bad --diurnal burst {part!r} "
                             f"(want start:count:spacing)")
        start, count, spacing = (int(f) for f in fields)
        if count < 1 or spacing < 1:
            raise ValueError(f"bad --diurnal burst {part!r} "
                             f"(count and spacing must be >= 1)")
        due.extend(start + i * spacing for i in range(count))
    return sorted(due)


def parse_budgets(spec: str, window_steps: int) -> dict:
    """``teamA=2.5,teamB=0.8`` -> {tenant: WsBudget} (Ws per window)."""
    budgets = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        tenant, _, ws = part.partition("=")
        if not tenant or not ws:
            raise ValueError(f"bad --admission entry {part!r} "
                             f"(want tenant=Ws)")
        budgets[tenant.strip()] = WsBudget(budget_ws=float(ws),
                                           window_steps=window_steps)
    return budgets


def build_governor(cfg, args, node: str, plan=None,
                   verifier_factory=None) -> PowerGovernor:
    """One node's governor: a Reconfigurator re-searching at
    ``--recon-shape`` (``verifier_factory`` builds its verifiers; one
    card, analytic, when None), re-verifying on ``--verify-rung``."""
    recon = Reconfigurator(cfg, args.recon_shape,
                           policy=ReconfigPolicy(),
                           ga=GAConfig(population=6, generations=2),
                           verifier_factory=verifier_factory,
                           node=node)
    return PowerGovernor(
        recon, plan=plan if plan is not None else cfg.plan,
        policy=GovernorPolicy(flush_every=args.flush_every,
                              checkpoint_every=args.checkpoint_every),
        verify_rung=args.verify_rung)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="A power-governed fleet of decode loops on the card.")
    ap.add_argument("--arch", default="tiny-test")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device the model serves on (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--fleet", type=int, default=1,
                    help="number of serving nodes under the scheduler")
    ap.add_argument("--engine", default="object", choices=ENGINES,
                    help="fleet core: the object engine (a ServeLoop per "
                         "node on the model)")
    ap.add_argument("--node", default="node",
                    help="node label prefix (node0..nodeN-1)")
    ap.add_argument("--router", default="energy",
                    choices=("energy", "round_robin"),
                    help="dispatch policy: lowest marginal Ws/token, or "
                         "the energy-blind round-robin baseline")
    ap.add_argument("--tenants", default="default",
                    help="comma-separated tenant labels, cycled across "
                         "requests (per-tenant energy billing)")
    ap.add_argument("--admission", default=None,
                    help="per-tenant Ws budgets, e.g. teamA=2.5,teamB=0.8; "
                         "exhausted tenants are throttled (zero Ws booked)")
    ap.add_argument("--admission-window", type=int, default=0,
                    help="budget window in fleet steps (0 = whole run)")
    ap.add_argument("--arrival-every", type=int, default=0,
                    help="pace arrivals: submit one request every N fleet "
                         "steps (0 = all upfront); paced arrivals are what "
                         "make admission throttling observable")
    ap.add_argument("--no-drain", action="store_true",
                    help="disable cross-node load migration on drift")
    ap.add_argument("--placement", default=None,
                    choices=("gate", "always_on"),
                    help="attach the fleet power planner: consolidate-and-"
                         "gate idle nodes to a parked draw (gate), or keep "
                         "every node powered but book its idle floor "
                         "(always_on, the A/B baseline)")
    ap.add_argument("--slo-queue-depth", type=float, default=4.0,
                    help="expected queued requests the placement planner "
                         "must keep the active node set under")
    ap.add_argument("--govern", action="store_true",
                    help="attach a per-node PowerGovernor (Step-7 loop)")
    ap.add_argument("--flush-every", type=int, default=8,
                    help="serve steps between meter flushes")
    ap.add_argument("--checkpoint-every", type=int, default=16,
                    help="serve steps between checkpoint boundaries")
    ap.add_argument("--recon-shape", default="decode_32k_b8",
                    help="shape the governor's re-search evaluates (and "
                         "its re-verification trials run)")
    ap.add_argument("--verify-rung", default=None, choices=VERIFY_RUNGS,
                    help="re-verify pending plan migrations on this "
                         "measurement rung before applying them")
    ap.add_argument("--ledger-out", default=None,
                    help="persist the fleet ledger (JSON) here")
    ap.add_argument("--trace-out", default=None,
                    help="persist node0's power trace (JSONL) here")
    ap.add_argument("--diurnal", default=None,
                    help="bursty arrival script start:count:spacing[,...]; "
                         "overrides --requests/--arrival-every with due "
                         "fleet steps (troughs let the placement planner "
                         "gate idle nodes)")
    ap.add_argument("--trace-spans", default=None,
                    help="enable span tracing; write the Chrome trace_event "
                         "JSON here (plus <stem>.spans.jsonl raw spans), "
                         "rendered offline via scripts/trace_report.py")
    ap.add_argument("--metrics-out", default=None,
                    help="enable the metrics registry; write the Prometheus "
                         "text exposition here")
    return ap


def run(args, model: Optional[Model] = None, params=None,
        measured=None) -> dict:
    """Serve ``args``' arrival script on a fleet; prints the reference's
    report lines and returns the run's objects (scheduler, nodes, every
    request, the finished ones, admission, planner, attribution, wall
    seconds).

    ``model``/``params`` serve on weights the caller holds (the model's
    own plan and device; ``args.device`` is then not read); without them
    the arch's model is built on ``args.device`` with seeded weights.
    ``measured`` is the governors' measured-rung backend (default: a
    ``MeasuredBackend`` on the served weights, its draw from the card's
    NVML counter)."""
    if args.trace_spans or args.metrics_out:
        obs.enable()
    if model is None:
        cfg = get_config(args.arch, reduced=args.reduced)
        model = Model(cfg, device=args.device)
        params = model.init(torch.Generator(device=model.device)
                            .manual_seed(0))
    cfg = model.cfg

    factory = None
    if args.govern:
        # the nodes share one card and one set of weights: one verifier,
        # whose measured rung holds the served weights, caches every
        # node's trials (a plan tried for one node is not tried again)
        if measured is None:
            measured = MeasuredBackend(device=model.device,
                                       params={cfg.name: params})
        verifier = Verifier(cfg, args.recon_shape, mode="analytic",
                            backends={"measured": measured})

        def factory():
            return verifier
    nodes = []
    for i in range(max(args.fleet, 1)):
        name = f"{args.node}{i}"
        governor = build_governor(cfg, args, name, plan=model.plan,
                                  verifier_factory=factory) \
            if args.govern else None
        nodes.append(Node.build(name, model, params, slots=args.slots,
                                max_seq=args.max_seq, governor=governor,
                                device=model.device))
    admission = None
    if args.admission:
        admission = AdmissionController(
            parse_budgets(args.admission, args.admission_window))
    planner = None
    if args.placement:
        planner = FleetPowerPlanner(policy=PowerPlanPolicy(
            mode=args.placement, slo_queue_depth=args.slo_queue_depth))
    sched = FleetScheduler(
        nodes,
        policy=FleetPolicy(flush_every=args.flush_every,
                           checkpoint_every=args.checkpoint_every,
                           router=args.router,
                           migrate_on_drift=not args.no_drain),
        admission=admission, planner=planner)

    tenants = [t.strip() for t in args.tenants.split(",") if t.strip()] \
        or ["default"]
    rng = np.random.default_rng(0)

    def make_request(i: int) -> Request:
        plen = int(rng.integers(4, 12))
        prompt = rng.integers(2, cfg.vocab_size, size=plen).astype(np.int32)
        return Request(rid=i, prompt=prompt, max_new=args.max_new,
                       tenant=tenants[i % len(tenants)])

    t0 = time.time()
    if args.diurnal:
        arrivals = [(due, make_request(i))
                    for i, due in enumerate(parse_diurnal(args.diurnal))]
        finished = sched.run(arrivals=arrivals)
        requests = [r for _, r in arrivals]
    elif args.arrival_every > 0:
        requests = [make_request(i) for i in range(args.requests)]
        finished = sched.run(arrivals=requests,
                             arrival_every=args.arrival_every)
    else:
        requests = [make_request(i) for i in range(args.requests)]
        for req in requests:
            sched.submit(req)
        finished = sched.run()
    wall = time.time() - t0
    if admission is not None:
        for rej in admission.rejections:
            print(f"req {rej.rid}: tenant={rej.tenant} THROTTLED @step "
                  f"{rej.step} ({rej.reason})")
    n_tok = sum(len(r.out) for r in finished)
    for r in finished:
        print(f"req {r.rid}: tenant={r.tenant} "
              f"prompt={r.prompt.tolist()[:6]}... "
              f"out={r.out[:10]} ({len(r.out)} tokens) "
              f"{r.prefill_ws:.3f}Ws prefill + {r.decode_ws:.3f}Ws decode")
    steps = sum(n.loop.steps_done for n in nodes)
    print(f"\nserved {len(finished)} requests, {n_tok} tokens in {wall:.2f}s "
          f"({n_tok/max(wall,1e-9):.1f} tok/s, {steps} decode steps on "
          f"{len(nodes)} nodes, router={args.router})")

    for line in render_rollups(sched.ledger, label="fleet"):
        print(line)
    for node in nodes:
        d = node.to_dict()
        util = node.loop.utilization.per_phase() \
            if node.loop.utilization is not None else {}
        util_s = " ".join(f"{k}={v:.2f}" for k, v in sorted(util.items()))
        print(f"node {d['name']}: served={d['served']} "
              f"{d['total_ws']:.2f}Ws parked={d['parked']} "
              f"measured_util[{util_s}]")
    for ev in sched.events:
        print(f"fleet drain @step {ev.step} (detected {ev.detected_step}): "
              f"{ev.node} drift {ev.drift_ratio:.2f}x -> "
              f"{len(ev.moved_rids)} requests to {','.join(ev.targets)}")
    if planner is not None:
        for ev in planner.events:
            print(f"placement {ev.action} @step {ev.step}: {ev.node} "
                  f"(rate={ev.rate:.3f}/step, "
                  f"Lq={ev.queue_depth_est:.2f}, "
                  f"keep {ev.active_target} nodes) {ev.reason}")
        print(f"placement[{args.placement}]: states={planner.states} "
              f"max_queue_depth={planner.max_queue_depth} "
              f"(SLO {args.slo_queue_depth:g})")
    if admission is not None:
        for tenant, row in admission.summary(sched.ledger).items():
            print(f"admission {tenant}: spent {row['spent_ws']:.2f}Ws of "
                  f"{row['budget_ws']:.2f}Ws, rejected {row['rejected']} "
                  f"submits (0.00Ws booked)")
    for node in nodes:
        if node.governor is None:
            continue
        for ev in node.governor.events:
            verdict = "plan migration" if ev.applied else \
                (f"REJECTED by {ev.verify_rung} rung "
                 f"({ev.reject_reason[:60]})")
            print(f"reconfig @step {ev.step} (detected {ev.detected_step}, "
                  f"node {ev.node}): drift {ev.drift_ratio:.2f}x -> "
                  f"{verdict}")
    if args.ledger_out:
        print(f"ledger -> {sched.ledger.to_json(args.ledger_out)}")
    if args.trace_out:
        print(f"trace  -> {nodes[0].meter.trace.to_jsonl(args.trace_out)}")
    result = None
    if args.trace_spans:
        result = obs.attribute_joules(list(obs.TRACER.spans), sched.ledger)
        for node_name, row in sorted(
                result.conservation(sched.ledger).items()):
            flag = "ok" if row["ok"] else "DRIFT"
            print(f"attribution {node_name}: ledger {row['ledger_ws']:.4f}Ws "
                  f"attributed {row['attributed_ws']:.4f}Ws "
                  f"(delta {row['delta']:+.2e}) {flag}")
        spans_out = str(Path(args.trace_spans).with_suffix(".spans.jsonl"))
        print(f"spans  -> {obs.write_chrome_trace(result.all_spans(), args.trace_spans)}"
              f" (+ {obs.write_spans_jsonl(result.all_spans(), spans_out)})")
        if obs.TRACER.dropped:
            print(f"spans  dropped {obs.TRACER.dropped} past the tracer cap")
    if args.metrics_out:
        print(f"metrics -> {obs.METRICS.write_prometheus(args.metrics_out)}")
        h = obs.METRICS.histogram("queue_wait_s")
        print("queue_wait_s " + " ".join(
            f"p{int(q * 100)}={h.quantile(q):.4f}s" for q in obs.QUANTILES))
    return {"sched": sched, "nodes": nodes, "requests": requests,
            "finished": finished, "admission": admission,
            "planner": planner, "attribution": result, "wall_s": wall}


def main(argv: Optional[list] = None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
