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

The vectorized engines serve the same fleet/placement/admission surface
with no model (``repro_torch.fleet.vector``; nodes at the H100 envelope):

    PYTHONPATH=src python -m repro_torch.launch.serve --engine vector-seg \
        --fleet 64 --slots 4 --tick 0.004 --max-new 8 --placement gate \
        --diurnal 1:8:1,160:12:3 --tenants teamA,teamB

``--engine vector`` is the stepped core, ``vector-seg`` the event-horizon
segment core, ``vector-torch`` the segment core with its booking plane
folded on ``--device`` (default: the card; ``--device cpu`` folds on the
CPU) and ``vector-shard`` the sharded segment core (``--shard-workers``,
``--shard-parallel``).  ``--trace-sample``, ``--snapshot-every`` and
``--flight-log`` arm the flight recorder (``repro_torch.obs.flight``).

The model runs on ``--device`` (default: the card; raises without one).
The printed lines and the persisted files keep the reference's formats,
so ``scripts/power_report.py --ledger`` and ``scripts/trace_report.py``
render the port's output unchanged.  ``run(args, model, params)`` is the
library entry: it serves on weights the caller already holds;
``run_vector(args, arrivals)`` serves a caller's ``VectorArrivals`` on a
vectorized engine.
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
                               PowerPlanPolicy, SegmentFleet,
                               ShardedSegmentFleet, VectorArrivals,
                               VectorFleet, VectorNodeSpec)
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request
from repro_torch.telemetry import (GovernorPolicy, PowerGovernor, WsBudget,
                                   render_rollups)

#: fleet cores: the object engine (a ServeLoop per node on the model) and
#: the vectorized cores (no model)
ENGINES = ("object", "vector", "vector-seg", "vector-torch", "vector-shard")
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
                    help="device the model serves on, or vector-torch "
                         "folds its booking plane on (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--fleet", type=int, default=1,
                    help="number of serving nodes under the scheduler")
    ap.add_argument("--engine", default="object", choices=ENGINES,
                    help="fleet core: the object engine (a ServeLoop per "
                         "node on the model), the stepped vectorized core "
                         "(vector: numpy node arrays, joule-equivalent by "
                         "contract, no model), the event-horizon segment "
                         "engine (vector-seg: quiet stretches advance in "
                         "one batched update), the segment engine with its "
                         "booking plane folded on --device (vector-torch), "
                         "or the sharded segment engine (vector-shard: "
                         "node shards with a two-level routing argmin, "
                         "bit-identical ledger to vector-seg)")
    ap.add_argument("--shard-workers", type=int, default=2,
                    help="vector-shard: node shards (1/2/4/8...)")
    ap.add_argument("--shard-parallel", default="auto",
                    choices=("auto", "inline", "process"),
                    help="vector-shard booking plane: shared-memory "
                         "worker processes, the in-process fold (bit-"
                         "identical), or auto (processes only when more "
                         "than one CPU is usable)")
    ap.add_argument("--tick", type=float, default=0.004,
                    help="vector engines: virtual TickClock seconds per "
                         "decode/prefill/idle window")
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
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="flight recorder: head-sample this fraction of "
                         "request ids for full serve.request span trees "
                         "(deterministic splitmix64 hash; < 1.0 also "
                         "suppresses per-arrival route/submit instants so "
                         "the fused dispatch path stays fused)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="flight recorder: record one fleet time-series "
                         "row (watts, active nodes, queue depth, "
                         "cumulative Ws, arrivals) every N simulated "
                         "fleet steps (0 = off)")
    ap.add_argument("--flight-log", default=None,
                    help="persist the flight-recorder snapshot rows "
                         "(JSONL) here, rendered offline via "
                         "scripts/trace_report.py --flight")
    return ap


def flight_on(args) -> bool:
    """Whether ``args`` arm the flight recorder."""
    return args.trace_sample < 1.0 or args.snapshot_every > 0 \
        or bool(args.flight_log)


def vector_arrivals(args) -> VectorArrivals:
    """The object engine's arrival recipe as a ``VectorArrivals`` stream:
    the same rng draws for prompt lengths (token values are drawn and
    dropped to keep the stream aligned), tenant cycling and due steps."""
    cfg = get_config(args.arch, reduced=args.reduced)
    tenants = [t.strip() for t in args.tenants.split(",") if t.strip()] \
        or ["default"]
    rng = np.random.default_rng(0)
    if args.diurnal:
        dues = parse_diurnal(args.diurnal)
    elif args.arrival_every > 0:
        dues = [i * args.arrival_every for i in range(args.requests)]
    else:
        dues = [0] * args.requests
    plens = []
    for _ in dues:
        plen = int(rng.integers(4, 12))
        rng.integers(2, cfg.vocab_size, size=plen)   # keep the rng
        plens.append(plen)                           # stream aligned
    return VectorArrivals(
        due=dues,
        tenant_idx=[i % len(tenants) for i in range(len(dues))],
        prompt_len=plens,
        max_new=[args.max_new] * len(dues),
        tenant_names=tenants)


def run_vector(args, arrivals: Optional[VectorArrivals] = None,
               max_steps: int = 10_000) -> dict:
    """``--engine vector*``: the same fleet/placement/admission surface
    through the vectorized cores — no model, no weights; token values
    never exist, only the joule account.  Nodes meter at the H100
    envelope.  ``arrivals`` defaults to the object engine's recipe
    (``vector_arrivals``), so the engines are A/B-comparable run for run;
    ``max_steps`` caps the fleet steps (the CLI's scripts end well inside
    the default; a simulated day of 2000-step hours needs 48000).
    ``vector-torch`` folds the booking plane on ``args.device`` (default
    the card; raises without one).  Prints the reference's report lines
    and returns the fleet, the arrivals, the finished rids, admission,
    attribution, the sampled scale-up and the wall seconds."""
    from repro_torch.core.power import H100
    from repro_torch.telemetry import envelope_for

    if args.trace_spans or args.metrics_out:
        obs.enable()
    if flight_on(args):
        obs.set_flight(obs.FlightRecorder(sample_rate=args.trace_sample,
                                          snapshot_every=args.snapshot_every,
                                          log_path=args.flight_log))
        if args.trace_sample < 1.0 and not obs.TRACER.enabled:
            obs.enable()        # sampled trees need a live tracer
    if arrivals is None:
        arrivals = vector_arrivals(args)
    env = envelope_for(H100)
    specs = [VectorNodeSpec(f"{args.node}{i}", env, slots=args.slots,
                            step_s=args.tick, max_seq=args.max_seq)
             for i in range(max(args.fleet, 1))]
    admission = None
    if args.admission:
        admission = AdmissionController(
            parse_budgets(args.admission, args.admission_window))
    plan = None
    if args.placement:
        plan = PowerPlanPolicy(mode=args.placement,
                               slo_queue_depth=args.slo_queue_depth)
    policy = FleetPolicy(flush_every=args.flush_every,
                         checkpoint_every=args.checkpoint_every,
                         router=args.router,
                         migrate_on_drift=False)
    if args.engine == "vector":
        vec = VectorFleet(specs, policy=policy, plan=plan,
                          admission=admission, loop_model="serve")
    elif args.engine == "vector-shard":
        vec = ShardedSegmentFleet(specs, policy=policy, plan=plan,
                                  admission=admission,
                                  loop_model="serve",
                                  shards=args.shard_workers,
                                  parallel=args.shard_parallel)
    else:
        torch_plane = args.engine == "vector-torch"
        vec = SegmentFleet(specs, policy=policy, plan=plan,
                           admission=admission, loop_model="serve",
                           backend="torch" if torch_plane else "numpy",
                           device=args.device if torch_plane else None)
    t0 = time.time()
    finished = vec.run(arrivals, max_steps=max_steps)
    wall = time.time() - t0

    if admission is not None:
        for rej in admission.rejections:
            print(f"req {rej.rid}: tenant={rej.tenant} THROTTLED @step "
                  f"{rej.step} ({rej.reason})")
    rows = vec.results()
    n_tok = sum(r["tokens"] for r in rows if r["finished"])
    for r in rows:
        if not r["finished"]:
            continue
        print(f"req {r['rid']}: tenant={r['tenant']} node={r['node']} "
              f"({r['tokens']} tokens) {r['prefill_ws']:.3f}Ws prefill + "
              f"{r['decode_ws']:.3f}Ws decode")
    print(f"\nserved {len(finished)} requests, {n_tok} tokens in "
          f"{wall:.2f}s simulated on {vec.n} nodes ({vec.steps} fleet "
          f"steps, router={args.router}, engine={args.engine})")
    for line in render_rollups(vec.ledger, label="fleet[vector]"):
        print(line)
    summary = vec.summary()
    for d in summary["nodes"]:
        print(f"node {d['name']}: served={d['served']} "
              f"{d['total_ws']:.2f}Ws parked={d['parked']}")
    if plan is not None:
        for ev in vec.events:
            print(f"placement {ev.action} @step {ev.step}: {ev.node} "
                  f"(rate={ev.rate:.3f}/step, "
                  f"Lq={ev.queue_depth_est:.2f}, "
                  f"keep {ev.active_target} nodes) {ev.reason}")
        p = summary["placement"]
        print(f"placement[{args.placement}]: states={p['states']} "
              f"max_queue_depth={p['max_queue_depth']} "
              f"(SLO {args.slo_queue_depth:g})")
    if admission is not None:
        for tenant, row in summary["admission"].items():
            print(f"admission {tenant}: spent {row['spent_ws']:.2f}Ws of "
                  f"{row['budget_ws']:.2f}Ws, rejected {row['rejected']} "
                  f"submits (0.00Ws booked)")
    if args.ledger_out:
        print(f"ledger -> {vec.ledger.to_json(args.ledger_out)}")
    result = None
    if args.trace_spans:
        result = obs.attribute_joules(list(obs.TRACER.spans), vec.ledger)
        for node_name, row in sorted(
                result.conservation(vec.ledger).items()):
            flag = "ok" if row["ok"] else "DRIFT"
            print(f"attribution {node_name}: ledger {row['ledger_ws']:.4f}Ws "
                  f"attributed {row['attributed_ws']:.4f}Ws "
                  f"(delta {row['delta']:+.2e}) {flag}")
        spans_out = str(Path(args.trace_spans).with_suffix(".spans.jsonl"))
        print(f"spans  -> "
              f"{obs.write_chrome_trace(result.all_spans(), args.trace_spans)}"
              f" (+ {obs.write_spans_jsonl(result.all_spans(), spans_out)})")
        if obs.TRACER.dropped:
            print(f"spans  dropped {obs.TRACER.dropped} past the tracer cap")
    if args.metrics_out:
        print(f"metrics -> {obs.METRICS.write_prometheus(args.metrics_out)}")
        h = obs.METRICS.histogram("queue_wait_s")
        print("queue_wait_s " + " ".join(
            f"p{int(q * 100)}={h.quantile(q):.4f}s" for q in obs.QUANTILES))
    fl = obs.FLIGHT
    sa = None
    if fl.enabled:
        if args.flight_log:
            print(f"flight -> {fl.write_jsonl()} "
                  f"({len(fl.snapshots)} snapshots)")
        elif fl.snapshot_every > 0:
            print(f"flight: {len(fl.snapshots)} snapshots "
                  f"(pass --flight-log to persist)")
        if fl.sampling and obs.TRACER.enabled:
            sa = obs.attribute_joules_sampled(
                list(obs.TRACER.spans), vec.ledger, fl.sample_rate,
                population=fl.population)
            if sa.scaled_ws is None:
                print(f"flight sampled 0/{sa.total_requests} requests "
                      f"(rate {fl.sample_rate:g}) — nothing to scale up")
            else:
                print(f"flight sampled {sa.sampled_requests}/"
                      f"{sa.total_requests} requests "
                      f"(rate {fl.sample_rate:g}): scaled "
                      f"{sa.scaled_ws:.2f}Ws vs ledger "
                      f"{sa.ledger_request_ws:.2f}Ws request-phase "
                      f"(err {sa.error_ws:+.2f}Ws, bound "
                      f"{sa.error_bound_ws:.2f}Ws) "
                      f"{'ok' if sa.ok else 'OUT OF BOUND'}")
    prof = summary.get("profile")
    if prof:
        for p, row in sorted(prof["phases"].items()):
            print(f"profile {p}: {row['seconds']:.4f}s x{row['count']}")
    return {"fleet": vec, "arrivals": arrivals, "finished": finished,
            "admission": admission, "attribution": result, "sampled": sa,
            "wall_s": wall}


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
    NVML counter).  A vectorized ``args.engine`` goes to ``run_vector``
    (no model)."""
    if args.engine != "object":
        return run_vector(args)
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
    ap = parser()
    args = ap.parse_args(argv)
    if args.engine != "object":
        for flag, name in ((args.govern, "--govern"),
                           (args.trace_out, "--trace-out"),
                           (args.verify_rung, "--verify-rung")):
            if flag:
                ap.error(f"{name} is object-engine only (per-node "
                         f"governors and power traces need the object "
                         f"loops) — drop it or use --engine object")
    elif flight_on(args):
        ap.error("--trace-sample/--snapshot-every/--flight-log ride the "
                 "vectorized cores — pick --engine vector/vector-seg/"
                 "vector-torch/vector-shard")
    return run(args)


if __name__ == "__main__":
    main()
